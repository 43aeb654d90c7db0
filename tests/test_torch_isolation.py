"""The port stands alone: it imports neither JAX nor the JAX package, and
its entry points refuse to run on the card when there is none."""

import os
import pathlib
import re
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
_FORBIDDEN = re.compile(r"^\s*(?:import|from)\s+(?:jax|jaxlib|repro)(?:[.\s,]|$)", re.M)


def _port_sources():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    return files + [ROOT / "chip_smoke.py"]


def test_sources_import_no_jax_and_no_repro():
    found = [f"{path.relative_to(ROOT)}: {m.group(0).strip()}"
             for path in _port_sources()
             for m in _FORBIDDEN.finditer(path.read_text())]
    assert len(_port_sources()) > 10 and not found, found


def test_serve_smoke_on_cpu_loads_no_jax():
    prog = (
        "import sys\n"
        "from repro_torch.launch import serve\n"
        "toks = serve.main(['--preset', 'smoke', '--device', 'cpu', '--batch', '2',\n"
        "                   '--prompt-len', '16', '--new-tokens', '4'])\n"
        "assert tuple(toks.shape) == (2, 4), toks.shape\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n"
        "print('ISOLATED')\n")
    out = subprocess.run([sys.executable, "-c", prog], capture_output=True, text=True,
                         cwd=ROOT, env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
                         timeout=300)
    assert out.returncode == 0 and "ISOLATED" in out.stdout, out.stderr
    assert "prefill" in out.stdout and "ms/step" in out.stdout


def test_engine_on_cpu_loads_no_jax_and_numpy_route_no_torch():
    """The port's engine runs a SQL query on the CPU (torch route, plain
    version) with no jax, jaxlib or repro module loaded; an engine on the
    numpy route never imports torch at all."""
    prog = (
        "import sys\n"
        "from repro_torch.core import FlintConfig, FlintContext\n"
        "from repro_torch.data.synthetic import taxi_csv\n"
        "from repro_torch.sql import Schema, col, lit, sum_\n"
        "schema = Schema([('pickup', 'str'), ('dropoff', 'str'), ('lon', 'float'),\n"
        "                 ('lat', 'float'), ('miles', 'float'), ('pay', 'str'),\n"
        "                 ('tip', 'float'), ('total', 'float'), ('precip', 'float'),\n"
        "                 ('color', 'str')])\n"
        "def query(backend):\n"
        "    ctx = FlintContext('flint', FlintConfig(concurrency=4, vector_backend=backend,\n"
        "                                            vector_device='cpu'))\n"
        "    ctx.upload('taxi.csv', taxi_csv(2000, seed=1))\n"
        "    df = ctx.read_csv('taxi.csv', schema, 4)\n"
        "    return sorted(df.withColumn('h', col('pickup').substr(12, 2))\n"
        "                    .withColumn('c', (col('tip') * lit(100.0)).cast('int'))\n"
        "                    .groupBy('h').agg(sum_(col('c')).alias('t')).collect())\n"
        "numpy_rows = query('numpy')\n"
        "assert 'torch' not in sys.modules, 'the numpy route imported torch'\n"
        "assert query('torch') == numpy_rows and len(numpy_rows) == 24\n"
        "from repro_torch.kernels.ops import grouped_reduce\n"
        "assert grouped_reduce.folds > 0\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n"
        "print('ISOLATED')\n")
    out = subprocess.run([sys.executable, "-c", prog], capture_output=True, text=True,
                         cwd=ROOT, env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
                         timeout=300)
    assert out.returncode == 0 and "ISOLATED" in out.stdout, out.stderr


def test_engine_default_config_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present; this checks the behaviour without one")
    from repro_torch.core import FlintConfig, FlintContext
    with pytest.raises(RuntimeError, match="no CUDA device"):
        FlintContext()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        FlintConfig(vector_backend="torch").validate()


def test_cuda_entry_points_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present; this checks the behaviour without one")
    from repro_torch.common.device import resolve_device
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models import lm
    cfg = get_config("yi-9b").reduced()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        lm.init(cfg, torch.Generator(), device="cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        lm.init_caches(cfg, 1, 8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--preset", "smoke"])
