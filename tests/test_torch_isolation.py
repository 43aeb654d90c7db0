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
