"""qwen3-14b [dense] — per-head q/k RMSNorm, GQA kv=8.

40L d_model=5120 40H (GQA kv=8) d_ff=17408 vocab=151936 [hf:Qwen/Qwen3-14B].
40 heads on a 16-way model axis shards unevenly (GSPMD pads to 48) — noted
in the roofline. Full attention -> long_500k skipped.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-14b",
    family="dense",
    n_layers=40,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    head_dim=128,
    d_ff=17408,
    vocab_size=151936,
    qk_norm=True,
    rope_theta=1_000_000.0,
)
