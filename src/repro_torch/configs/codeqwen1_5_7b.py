"""codeqwen1.5-7b [dense] — qwen1.5 arch: QKV bias, MHA (kv = heads).

32L d_model=4096 32H (GQA kv=32) d_ff=13440 vocab=92416
[hf:Qwen/CodeQwen1.5-7B].  Full attention -> long_500k skipped.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="codeqwen1.5-7b",
    family="dense",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=32,
    d_ff=13440,
    vocab_size=92416,
    attn_bias=True,
    rope_theta=1_000_000.0,
)
