"""pixtral-12b [vlm] — pixtral-ViT frontend (STUB: precomputed patch
embeddings per assignment) + mistral-nemo decoder backbone.

40L d_model=5120 32H (GQA kv=8) d_ff=14336 vocab=131072
[hf:mistralai/Pixtral-12B-2409]. head_dim=128 (nemo uses explicit 128,
not d_model/n_heads). Full attention -> long_500k skipped.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="pixtral-12b",
    family="vlm",
    n_layers=40,
    d_model=5120,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=131072,
    rope_theta=1_000_000.0,
    frontend="vision",
    frontend_len=256,
)
