"""mixtral-8x22b [moe] — 8 experts top-2, sliding-window attention.

56L d_model=6144 48H (GQA kv=8) d_ff=16384 vocab=32768 [arXiv:2401.04088].
8 experts < 16-way model axis, so experts replicate and the expert-internal
width shards (TP-in-expert) — see sharding_overrides. SWA makes decode
memory O(window) -> runs long_500k with a rolling 4096-slot cache.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mixtral-8x22b",
    family="moe",
    n_layers=56,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    head_dim=128,
    d_ff=16384,
    moe_d_ff=16384,
    n_experts=8,
    top_k=2,
    sliding_window=4096,
    vocab_size=32768,
    rope_theta=1_000_000.0,
    sharding_overrides=(("w_experts", None), ("w_expert_mlp", "model")),
    subquadratic=True,
)
