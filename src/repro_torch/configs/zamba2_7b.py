"""zamba2-7b [hybrid] — Mamba2 backbone + one weight-shared attention block
applied every 6 layers (applied via lax.cond inside the layer scan).

81L d_model=3584 32H (GQA kv=32) d_ff=14336 vocab=32000 ssm_state=64
[arXiv:2411.15242]. Sub-quadratic (SSM state; the shared-attn KV cache is
the only seq-length-bound memory) -> runs long_500k.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-7b",
    family="hybrid",
    block_pattern="mamba_shared_attn",
    n_layers=81,
    d_model=3584,
    n_heads=32,
    n_kv_heads=32,
    d_ff=14336,
    vocab_size=32000,
    ssm_state=64,
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_conv_width=4,
    ssm_chunk=256,
    shared_attn_every=6,
    subquadratic=True,
)
