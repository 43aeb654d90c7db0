"""deepseek-v2-236b [moe] — MLA (kv_lora=512, decoupled RoPE 64) + MoE with
2 shared + 160 routed experts, top-6; first layer dense (as released).

60L d_model=5120 128H d_ff(expert)=1536 vocab=102400 [arXiv:2405.04434].
EP: experts shard on the 16-way model axis (10 experts/chip); the MoE
dispatch/combine einsums are the in-model analogue of the paper's SQS
shuffle (DESIGN.md §2). Decode caches the 512-d latent + 64-d rope key
per token — not per-head K/V. Full attention (over latent) -> long_500k
skipped.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v2-236b",
    family="moe",
    n_layers=60,
    d_model=5120,
    n_heads=128,
    n_kv_heads=128,
    head_dim=128,       # nope head dim
    attn_type="mla",
    kv_lora_rank=512,
    q_lora_rank=1536,
    rope_head_dim=64,
    v_head_dim=128,
    d_ff=12288,          # the dense first layer (as released)
    moe_d_ff=1536,
    n_experts=160,
    n_shared_experts=2,
    top_k=6,
    first_dense_layers=1,
    vocab_size=102400,
    capacity_factor=1.25,
)
