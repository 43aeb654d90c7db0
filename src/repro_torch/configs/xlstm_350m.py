"""xlstm-350m [ssm] — sLSTM + mLSTM pairs, no separate FFN (d_ff=0).

24L d_model=1024 4H (GQA kv=4) d_ff=0 vocab=50304 [arXiv:2405.04517].
Sub-quadratic (recurrent state) -> runs long_500k.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-350m",
    family="ssm",
    block_pattern="xlstm_pair",
    n_layers=24,
    d_model=1024,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab_size=50304,
    ssm_expand=2,
    ssm_conv_width=4,
    ssm_chunk=256,
    tie_embeddings=True,
    subquadratic=True,
)
