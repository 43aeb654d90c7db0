"""Architecture + run configuration dataclasses (torch counterpart of
``repro.configs.base``: the same fields and defaults, dtype strings mapped
to torch dtypes).

One ``ModelConfig`` instance per assigned architecture lives in
``repro_torch/configs/<arch>.py``; reduced variants for CPU smoke tests come
from ``ModelConfig.reduced()``.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // n_heads

    # attention flavour
    attn_type: str = "gqa"  # gqa | mla
    qk_norm: bool = False
    attn_bias: bool = False
    sliding_window: int = 0  # 0 -> full attention
    rope_theta: float = 10_000.0

    # MLA (deepseek-v2)
    kv_lora_rank: int = 0
    q_lora_rank: int = 0
    rope_head_dim: int = 0
    v_head_dim: int = 0  # 0 -> head_dim

    # MoE
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    first_dense_layers: int = 0
    capacity_factor: float = 1.25
    moe_impl: str = "einsum"  # einsum (GShard dispatch) | gmm (grouped matmul)
    router_aux_coef: float = 0.01

    # SSM / hybrid / xlstm
    block_pattern: str = "attn"  # attn | xlstm_pair | mamba_shared_attn
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_conv_width: int = 4
    ssm_chunk: int = 256
    shared_attn_every: int = 0  # zamba2: shared attn block cadence

    # enc-dec (seamless)
    encoder_layers: int = 0  # >0 -> encoder-decoder; n_layers = decoder depth

    # modality frontend (STUB per assignment: precomputed embeddings)
    frontend: str = ""  # "" | vision | audio
    frontend_len: int = 256  # patches/frames consumed per example (vision only)

    tie_embeddings: bool = False
    norm_eps: float = 1e-5
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    remat: str = "full"  # none | full | dots
    scan_layers: bool = True
    # per-arch overrides of the logical->mesh sharding rules
    sharding_overrides: tuple[tuple[str, Any], ...] = ()
    # set for archs whose decode path is sub-quadratic (SSM state / SWA):
    # required to run the long_500k shape.
    subquadratic: bool = False

    # ------------------------------------------------------------------
    @property
    def padded_vocab(self) -> int:
        """Embedding/unembed rows padded so the vocab dim tiles any mesh
        axis (logits are sliced back to vocab_size)."""
        pad = 2048
        if self.vocab_size % pad == 0 or self.vocab_size < 4 * pad:
            return self.vocab_size if self.vocab_size % 16 == 0 else \
                -(-self.vocab_size // 16) * 16
        return -(-self.vocab_size // pad) * pad

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def resolved_v_head_dim(self) -> int:
        return self.v_head_dim or self.resolved_head_dim

    @property
    def pdtype(self):
        return _DTYPES[self.param_dtype]

    @property
    def cdtype(self):
        return _DTYPES[self.compute_dtype]

    @property
    def is_enc_dec(self) -> bool:
        return self.encoder_layers > 0

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def reduced(self, **kw) -> "ModelConfig":
        """A small same-family config for CPU smoke tests."""
        small = dict(
            n_layers=max(2, min(4, self.n_layers)),
            d_model=64,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 4) if self.n_kv_heads else 4,
            head_dim=16,
            d_ff=128 if self.d_ff else 0,
            vocab_size=256,
            param_dtype="float32",
            compute_dtype="float32",
            remat="none",
        )
        if self.attn_type == "mla":
            small.update(kv_lora_rank=32, q_lora_rank=48, rope_head_dim=8, v_head_dim=16)
        if self.n_experts:
            small.update(n_experts=min(self.n_experts, 8), moe_d_ff=64,
                         n_shared_experts=min(self.n_shared_experts, 1),
                         top_k=min(self.top_k, 2))
        if self.sliding_window:
            small.update(sliding_window=32)
        if self.encoder_layers:
            small.update(encoder_layers=2)
        if self.block_pattern == "mamba_shared_attn":
            small.update(shared_attn_every=2, ssm_state=16, ssm_head_dim=16, ssm_chunk=16)
        if self.block_pattern == "xlstm_pair":
            small.update(n_layers=4, ssm_chunk=16)
        if self.frontend:
            small.update(frontend_len=8)
        small.update(kw)
        return self.replace(**small)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One assigned input shape (seq_len x global_batch + which step it lowers)."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode

    @property
    def tokens(self) -> int:
        return self.seq_len * self.global_batch


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Optimizer / runtime knobs for the training driver."""

    learning_rate: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 1_000
    weight_decay: float = 0.1
    beta1: float = 0.9
    beta2: float = 0.95
    grad_clip: float = 1.0
    seed: int = 0
    microbatches: int = 1  # grad accumulation
    grad_compression: str = "none"  # none | int8_ef
    checkpoint_every: int = 50
    lease_seconds: float = 0.0  # 0 -> unbounded (no chaining)
