"""Config dataclasses: model architecture, quantization, parallelism, shapes.

A JAX-free copy of ``repro/configs/base.py``: every assigned architecture
is a ``ModelConfig`` in its own module under repro_torch/configs/;
``repro_torch.configs.get_config(name)`` returns the full config and
``get_config(name, reduced=True)`` the smoke-test reduction of the same
family (same code paths, tiny dims).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from repro_torch.core.quant import QuantConfig


@dataclasses.dataclass(frozen=True)
class ParallelConfig:
    """How this config shards on the production mesh (DESIGN.md §6)."""

    fsdp_axis: str = "data"          # parameter/optimizer sharding axis
    tensor_axis: str = "model"       # Megatron TP axis
    fsdp_over_pod: bool = False      # also shard params over the pod axis
    expert_parallel: bool = False    # true EP (experts divide tensor axis)
    sequence_parallel: bool = False  # shard long-context KV/activations
    remat: str = "block"             # 'none' | 'block' | 'full'
    microbatches: int = 1            # gradient-accumulation steps
    eightbit_moments: bool = False   # int8 Adam moments (jamba-scale)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                       # dense|moe|ssm|hybrid|audio|vlm|cnn
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None
    # --- attention flavour ---
    qkv_bias: bool = False
    sliding_window: int = 0           # 0 = full attention
    rope_theta: float = 10000.0
    mrope: bool = False               # qwen2-vl multimodal RoPE
    mrope_sections: Tuple[int, int, int] = (16, 24, 24)
    # --- MoE ---
    num_experts: int = 0
    num_experts_per_tok: int = 2
    moe_stride: int = 1               # MoE every k-th layer
    capacity_factor: float = 1.25
    moe_group_size: int = 256         # dispatch blocking (DESIGN.md §6)
    # --- hybrid (jamba): attention every attn_stride-th layer, else mamba ---
    attn_stride: int = 0
    ssm_state_dim: int = 16
    ssm_conv_width: int = 4
    ssm_expand: int = 2
    ssm_dt_rank: int = 0              # 0 -> ceil(d_model/16)
    # --- xlstm ---
    slstm_every: int = 0              # sLSTM every k-th block (0 = none)
    mlstm_proj_factor: float = 2.0
    # --- encoder-decoder ---
    encoder_layers: int = 0           # >0 => enc-dec (seamless)
    # --- frontends (stub modality encoders) ---
    frontend: str = "none"            # none|audio|vision
    frontend_dim: int = 0             # precomputed embedding dim from stub
    # --- misc ---
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    # --- integration of the paper's technique ---
    # quant.kv_bits additionally selects the serving KV-cache storage
    # precision (0/16 bf16, 8 int8, 4/2 bit-dense packed; DESIGN.md §13) —
    # a deployment knob, orthogonal to the w_bits/a_bits compute lattice.
    quant: QuantConfig = dataclasses.field(default_factory=QuantConfig)
    parallel: ParallelConfig = dataclasses.field(
        default_factory=ParallelConfig)
    # --- CNN (sparq-cnn only) ---
    cnn_channels: Tuple[int, ...] = ()
    cnn_kernel: int = 7
    cnn_input_hw: int = 256
    cnn_num_classes: int = 10

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def padded_vocab(self) -> int:
        """Vocab rounded up to a multiple of 256 — hardware-aligned and
        divisible by the tensor axis (embedding/logits shard over 'model')."""
        if self.vocab_size == 0:
            return 0
        return -(-self.vocab_size // 256) * 256

    @property
    def dt_rank(self) -> int:
        return self.ssm_dt_rank or -(-self.d_model // 16)

    @property
    def is_encoder_decoder(self) -> bool:
        return self.encoder_layers > 0

    def layer_kind(self, i: int) -> str:
        """Block type for decoder layer i: attn | mamba | slstm | mlstm."""
        if self.family == "ssm" and self.slstm_every:
            return "slstm" if (i % self.slstm_every == self.slstm_every - 1) \
                else "mlstm"
        if self.family == "ssm":
            return "mlstm"
        if self.attn_stride:
            # jamba 1:7 — one attention layer per attn_stride layers.
            return "attn" if (i % self.attn_stride == self.attn_stride // 2) \
                else "mamba"
        return "attn"

    def layer_is_moe(self, i: int) -> bool:
        if self.num_experts == 0:
            return False
        return i % self.moe_stride == self.moe_stride - 1

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    # ------------------------------------------------------------------
    # Parameter-count accounting (roofline MODEL_FLOPS; DESIGN.md §9)
    # ------------------------------------------------------------------

    def param_counts(self) -> dict:
        """Analytic total / active parameter counts (embedding included)."""
        d, v = self.d_model, self.vocab_size
        hd = self.resolved_head_dim
        nq, nkv = self.num_heads, self.num_kv_heads
        total = v * d * (1 if self.tie_embeddings else 2)
        active = total
        di = self.ssm_expand * d

        def attn_params():
            return d * hd * (nq + 2 * nkv) + nq * hd * d + \
                (hd * (nq + 2 * nkv) if self.qkv_bias else 0)

        def mlp_params():
            return 3 * d * self.d_ff

        def mamba_params():
            dtr = self.dt_rank
            return (d * 2 * di + self.ssm_conv_width * di
                    + di * (dtr + 2 * self.ssm_state_dim)
                    + dtr * di + di * self.ssm_state_dim + di + di * d)

        def mlstm_params():
            inner = int(self.mlstm_proj_factor * d)
            return d * 2 * inner + 3 * inner * inner + 3 * inner + \
                inner * d

        def slstm_params():
            return 4 * d * d + 4 * d * d + 4 * d + int(d * 4 / 3 * d) * 2

        n_dec = self.num_layers
        for i in range(n_dec):
            kind = self.layer_kind(i)
            if kind == "attn":
                total += attn_params(); active += attn_params()
            elif kind == "mamba":
                total += mamba_params(); active += mamba_params()
            elif kind == "mlstm":
                total += mlstm_params(); active += mlstm_params()
            elif kind == "slstm":
                total += slstm_params(); active += slstm_params()
            if kind in ("attn", "mamba"):
                if self.layer_is_moe(i):
                    total += self.num_experts * mlp_params() + \
                        d * self.num_experts
                    active += self.num_experts_per_tok * mlp_params() + \
                        d * self.num_experts
                elif self.d_ff:
                    total += mlp_params(); active += mlp_params()
        if self.is_encoder_decoder:
            enc = self.encoder_layers * (attn_params() + mlp_params())
            cross = self.num_layers * attn_params()
            total += enc + cross
            active += enc + cross
        return {"total": total, "active": active}
