"""jamba-1.5-large-398b — Mamba+attention 1:7 hybrid, MoE 16e top-2 [arXiv:2403.19887]."""

from repro_torch.configs.base import ModelConfig, ParallelConfig
from repro_torch.core.quant import QuantConfig


def full_config() -> ModelConfig:
    return ModelConfig(
        name="jamba-1.5-large-398b", family="hybrid",
        num_layers=72, d_model=8192, num_heads=64, num_kv_heads=8,
        d_ff=24576, vocab_size=65536,
        attn_stride=8,                    # 1 attention : 7 mamba
        num_experts=16, num_experts_per_tok=2, moe_stride=2,
        ssm_state_dim=16, ssm_conv_width=4, ssm_expand=2,
        quant=QuantConfig(enabled=True, w_bits=2, a_bits=2),
        parallel=ParallelConfig(remat="full", microbatches=16,
                                fsdp_over_pod=True, expert_parallel=True,
                                eightbit_moments=True),
    )


def reduced_config() -> ModelConfig:
    return full_config().replace(
        num_layers=4, d_model=64, num_heads=4, num_kv_heads=2,
        d_ff=128, vocab_size=512, attn_stride=2, num_experts=4,
        moe_stride=2, moe_group_size=16,
        parallel=ParallelConfig(remat="none", microbatches=1))
