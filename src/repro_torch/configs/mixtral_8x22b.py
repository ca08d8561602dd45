"""mixtral-8x22b MoE 8e top-2, SWA [arXiv:2401.04088]."""

from repro_torch.configs.base import ModelConfig, ParallelConfig
from repro_torch.core.quant import QuantConfig


def full_config() -> ModelConfig:
    return ModelConfig(
        name="mixtral-8x22b", family="moe",
        num_layers=56, d_model=6144, num_heads=48, num_kv_heads=8,
        d_ff=16384, vocab_size=32768, sliding_window=4096,
        num_experts=8, num_experts_per_tok=2, moe_stride=1,
        quant=QuantConfig(enabled=True, w_bits=2, a_bits=2),
        parallel=ParallelConfig(remat="full", microbatches=8,
                                fsdp_over_pod=True, eightbit_moments=True),
    )


def reduced_config() -> ModelConfig:
    return full_config().replace(
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, d_ff=128,
        vocab_size=512, sliding_window=8, num_experts=4, moe_group_size=16,
        parallel=ParallelConfig(remat="none", microbatches=1))
