"""seamless-m4t-medium enc-dec audio (stub frontend) [arXiv:2308.11596]."""

from repro_torch.configs.base import ModelConfig, ParallelConfig
from repro_torch.core.quant import QuantConfig


def full_config() -> ModelConfig:
    return ModelConfig(
        name="seamless-m4t-medium", family="audio",
        num_layers=12, encoder_layers=12, d_model=1024, num_heads=16,
        num_kv_heads=16, d_ff=4096, vocab_size=256206,
        frontend="audio", frontend_dim=512,
        quant=QuantConfig(enabled=True, w_bits=2, a_bits=2),
        parallel=ParallelConfig(remat="block"),
    )


def reduced_config() -> ModelConfig:
    return full_config().replace(num_layers=2, encoder_layers=2, d_model=64,
                                 num_heads=4, num_kv_heads=4, d_ff=128,
                                 vocab_size=512, frontend_dim=32)
