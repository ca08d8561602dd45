"""stablelm-1.6b dense [hf:stabilityai/stablelm-2-1_6b]."""

from repro_torch.configs.base import ModelConfig, ParallelConfig
from repro_torch.core.quant import QuantConfig


def full_config() -> ModelConfig:
    return ModelConfig(
        name="stablelm-1.6b", family="dense",
        num_layers=24, d_model=2048, num_heads=32, num_kv_heads=32,
        d_ff=5632, vocab_size=100352,
        quant=QuantConfig(enabled=True, w_bits=2, a_bits=2),
        parallel=ParallelConfig(remat="block", microbatches=2),
    )


def reduced_config() -> ModelConfig:
    return full_config().replace(num_layers=2, d_model=64, num_heads=4,
                                 num_kv_heads=4, d_ff=128, vocab_size=512)
