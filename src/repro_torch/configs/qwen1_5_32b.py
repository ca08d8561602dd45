"""qwen1.5-32b dense, QKV bias [hf:Qwen/Qwen1.5-32B]."""

from repro_torch.configs.base import ModelConfig, ParallelConfig
from repro_torch.core.quant import QuantConfig


def full_config() -> ModelConfig:
    return ModelConfig(
        name="qwen1.5-32b", family="dense",
        num_layers=64, d_model=5120, num_heads=40, num_kv_heads=40,
        d_ff=27392, vocab_size=152064, qkv_bias=True,
        quant=QuantConfig(enabled=True, w_bits=2, a_bits=2),
        parallel=ParallelConfig(remat="block", microbatches=4,
                                eightbit_moments=True),
    )


def reduced_config() -> ModelConfig:
    return full_config().replace(num_layers=2, d_model=64, num_heads=4,
                                 num_kv_heads=4, d_ff=128, vocab_size=512)
