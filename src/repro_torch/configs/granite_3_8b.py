"""granite-3-8b dense GQA [hf:ibm-granite/granite-3.0-8b-base]."""

from repro_torch.configs.base import ModelConfig, ParallelConfig
from repro_torch.core.quant import QuantConfig


def full_config() -> ModelConfig:
    return ModelConfig(
        name="granite-3-8b", family="dense",
        num_layers=40, d_model=4096, num_heads=32, num_kv_heads=8,
        d_ff=12800, vocab_size=49155, tie_embeddings=True,
        quant=QuantConfig(enabled=True, w_bits=2, a_bits=2),
        parallel=ParallelConfig(remat="block", microbatches=2),
    )


def reduced_config() -> ModelConfig:
    return full_config().replace(num_layers=2, d_model=64, num_heads=4,
                                 num_kv_heads=2, d_ff=128, vocab_size=512)
