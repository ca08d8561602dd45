"""minicpm-2b dense (llama-like), WSD schedule [arXiv:2404.06395]."""

from repro_torch.configs.base import ModelConfig, ParallelConfig
from repro_torch.core.quant import QuantConfig


def full_config() -> ModelConfig:
    return ModelConfig(
        name="minicpm-2b", family="dense",
        num_layers=40, d_model=2304, num_heads=36, num_kv_heads=36,
        d_ff=5760, vocab_size=122753, tie_embeddings=True,
        quant=QuantConfig(enabled=True, w_bits=2, a_bits=2),
        parallel=ParallelConfig(remat="block", microbatches=2),
    )


def reduced_config() -> ModelConfig:
    return full_config().replace(num_layers=2, d_model=72, num_heads=4,
                                 num_kv_heads=4, d_ff=128, vocab_size=512)
