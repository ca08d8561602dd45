"""xlstm-1.3b — sLSTM + mLSTM blocks [arXiv:2405.04517]."""

from repro_torch.configs.base import ModelConfig, ParallelConfig
from repro_torch.core.quant import QuantConfig


def full_config() -> ModelConfig:
    return ModelConfig(
        name="xlstm-1.3b", family="ssm",
        num_layers=48, d_model=2048, num_heads=4, num_kv_heads=4,
        d_ff=0, vocab_size=50304,
        slstm_every=8, mlstm_proj_factor=2.0,
        quant=QuantConfig(enabled=True, w_bits=2, a_bits=2),
        parallel=ParallelConfig(remat="block", microbatches=4),
    )


def reduced_config() -> ModelConfig:
    return full_config().replace(
        num_layers=4, d_model=64, num_heads=4, num_kv_heads=4,
        vocab_size=512, slstm_every=2)
