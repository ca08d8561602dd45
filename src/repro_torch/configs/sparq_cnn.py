"""sparq-cnn — the paper's own conv2d benchmark network (Fig. 4/5)."""

from repro_torch.configs.base import ModelConfig
from repro_torch.core.quant import QuantConfig


def full_config() -> ModelConfig:
    return ModelConfig(
        name="sparq-cnn", family="cnn",
        num_layers=3, d_model=0, num_heads=1, num_kv_heads=1, d_ff=0,
        vocab_size=0,
        cnn_channels=(32, 32, 64), cnn_kernel=7, cnn_input_hw=256,
        cnn_num_classes=10,
        quant=QuantConfig(enabled=True, w_bits=2, a_bits=2),
    )


def reduced_config() -> ModelConfig:
    return full_config().replace(cnn_channels=(8, 8), cnn_kernel=3,
                                 cnn_input_hw=16)
