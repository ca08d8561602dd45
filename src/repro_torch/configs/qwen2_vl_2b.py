"""qwen2-vl-2b VLM backbone, M-RoPE, stub vision frontend [arXiv:2409.12191]."""

from repro_torch.configs.base import ModelConfig, ParallelConfig
from repro_torch.core.quant import QuantConfig


def full_config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-vl-2b", family="vlm",
        num_layers=28, d_model=1536, num_heads=12, num_kv_heads=2,
        d_ff=8960, vocab_size=151936, head_dim=128,
        mrope=True, mrope_sections=(16, 24, 24),
        frontend="vision", frontend_dim=1280, tie_embeddings=True,
        quant=QuantConfig(enabled=True, w_bits=2, a_bits=2),
        parallel=ParallelConfig(remat="block"),
    )


def reduced_config() -> ModelConfig:
    return full_config().replace(num_layers=2, d_model=64, num_heads=4,
                                 num_kv_heads=2, d_ff=128, vocab_size=512,
                                 head_dim=16, mrope_sections=(2, 3, 3),
                                 frontend_dim=32)
