"""Architecture registry.

``get_config(name)`` returns the full assigned configuration;
``get_config(name, reduced=True)`` returns the smoke-test reduction of the
same family (same code paths, tiny dims — suitable for CPU).
"""

from __future__ import annotations

from repro_torch.configs import (granite_3_8b, jamba_1_5_large_398b,
                                 minicpm_2b, mixtral_8x22b, mixtral_8x7b,
                                 qwen1_5_32b, qwen2_vl_2b,
                                 seamless_m4t_medium, sparq_cnn,
                                 stablelm_1_6b, xlstm_1_3b)
from repro_torch.configs.base import ModelConfig, ParallelConfig  # noqa: F401

_MODULES = {
    "xlstm-1.3b": xlstm_1_3b,
    "jamba-1.5-large-398b": jamba_1_5_large_398b,
    "stablelm-1.6b": stablelm_1_6b,
    "qwen1.5-32b": qwen1_5_32b,
    "granite-3-8b": granite_3_8b,
    "minicpm-2b": minicpm_2b,
    "seamless-m4t-medium": seamless_m4t_medium,
    "qwen2-vl-2b": qwen2_vl_2b,
    "mixtral-8x22b": mixtral_8x22b,
    "mixtral-8x7b": mixtral_8x7b,
    "sparq-cnn": sparq_cnn,
}

ARCH_NAMES = [n for n in _MODULES if n != "sparq-cnn"]
ALL_NAMES = list(_MODULES)


def get_config(name: str, *, reduced: bool = False) -> ModelConfig:
    if name not in _MODULES:
        raise KeyError(f"unknown architecture {name!r}; "
                       f"available: {sorted(_MODULES)}")
    mod = _MODULES[name]
    return mod.reduced_config() if reduced else mod.full_config()
