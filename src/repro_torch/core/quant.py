"""Affine lattice quantizers (counterpart of ``repro/core/quant.py``).

Every quantizer emits an *unsigned* lattice q in [0, 2^bits - 1] with the
affine dequant  x ~= scale * (q - zero_point), because ULPPACK packing
needs non-negative fields.  Weights use the midpoint zero-point
2^(bits-1).  Only the lattice half is ported here: the fake-quant
straight-through estimators belong to training, which comes later.

Rounding is ``torch.round`` (half to even), the same rule as
``jnp.round``, so lattices are bit-equal to the reference package.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class QuantConfig:
    """Quantization settings threaded through model configs."""

    w_bits: int = 4
    a_bits: int = 4
    enabled: bool = False
    # 'lsq' (QAT) or 'absmax' (PTQ) for weights; activations: 'lsq'|'minmax'.
    w_method: str = "lsq"
    a_method: str = "lsq"
    lane_dtype: str = "int16"   # packed lane for the inference kernel
    n_pack: int = 2
    # Field stride override for the packed lane (None -> lane default).
    pack_shift: int | None = None
    # KV cache storage precision: 0 = bf16; 8 = int8 + per-(pos, kv-head)
    # bf16 scales; 4 | 2 = bit-dense packed int32 words (pack_words along
    # head_dim) + the same scale granularity.
    kv_bits: int = 0
    # Which projections to quantize.  Attention einsums always stay fp.
    quantize_lm_head: bool = False

    def __post_init__(self):
        if self.kv_bits not in (0, 2, 4, 8, 16):
            raise ValueError(
                f"kv_bits must be one of 0/16/8/4/2, got {self.kv_bits}")

    @property
    def qmax_w(self) -> int:
        return (1 << self.w_bits) - 1

    @property
    def qmax_a(self) -> int:
        return (1 << self.a_bits) - 1

    @property
    def w_zero_point(self) -> int:
        return 1 << (self.w_bits - 1)

    def replace(self, **kw) -> "QuantConfig":
        return dataclasses.replace(self, **kw)


def quantize_affine(x: torch.Tensor, scale, zero_point, bits: int
                    ) -> torch.Tensor:
    """clip(round(x / scale) + zero_point, 0, 2^bits - 1) as int32."""
    qmax = (1 << bits) - 1
    q = torch.round(x / scale) + zero_point
    return torch.clamp(q, 0, qmax).to(torch.int32)


def dequantize_affine(q: torch.Tensor, scale, zero_point) -> torch.Tensor:
    return (q.to(torch.float32) - zero_point) * scale


def calibrate_absmax(x: torch.Tensor, bits: int, symmetric: bool = True):
    """absmax scale; midpoint zero-point when symmetric (weights).

    Symmetric targets ``qmax - zp`` steps above the midpoint so ``+amax``
    lands exactly on ``qmax`` (see the reference docstring).
    """
    amax = torch.clamp(torch.max(torch.abs(x)), min=1e-8)
    qmax = (1 << bits) - 1
    if symmetric:
        zp = 1 << (bits - 1)
        scale = amax / max(qmax - zp, 1)
    else:
        zp = 0
        scale = amax / qmax
    return scale, zp


def init_step_from_data(x: torch.Tensor, bits: int, signed_midpoint: bool
                        ) -> torch.Tensor:
    """LSQ init: 2*E|x| / sqrt(qmax) (Esser et al. §3), as f32."""
    del signed_midpoint
    qmax = (1 << bits) - 1
    denom = torch.sqrt(torch.tensor(float(qmax), dtype=torch.float32))
    step = 2.0 * torch.mean(torch.abs(x.to(torch.float32))) / denom
    return torch.clamp(step, min=1e-6)
