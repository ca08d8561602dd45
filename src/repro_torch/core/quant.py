"""Affine lattice quantizers (counterpart of ``repro/core/quant.py``).

Every quantizer emits an *unsigned* lattice q in [0, 2^bits - 1] with the
affine dequant  x ~= scale * (q - zero_point), because ULPPACK packing
needs non-negative fields.  Weights use the midpoint zero-point
2^(bits-1).

The QAT forward path is three ``torch.autograd.Function``s, the
counterparts of the reference's custom VJPs: :func:`fake_quant`
(straight-through, no gradient to scale or zero point),
:func:`lsq_fake_quant` (LSQ's learned step) and :func:`pact_clip` (PACT's
learned clip).  Each computes in its inputs' dtype, as the reference does.
Their forward and backward run in a ``fake_quant`` profiler range, which
a trace groups by (it costs nothing when no profiler runs).

Rounding is ``torch.round`` (half to even), the same rule as
``jnp.round``, so lattices are bit-equal to the reference package.
"""

from __future__ import annotations

import dataclasses

import numpy as np
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


# ---------------------------------------------------------------------------
# Fake-quant with straight-through estimators (the QAT forward path)
# ---------------------------------------------------------------------------

def _promoted(x, *others):
    """``x`` in the dtype the reference computes ``x`` op ``others`` in:
    JAX promotes across ranks (a bf16 array over an f32 0-d array is f32),
    where PyTorch would keep a dimensioned operand's dtype."""
    dt = x.dtype
    for o in others:
        if isinstance(o, torch.Tensor):
            dt = torch.promote_types(dt, o.dtype)
    return x.to(dt)


class _FakeQuant(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale, zero_point, bits):
        with torch.profiler.record_function("fake_quant"):
            xp = _promoted(x, scale, zero_point)   # Python numbers are weak
            scale = torch.as_tensor(scale, device=x.device)
            zero_point = torch.as_tensor(zero_point, device=x.device)
            ctx.save_for_backward(x, scale, zero_point)
            ctx.bits = bits
            ctx.dtype = xp.dtype
            q = quantize_affine(xp, scale, zero_point, bits)
            return dequantize_affine(q, scale, zero_point)

    @staticmethod
    def backward(ctx, g):
        with torch.profiler.record_function("fake_quant"):
            x, scale, zp = ctx.saved_tensors
            qmax = (1 << ctx.bits) - 1
            lo = (0 - zp) * scale
            hi = (qmax - zp) * scale
            xp = x.to(ctx.dtype)
            dx = torch.where((xp >= lo) & (xp <= hi), g, 0.0)
            # scale and zero point are calibration constants here; LSQ below
            # is the learned-scale path
            return (dx, torch.zeros_like(scale), torch.zeros_like(zp), None)


def fake_quant(x, scale, zero_point, bits: int):
    """Affine fake-quant (quantize, then dequantize to f32) with the
    straight-through gradient inside the lattice's range; scale and zero
    point get zero gradient."""
    return _FakeQuant.apply(x, scale, zero_point, bits)


class _LsqFakeQuant(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, step, bits, signed_midpoint):
        with torch.profiler.record_function("fake_quant"):
            ctx.save_for_backward(x, step)
            ctx.bits, ctx.signed_midpoint = bits, signed_midpoint
            zp = (1 << (bits - 1)) if signed_midpoint else 0
            qmax = (1 << bits) - 1
            q = torch.clamp(torch.round(x / step + zp), 0, qmax)
            return (q - zp) * step

    @staticmethod
    def backward(ctx, g):
        with torch.profiler.record_function("fake_quant"):
            x, step = ctx.saved_tensors
            zp = (1 << (ctx.bits - 1)) if ctx.signed_midpoint else 0
            qmax = (1 << ctx.bits) - 1
            v = x / step + zp
            q = torch.round(v)
            below, above = v < 0, v > qmax
            mid = ~(below | above)
            dx = torch.where(mid, g, 0.0)
            # d(out)/d(step): q - v inside the range, rail - zp at the rails
            dstep_elem = (q - v).masked_fill(below, 0 - zp) \
                .masked_fill(above, qmax - zp)
            # LSQ's gradient scale 1/sqrt(numel * qmax), in f32 on the
            # host (a device scalar made here would wait for the card)
            f32 = np.float32
            gscale = float(f32(1.0) / np.sqrt(f32(x.numel()) * f32(qmax)))
            dstep = (g * dstep_elem).to(torch.float32).sum() * gscale
            return dx, dstep.reshape(step.shape).to(step.dtype), None, None


def lsq_fake_quant(x, step, bits: int, signed_midpoint: bool):
    """LSQ fake-quant: the lattice at a learned step size with the LSQ
    gradient.  ``signed_midpoint=True`` puts the zero point at
    2^(bits-1) (weights); False uses 0 (non-negative activations).  ``x``
    and ``step`` should share a dtype: the arithmetic runs in it."""
    return _LsqFakeQuant.apply(x, step, bits, signed_midpoint)


class _PactClip(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, alpha):
        with torch.profiler.record_function("fake_quant"):
            ctx.save_for_backward(x, alpha)
            return torch.minimum(torch.clamp(x, min=0.0), alpha)

    @staticmethod
    def backward(ctx, g):
        with torch.profiler.record_function("fake_quant"):
            x, alpha = ctx.saved_tensors
            dx = torch.where((x > 0) & (x < alpha), g, 0.0)
            dalpha = torch.where(x >= alpha, g, 0.0).sum()
            return dx, dalpha.reshape(alpha.shape)


def pact_clip(x, alpha, bits: int):
    """PACT: clip non-negative activations to a learnable [0, alpha];
    alpha's gradient is the sum of the incoming gradient where x >= alpha.
    ``bits`` is unused, as in the reference."""
    del bits
    return _PactClip.apply(x, alpha)
