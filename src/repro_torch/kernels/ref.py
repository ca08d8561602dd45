"""Plain oracles for the packed kernels (counterpart of
``repro/kernels/ref.py``): exact integer references for the tests."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core import packing, quant
from repro_torch.core.packing import PackSpec


def matmul_i32_ref(q_a: torch.Tensor, q_w: torch.Tensor) -> torch.Tensor:
    """Exact integer matmul oracle: [M, K] x [K, N] -> int32 (wrapping)."""
    return packing.tile_dots(q_a[None].to(torch.int32),
                             q_w[None].to(torch.int32))[0]


def packed_matmul_ref(q_a: torch.Tensor, q_w: torch.Tensor, spec: PackSpec):
    """Native-ULPPACK path (pack + tile + extract); bit-exact target."""
    return packing.packed_matmul_reference(q_a, q_w, spec)


def conv2d_i32_ref(q_x: torch.Tensor, q_w: torch.Tensor, padding="VALID"
                   ) -> torch.Tensor:
    """Exact integer conv2d oracle: q_x [N, H, W, C] x q_w [Fh, Fw, C, Co]
    -> int32 NHWC, 'VALID' or 'SAME', wrapped mod 2^32 like XLA's s32.

    Computed as a float64 convolution (exact while every partial sum stays
    below 2^53, e.g. any int16 operands over fewer than 2^22 taps x
    channels), then reduced mod 2^32 -- independent of the plain versions'
    packed-lane contractions."""
    fh, fw = q_w.shape[:2]
    if padding == "SAME":
        ph, pw = fh - 1, fw - 1
        pads = (pw // 2, pw - pw // 2, ph // 2, ph - ph // 2)
    elif padding == "VALID":
        pads = (0, 0, 0, 0)
    else:
        raise ValueError(f"padding must be 'SAME' or 'VALID', got {padding!r}")
    x = F.pad(q_x.to(torch.float64).permute(0, 3, 1, 2), pads)
    y = F.conv2d(x, q_w.to(torch.float64).permute(3, 2, 0, 1))
    return packing.wrap_i32(y.to(torch.int64)).permute(0, 2, 3, 1) \
        .contiguous()


def quantize_pack_ref(x: torch.Tensor, scale, zero_point, spec: PackSpec):
    """Oracle for the fused quantize+pack kernel: (lanes, row sums [M])."""
    q = quant.quantize_affine(x, scale, zero_point, spec.a_bits)
    packed = packing.pack_activations(q, spec, axis=-1)
    return packed, q.sum(dim=-1, dtype=torch.int32)


def quantized_linear_ref(x, w, a_scale, a_zp, w_scale, w_zp, a_bits, w_bits):
    """Float oracle of a fully affine-corrected quantized linear layer."""
    q_a = quant.quantize_affine(x, a_scale, a_zp, a_bits)
    q_w = quant.quantize_affine(w, w_scale, w_zp, w_bits)
    k = x.shape[-1]
    acc = matmul_i32_ref(q_a, q_w).to(torch.float32)
    a_sums = q_a.sum(dim=-1, keepdim=True).to(torch.float32)
    w_sums = q_w.sum(dim=0, keepdim=True).to(torch.float32)
    corrected = acc - w_zp * a_sums - a_zp * w_sums + k * a_zp * w_zp
    return a_scale * w_scale * corrected
