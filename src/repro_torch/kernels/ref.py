"""Plain oracles for the packed kernels (counterpart of
``repro/kernels/ref.py``): exact integer references for the tests."""

from __future__ import annotations

import torch

from repro_torch.core import packing, quant
from repro_torch.core.packing import PackSpec


def matmul_i32_ref(q_a: torch.Tensor, q_w: torch.Tensor) -> torch.Tensor:
    """Exact integer matmul oracle: [M, K] x [K, N] -> int32 (wrapping)."""
    return packing.tile_dots(q_a[None].to(torch.int32),
                             q_w[None].to(torch.int32))[0]


def packed_matmul_ref(q_a: torch.Tensor, q_w: torch.Tensor, spec: PackSpec):
    """Native-ULPPACK path (pack + tile + extract); bit-exact target."""
    return packing.packed_matmul_reference(q_a, q_w, spec)


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
