"""ISA-level model of Sparq's ``vmacsr`` instruction (paper §IV-A), the
counterpart of ``repro/core/vmacsr.py``.

    vmacsr:  Vd <- Vd + ((Vs1 * Vs2) >> M)

These functions mirror the hardware lane semantics on int8 / int16 / int32
tensors: fixed-width wraparound, and the shift applied to the full,
double-width product before it is accumulated.  The product widens to
int16 / int32 / int64 as the ISA says, whatever the lane, so an int32
lane's shifter sees all 64 bits of the product.  They serve as
documentation of the instruction, as the instruction-count model of the
Fig. 4 comparison (how many vector instructions each conv2d variant issues
on Ara and on Sparq), and as the per-MAC semantics the kernels' per-tile
extraction agrees with where nothing overflows.

The performance realisation on the card is not this module: the CUDA-core
K2 (``csrc/ulppack_matmul.cu``) applies the shift to each lane's full
product, and the tensor-core kernels extract the packed sum in their
epilogue.
"""

from __future__ import annotations

import dataclasses

import torch

#: Lane width in bits by lane dtype; the product is formed at twice that.
_BITS = {torch.int8: 8, torch.int16: 16, torch.int32: 32}


def _bits(dtype) -> int:
    if dtype not in _BITS:
        raise TypeError(f"vector lanes are int8, int16 or int32, got {dtype}")
    return _BITS[dtype]


def _wrap(x: torch.Tensor, lane) -> torch.Tensor:
    """int64 ``x`` reduced modulo the lane width (two's complement), as
    ``lane``: the low bits kept."""
    bits = _bits(lane)
    half = 1 << (bits - 1)
    return ((x + half) % (1 << bits) - half).to(lane)


def vmacc(vd, vs1, vs2):
    """RVV vmacc: vd += vs1*vs2, modulo lane width (low bits kept)."""
    lane = vd.dtype
    prod = _wrap(vs1.long(), lane).long() * _wrap(vs2.long(), lane).long()
    return _wrap(vd.long() + prod, lane)


def vmacsr(vd, vs1, vs2, shift):
    """Sparq vmacsr: vd += (full-width(vs1*vs2) >> shift), modulo lane width.

    The SIMD multiplier produces the double-width product, and the shifter
    (Fig. 2) sits between the multiplier and the accumulator, so the shift
    sees the full product: this is what removes the low cross-term before
    it can accumulate.  The shift is arithmetic, as on signed lanes."""
    lane = vd.dtype
    _bits(lane)
    prod = vs1.long() * vs2.long()
    return _wrap(vd.long() + (prod >> shift), lane)


def vsrl(v, shift):
    """Logical shift right on unsigned-interpreted lanes."""
    lane = v.dtype
    mask = (1 << _bits(lane)) - 1
    return _wrap((v.long() & mask) >> shift, lane)


def vand(v, imm):
    return v & torch.as_tensor(imm, device=v.device).to(v.dtype)


def vadd(a, b):
    return _wrap(a.long() + b.long(), a.dtype)


# ---------------------------------------------------------------------------
# Instruction-count model (the Fig. 4 comparison): vector instructions per
# output tile of a packed dot product of K channels.
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class InstructionCount:
    macs: int          # vmacc / vmacsr issues
    shifts: int        # standalone vsrl issues
    masks: int         # vand issues
    adds: int          # vadd issues (wide accumulate after extraction)

    @property
    def total(self) -> int:
        return self.macs + self.shifts + self.masks + self.adds


def native_ulppack_instruction_count(k_channels: int, k_tile: int,
                                     n_pack: int = 2) -> InstructionCount:
    """Stock-Ara ULPPACK: vmacc per packed lane + extract every k_tile
    lanes."""
    lanes = -(-k_channels // n_pack)
    k_tile = max(k_tile, 1)
    extractions = -(-lanes // k_tile)
    return InstructionCount(macs=lanes, shifts=extractions,
                            masks=extractions, adds=extractions)


def vmacsr_instruction_count(k_channels: int, k_tile: int,
                             n_pack: int = 2) -> InstructionCount:
    """Sparq: vmacsr per packed lane; extraction collapses to a mask+add only
    at accumulator spill points (the fused shift removed the vsrl), and the
    relaxed constraint (no L-carry) doubles the spill distance."""
    lanes = -(-k_channels // n_pack)
    k_tile = max(2 * k_tile, 1)
    spills = -(-lanes // k_tile)
    return InstructionCount(macs=lanes, shifts=0, masks=spills, adds=spills)


def int16_instruction_count(k_channels: int) -> InstructionCount:
    """Baseline int16 dot product: one widening MAC per channel."""
    return InstructionCount(macs=k_channels, shifts=0, masks=0, adds=0)
