"""NVIDIA H100 constants for the roofline model (counterpart of
``repro/roofline/hw.py``), dense rates from NVIDIA's data sheets.

H100 SXM5 80GB: HBM3 3.35 TB/s; 67 T f32 op/s on the CUDA cores; 989 T
bf16 and 1,979 T int8 op/s on the tensor cores; NVLink 900 GB/s both
directions together.  H100 PCIe 80GB: HBM2e 2.0 TB/s; 51 T, 756 T,
1,513 T; NVLink bridge 600 GB/s.  The 32-bit integer multiply-add rate of
the CUDA cores (two operations each) is from the Hopper white paper's 64
INT32 units per SM at the boost clock: 132 SMs x 64 x 2 x 1.98 GHz =
33.5 T op/s (SXM), 114 x 64 x 2 x 1.755 GHz = 25.6 T (PCIe).

The module constants are the SXM part's; :func:`card_constants` picks the
part by the name ``torch.cuda.get_device_name`` reports.
"""

from __future__ import annotations

SXM = {"variant": "H100 SXM5 80GB", "hbm": 3.35e12, "f32": 67e12,
       "bf16": 989e12, "int8": 1979e12, "int32": 33.5e12,
       "hbm_bytes": 80e9, "link": 450e9}
PCIE = {"variant": "H100 PCIe 80GB", "hbm": 2.0e12, "f32": 51e12,
        "bf16": 756e12, "int8": 1513e12, "int32": 25.6e12,
        "hbm_bytes": 80e9, "link": 300e9}

PEAK_FLOPS_BF16 = SXM["bf16"]     # op/s per card, bf16 tensor cores
PEAK_OPS_INT8 = SXM["int8"]       # op/s per card, int8 tensor cores
PEAK_FLOPS_F32 = SXM["f32"]       # op/s per card, f32 CUDA cores
PEAK_OPS_INT32 = SXM["int32"]     # op/s per card, int32 multiply-add
HBM_BW = SXM["hbm"]               # bytes/s per card
LINK_BW = SXM["link"]             # NVLink bytes/s per card, one direction
HBM_PER_CHIP = SXM["hbm_bytes"]   # bytes of HBM per card

#: The keys of :func:`card_peaks`: the rates a kernel's bound is taken over.
PEAK_KEYS = ("hbm", "f32", "bf16", "int8", "int32")


def card_constants(name: str) -> dict:
    """Every constant of the H100 part named ``name`` (the PCIe part when
    the name says so, else SXM)."""
    return dict(PCIE if "PCIe" in name else SXM)


def card_peaks(name: str) -> dict:
    """The peak rates of the card named ``name``: HBM bytes/s, f32 op/s on
    the CUDA cores, bf16 and int8 op/s on the tensor cores, and the CUDA
    cores' 32-bit integer multiply-add op/s."""
    c = card_constants(name)
    return {k: c[k] for k in PEAK_KEYS}
