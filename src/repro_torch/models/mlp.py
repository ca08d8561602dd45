"""Gated (SwiGLU) and plain MLPs with quantizable projections (counterpart
of ``repro/models/mlp.py``)."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models import common
from repro_torch.models.common import dense_apply, dense_init


def mlp_init(generator, cfg, d_ff=None, *, gated=True, dtype=torch.float32,
             device="cpu"):
    d_ff = d_ff or cfg.d_ff
    kw = dict(dtype=dtype, quantized=True, qcfg=cfg.quant, device=device)
    p = {"up": dense_init(generator, cfg.d_model, d_ff, **kw),
         "down": dense_init(generator, d_ff, cfg.d_model, **kw)}
    if gated:
        p["gate"] = dense_init(generator, cfg.d_model, d_ff, **kw)
    return p


def _sigmoid(x):
    """The logistic as the reference lowers it: in bf16 XLA computes
    1 / (1 + exp(-x)) rounding after every op.  A one-ulp change here can
    flip a 2-bit lattice of the down projection's input, so the port rounds
    at the same places (in f32, torch.sigmoid is the closer match)."""
    if x.dtype == torch.float32:
        return torch.sigmoid(x)
    return 1 / (1 + torch.exp(-x))


def mlp_apply(p, cfg, x, *, quant_mode="none", backend="auto"):
    cd = common.dtype_of(cfg.compute_dtype)
    qm = dict(qcfg=cfg.quant, quant_mode=quant_mode, compute_dtype=cd,
              backend=backend)
    up = dense_apply(p["up"], x, **qm)
    if "gate" in p:
        g = dense_apply(p["gate"], x, **qm)
        h = g * _sigmoid(g) * up
    else:
        h = F.gelu(up, approximate="tanh")
    return dense_apply(p["down"], h, **qm)
