"""Mamba (selective SSM) block of the jamba hybrid (counterpart of
``repro/models/mamba.py``).

Mamba-1: in-proj -> (x, z); depthwise causal conv1d + SiLU; input-
dependent (dt, B, C); selective scan; gate by SiLU(z); out-proj.  The
in / x / out projections are quantizable Dense layers (W2A2 packed
linears in serving); dt_proj, the conv and the recurrence stay float, the
state f32.  The reference runs the scan in XLA (``lax.scan``) without a
Pallas kernel, so plain PyTorch ops are its port: a Python loop of S
steps, which a CUDA graph captures as S steps.

A cache is ``{"conv": [B, cw-1, di], "ssm": [B, di, ds]}`` f32, one row a
slot.  The cached forward writes the new state into those tensors in
place (``copy_``), so the serving steps' graphs, whose cache pointers are
fixed, advance it on every replay; a row's tokens past its
``cache_valid`` count -- a whole dead row -- leave its state unchanged.
The scan runs in a ``mamba_scan`` profiler range.
"""

from __future__ import annotations

import math

import torch

from repro_torch.models import common
from repro_torch.models.common import dense_apply, dense_init
from repro_torch.models.mlp import _sigmoid


def mamba_init(generator, cfg, *, dtype=torch.float32, device="cpu"):
    d = cfg.d_model
    di = cfg.ssm_expand * d
    ds, dtr, cw = cfg.ssm_state_dim, cfg.dt_rank, cfg.ssm_conv_width
    q = dict(dtype=dtype, quantized=True, qcfg=cfg.quant, device=device)
    conv = torch.randn((cw, di), generator=generator, dtype=torch.float32,
                       device=device) / math.sqrt(cw)
    return {
        "in_proj": dense_init(generator, d, 2 * di, **q),
        "conv_w": conv.to(dtype),
        "conv_b": torch.zeros((di,), dtype=dtype, device=device),
        "x_proj": dense_init(generator, di, dtr + 2 * ds, **q),
        "dt_proj": dense_init(generator, dtr, di, use_bias=True, dtype=dtype,
                              device=device),
        # S4D-real initialization of A (negative real spectrum)
        "A_log": torch.log(torch.arange(1, ds + 1, dtype=torch.float32,
                                        device=device)).repeat(di, 1),
        "D": torch.ones((di,), dtype=torch.float32, device=device),
        "out_proj": dense_init(generator, di, d, **q),
    }


def init_mamba_cache(cfg, batch, dtype=torch.float32, device="cpu"):
    di = cfg.ssm_expand * cfg.d_model
    return {
        "conv": torch.zeros((batch, cfg.ssm_conv_width - 1, di), dtype=dtype,
                            device=device),
        "ssm": torch.zeros((batch, di, cfg.ssm_state_dim), dtype=dtype,
                           device=device),
    }


def softplus(x):
    """``jax.nn.softplus``: log(1 + e^x) as ``logaddexp(x, 0)`` at every x
    (``F.softplus`` returns x itself above its threshold of 20)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype,
                                          device=x.device))


def silu(x):
    """``jax.nn.silu``, rounding where the reference rounds
    (``mlp._sigmoid``)."""
    return x * _sigmoid(x)


def _ssm_params(p, cfg, xc, quant_mode, backend="auto"):
    """Input-dependent dt, B, C (f32) from the conved activation xc
    [B, S, di] in the compute dtype."""
    cd = common.dtype_of(cfg.compute_dtype)
    dtr, ds = cfg.dt_rank, cfg.ssm_state_dim
    dbc = dense_apply(p["x_proj"], xc, qcfg=cfg.quant, quant_mode=quant_mode,
                      compute_dtype=cd, backend=backend).to(torch.float32)
    dt_r, b_mat, c_mat = torch.split(dbc, [dtr, ds, ds], dim=-1)
    dt = softplus(dense_apply(p["dt_proj"], dt_r.to(cd),
                              compute_dtype=torch.float32))
    return dt, b_mat, c_mat


def _conv(windows, p):
    """The depthwise conv over [B, S, cw, di] windows, f32."""
    out = torch.einsum("bskd,kd->bsd", windows, p["conv_w"].to(torch.float32))
    return out + p["conv_b"].to(torch.float32)


def mamba_apply(p, cfg, x, *, quant_mode="none", cache=None,
                cache_index=None, cache_valid=None, backend="auto"):
    """x: [B, S, d].  Returns (y, cache).

    With ``cache`` and ``cache_index`` the recurrence continues from the
    cached (conv, ssm) state for any window length S (a decode token or a
    chunked-prefill window): only each row's first ``cache_valid[b]``
    tokens (all S when None) advance its state.  With ``cache`` alone
    (the prefill of a fresh cache) the window runs from a zero state and
    its final state is written into the cache.  Either way the cache's
    tensors are updated in place."""
    b, s, _ = x.shape
    cd = common.dtype_of(cfg.compute_dtype)
    qm = dict(qcfg=cfg.quant, quant_mode=quant_mode, compute_dtype=cd,
              backend=backend)
    di = cfg.ssm_expand * cfg.d_model
    cw = cfg.ssm_conv_width
    decoding = cache is not None and cache_index is not None

    xz = dense_apply(p["in_proj"], x, **qm)
    xi, z = torch.chunk(xz, 2, dim=-1)                # [B, S, di] each
    xi32 = xi.to(torch.float32)

    with torch.profiler.record_function("mamba_scan"):
        if decoding:
            vlen = (torch.full((b,), s, dtype=torch.int64, device=x.device)
                    if cache_valid is None else
                    torch.as_tensor(cache_valid, device=x.device)
                    .to(torch.int64))
            # the conv history comes from the cache
            hist = torch.cat([cache["conv"].to(torch.float32), xi32], dim=1)
            windows = torch.stack([hist[:, i:i + s] for i in range(cw)],
                                  dim=2)                 # [B, S, cw, di]
            conv_out = _conv(windows, p)
            # the history after each row consumed its vlen[b] valid tokens:
            # a per-row shifted window of hist (a gather is exact, as the
            # reference's one-hot contraction is)
            want = vlen[:, None] + torch.arange(cw - 1, device=x.device)
            new_conv = torch.gather(hist, 1,
                                    want[:, :, None].expand(b, cw - 1, di))
        else:
            padded = torch.nn.functional.pad(xi32, (0, 0, cw - 1, 0))
            windows = torch.stack([padded[:, i:i + s] for i in range(cw)],
                                  dim=2)
            conv_out = _conv(windows, p)
            new_conv = padded[:, -(cw - 1):]
        xc = silu(conv_out)                              # [B, S, di] f32

    dt, b_mat, c_mat = _ssm_params(p, cfg, xc.to(cd), quant_mode, backend)

    with torch.profiler.record_function("mamba_scan"):
        a = -torch.exp(p["A_log"].to(torch.float32))     # [di, ds]
        da = torch.exp(dt[..., None] * a)                # [B, S, di, ds]
        dbx = (dt * xc)[..., None] * b_mat[:, :, None, :]
        if decoding:
            h = cache["ssm"].to(torch.float32)
            keep = (torch.arange(s, device=x.device)[None, :]
                    < vlen[:, None])                     # [B, S]
        else:
            h = torch.zeros((b, di, cfg.ssm_state_dim), dtype=torch.float32,
                            device=x.device)
        ys = []
        for t in range(s):
            h2 = h * da[:, t] + dbx[:, t]
            ys.append(torch.einsum("bds,bs->bd", h2, c_mat[:, t]))
            # a pad token emits garbage y but leaves the state alone
            h = torch.where(keep[:, t, None, None], h2, h) if decoding \
                else h2
        y = torch.stack(ys, dim=1)                       # [B, S, di]
        if cache is not None:
            cache["conv"].copy_(new_conv)
            cache["ssm"].copy_(h)

    y = y + xc * p["D"].to(torch.float32)
    y = y * silu(z.to(torch.float32))
    out = dense_apply(p["out_proj"], y.to(cd), **qm)
    return out, cache
