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

A cache whose states split their channels over tensor-parallel shards
(serve/shard.ShardPlan: ``conv`` on axis 2, ``ssm`` on axis 1) runs the
per-channel work once a shard on its slice, a whole state as its one
shard (:func:`_recurrence`); the joins run in a ``shard_join`` range.
"""

from __future__ import annotations

import math

import torch

from repro_torch.models import common
from repro_torch.models.common import dense_apply, dense_init
from repro_torch.models.mlp import _sigmoid
from repro_torch.parallel import sharding


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
    """dt's low-rank input and B, C (f32) from the conved activation xc
    [B, S, di] in the compute dtype (``x_proj`` contracts every
    channel)."""
    cd = common.dtype_of(cfg.compute_dtype)
    dtr, ds = cfg.dt_rank, cfg.ssm_state_dim
    dbc = dense_apply(p["x_proj"], xc, qcfg=cfg.quant, quant_mode=quant_mode,
                      compute_dtype=cd, backend=backend).to(torch.float32)
    return torch.split(dbc, [dtr, ds, ds], dim=-1)


def _dt(dt_proj, dt_r, cd):
    """Input-dependent dt (f32) of the channels ``dt_proj``'s columns
    hold."""
    return softplus(dense_apply(dt_proj, dt_r.to(cd),
                                compute_dtype=torch.float32))


def _conv(conv, xi32, conv_w, conv_b, vlen):
    """The depthwise causal conv (f32) of a window continuing the history
    ``conv`` [B, cw-1, di] (zeros for a fresh state): (conv_out, the
    history after each row consumed its ``vlen[b]`` valid tokens -- a
    per-row shifted window of the history; a gather is exact, as the
    reference's one-hot contraction is)."""
    b, s, di = xi32.shape
    cw = conv_w.shape[0]
    hist = torch.cat([conv.to(torch.float32), xi32], dim=1)
    windows = torch.stack([hist[:, i:i + s] for i in range(cw)],
                          dim=2)                     # [B, S, cw, di]
    want = vlen[:, None] + torch.arange(cw - 1, device=xi32.device)
    new_conv = torch.gather(hist, 1, want[:, :, None].expand(b, cw - 1, di))
    out = torch.einsum("bskd,kd->bsd", windows, conv_w.to(torch.float32))
    return out + conv_b.to(torch.float32), new_conv


def _scan(h, xc, dt, b_mat, c_mat, a_log, d_skip, z, keep):
    """The selective scan from the state ``h`` [B, di, ds] over the
    window's S steps, then the ``D`` skip and the ``z`` gate.  ``keep``
    [B, S] (None: every token) says which tokens advance the state: a pad
    token emits garbage y but leaves the state alone.  Returns (y [B, S,
    di] f32, the final state)."""
    a = -torch.exp(a_log.to(torch.float32))            # [di, ds]
    da = torch.exp(dt[..., None] * a)                  # [B, S, di, ds]
    dbx = (dt * xc)[..., None] * b_mat[:, :, None, :]
    ys = []
    for t in range(xc.shape[1]):
        h2 = h * da[:, t] + dbx[:, t]
        ys.append(torch.einsum("bds,bs->bd", h2, c_mat[:, t]))
        h = h2 if keep is None else torch.where(keep[:, t, None, None], h2,
                                                h)
    y = torch.stack(ys, dim=1) + xc * d_skip.to(torch.float32)
    return y * silu(z.to(torch.float32)), h


def valid_lengths(cache_valid, b, s, device):
    """Each row's valid token count [B] int64 (all S when None)."""
    return (torch.full((b,), s, dtype=torch.int64, device=device)
            if cache_valid is None else
            torch.as_tensor(cache_valid, device=device).to(torch.int64))


def mamba_apply(p, cfg, x, *, quant_mode="none", cache=None,
                cache_index=None, cache_valid=None, backend="auto"):
    """x: [B, S, d].  Returns (y, cache).

    With ``cache`` and ``cache_index`` the recurrence continues from the
    cached (conv, ssm) state for any window length S (a decode token or a
    chunked-prefill window): only each row's first ``cache_valid[b]``
    tokens (all S when None) advance its state.  With ``cache`` alone
    (the prefill of a fresh cache) the cache is zeroed, the window runs
    from that zero state and its final state is written into the cache;
    without a cache the window runs from a zero state.  A cache's tensors
    are updated in place (:func:`_recurrence`)."""
    b, s, _ = x.shape
    cd = common.dtype_of(cfg.compute_dtype)
    qm = dict(qcfg=cfg.quant, quant_mode=quant_mode, compute_dtype=cd,
              backend=backend)

    xz = dense_apply(p["in_proj"], x, **qm)
    xi, z = torch.chunk(xz, 2, dim=-1)                # [B, S, di] each
    if cache is None:
        state = init_mamba_cache(cfg, b, device=x.device)
    else:
        state = cache
        if cache_index is None:
            for leaf in cache.values():
                for t in sharding.parts(leaf):
                    t.zero_()
    if cache is None or cache_index is None:
        cache_valid = None
    y = _recurrence(p, cfg, xi.to(torch.float32), z, state, cache_valid,
                    quant_mode, backend, write=cache is not None)
    return dense_apply(p["out_proj"], y.to(cd), **qm), cache


def _recurrence(p, cfg, xi32, z, state, cache_valid, quant_mode, backend,
                write=True):
    """The recurrence continuing ``state``'s (conv, ssm), a shard at a
    time: shard i of the n its tensors split their channels over (one
    when whole; serve/shard.ShardPlan splits ``conv`` on axis 2, ``ssm``
    on axis 1) runs the conv and its history gather, silu, dt, the scan,
    the ``D`` skip and the ``z`` gate on its di / n channels on its
    device, reading its parts of ``conv`` and ``ssm`` and, with
    ``write``, writing them in place.  ``x_proj`` contracts every
    channel, so the conved slices join on the home device before it and
    its B and C go back to each shard; ``dt_proj``'s column parts are the
    shards' channels (the ShardPlan splits its kernel with the states).
    Every per-channel op reduces only over axes that are not split, so n
    shards run one shard's ops on slices (on the card within
    ``sharding.CHANNEL_SPLIT_RTOL``: cuBLAS picks ``dt_proj``'s kernel by
    shape).  Returns y [B, S, di] f32 on the home device."""
    b, s, di = xi32.shape
    convs, ssms = sharding.parts(state["conv"]), sharding.parts(state["ssm"])
    n = len(convs)
    w = di // n
    home = xi32.device
    cd = common.dtype_of(cfg.compute_dtype)
    vlen = valid_lengths(cache_valid, b, s, home)
    keep = (None if cache_valid is None else
            torch.arange(s, device=home)[None, :] < vlen[:, None])
    devs = [t.device for t in convs]
    chans = [slice(i * w, (i + 1) * w) for i in range(n)]

    def part(name, i):
        return sharding.channel_part(p, name, i, n, devs[i])

    xcs, new_convs = [], []
    with torch.profiler.record_function("mamba_scan"):
        for i, dev in enumerate(devs):
            conv_out, new_conv = _conv(convs[i], xi32[..., chans[i]].to(dev),
                                       part("conv_w", i), part("conv_b", i),
                                       vlen.to(dev))
            xcs.append(silu(conv_out))                   # [B, S, di/n] f32
            new_convs.append(new_conv)
    xc = sharding.join(xcs, home)
    dt_r, b_mat, c_mat = _ssm_params(p, cfg, xc.to(cd), quant_mode, backend)
    ys = []
    with torch.profiler.record_function("mamba_scan"):
        for i, dev in enumerate(devs):
            dt = _dt(sharding.local(p["dt_proj"], i), dt_r.to(dev), cd)
            y, h = _scan(ssms[i].to(torch.float32), xcs[i], dt,
                         b_mat.to(dev), c_mat.to(dev), part("A_log", i),
                         part("D", i), z[..., chans[i]].to(dev),
                         None if keep is None else keep.to(dev))
            if write:
                convs[i].copy_(new_convs[i])
                ssms[i].copy_(h)
            ys.append(y)
    return sharding.join(ys, home)
