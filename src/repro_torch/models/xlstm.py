"""xLSTM blocks: chunkwise-parallel mLSTM and recurrent sLSTM (counterpart
of ``repro/models/xlstm.py``).

mLSTM (matrix memory, exponential input gate, sigmoid forget gate) runs in
the chunkwise-parallel form: within a chunk of length L the recurrence is
a masked, gate-weighted attention-like product; across chunks the
stabilized (log-space, every exponent <= 0) state (C, n, m) is carried.
sLSTM (scalar memory, recurrent gate feedback) runs step by step.  The
reference computes both in XLA (``lax.scan``, einsums) without a Pallas
kernel, so plain PyTorch ops are their port; the up / q / k / v / down
and the sLSTM FFN projections are quantizable Dense layers (W2A2 packed
linears in serving), the gate projections stay float and the recurrences
run in f32.

Caches hold one row a slot: mLSTM ``{"C": [B, NH, hd, hd], "n": [B, NH,
hd], "m": [B, NH]}`` (m starts at -1e30), sLSTM ``{"c", "n", "h", "m"}``
of [B, NH, hd].  The cached forwards write the new state into those
tensors in place (``copy_``), so the serving steps' CUDA graphs advance
it on every replay; tokens past a row's ``cache_valid`` count leave its
state unchanged.  The recurrences run in ``mlstm`` / ``slstm`` profiler
ranges.

A cache whose states split their channels over tensor-parallel shards
(serve/shard.ShardPlan: the mLSTM's ``C`` and ``n`` on their key axis,
the sLSTM's four states on hd) runs each shard's part of the recurrence
on its slice, a whole state as its one shard (:func:`_mlstm_chunk`,
:func:`_slstm_scan`); the joins run in a ``shard_join`` range.  The
mLSTM's contractions over the split axis become partial sums added on
the home device in shard order, so its output is the one-shard output
within f32 rounding, not bit for bit
(``parallel.sharding.CHANNEL_SPLIT_RTOL``).
"""

from __future__ import annotations

import math

import torch

from repro_torch.models import common
from repro_torch.models.common import dense_apply, dense_init
from repro_torch.models.mamba import silu, softplus, valid_lengths
from repro_torch.parallel import sharding


def log_sigmoid(x):
    """``jax.nn.log_sigmoid``: -softplus(-x)."""
    return -softplus(-x)


def _fresh(cache):
    """Reset a cache's states, every part of a split one, to the fresh
    state in place: the stabilizer ``m`` at -1e30, the rest 0."""
    for name, leaf in cache.items():
        for t in sharding.parts(leaf):
            t.fill_(-1e30 if name == "m" else 0.0)


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------

def mlstm_init(generator, cfg, *, dtype=torch.float32, device="cpu"):
    d = cfg.d_model
    inner = int(cfg.mlstm_proj_factor * d)
    nh = cfg.num_heads
    q = dict(dtype=dtype, quantized=True, qcfg=cfg.quant, device=device)
    p = {
        "up": dense_init(generator, d, 2 * inner, **q),
        "q": dense_init(generator, inner, inner, **q),
        "k": dense_init(generator, inner, inner, **q),
        "v": dense_init(generator, inner, inner, **q),
        "if_gate": dense_init(generator, inner, 2 * nh, use_bias=True,
                              dtype=dtype, device=device),
        "norm": common.rmsnorm_init(inner, dtype, device),
        "down": dense_init(generator, inner, d, **q),
    }
    # forget-gate bias: strongly positive, a long memory at init
    p["if_gate"]["bias"][nh:] = 3.0
    return p


def init_mlstm_cache(cfg, batch, dtype=torch.float32, device="cpu"):
    inner = int(cfg.mlstm_proj_factor * cfg.d_model)
    nh = cfg.num_heads
    hd = inner // nh
    return {
        "C": torch.zeros((batch, nh, hd, hd), dtype=dtype, device=device),
        "n": torch.zeros((batch, nh, hd), dtype=dtype, device=device),
        "m": torch.full((batch, nh), -1e30, dtype=dtype, device=device),
    }


def _mlstm_chunk(q, k, v, i_raw, g_log, state):
    """One chunk of the stabilized chunkwise mLSTM.

    q, k, v: [B, NH, L, hd] f32; i_raw, g_log: [B, NH, L]; state (C, n, m)
    stored descaled by exp(m), ``C`` [B, NH, hd, hd] and ``n`` [B, NH, hd]
    as lists of their key-axis (axis 2) parts, one a shard on its shard's
    device (one part when whole), ``m`` [B, NH] whole.  What every key
    slice shares (the gates' weights, the stabilizer) is computed once on
    q's device; shard i updates its key slice of ``C`` and ``n`` and gives
    its partial sums of the two contractions over the key axis, ``q . C``
    and ``q . n``, which are added on q's device in shard order (one
    shard's contraction when whole).  Returns (h [B, NH, L, hd], the new
    state in the same form).

    The contractions are those of the reference's einsums; the
    three-operand one (``bhs,bhsd,bhse->bhde``) is taken as (w_kv * k)
    then the product with v, which may sum in another order than XLA's
    (a last-bit difference over a window of more than one token)."""
    c_parts, n_parts, m_prev = state
    hd = q.shape[-1]
    big = q.shape[2]
    gc = torch.cumsum(g_log, dim=-1)                     # G_t
    s_run = torch.cummax(i_raw - gc, dim=-1).values      # s_t
    m_eff = torch.maximum(s_run, m_prev[..., None])      # M_t - G_t
    m_t = gc + m_eff

    # intra-chunk weights A[t, tau] = exp(i_tau - G_tau - m_eff_t)
    log_a = (i_raw - gc)[..., None, :] - m_eff[..., :, None]
    mask = torch.tril(torch.ones((big, big), dtype=torch.bool,
                                 device=q.device))
    # the exponent is masked, not its exp: above the diagonal log_a can
    # overflow exp, and where's zero gradient times an infinite exp
    # would be NaN (the reference's where(mask, exp(log_a), 0) gives
    # NaN gradients from xlstm-1.3b's fourth layer down at 128 tokens)
    a = torch.exp(torch.where(mask, log_a, -torch.inf))  # [B, NH, L, L]

    qs = q * hd ** -0.5
    scores = torch.einsum("bhtd,bhsd->bhts", qs, k)
    h_num = torch.einsum("bhts,bhsd->bhtd", a * scores, v)
    # the inter-chunk weight b_t = exp(m_prev - max(s_t, m_prev))
    bw = torch.exp(m_prev[..., None] - m_eff)            # [B, NH, L]

    # the state at the chunk's end
    g_total = gc[..., -1]                                # G_L
    m_new = g_total + torch.maximum(s_run[..., -1], m_prev)
    decay = torch.exp(g_total + m_prev - m_new)          # <= 1
    w_kv = torch.exp((g_total[..., None] - gc) + i_raw - m_new[..., None])

    w = hd // len(c_parts)
    qc_parts, qn_parts, c_new, n_new = [], [], [], []
    for i, (c_prev, n_prev) in enumerate(zip(c_parts, n_parts)):
        dev = c_prev.device
        sl = slice(i * w, (i + 1) * w)
        qs_i, k_i = qs[..., sl].to(dev), k[..., sl].to(dev)
        bw_i, w_i, dec = bw.to(dev), w_kv.to(dev), decay.to(dev)
        qc_parts.append(torch.einsum("bhtd,bhde->bhte", qs_i, c_prev))
        n_t = (torch.einsum("bhts,bhsd->bhtd", a.to(dev), k_i)
               + bw_i[..., None] * n_prev[..., None, :])
        qn_parts.append(torch.einsum("bhtd,bhtd->bht", qs_i, n_t))
        c_new.append(dec[..., None, None] * c_prev
                     + torch.einsum("bhsd,bhse->bhde", w_i[..., None] * k_i,
                                    v.to(dev)))
        n_new.append(dec[..., None] * n_prev
                     + torch.einsum("bhs,bhsd->bhd", w_i, k_i))
    h_num = h_num + bw[..., None] * sharding.add_up(qc_parts, q.device)
    qn = sharding.add_up(qn_parts, q.device)
    denom = torch.maximum(torch.abs(qn), torch.exp(-m_t))
    return h_num / denom[..., None], (c_new, n_new, m_new)


def mlstm_apply(p, cfg, x, *, quant_mode="none", cache=None,
                cache_index=None, cache_valid=None, chunk=128,
                backend="auto"):
    """x: [B, S, d] -> (y, cache).

    The cached path continues the recurrence from (C, n, m) over the whole
    window as one chunk; pad tokens past each row's ``cache_valid`` count
    become identity updates (input gate -1e30, forget gate 1, k and v
    zeroed -- the zeroing keeps C and n unchanged even in the all-dead
    fresh-state corner, where m = -1e30 makes w_kv = 1).  The uncached
    path runs chunks of ``chunk`` tokens from the fresh state, the last
    padded the same way; with ``cache`` (the prefill of a fresh cache) the
    cache is reset to the fresh state first and the final state written
    into it.  The cache's tensors are updated in place, a channel-split
    ``C`` and ``n`` part by part (:func:`_mlstm_chunk`)."""
    b, s, d = x.shape
    cd = common.dtype_of(cfg.compute_dtype)
    qm = dict(qcfg=cfg.quant, quant_mode=quant_mode, compute_dtype=cd,
              backend=backend)
    inner = int(cfg.mlstm_proj_factor * d)
    nh = cfg.num_heads
    hd = inner // nh

    up = dense_apply(p["up"], x, **qm)
    xm, z = torch.chunk(up, 2, dim=-1)

    def heads(t):
        return t.reshape(b, s, nh, hd).transpose(1, 2).to(torch.float32)

    q = heads(dense_apply(p["q"], xm, **qm))
    k = heads(dense_apply(p["k"], xm, **qm))
    v = heads(dense_apply(p["v"], xm, **qm))
    gates = dense_apply(p["if_gate"], xm, compute_dtype=torch.float32)
    with torch.profiler.record_function("mlstm"):
        i_raw = gates[..., :nh].transpose(1, 2)          # [B, NH, S]
        g_log = log_sigmoid(gates[..., nh:]).transpose(1, 2)

        if cache is None:
            src = init_mlstm_cache(cfg, b, device=x.device)
        else:
            src = cache
            if cache_index is None:
                _fresh(cache)
        state = ([t.to(torch.float32) for t in sharding.parts(src["C"])],
                 [t.to(torch.float32) for t in sharding.parts(src["n"])],
                 src["m"].to(torch.float32))
        if cache is not None and cache_index is not None:
            if cache_valid is not None:
                vlen = torch.as_tensor(cache_valid, device=x.device)
                inval = (torch.arange(s, device=x.device)[None, None, :]
                         >= vlen.to(torch.int64)[:, None, None])
                i_raw = torch.where(inval, -1e30, i_raw)
                g_log = torch.where(inval, 0.0, g_log)
                k = torch.where(inval[..., None], 0.0, k)
                v = torch.where(inval[..., None], 0.0, v)
            h, state = _mlstm_chunk(q, k, v, i_raw, g_log, state)
        else:
            l_chunk = min(chunk, s)
            pad = (-s) % l_chunk
            if pad:
                q, k, v = (torch.nn.functional.pad(t, (0, 0, 0, pad))
                           for t in (q, k, v))
                i_raw = torch.nn.functional.pad(i_raw, (0, pad),
                                                value=-1e30)
                g_log = torch.nn.functional.pad(g_log, (0, pad))
            hs = []
            for c0 in range(0, q.shape[2], l_chunk):
                sl = slice(c0, c0 + l_chunk)
                h_c, state = _mlstm_chunk(q[:, :, sl], k[:, :, sl],
                                          v[:, :, sl], i_raw[..., sl],
                                          g_log[..., sl], state)
                hs.append(h_c)
            h = torch.cat(hs, dim=2)[:, :, :s]
        if cache is not None:
            c_new, n_new, m_new = state
            for dst, val in zip(sharding.parts(cache["C"]), c_new):
                dst.copy_(val)
            for dst, val in zip(sharding.parts(cache["n"]), n_new):
                dst.copy_(val)
            cache["m"].copy_(m_new)

    h = h.transpose(1, 2).reshape(b, s, inner)
    h = common.rmsnorm_apply(p["norm"], h.to(cd), cfg.norm_eps)
    h = h * silu(z.to(cd))
    return dense_apply(p["down"], h, **qm), cache


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------

def slstm_init(generator, cfg, *, dtype=torch.float32, device="cpu"):
    d = cfg.d_model
    nh = cfg.num_heads
    hd = d // nh
    dff = int(d * 4 / 3)
    q = dict(dtype=dtype, quantized=True, qcfg=cfg.quant, device=device)
    r = torch.randn((nh, hd, 4 * hd), generator=generator,
                    dtype=torch.float32, device=device) / math.sqrt(hd)
    p = {
        # the gate path feeds the recurrence: kept float
        "w_gates": dense_init(generator, d, 4 * d, use_bias=True,
                              dtype=dtype, device=device),
        # block-diagonal (per-head) recurrent weights
        "r_gates": r.to(dtype),
        "norm": common.rmsnorm_init(d, dtype, device),
        "ffn_up": dense_init(generator, d, 2 * dff, **q),
        "ffn_down": dense_init(generator, dff, d, **q),
    }
    p["w_gates"]["bias"][2 * d:3 * d] = 3.0              # forget bias
    return p


_SLSTM_STATE = ("c", "n", "h", "m")


def init_slstm_cache(cfg, batch, dtype=torch.float32, device="cpu"):
    nh = cfg.num_heads
    hd = cfg.d_model // nh
    shape = (batch, nh, hd)
    out = {name: torch.zeros(shape, dtype=dtype, device=device)
           for name in _SLSTM_STATE}
    out["m"].fill_(-1e30)
    return out


def _slstm_update(state, z_in, i_raw, f_raw, o_raw):
    """The elementwise sLSTM update of (c, n, h, m) from the four gate
    pre-activations."""
    c, n, _, m = state
    z_t = torch.tanh(z_in)
    o_t = torch.sigmoid(o_raw)
    f_log = log_sigmoid(f_raw)
    m_new = torch.maximum(f_log + m, i_raw)
    i_p = torch.exp(i_raw - m_new)
    f_p = torch.exp(f_log + m - m_new)
    c_new = f_p * c + i_p * z_t
    n_new = torch.maximum(f_p * n + i_p, torch.exp(-m_new))
    h_new = o_t * c_new / n_new
    return (c_new, n_new, h_new, m_new)


def slstm_apply(p, cfg, x, *, quant_mode="none", cache=None,
                cache_index=None, cache_valid=None, chunk=256,
                backend="auto"):
    """x: [B, S, d] -> (y, cache), step by step (:func:`_slstm_scan`).

    The cached path continues from the cached state; tokens past each
    row's ``cache_valid`` count leave that row's state unchanged.  The
    uncached path starts from the fresh state and, as the reference's
    chunked scan does, runs the window zero-padded to a multiple of
    ``min(chunk, S)`` (its final state includes those pad steps); with
    ``cache`` (the prefill of a fresh cache) the cache is reset to the
    fresh state first and that final state written into it.  The cache's
    tensors are updated in place, part by part when they split."""
    b, s, d = x.shape
    cd = common.dtype_of(cfg.compute_dtype)
    qm = dict(qcfg=cfg.quant, quant_mode=quant_mode, compute_dtype=cd,
              backend=backend)
    nh = cfg.num_heads
    hd = d // nh
    wx = dense_apply(p["w_gates"], x, compute_dtype=torch.float32)
    decoding = cache is not None and cache_index is not None
    if cache is None:
        src = init_slstm_cache(cfg, b, device=x.device)
    else:
        src = cache
        if not decoding:
            _fresh(cache)

    with torch.profiler.record_function("slstm"):
        states = [tuple(t.to(torch.float32) for t in shard) for shard in
                  zip(*(sharding.parts(src[n]) for n in _SLSTM_STATE))]
        keep = None
        if not decoding:
            l_chunk = min(chunk, s)
            wx = torch.nn.functional.pad(wx, (0, 0, 0, (-s) % l_chunk))
        elif cache_valid is not None:
            vlen = valid_lengths(cache_valid, b, s, x.device)
            keep = torch.arange(s, device=x.device)[None, :] < vlen[:, None]
        h_seq, states = _slstm_scan(p, wx, states, keep, nh, hd)
        if cache is not None:
            for i, shard in enumerate(states):
                for name, val in zip(_SLSTM_STATE, shard):
                    sharding.parts(cache[name])[i].copy_(val)

    return _slstm_out(p, cfg, h_seq[:, :s], qm), cache


def _slstm_scan(p, wx, states, keep, nh, hd):
    """The sLSTM step by step over ``wx`` [B, T, 4d] (each step's input
    contribution) from ``states``: (c, n, h, m) by shard, each [B, NH, hd
    / n] f32 on its shard's device -- the states split on hd over n
    shards, one when whole.  At each step ``h`` joins whole on the home
    device (wx's); shard i computes the columns of ``h @ r_gates`` for its
    channels of the four gate blocks (``sharding.channel_part``: a [NH,
    hd, 4, hd / n] view) and the elementwise update of its slices.
    ``keep`` [B, T] (None: every step) says which steps advance a row's
    state.  Returns (the hidden states [B, T, NH, hd] on the home device,
    the final states by shard)."""
    b, steps = wx.shape[:2]
    home = wx.device
    n = len(states)
    w = hd // n
    devs = [shard[0].device for shard in states]
    wx4 = wx.reshape(b, steps, nh, 4, hd)
    wxs = [wx4[..., i * w:(i + 1) * w].to(dev) for i, dev in enumerate(devs)]
    rs = [sharding.channel_part(p, "r_gates", i, n, dev).to(torch.float32)
          for i, dev in enumerate(devs)]
    keeps = [None if keep is None else keep.to(dev) for dev in devs]
    h = sharding.join([shard[2] for shard in states], home)
    hs = []
    for t in range(steps):
        for i, dev in enumerate(devs):
            rx = torch.einsum("bhd,hdge->bhge", h.to(dev), rs[i])
            gates = wxs[i][:, t] + rx                # [B, NH, 4, hd / n]
            st2 = _slstm_update(states[i], *gates.unbind(dim=2))
            states[i] = st2 if keeps[i] is None else tuple(
                torch.where(keeps[i][:, t, None, None], a2, a1)
                for a1, a2 in zip(states[i], st2))
        h = sharding.join([shard[2] for shard in states], home)
        hs.append(h)
    return torch.stack(hs, dim=1), states


def _slstm_out(p, cfg, h_seq, qm):
    """The norm and the post-sLSTM gated FFN (proj factor 4/3) over the
    hidden states [B, S, NH, hd]."""
    b, s = h_seq.shape[:2]
    h = h_seq.reshape(b, s, cfg.d_model).to(qm["compute_dtype"])
    h = common.rmsnorm_apply(p["norm"], h, cfg.norm_eps)
    u, g = torch.chunk(dense_apply(p["ffn_up"], h, **qm), 2, dim=-1)
    return dense_apply(p["ffn_down"], u * silu(g), **qm)
