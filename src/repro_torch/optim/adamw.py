"""AdamW with optional 8-bit (blockwise-quantized) moments, functional over
a parameter tree (counterpart of ``repro/optim/adamw.py``):

  state = init(params, cfg)
  updates, state = update(grads, state, params, lr, cfg)
  params = apply_updates(params, updates)

The order of operations is the reference's (bias correction on the
moments, then weight decay added to the step, all in f32), which is not
``torch.optim.AdamW``'s.  With ``eightbit_moments`` m and v are stored as
int8 lattices with per-block f32 absmax / 127 scales over the flattened
leaf, in blocks of ``moment_block`` (zero-padded): a leaf's moment is the
dict ``{"q": int8 [blocks, block], "scale": f32 [blocks, 1]}``, the
reference's layout, so train states cross between the packages
(bridge.py, train/checkpoint.py).
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch import tree as tree_lib


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    eightbit_moments: bool = False
    moment_block: int = 256


def _qm(x: torch.Tensor, block: int):
    """Flattened f32 ``x`` -> (int8 [blocks, block], f32 [blocks, 1])."""
    flat = x.to(torch.float32).reshape(-1)
    pad = (-flat.numel()) % block
    if pad:
        flat = torch.nn.functional.pad(flat, (0, pad))
    xb = flat.reshape(-1, block)
    # divided by a device tensor: PyTorch's CUDA division by a host scalar
    # multiplies by its rounded reciprocal, which can move the last bit of
    # the reference's (and the CPU's) true quotient
    scale = torch.clamp(xb.abs().amax(dim=1, keepdim=True)
                        / torch.full((), 127.0, device=xb.device),
                        min=1e-12)
    q = torch.clamp(torch.round(xb / scale), -127, 127).to(torch.int8)
    return q, scale


def _dq(q: torch.Tensor, scale: torch.Tensor, shape) -> torch.Tensor:
    x = (q.to(torch.float32) * scale).reshape(-1)
    n = 1
    for d in shape:
        n *= d
    return x[:n].reshape(shape)


def is_moment(node) -> bool:
    """An 8-bit moment leaf: a dict with exactly the keys q and scale
    (attention parameter blocks also hold a "q" key, so the whole key set
    decides)."""
    return isinstance(node, dict) and set(node) == {"q", "scale"}


def init(params, cfg: AdamWConfig):
    def zero_like(p):
        z = torch.zeros(p.shape, dtype=torch.float32, device=p.device)
        if cfg.eightbit_moments:
            q, scale = _qm(z, cfg.moment_block)
            return {"q": q, "scale": scale}
        return z

    dev = tree_lib.leaves(params)[0].device
    return {"m": tree_lib.tree_map(zero_like, params),
            "v": tree_lib.tree_map(zero_like, params),
            "count": torch.zeros((), dtype=torch.int32, device=dev)}


def update(grads, state, params, lr, cfg: AdamWConfig):
    """One AdamW step: (updates in f32, new optimizer state).  ``lr`` is a
    0-d f32 tensor (or a float)."""
    count = state["count"] + 1
    b1c = 1.0 - torch.pow(cfg.b1, count.to(torch.float32))
    b2c = 1.0 - torch.pow(cfg.b2, count.to(torch.float32))
    lr = torch.as_tensor(lr, dtype=torch.float32)
    eight = cfg.eightbit_moments
    m_leaves = tree_lib.leaves(state["m"], is_leaf=is_moment)
    v_leaves = tree_lib.leaves(state["v"], is_leaf=is_moment)
    p_leaves = tree_lib.leaves(params)
    g_leaves = tree_lib.leaves(grads)
    updates, new_m, new_v = [], [], []
    for g, m_st, v_st, p in zip(g_leaves, m_leaves, v_leaves, p_leaves):
        g = g.to(torch.float32)
        if eight:
            m_prev = _dq(m_st["q"], m_st["scale"], p.shape)
            v_prev = _dq(v_st["q"], v_st["scale"], p.shape)
        else:
            m_prev, v_prev = m_st, v_st
        m = cfg.b1 * m_prev + (1 - cfg.b1) * g
        v = cfg.b2 * v_prev + (1 - cfg.b2) * g * g
        mhat = m / b1c
        vhat = v / b2c
        step = mhat / (torch.sqrt(vhat) + cfg.eps)
        step = step + cfg.weight_decay * p.to(torch.float32)
        updates.append(-lr * step)
        if eight:
            mq, ms = _qm(m, cfg.moment_block)
            vq, vs = _qm(v, cfg.moment_block)
            m, v = {"q": mq, "scale": ms}, {"q": vq, "scale": vs}
        new_m.append(m)
        new_v.append(v)
    return (tree_lib.unflatten(params, updates),
            {"m": tree_lib.unflatten(params, new_m),
             "v": tree_lib.unflatten(params, new_v), "count": count})


def apply_updates(params, updates):
    """p + u in f32, cast back to each parameter's dtype."""
    return tree_lib.tree_map(
        lambda p, u: (p.to(torch.float32) + u).to(p.dtype), params, updates)


def global_norm(tree) -> torch.Tensor:
    sums = [torch.sum(torch.square(x.to(torch.float32)))
            for x in tree_lib.leaves(tree)]
    return torch.sqrt(torch.sum(torch.stack(sums)))


def clip_by_global_norm(grads, max_norm):
    """Scale ``grads`` so their global norm is at most ``max_norm``; the
    clipped grads come out f32 (the reference multiplies by an f32
    factor, which promotes bf16).  Returns (grads, norm)."""
    norm = global_norm(grads)
    factor = torch.clamp(max_norm / (norm + 1e-9), max=1.0)
    return (tree_lib.tree_map(lambda g: g.to(torch.float32) * factor, grads),
            norm)
