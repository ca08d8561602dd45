"""The KV-cache window write: a predicated row scatter with fixed shapes.

No TPU kernel of its own: the reference's window write is XLA's scatter
(``repro/models/attention.py:_cache_write_ragged`` and
``_cache_write_paged``, ``mode='drop'``).  The port writes through
destination rows, one per token of a [B, width] window (a fixed-shape int64
vector: the flat cache row, or -1 where the reference drops the token), so
a CUDA graph can capture the write.  The hand-written kernel is
``csrc/cache_write.cu`` (one launch per layer over every cache leaf; its
source note says what bounds it).  :func:`cache_write_torch` is its plain
twin, ``nonzero`` + ``index_put_``: the CPU path and the on-card
comparison.  Both keep a token's row when its destination lies inside the
leaf and no later token of the window has the same one (the last writer
wins, as a sequential scatter leaves it).

``kernel_launches`` / ``plain_calls`` count the kernel's launches and the
plain version's calls.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels import plan as plan_lib

NAME = "cache_write"
MAX_LEAVES = 4

#: Launches of the CUDA kernel / calls of the plain version in this process.
kernel_launches = dict.fromkeys((NAME,), 0)
plain_calls = dict.fromkeys((NAME,), 0)

_launch: dict = {}


def reset_counts():
    kernel_launches[NAME] = plain_calls[NAME] = 0


def _rows(dest: torch.Tensor, leaves):
    """Check the leaves: (dst [R, ...], src [N, ...]) pairs, every dst with
    R rows, every src with one row per destination and dst's dtype and row
    shape.  Returns them flattened to [R, row] / [N, row]."""
    if dest.dtype != torch.int64 or dest.dim() != 1:
        raise TypeError(f"dest must be int64 [N], got {dest.dtype} "
                        f"{tuple(dest.shape)}")
    if not 1 <= len(leaves) <= MAX_LEAVES:
        raise ValueError(f"1 to {MAX_LEAVES} leaves, got {len(leaves)}")
    n = dest.shape[0]
    out = []
    for dst, src in leaves:
        if src.dtype != dst.dtype or src.shape[0] != n \
                or src.shape[1:] != dst.shape[1:]:
            raise ValueError(f"source {src.dtype} {tuple(src.shape)} does "
                             f"not fit destination {dst.dtype} "
                             f"{tuple(dst.shape)} at {n} tokens")
        if not dst.is_contiguous():
            raise ValueError("cache leaves must be contiguous")
        out.append((dst.view(dst.shape[0], -1),
                    src.reshape(n, -1).contiguous()))
    return out


def kept(dest: torch.Tensor, rows: int) -> torch.Tensor:
    """[N] bool: token t writes when ``0 <= dest[t] < rows`` and no later
    token has the same destination."""
    later = torch.triu(dest[:, None] == dest[None, :], diagonal=1).any(dim=1)
    return (dest >= 0) & (dest < rows) & ~later


def cache_write_torch(dest: torch.Tensor, leaves):
    """Plain PyTorch version: for each (dst [R, ...], src [N, ...]) leaf,
    ``dst[dest[t]] = src[t]`` for every kept token t, in place."""
    plain_calls[NAME] += 1
    for dst, src in _rows(dest, leaves):
        keep = kept(dest, dst.shape[0]).nonzero(as_tuple=True)[0]
        dst.index_put_((dest[keep],), src[keep])


def _unit(row_bytes: int, *ptrs: int) -> int:
    """The widest copy unit (16 down to 1 bytes) dividing the row size and
    every address."""
    u = 16
    while u > 1 and (row_bytes % u or any(p % u for p in ptrs)):
        u //= 2
    return u


def cache_write_cuda(dest: torch.Tensor, leaves):
    """Launch ``csrc/cache_write.cu`` once over every leaf (CUDA tensors on
    one device), in place."""
    flat = _rows(dest, leaves)
    dev = dest.device
    if not dest.is_cuda or any(t.device != dev for pair in flat
                               for t in pair):
        raise ValueError("cache_write_cuda needs dest and every leaf on one "
                         "CUDA device")
    if any(dst.shape[0] >= 2**31 for dst, _ in flat):
        raise ValueError("a cache leaf with 2^31 rows or more")
    dest = dest.contiguous()
    pad = MAX_LEAVES - len(flat)
    srcs = [s.data_ptr() for _, s in flat] + [None] * pad
    dsts = [d.data_ptr() for d, _ in flat] + [None] * pad
    row_bytes = [d.shape[1] * d.element_size() for d, _ in flat]
    units = [_unit(rb, s.data_ptr(), d.data_ptr())
             for rb, (d, s) in zip(row_bytes, flat)]
    fn = _launch.get(NAME)
    if fn is None:
        fn = _launch[NAME] = build.bind(NAME, "cache_write_launch", 9, 14)
    fn(dest.data_ptr(), *srcs, *dsts, dest.shape[0], len(flat),
       *(row_bytes + [0] * pad), *([d.shape[0] for d, _ in flat] + [0] * pad),
       *(units + [1] * pad), dev.index or 0,
       torch.cuda.current_stream(dev).cuda_stream)
    kernel_launches[NAME] += 1


def cache_write(dest: torch.Tensor, leaves, *, backend: str = "auto"):
    """Write each kept token's row of every leaf at its destination row, in
    place: the kernel for CUDA tensors, the plain version on the CPU (or
    when ``backend='torch'`` is asked for)."""
    if plan_lib.resolve_backend(backend, dest.device) == "cuda":
        cache_write_cuda(dest, leaves)
    else:
        cache_write_torch(dest, leaves)
