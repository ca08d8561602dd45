"""Offline conversion of float/QAT params into deployed Sparq serving form
(counterpart of ``repro/serve/prepare.py``).

Every quantizable 2-D Dense ({kernel, w_step, a_step}) becomes its packed
integer form ({w_packed, col_sums, scales, zero-points, k_full}) through
``models.common.pack_dense_params``; with ``dense_store=True`` the weight
is stored bit-dense instead (``w_dense``: int32 words, w_bits a value).
Each 3-D MoE expert node ({kernel [E, d_in, d_out], w_step, a_step})
becomes {kernel: its LSQ lattice in the compute dtype, a_step}: the
values ``models.moe._expert_kernel`` would derive on every 'packed'
forward (the reference derives them there, ``repro/models/moe.py``),
derived once here, one expert at a time, and ``w_step`` dropped, so the
forward skips the weights' fake quant; the activations' (``a_step``)
stays on every forward.  Embeddings, the float LM head and the MoE
router stay as they are; ``serving_param_bytes`` counts them.
``build_layer_plans`` fixes each packed layer's KernelPlan once, for the
decode and the chunked-prefill row counts.
"""

from __future__ import annotations

import torch

from repro_torch.core.packing import PackSpec
from repro_torch.kernels import plan as plan_lib
from repro_torch.models import common, moe
from repro_torch.parallel import sharding


def _is_packable(node) -> bool:
    return (isinstance(node, dict) and "kernel" in node and "w_step" in node
            and isinstance(node["kernel"], torch.Tensor)
            and node["kernel"].dim() == 2)


def _is_packed(node) -> bool:
    return isinstance(node, dict) and ("w_packed" in node
                                       or "w_dense" in node)


def _is_expert(node) -> bool:
    return (isinstance(node, dict) and "kernel" in node and "w_step" in node
            and isinstance(node["kernel"], torch.Tensor)
            and node["kernel"].dim() == 3)


def _prepare_experts(node, cfg) -> dict:
    """A 3-D expert node in its serving form: the kernel's lattice
    (``moe.expert_lattice``) derived one expert at a time (the f32
    temporaries are one expert's; the lattice is elementwise at a scalar
    step, so the values equal the whole tensor's), without ``w_step``."""
    kernel, step = node["kernel"], node["w_step"]
    out = torch.empty(kernel.shape, dtype=common.dtype_of(cfg.compute_dtype),
                      device=kernel.device)
    with torch.no_grad():
        for e in range(kernel.shape[0]):
            out[e] = moe.expert_lattice(kernel[e], step, cfg)
    return {**{k: v for k, v in node.items() if k != "w_step"},
            "kernel": out}


def _walk(node, fn):
    if isinstance(node, dict):
        return {k: fn(v) for k, v in node.items()}
    if isinstance(node, list):
        return [fn(v) for v in node]
    if isinstance(node, tuple):
        return tuple(fn(v) for v in node)
    return node


def prepare_serving_params(params, cfg, *, dense_store: bool = False,
                           autotune: bool = False, tune_rows: int = 8,
                           recalibrate: bool = False, device="cuda"):
    """Move ``params`` to ``device`` and pack every quantizable Dense leaf
    (P1 lanes in each layer's chosen layout -- ``common.dense_layer_spec``:
    the active tuning cache's, else the config's base -- or bit-dense
    words with ``dense_store=True``).

    ``autotune=True`` sweeps the lane-layout family for each distinct (k,
    n) before packing (``autotune.tune_matmul_layout`` at ``tune_rows``
    rows): weights pack once, so the layout is weighed here, and
    ``build_layer_plans`` and dispatch later resolve the same answer.
    ``recalibrate=True`` drops each leaf's learned ``w_step`` / ``a_step``
    before packing, so the scales are derived anew (absmax / the qmax
    default) for ``cfg.quant``'s bit widths: the speculative draft's
    repack of the same checkpoint at a lower precision; the experts keep
    the step they carry.  With quantization each MoE expert node's
    kernel becomes its lattice (``moe.expert_lattice``); a tree already
    prepared passes through unchanged.  Without quantization the tree is
    only moved."""
    dev = plan_lib.resolve_device(device)
    store = "dense" if dense_store else "lanes"

    def walk(node):
        if isinstance(node, torch.Tensor):
            return node.to(dev)
        node = _walk(node, walk)
        if cfg.quant.enabled and _is_packable(node):
            if autotune:
                from repro_torch.kernels import autotune as autotune_lib
                k, n = node["kernel"].shape
                autotune_lib.tune_matmul_layout(
                    tune_rows, int(k), int(n), PackSpec.from_config(cfg.quant),
                    x_dtype=common.dtype_of(cfg.compute_dtype),
                    weight_store=store, device=dev)
            if recalibrate:
                node = {k: v for k, v in node.items()
                        if k not in ("w_step", "a_step")}
            return common.pack_dense_params(node, cfg.quant,
                                            dense_store=dense_store)
        if cfg.quant.enabled and _is_expert(node):
            return _prepare_experts(node, cfg)
        return node

    return walk(params)


def build_layer_plans(params, cfg, *, batch_rows: int = 1,
                      prefill_rows: int | None = None,
                      backend: str = "auto", autotune: bool = False,
                      shard_plan=None):
    """One KernelPlan per packed Dense leaf, keyed by its tree path, for
    the decode row count (and under ``...@prefill`` the chunked-prefill
    one), in the leaf's chosen layout (``common.dense_layer_spec``; the
    packed bytes must match it).  The planners are memoized, so the
    serving steps dispatch through these same objects.

    ``autotune=True`` is the warm-tune pass: each signature the steps will
    dispatch and the active tuning cache lacks -- the serving call at the
    decode rows and at the prefill rows, on the fused route or the packed
    matmul's, lanes or dense (``autotune.tune_quantized_linear``) -- is
    measured once before planning, so the plans come back
    ``source='tuned'``; the caller saves the cache (``autotune.
    active_cache().save()``).

    With a ``shard_plan`` (serve/shard.ShardPlan) each leaf is planned at
    its per-shard width ``shard_plan.local_out(N)``: the plans, and their
    tuning-cache keys, describe the ``[rows, Kp] x [Kp, N / tp]`` product
    one shard launches (K is never split).  The layout stays the one the
    whole [K, N] was packed in."""
    if not cfg.quant.enabled:
        return {}
    plans = {}
    x_dtype = getattr(torch, cfg.compute_dtype)   # the activations' dtype

    def walk(node, path):
        if _is_packed(node):
            dense = "w_dense" in node
            w = node["w_dense"] if dense else node["w_packed"]
            per = 32 // cfg.quant.w_bits if dense else cfg.quant.n_pack
            k = int(node.get("k_full", w.shape[0] * per))
            spec = common.dense_layer_spec(
                k, int(w.shape[-1]), cfg.quant,
                weight_store="dense" if dense else "lanes",
                w_packed=None if dense else w, backend=backend,
                device=w.device)
            if dense:
                rows_w = plan_lib.dense_words(k, spec.w_bits)
                if w.dtype != torch.int32 or w.shape[0] != rows_w:
                    raise ValueError(
                        f"{path}: dense words ({w.dtype}, {w.shape[0]} "
                        f"rows) do not hold k={k} at w_bits {spec.w_bits} "
                        f"(int32, {rows_w} rows)")
            elif w.dtype != spec.lane_dtype \
                    or w.shape[0] != -(-k // spec.n_pack):
                raise ValueError(
                    f"{path}: packed bytes ({w.dtype}, kp={w.shape[0]}) do "
                    f"not match the lane layout {spec} for k={k}")
            n = int(w.shape[-1])
            if shard_plan is not None:
                n = shard_plan.local_out(n)
            for rows, key in ((batch_rows, path),
                              (prefill_rows, f"{path}@prefill")):
                if rows and (key == path or rows != batch_rows):
                    if autotune:
                        from repro_torch.kernels import \
                            autotune as autotune_lib
                        autotune_lib.tune_quantized_linear(
                            rows, k, n, spec, x_dtype,
                            weight_store="dense" if dense else "lanes",
                            backend=backend, device=w.device)
                    plans[key] = plan_lib.plan_quantized_linear(
                        rows, k, n, spec, x_dtype,
                        weight_store="dense" if dense else "lanes",
                        backend=backend, device=w.device)
            return
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, f"{path}/{k}" if path else k)
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, f"{path}[{i}]")

    walk(params, "")
    return plans


def cache_bytes_per_slot(cfg, max_len: int) -> int:
    """Device bytes one batch slot's decode caches occupy at ``max_len``
    (a sliding-window config's ring: ``min(max_len, window)`` rows; slots
    = budget // cache_bytes_per_slot)."""
    from repro_torch.models import lm
    return lm.cache_bytes(cfg, 1, max_len)


def cache_page_bytes(cfg, page_size: int) -> int:
    """Device bytes one KV page (``page_size`` token rows, all attention
    layers, scale planes included) occupies: the paged engine's capacity
    term (num_pages = budget // cache_page_bytes)."""
    from repro_torch.models import lm
    return lm.cache_page_bytes(cfg, page_size)


def serving_param_bytes(params) -> int:
    """Device bytes of a serving param tree (every shard's part of a split
    leaf counted, and a ``Mirrored`` leaf's copies)."""
    if isinstance(params, torch.Tensor):
        return params.numel() * params.element_size()
    if isinstance(params, (sharding.Sharded, sharding.Mirrored)):
        return params.nbytes()
    if isinstance(params, dict):
        return sum(serving_param_bytes(v) for v in params.values())
    if isinstance(params, (list, tuple)):
        return sum(serving_param_bytes(v) for v in params)
    return 0
