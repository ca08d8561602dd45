"""Functional NN substrate: Dense (float / packed-integer), norms, embedding,
RoPE and M-RoPE (counterpart of ``repro/models/common.py``).

Parameters are plain nested dicts of tensors; every layer is an (init,
apply) pair, with the reference package's layouts, so trees carry across
through repro_torch/bridge.py.  ``quant_mode``:
  'none'   -- float path.
  'qat'    -- LSQ fake-quant on weights and activations (training; the
              straight-through gradients of core/quant.py).
  'packed' -- deployed Sparq path: runtime activation quantize+pack, packed
              integer matmul, affine dequant.  Params must have been
              converted with ``pack_dense_params``.
"""

from __future__ import annotations

import contextlib
import math

import torch

from repro_torch.core import quant
from repro_torch.core.packing import PackSpec
from repro_torch.core.quant import QuantConfig
from repro_torch.kernels import ops
from repro_torch.parallel import sharding

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def dtype_of(name: str) -> torch.dtype:
    return _DTYPES[name]


@contextlib.contextmanager
def full_f32():
    """Run float32 convolutions and matmuls in full float32 on the card.

    cuDNN runs a float32 convolution in TF32 by default
    (``torch.backends.cudnn.allow_tf32``), which keeps ~3 decimal digits;
    the reference computes in float32.  Both TF32 switches are off inside
    the block and restored after it."""
    conv, mm = torch.backends.cudnn.allow_tf32, \
        torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = conv
        torch.backends.cuda.matmul.allow_tf32 = mm


# ---------------------------------------------------------------------------
# Dense
# ---------------------------------------------------------------------------

def dense_init(generator: torch.Generator, d_in: int, d_out: int, *,
               use_bias=False, dtype=torch.float32, quantized=False,
               qcfg: QuantConfig | None = None, scale=None, device="cpu"):
    std = scale if scale is not None else 1.0 / math.sqrt(d_in)
    kernel = torch.randn((d_in, d_out), generator=generator,
                         dtype=torch.float32, device=device) * std
    p = {"kernel": kernel.to(dtype)}
    if use_bias:
        p["bias"] = torch.zeros((d_out,), dtype=dtype, device=device)
    if quantized and qcfg is not None and qcfg.enabled:
        p["w_step"] = quant.init_step_from_data(kernel, qcfg.w_bits, True)
        p["a_step"] = torch.tensor(1.0 / math.sqrt(qcfg.qmax_a),
                                   dtype=torch.float32, device=device)
    return p


def dense_layer_spec(k: int, n: int, qcfg: QuantConfig, *,
                     weight_store: str = "lanes", w_packed=None,
                     backend: str = "auto", device="cpu") -> PackSpec:
    """The per-layer chosen lane layout for a [k, n] Dense on ``device``.

    Resolves through the active tuning cache (``autotune.
    matmul_layout_for``) with the config's base spec on a miss, so pack
    time, plan time and dispatch time agree on one layout.  With the lanes
    store the packed leaf (``w_packed``) is evidence of the layout its
    bytes use: where the cache changed since packing and the chosen layout
    no longer matches the leaf's dtype and rows, the config's spec stands
    rather than misreading the bytes (bit-dense words are layout-agnostic
    at rest, so the dense store needs no such guard)."""
    from repro_torch.kernels import autotune

    base = PackSpec.from_config(qcfg)
    spec = autotune.matmul_layout_for(k, n, base, backend=backend,
                                      device=device,
                                      weight_store=weight_store)
    if weight_store == "lanes" and w_packed is not None and spec != base \
            and (w_packed.dtype != spec.lane_dtype
                 or w_packed.shape[0] != -(-k // spec.n_pack)):
        return base
    return spec


def dense_apply(p, x, *, qcfg: QuantConfig | None = None,
                quant_mode: str = "none", compute_dtype=torch.bfloat16,
                backend: str = "auto"):
    """y = x @ kernel (+ bias), under the selected quantization mode.

    A column-split layer (serve/shard.ShardPlan: its weight, column sums
    and bias ``Sharded`` along N) runs once per shard on that shard's
    columns -- the packed path one K2 launch a shard, the packed layout
    the one chosen for the whole [K, N] at packing -- and the outputs are
    joined along N on ``x``'s device.  Each column's result is the
    unsplit layer's."""
    n_shards = sharding.num_shards(p)
    if n_shards:
        spec = None
        if quant_mode == "packed" and ("w_packed" in p or "w_dense" in p):
            dense = "w_dense" in p
            w = p["w_dense"] if dense else p["w_packed"]
            spec = dense_layer_spec(
                int(x.shape[-1]), int(w.shape[-1]), qcfg,
                weight_store="dense" if dense else "lanes",
                w_packed=None if dense else sharding.parts(w)[0],
                backend=backend, device=x.device)
        outs = []
        for i in range(n_shards):
            xi = x.to(sharding.shard_device(p, i))
            outs.append(_dense_local(sharding.local(p, i), xi, qcfg,
                                     quant_mode, compute_dtype, backend,
                                     spec))
        return sharding.join(outs, x.device)
    return _dense_local(p, x, qcfg, quant_mode, compute_dtype, backend)


def _dense_local(p, x, qcfg, quant_mode, compute_dtype, backend, spec=None):
    """:func:`dense_apply` of one device's whole leaves; ``spec`` fixes
    the packed layout (by default the one for this [K, N])."""
    if quant_mode == "packed" and ("w_packed" in p or "w_dense" in p):
        dense = "w_dense" in p
        w = p["w_dense"] if dense else p["w_packed"]
        if spec is None:
            spec = dense_layer_spec(
                int(x.shape[-1]), int(w.shape[-1]), qcfg,
                weight_store="dense" if dense else "lanes",
                w_packed=None if dense else w, backend=backend,
                device=x.device)
        return ops.quantized_linear(
            x, w, p["col_sums"], p["a_scale"], p["a_zp"],
            p["w_scale"], p["w_zp"], spec, bias=p.get("bias"),
            backend=backend, weight_store="dense" if dense else "lanes",
            out_dtype=compute_dtype)
    if quant_mode not in ("none", "qat", "packed"):
        raise ValueError(f"unknown quant_mode {quant_mode!r}")
    if quant_mode == "qat" and qcfg is not None and qcfg.enabled \
            and "w_step" in p:
        # weights fake-quantized in f32 (few, precision-sensitive);
        # activations in the compute dtype, where the lattice is exact
        kernel = quant.lsq_fake_quant(
            p["kernel"].to(torch.float32), p["w_step"], qcfg.w_bits,
            True).to(compute_dtype)
        x = quant.lsq_fake_quant(
            x.to(compute_dtype), p["a_step"].to(compute_dtype),
            qcfg.a_bits, True)
    else:
        kernel = p["kernel"].to(compute_dtype)
    y = x.to(compute_dtype) @ kernel
    if "bias" in p:
        y = y + p["bias"].to(compute_dtype)
    return y


def pack_dense_params(p, qcfg: QuantConfig, *, dense_store: bool = False,
                      spec: PackSpec | None = None):
    """Offline conversion of float/QAT Dense params -> deployed packed params.

    P1 lanes under ``w_packed``, or with ``dense_store=True`` the lattice
    bit-dense under ``w_dense`` (int32 words [ceil(K / per), N], per = 32
    // w_bits: w_bits a value in device memory), which the packed matmul
    expands at use -- on the card inside the tensor-core K2's staging.
    ``col_sums`` and the exact ``k_full`` come out in both cases."""
    kernel = p["kernel"].to(torch.float32)
    if spec is None:
        spec = dense_layer_spec(
            int(kernel.shape[0]), int(kernel.shape[1]), qcfg,
            weight_store="dense" if dense_store else "lanes",
            device=kernel.device)
    dev = kernel.device
    w_scale = p.get("w_step")
    if w_scale is None:
        w_scale, _ = quant.calibrate_absmax(kernel, qcfg.w_bits)
    w_zp = torch.tensor(qcfg.w_zero_point, dtype=torch.int32, device=dev)
    w_packed, col_sums = ops.prepare_weights(
        kernel, w_scale, w_zp, spec,
        weight_store="dense" if dense_store else "lanes")
    a_scale = p.get("a_step")
    if a_scale is None:
        a_scale = torch.tensor(1.0 / math.sqrt(qcfg.qmax_a),
                               dtype=torch.float32)
    a_zp = torch.tensor((qcfg.qmax_a + 1) // 2, dtype=torch.int32,
                        device=dev)
    out = {"w_dense" if dense_store else "w_packed": w_packed,
           "col_sums": col_sums,
           "w_scale": torch.as_tensor(w_scale).to(dev, torch.float32),
           "w_zp": w_zp,
           "a_scale": torch.as_tensor(a_scale).to(dev, torch.float32),
           "a_zp": a_zp,
           "k_full": int(kernel.shape[0])}
    if "bias" in p:
        out["bias"] = p["bias"]
    return out


# ---------------------------------------------------------------------------
# Norms & embedding
# ---------------------------------------------------------------------------

def rmsnorm_init(d: int, dtype=torch.float32, device="cpu"):
    return {"scale": torch.ones((d,), dtype=dtype, device=device)}


def rmsnorm_apply(p, x, eps=1e-5):
    dt = x.dtype
    x32 = x.to(torch.float32)
    var = (x32 * x32).mean(dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * p["scale"].to(torch.float32)).to(dt)


def layernorm_init(d: int, dtype=torch.float32, device="cpu"):
    return {"scale": torch.ones((d,), dtype=dtype, device=device),
            "bias": torch.zeros((d,), dtype=dtype, device=device)}


def layernorm_apply(p, x, eps=1e-5):
    """LayerNorm in f32 (population variance), back in x's dtype."""
    dt = x.dtype
    x32 = x.to(torch.float32)
    mu = x32.mean(dim=-1, keepdim=True)
    var = x32.var(dim=-1, unbiased=False, keepdim=True)
    y = (x32 - mu) * torch.rsqrt(var + eps)
    return (y * p["scale"] + p["bias"]).to(dt)


def embedding_init(generator: torch.Generator, vocab: int, d: int,
                   dtype=torch.float32, device="cpu"):
    table = torch.randn((vocab, d), generator=generator, dtype=torch.float32,
                        device=device) * 0.02
    return {"table": table.to(dtype)}


def embedding_apply(p, tokens, compute_dtype=torch.bfloat16):
    """Unsharded embedding lookup (the sharded-vocab path waits for the
    multi-GPU slice)."""
    return p["table"][tokens].to(compute_dtype)


def embedding_attend(p, x):
    """Tied LM head: x [.., d] @ table.T -> [.., vocab]."""
    return x @ p["table"].to(x.dtype).T


# ---------------------------------------------------------------------------
# RoPE (standard + M-RoPE)
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device="cpu") -> torch.Tensor:
    """1 / theta^(2i/hd) as f32.  Computed in f64 and rounded once: that is
    the value the reference's compiled steps use (XLA folds the constant in
    higher precision), so the rotated K/V -- and the 2-bit lattices built
    from them downstream -- agree with the deployed reference."""
    half = head_dim // 2
    exps = torch.arange(0, half, dtype=torch.float64, device=device) / half
    return (1.0 / (theta ** exps)).to(torch.float32)


def apply_rope(x, positions, theta=10000.0):
    """x: [B, S, H, hd]; positions: [B, S] int."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)          # [hd/2]
    angles = positions[..., None].to(torch.float32) * freqs   # [B, S, hd/2]
    return _rotate(x, angles)


def _rotate(x, angles):
    """x [B, S, H, hd] rotated by ``angles`` [B, S, hd/2] (f32)."""
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x.to(torch.float32).chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def apply_mrope(x, positions3, sections, theta=10000.0):
    """Multimodal RoPE (qwen2-vl): ``positions3`` [3, B, S] holds the (t,
    h, w) ids; the hd/2 frequency channels are split between the three
    components by ``sections``, each rotated as :func:`apply_rope` rotates.
    With t = h = w the result equals :func:`apply_rope`'s bit for bit (the
    same f32 products, cosines and sines)."""
    half = x.shape[-1] // 2
    if sum(sections) != half:
        raise ValueError(f"M-RoPE sections {tuple(sections)} do not sum to "
                         f"head_dim / 2 = {half}")
    freqs = rope_freqs(x.shape[-1], theta, x.device)           # [hd/2]
    # channel i takes its component's ids: fixed shapes, no host copy, so
    # a CUDA graph can capture it
    pos = torch.cat([positions3[c:c + 1].expand(n, *positions3.shape[1:])
                     for c, n in enumerate(sections)])          # [hd/2, B, S]
    angles = pos.permute(1, 2, 0).to(torch.float32) * freqs    # [B, S, hd/2]
    return _rotate(x, angles)
