"""sparq-cnn: the paper's conv2d benchmark network, packed inference
(counterpart of ``repro/models/cnn.py``).

Layouts are the reference's: images and activations NHWC, conv kernels
HWIO.  Conv layers run in one of three modes:
  'none'   -- the float conv (full float32, TF32 off).
  'qat'    -- training: LSQ fake-quant weights, PACT-clipped activations
              fake-quantized at ``alpha / qmax`` (core/quant.py's
              straight-through gradients), then the float conv.
  'packed' -- the deployed Sparq path: quantize the activations onto the
              PACT lattice, P1-pack them over channels, the packed conv
              kernel (K5, kernels/ulppack_conv2d.py) and the affine dequant
              ``a_scale * w_scale * (acc - w_zp * psum)``.  On a 'cuda'
              plan on the tensor cores (every layout; ``plan.route``) the
              dequant, with its patch sums, is fused into the tensor-core
              K5 (one launch a layer).

Deployment is two-phase, as in the reference: ``prepare_packed_params``
quantizes and packs each conv layer's weights once (P1 lanes or bit-dense
words) and ``layer_plans`` builds the per-layer ``KernelPlan``s; the
forward pass then only quantizes activations and dispatches through the
plans.  Un-prepared params still work (weights are packed inline).

Patch sums ``psum`` (the zero-point correction, an int32 conv of the
activation lattice with ones in the reference) are computed exactly as the
int32 channel sum followed by an fh x fw box sum over shifted slices
(rows, then columns): CUDA PyTorch has no integer conv, and this stays in
int32 on every device.  The fused route takes them from the kernel's MMAs
instead (an extra column of ones), bit-equal.  The float stem, the pooling
and the head are library calls, as the reference leaves them to XLA.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.core import packing, quant
from repro_torch.core.packing import PackSpec
from repro_torch.core.quant import QuantConfig
from repro_torch.kernels import ops
from repro_torch.kernels import plan as plan_lib
from repro_torch.kernels import ulppack_conv2d as _conv
from repro_torch.kernels.ulppack_conv2d import same_pads
from repro_torch.models import common

def conv_init(generator: torch.Generator, fh: int, fw: int, cin: int,
              cout: int, qcfg: QuantConfig, *, dtype=torch.float32,
              device="cpu"):
    w = torch.randn((fh, fw, cin, cout), generator=generator,
                    dtype=torch.float32, device=device) \
        / math.sqrt(fh * fw * cin)
    p = {"kernel": w.to(dtype)}
    if qcfg.enabled:
        p["w_step"] = quant.init_step_from_data(w, qcfg.w_bits, True)
        p["alpha"] = torch.tensor(4.0, dtype=torch.float32, device=device)
    return p


def init_params(cfg, generator: torch.Generator, *, device="cuda"):
    """Random float params from ``generator`` (which must live on
    ``device``): a 3x3 float stem to ``cnn_channels[0]``, the conv stack
    and the f32 head.  The port never reproduces JAX's random stream; trees
    from the reference cross through bridge.from_repro."""
    dev = plan_lib.resolve_device(device)
    chans = cfg.cnn_channels
    k = cfg.cnn_kernel
    stem = conv_init(generator, 3, 3, 3, chans[0], cfg.quant, device=dev)
    layers, cin = [], chans[0]
    for cout in chans:
        layers.append(conv_init(generator, k, k, cin, cout, cfg.quant,
                                device=dev))
        cin = cout
    head = common.dense_init(generator, cin, cfg.cnn_num_classes, device=dev)
    return {"stem": stem, "layers": layers, "head": head}


def conv_layer_spec(x_shape, w_shape, qcfg: QuantConfig, *,
                    padding: str = "SAME", weight_store: str = "lanes",
                    w_packed=None, backend: str = "auto",
                    device="cpu") -> PackSpec:
    """The per-layer chosen lane layout of a conv2d on ``device``.

    ``x_shape`` / ``w_shape`` are the UNPACKED [N, H, W, Cin] / [Fh, Fw,
    Cin, Co].  Resolves through the active tuning cache (``autotune.
    conv2d_layout_for``) with the config's spec on a miss; a lanes leaf
    (``w_packed``) whose dtype or channel count contradicts the resolved
    layout (the cache changed after packing) keeps the config's spec."""
    from repro_torch.kernels import autotune

    base = PackSpec.from_config(qcfg)
    spec = autotune.conv2d_layout_for(tuple(x_shape), tuple(w_shape), base,
                                      padding=padding, backend=backend,
                                      device=device,
                                      weight_store=weight_store)
    if weight_store == "lanes" and w_packed is not None and spec != base \
            and (w_packed.dtype != spec.lane_dtype
                 or w_packed.shape[2] != -(-w_shape[2] // spec.n_pack)):
        return base
    return spec


def conv_prepare(p, qcfg: QuantConfig, *, weight_store: str = "lanes",
                 spec: PackSpec | None = None):
    """Offline per-layer weight preparation (once, not per forward): the
    float kernel quantized to the w_bits lattice and stored as P1 lanes
    ('lanes' -> ``w_packed``) or bit-dense int32 words ('dense' ->
    ``w_words``).  The float kernel is dropped."""
    spec = spec if spec is not None else PackSpec.from_config(qcfg)
    w = p["kernel"].to(torch.float32)
    dev = w.device
    w_scale = p["w_step"] if "w_step" in p \
        else quant.calibrate_absmax(w, qcfg.w_bits)[0]
    w_zp = qcfg.w_zero_point
    q_w = quant.quantize_affine(w, w_scale, w_zp, qcfg.w_bits)
    out = {"alpha": p["alpha"] if "alpha" in p
           else torch.tensor(4.0, dtype=torch.float32, device=dev),
           "w_scale": torch.as_tensor(w_scale).to(dev, torch.float32),
           "w_zp": torch.tensor(w_zp, dtype=torch.int32, device=dev)}
    if weight_store == "dense":
        out["w_words"] = ops.dense_store_conv_weights(q_w, qcfg.w_bits)
    elif weight_store == "lanes":
        out["w_packed"] = packing.pack_weights(q_w, spec, axis=2)
    else:
        raise ValueError(f"weight_store must be 'lanes' or 'dense', got "
                         f"{weight_store!r}")
    return out


def prepare_packed_params(params, cfg, *, weight_store: str = "lanes",
                          x_shape=None, padding: str = "SAME",
                          autotune: bool = False):
    """Convert a float param tree for packed inference (weights packed
    once, on the device they live on); the float stem and head are kept.

    With ``x_shape`` ([N, H, W, 3], the network's input) each layer packs
    in its chosen lane layout (``conv_layer_spec``; SAME padding keeps H, W
    through the stack); ``autotune=True`` first sweeps each layer's layout
    family (``autotune.tune_conv2d_layout``) -- the layout is weighed
    before the bytes are packed.  Without ``x_shape`` every layer takes
    the config's spec (and ``autotune`` has no shape to sweep), as in the
    reference."""
    chans = cfg.cnn_channels
    layers = []
    for i, p in enumerate(params["layers"]):
        spec = None
        if x_shape is not None:
            n, h, w, _ = x_shape
            cin = chans[i - 1] if i > 0 else chans[0]
            fh = fw = cfg.cnn_kernel
            xs, ws = (n, h, w, cin), (fh, fw, cin, chans[i])
            dev = p["kernel"].device
            if autotune:
                from repro_torch.kernels import autotune as autotune_lib
                autotune_lib.tune_conv2d_layout(
                    xs, ws, PackSpec.from_config(cfg.quant), padding=padding,
                    weight_store=weight_store, device=dev)
            spec = conv_layer_spec(xs, ws, cfg.quant, padding=padding,
                                   weight_store=weight_store, device=dev)
        layers.append(conv_prepare(p, cfg.quant, weight_store=weight_store,
                                   spec=spec))
    return {"stem": params["stem"], "layers": layers,
            "head": params["head"]}


def layer_plans(params, cfg, x_shape, *, padding: str = "SAME",
                backend: str = "auto", autotune: bool = False):
    """Per-conv-layer KernelPlans for an input [N, H, W, 3] shape, on the
    device the layer's weights live on.  SAME padding keeps H, W constant
    through the stack, so the plans differ only in channel counts.  Each
    plan records the layout (``conv_layer_spec``, as pack time resolved
    it), the weight store and ``k_full``.  ``autotune=True`` warm-tunes
    each layer's signature missing from the active tuning cache
    (``autotune.tune_packed_conv2d``) before planning, so the plans come
    back ``source='tuned'``; the caller saves the cache
    (``autotune.active_cache().save()``)."""
    n, h, w, _ = x_shape
    chans = cfg.cnn_channels
    plans = []
    for i, p in enumerate(params["layers"]):
        cin = chans[i - 1] if i > 0 else chans[0]
        if "w_packed" in p:
            leaf = p["w_packed"]
            fh, fw, cp, cout = (int(d) for d in leaf.shape)
            store, k_full = "lanes", None
            spec = conv_layer_spec((n, h, w, cin), (fh, fw, cin, cout),
                                   cfg.quant, padding=padding,
                                   weight_store=store, w_packed=leaf,
                                   backend=backend, device=leaf.device)
            if leaf.dtype != spec.lane_dtype \
                    or cp != -(-cin // spec.n_pack):
                raise ValueError(
                    f"layers[{i}]: packed bytes ({leaf.dtype}, cp={cp}) do "
                    f"not match the lane layout {spec} for cin={cin}")
            w_shape = tuple(leaf.shape)
        elif "w_words" in p:
            leaf = p["w_words"]
            fh, fw, _, cout = (int(d) for d in leaf.shape)
            store, k_full = "dense", cin
            spec = conv_layer_spec((n, h, w, cin), (fh, fw, cin, cout),
                                   cfg.quant, padding=padding,
                                   weight_store=store, backend=backend,
                                   device=leaf.device)
            cp = -(-cin // spec.n_pack)
            w_shape = tuple(leaf.shape)
        else:
            leaf = p["kernel"]
            fh, fw, cin, cout = (int(d) for d in leaf.shape)
            store, k_full = "lanes", None
            spec = conv_layer_spec((n, h, w, cin), (fh, fw, cin, cout),
                                   cfg.quant, padding=padding,
                                   weight_store=store, backend=backend,
                                   device=leaf.device)
            cp = -(-cin // spec.n_pack)
            w_shape = (fh, fw, cp, cout)
        if autotune:
            from repro_torch.kernels import autotune as autotune_lib
            autotune_lib.tune_packed_conv2d(
                (n, h, w, cp), w_shape, spec, padding=padding,
                weight_store=store, k_full=k_full, backend=backend,
                device=leaf.device)
        plans.append(plan_lib.plan_packed_conv2d(
            (n, h, w, cp), w_shape, spec, padding=padding, backend=backend,
            weight_store=store, k_full=k_full, device=leaf.device))
    return plans


def patch_sums(xq: torch.Tensor, fh: int, fw: int, padding: str
               ) -> torch.Tensor:
    """Exact int32 fh x fw patch sums of a lattice [N, H, W, C] over all
    channels -> [N, Ho, Wo, 1] (the reference's conv with ones)."""
    top, bottom, left, right = same_pads(fh, fw, padding)
    s = F.pad(xq.sum(dim=-1, dtype=torch.int32), (left, right, top, bottom))
    ho, wo = s.shape[1] - fh + 1, s.shape[2] - fw + 1
    rows = s[:, :ho]
    for i in range(1, fh):
        rows = rows + s[:, i:i + ho]
    out = rows[:, :, :wo]
    for j in range(1, fw):
        out = out + rows[:, :, j:j + wo]
    return out[..., None]


def _packed_operands(p, x, qcfg: QuantConfig, padding: str, backend: str,
                     plan) -> dict:
    """What a packed conv layer feeds its kernel on float input x: the
    activation lattice ``xq`` and its lanes ``xp``, the weight operand
    ``wp`` and its store, ``k_full``, the layer's plan (``plan``, else the
    memoized planner's for ``backend``) and the epilogue's scalars."""
    prepared = "w_packed" in p or "w_words" in p
    store = "dense" if "w_words" in p else "lanes"
    if plan is not None:
        spec = plan.spec             # the layout the stored bytes use
    else:
        leaf = p.get("w_words", p.get("w_packed", p.get("kernel")))
        fh, fw, _, co = (int(d) for d in leaf.shape)
        spec = conv_layer_spec(
            tuple(x.shape), (fh, fw, int(x.shape[-1]), co), qcfg,
            padding=padding, weight_store=store,
            w_packed=p.get("w_packed"), backend=backend, device=x.device)
    if prepared:
        w_scale, w_zp = p["w_scale"], p["w_zp"]
        wp = p["w_words"] if store == "dense" else p["w_packed"]
    else:
        # un-prepared params: pack inline
        w = p["kernel"].to(torch.float32)
        w_scale = p["w_step"] if "w_step" in p \
            else quant.calibrate_absmax(w, qcfg.w_bits)[0]
        w_zp = qcfg.w_zero_point
        q_w = quant.quantize_affine(w, w_scale, w_zp, qcfg.w_bits)
        wp = packing.pack_weights(q_w, spec, axis=2)
    # activations: PACT range [0, alpha] -> the z = 0 lattice
    alpha = p["alpha"] if "alpha" in p \
        else torch.tensor(4.0, dtype=torch.float32, device=x.device)
    a_scale = alpha / qcfg.qmax_a
    xq = quant.quantize_affine(torch.minimum(torch.clamp(x, min=0.0), alpha),
                               a_scale, 0, qcfg.a_bits)
    xp = packing.pack_activations(xq, spec, axis=-1)
    k_full = int(x.shape[-1]) if store == "dense" else None
    if plan is None:
        plan = plan_lib.plan_packed_conv2d(
            tuple(xp.shape), tuple(wp.shape), spec, padding=padding,
            backend=backend, weight_store=store, k_full=k_full,
            device=xp.device)
    return {"xq": xq, "xp": xp, "wp": wp, "store": store, "k_full": k_full,
            "plan": plan, "a_scale": a_scale, "w_scale": w_scale,
            "w_zp": w_zp}


def conv_integer_core(p, x, qcfg: QuantConfig, *, padding: str = "SAME",
                      backend: str = "auto", plan=None) -> dict:
    """The integer half of a packed conv layer on float input x [N,H,W,C]:
    the activation lattice ``xq``, the packed conv's int32 ``acc`` and the
    int32 patch sums ``psum``, with the scalars of the affine epilogue
    (``a_scale``, ``w_scale``, ``w_zp``)."""
    return _integer_core(_packed_operands(p, x, qcfg, padding, backend,
                                          plan), padding)


def _integer_core(o: dict, padding: str) -> dict:
    wp = o["wp"]
    acc = ops.packed_conv2d(o["xp"], wp, o["plan"].spec, padding=padding,
                            weight_store=o["store"], k_full=o["k_full"],
                            plan=o["plan"])
    fh, fw = int(wp.shape[0]), int(wp.shape[1])
    return {"xq": o["xq"], "acc": acc,
            "psum": patch_sums(o["xq"], fh, fw, padding),
            "a_scale": o["a_scale"], "w_scale": o["w_scale"],
            "w_zp": o["w_zp"]}


def conv_epilogue(c: dict) -> torch.Tensor:
    """The affine dequant of ``conv_integer_core``'s result, in the
    reference's order: ``a_scale * w_scale * (acc - w_zp * psum)``."""
    f32 = torch.float32
    return c["a_scale"] * c["w_scale"] \
        * (c["acc"].to(f32) - c["w_zp"] * c["psum"].to(f32))


def _conv_f32(x, w, padding):
    """Float NHWC x HWIO conv in full float32."""
    top, bottom, left, right = same_pads(w.shape[0], w.shape[1], padding)
    xn = F.pad(x.to(torch.float32).permute(0, 3, 1, 2),
               (left, right, top, bottom))
    with common.full_f32():
        y = F.conv2d(xn, w.to(torch.float32).permute(3, 2, 0, 1))
    return y.permute(0, 2, 3, 1)


def conv_apply(p, x, qcfg: QuantConfig, *, quant_mode: str = "none",
               padding: str = "SAME", backend: str = "auto", plan=None):
    """One conv layer on float NHWC x.  'packed' on a 'cuda' plan whose
    route is the tensor cores is one K5 launch with the affine dequant
    fused in (bit-equal to ``conv_epilogue(conv_integer_core(...))``, the
    route of every other backend and shape)."""
    if quant_mode == "packed" and qcfg.enabled:
        o = _packed_operands(p, x, qcfg, padding, backend, plan)
        plan = o["plan"]
        if plan.backend == "cuda" and plan.route == "tensor_cores":
            return _conv.ulppack_conv2d_mma_cuda(
                o["xp"], o["wp"], plan.spec, plan=plan, padding=padding,
                weight_store=o["store"], k_full=o["k_full"],
                epilogue=_conv.ConvAffine(o["a_scale"], o["w_scale"],
                                          o["w_zp"]))
        return conv_epilogue(_integer_core(o, padding))
    if quant_mode not in ("none", "qat", "packed"):
        raise ValueError(f"unknown quant_mode {quant_mode!r}")
    w, xx = p["kernel"].to(torch.float32), x.to(torch.float32)
    if quant_mode == "qat" and qcfg.enabled:
        w = quant.lsq_fake_quant(w, p["w_step"], qcfg.w_bits, True)
        alpha = p["alpha"]
        xc = quant.pact_clip(xx, alpha, qcfg.a_bits)
        # the scale alpha / qmax gets no gradient (fake_quant's rule):
        # alpha learns through the clip alone
        xx = quant.fake_quant(xc, alpha / qcfg.qmax_a,
                              torch.zeros((), dtype=torch.float32,
                                          device=x.device), qcfg.a_bits)
    return _conv_f32(xx, w, padding)


def forward(params, cfg, x, *, quant_mode: str = "none",
            backend: str = "auto", plans=None):
    """x: [N, H, W, 3] float image -> f32 logits [N, classes].

    ``plans`` (from ``layer_plans``) routes each conv through its prebuilt
    KernelPlan; without it, plans come from the memoized planners."""
    h = torch.relu(conv_apply(params["stem"], x, cfg.quant,
                              quant_mode="none"))
    for i, p in enumerate(params["layers"]):
        plan = plans[i] if plans is not None else None
        h = torch.relu(conv_apply(p, h, cfg.quant, quant_mode=quant_mode,
                                  backend=backend, plan=plan))
    pooled = h.mean(dim=(1, 2))
    with common.full_f32():
        return common.dense_apply(params["head"], pooled,
                                  compute_dtype=torch.float32)
