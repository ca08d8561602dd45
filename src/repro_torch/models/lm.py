"""LM assembly (counterpart of ``repro/models/lm.py``): blocks of
attention, mamba, mLSTM or sLSTM (attention and mamba blocks with a dense
or MoE FFN half, xLSTM blocks single-residual; an encoder-decoder's
decoder blocks add a cross-attention sublayer), the encoder of an
encoder-decoder, the modality frontend's float projection, parameter
init, forward with the pad-vocab bias and the summed MoE aux loss
(optionally recomputing each block in the backward, ``remat=True``), the
training loss, decode caches -- contiguous (ring, for sliding-window
configs) or paged attention caches beside per-slot recurrent states --
and their byte counts.

Batches (the reference's protocols): ``{"tokens": [B, S]}``, plus for a
vision config (qwen2-vl) optional ``"embeds"`` [B, S_img, frontend_dim],
the image prefix put before the tokens, and ``"positions3"`` [3, B, S]
(t, h, w ids for M-RoPE); for an encoder-decoder (seamless) optional
``"enc_embeds"`` [B, S_enc, frontend_dim], which :func:`encode` turns
into the states every cross-attention sublayer reads.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils import checkpoint as torch_checkpoint

from repro_torch.kernels import plan as plan_lib
from repro_torch.models import attention, common, mamba, mlp, moe, xlstm
from repro_torch.models.common import dense_apply, dense_init


def check_supported(cfg):
    """Raise for a config that is not an LM: the CNN runs through
    ``models/cnn.py``."""
    if cfg.family == "cnn":
        raise NotImplementedError(
            f"{cfg.name}: the CNN path is ROADMAP.md Queue 1 item 9")


# ---------------------------------------------------------------------------
# Block init / apply
# ---------------------------------------------------------------------------

_MIXERS = {"attn": attention.attention_init, "mamba": mamba.mamba_init,
           "mlstm": xlstm.mlstm_init, "slstm": xlstm.slstm_init}


def block_init(generator, cfg, i, *, cross=False, dtype=torch.float32,
               device="cpu"):
    """Block ``i`` of kind ``cfg.layer_kind(i)``; ``cross`` adds the
    cross-attention sublayer (``norm_x``, ``cross``) of a decoder block;
    attention and mamba blocks get the FFN half: the MoE FFN on the layers
    where ``cfg.layer_is_moe(i)``, else the dense MLP (when d_ff > 0)."""
    kind = cfg.layer_kind(i)
    p = {"norm1": common.rmsnorm_init(cfg.d_model, dtype, device),
         kind: _MIXERS[kind](generator, cfg, dtype=dtype, device=device)}
    if cross:
        p["norm_x"] = common.rmsnorm_init(cfg.d_model, dtype, device)
        p["cross"] = attention.attention_init(generator, cfg, dtype=dtype,
                                              device=device)
    if kind in ("attn", "mamba") and (cfg.d_ff or cfg.layer_is_moe(i)):
        p["norm2"] = common.rmsnorm_init(cfg.d_model, dtype, device)
        if cfg.layer_is_moe(i):
            p["moe"] = moe.moe_init(generator, cfg, dtype=dtype,
                                    device=device)
        else:
            p["mlp"] = mlp.mlp_init(generator, cfg, dtype=dtype,
                                    device=device)
    return p


_RECURRENT_APPLY = {"mamba": mamba.mamba_apply, "mlstm": xlstm.mlstm_apply,
                    "slstm": xlstm.slstm_apply}


def block_apply(p, cfg, x, *, kind="attn", positions, quant_mode="none",
                cache=None, cache_index=None, cache_valid=None, dest=None,
                block_tables=None, backend="auto", rec_valid=None,
                causal=True, positions3=None, enc_kv=None):
    """One residual block.  Returns (x, cache, aux loss); the MoE FFN
    takes the einsum path, whose fixed shapes the CUDA graphs capture.

    An attention block reads ``cache_index`` / ``cache_valid`` / ``dest``
    as :func:`attention.window` gives them, ``causal`` and ``positions3``
    as :func:`attention.attention_apply` does; a recurrent block takes the
    caller's valid counts ``rec_valid`` (``cache_valid`` when None).  A
    block with a cross sublayer given the encoder's K/V ``enc_kv`` runs
    it between the mixer and the FFN, in a ``cross_attention`` profiler
    range; without them it is skipped, as in the reference."""
    aux = 0.0
    h = common.rmsnorm_apply(p["norm1"], x, cfg.norm_eps)
    sub = cache.get(kind) if cache else None
    if kind == "attn":
        out, _ = attention.attention_apply(
            p["attn"], cfg, h, positions=positions, quant_mode=quant_mode,
            cache=sub, cache_index=cache_index, cache_valid=cache_valid,
            dest=dest, block_tables=block_tables, backend=backend,
            causal=causal, positions3=positions3)
    else:
        out, _ = _RECURRENT_APPLY[kind](
            p[kind], cfg, h, quant_mode=quant_mode, cache=sub,
            cache_index=cache_index,
            cache_valid=cache_valid if rec_valid is None else rec_valid,
            backend=backend)
    x = x + out
    if "cross" in p and enc_kv is not None:
        with torch.profiler.record_function("cross_attention"):
            h = common.rmsnorm_apply(p["norm_x"], x, cfg.norm_eps)
            out, _ = attention.attention_apply(
                p["cross"], cfg, h, positions=positions,
                quant_mode=quant_mode, cross_kv=enc_kv, backend=backend)
        x = x + out
    if "moe" in p:
        h = common.rmsnorm_apply(p["norm2"], x, cfg.norm_eps)
        out, aux = moe.moe_apply(p["moe"], cfg, h, quant_mode=quant_mode)
        x = x + out
    elif "mlp" in p:
        h = common.rmsnorm_apply(p["norm2"], x, cfg.norm_eps)
        x = x + mlp.mlp_apply(p["mlp"], cfg, h, quant_mode=quant_mode,
                              backend=backend)
    return x, cache, aux


# ---------------------------------------------------------------------------
# Full model
# ---------------------------------------------------------------------------

def init_params(cfg, generator: torch.Generator | None = None,
                device="cuda"):
    """Random float parameters (reference layout) drawn from ``generator``
    on ``device``; their values do not equal the reference's JAX draws.
    With no generator a fresh one seeded 0 on ``device`` is used.  On the
    ``meta`` device no value is drawn (no generator is used): the tree's
    shapes and dtypes alone, for planning without allocating."""
    check_supported(cfg)
    dev = plan_lib.resolve_device(device)
    if dev.type == "meta":
        generator = None
    elif generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    dtype = common.dtype_of(cfg.param_dtype)
    p = {"embed": common.embedding_init(generator, cfg.padded_vocab,
                                        cfg.d_model, dtype, dev)}
    p["layers"] = [block_init(generator, cfg, i,
                              cross=cfg.is_encoder_decoder, dtype=dtype,
                              device=dev)
                   for i in range(cfg.num_layers)]
    p["final_norm"] = common.rmsnorm_init(cfg.d_model, dtype, dev)
    if not cfg.tie_embeddings:
        p["lm_head"] = dense_init(
            generator, cfg.d_model, cfg.padded_vocab, dtype=dtype,
            quantized=cfg.quant.quantize_lm_head, qcfg=cfg.quant, device=dev)
    if cfg.is_encoder_decoder:
        # the encoder: the same dims, non-causal, no cross sublayer
        p["encoder"] = {
            "layers": [block_init(generator, cfg, i, dtype=dtype, device=dev)
                       for i in range(cfg.encoder_layers)],
            "final_norm": common.rmsnorm_init(cfg.d_model, dtype, dev)}
    if cfg.frontend != "none":
        # the stub frontend's projection: a float dense, never quantized
        p["frontend_proj"] = dense_init(generator, cfg.frontend_dim,
                                        cfg.d_model, dtype=dtype, device=dev)
    return p


def encode(params, cfg, enc_embeds, *, quant_mode="none", backend="auto"):
    """The encoder over stub modality embeddings [B, S_enc, frontend_dim]
    -> its states [B, S_enc, d_model]: the float frontend projection, the
    non-causal attention blocks at positions 0 .. S_enc-1, the final
    norm.  Runs in an ``encoder`` profiler range."""
    cd = common.dtype_of(cfg.compute_dtype)
    dev = params["frontend_proj"]["kernel"].device
    with torch.profiler.record_function("encoder"):
        x = dense_apply(params["frontend_proj"],
                        torch.as_tensor(enc_embeds, device=dev).to(cd),
                        compute_dtype=cd)
        b, s = x.shape[0], x.shape[1]
        pos = torch.arange(s, dtype=torch.int32,
                           device=dev)[None].expand(b, s)
        for blk in params["encoder"]["layers"]:
            x, _, _ = block_apply(blk, cfg, x, kind="attn", positions=pos,
                                  quant_mode=quant_mode, backend=backend,
                                  causal=False)
        return common.rmsnorm_apply(params["encoder"]["final_norm"], x,
                                    cfg.norm_eps)


def _decoder_inputs(params, cfg, batch):
    """Token embeddings, a vision config's projected image prefix before
    them when ``batch`` has ``embeds``, and the positions (``batch``'s,
    else 0 .. S-1 over the whole sequence)."""
    cd = common.dtype_of(cfg.compute_dtype)
    dev = params["embed"]["table"].device
    tokens = torch.as_tensor(batch["tokens"], device=dev)
    x = common.embedding_apply(params["embed"], tokens, cd)
    if cfg.frontend == "vision" and "embeds" in batch:
        prefix = dense_apply(params["frontend_proj"],
                             torch.as_tensor(batch["embeds"],
                                             device=dev).to(cd),
                             compute_dtype=cd)
        x = torch.cat([prefix, x], dim=1)
    b, s = x.shape[0], x.shape[1]
    positions = batch.get("positions")
    if positions is None:
        positions = torch.arange(s, dtype=torch.int32,
                                 device=dev)[None, :].expand(b, s)
    return x, positions


def forward(params, cfg, batch, *, quant_mode="none", caches=None,
            cache_index=None, cache_valid=None, dest=None, block_tables=None,
            backend="auto", remat=False, enc_out=None):
    """Full forward.  Returns (logits, aux_loss, caches); the aux loss is
    the sum of the MoE layers' (0.0 without any).

    ``remat=True`` runs each block under ``torch.utils.checkpoint``
    (non-reentrant), the counterpart of the reference's per-block
    ``jax.checkpoint``: the backward recomputes the block -- its
    fake-quant lattices included -- instead of storing its activations.
    ``caches`` without ``cache_index`` is the prefill of fresh caches:
    every attention layer writes rows 0 .. S-1 and attends over the raw
    window, every recurrent layer runs from its fresh state and stores
    its final state.

    ``cache_index`` [B] gives per-slot cache write offsets, a scalar the
    lockstep path (``attention.window``); ``cache_valid`` [B] the
    valid-prefix length of each row's window.  The caches are updated in
    place, the recurrent states too.  ``dest`` may carry the window's
    destination rows (``attention.window``, with device-side offsets,
    counts and table); otherwise they are computed once here from the
    first attention layer's cache (none for an attention-free stack).  With
    ``block_tables`` [B, n_pages] the caches are paged pools
    (``init_caches(..., page_size=, num_pages=)``).

    An encoder-decoder's cross sublayers read, per layer, the cached
    ``cross_kv`` of ``caches[li]`` when it holds one, else K/V projected
    from the encoder states ``enc_out`` (or from :func:`encode` of
    ``batch["enc_embeds"]``), which are then stored into the layer's
    cache dict; with neither, the cross sublayers are skipped.
    """
    check_supported(cfg)
    cd = common.dtype_of(cfg.compute_dtype)
    x, positions = _decoder_inputs(params, cfg, batch)
    b, s = x.shape[0], x.shape[1]
    positions3 = batch.get("positions3")
    if cfg.is_encoder_decoder and enc_out is None and "enc_embeds" in batch:
        enc_out = encode(params, cfg, batch["enc_embeds"],
                         quant_mode=quant_mode, backend=backend)
    # the recurrent blocks take the caller's valid counts: attention's
    # lockstep window (a scalar cache_index) sets its own to the window
    rec_valid = cache_valid
    kv = first_attn_cache(caches)
    if kv is not None and cache_index is not None and dest is None:
        # one set of destination rows per step, shared by every layer
        cache_index, cache_valid, dest, block_tables = attention.window(
            cache_index, cache_valid, block_tables, b, s, kv["k"].shape,
            x.device, sliding_window=cfg.sliding_window)

    def run_block(blk, x, cache, kind, enc_kv):
        x, _, aux = block_apply(
            blk, cfg, x, kind=kind, positions=positions,
            quant_mode=quant_mode, cache=cache, cache_index=cache_index,
            cache_valid=cache_valid, dest=dest, block_tables=block_tables,
            backend=backend, rec_valid=rec_valid, positions3=positions3,
            enc_kv=enc_kv)
        return x, aux

    aux_total = 0.0
    enc_kv = None
    for li, blk in enumerate(params["layers"]):
        cache = caches[li] if caches is not None else None
        kind = cfg.layer_kind(li)
        if cfg.is_encoder_decoder:
            cached = cache.get("cross_kv") if cache is not None else None
            if cached is not None:
                enc_kv = cached
            elif enc_out is not None:
                enc_kv = attention.precompute_cross_kv(
                    blk["cross"], cfg, enc_out, quant_mode=quant_mode,
                    backend=backend)
            if cache is not None and enc_kv is not None:
                cache["cross_kv"] = enc_kv
        if remat:
            x, aux = torch_checkpoint.checkpoint(
                run_block, blk, x, cache, kind, enc_kv, use_reentrant=False)
        else:
            x, aux = run_block(blk, x, cache, kind, enc_kv)
        aux_total = aux_total + aux

    x = common.rmsnorm_apply(params["final_norm"], x, cfg.norm_eps)
    if cfg.tie_embeddings:
        logits = common.embedding_attend(params["embed"], x)
    else:
        logits = dense_apply(
            params["lm_head"], x,
            qcfg=cfg.quant if cfg.quant.quantize_lm_head else None,
            quant_mode=quant_mode, compute_dtype=cd, backend=backend)
    if cfg.padded_vocab != cfg.vocab_size:
        pad = torch.arange(cfg.padded_vocab, device=logits.device) \
            >= cfg.vocab_size
        logits = logits + torch.where(pad, -1e30, 0.0).to(logits.dtype)
    return logits, aux_total, caches


def first_attn_cache(caches):
    """The first attention layer's cache of a cache list (None without
    caches or attention layers): its leaves' shapes fix every attention
    layer's destination rows."""
    return next((c["attn"] for c in caches or () if "attn" in c), None)


def init_recurrent_cache(cfg, kind, batch, device="cpu"):
    """A fresh f32 state of a ``kind`` block for ``batch`` slots (mLSTM's
    and sLSTM's ``m`` start at -1e30)."""
    init = {"mamba": mamba.init_mamba_cache, "mlstm": xlstm.init_mlstm_cache,
            "slstm": xlstm.init_slstm_cache}[kind]
    return init(cfg, batch, device=device)


def init_caches(cfg, batch_size, max_len, dtype=torch.bfloat16, *,
                page_size=None, num_pages=None, device="cuda"):
    """Per-layer decode caches on ``device``: attention layers contiguous,
    sized for ``max_len``, or with ``page_size`` / ``num_pages`` paged
    pools ([num_pages, page_size, KVH, ...], one page-id space across
    layers); recurrent layers keep ``batch_size`` slot rows of their f32
    state either way (never paged).  An encoder-decoder's layers also hold
    ``"cross_kv": None``, which :func:`forward` fills with the encoder's
    K/V at the first call given them."""
    check_supported(cfg)
    dev = plan_lib.resolve_device(device)
    if num_pages is not None and page_size is None:
        raise ValueError("num_pages requires page_size")
    caches = []
    for i in range(cfg.num_layers):
        kind = cfg.layer_kind(i)
        if kind != "attn":
            caches.append({kind: init_recurrent_cache(cfg, kind, batch_size,
                                                      dev)})
        elif num_pages is not None:
            caches.append({"attn": attention.init_paged_kv_cache(
                cfg, num_pages, page_size, dtype, dev)})
        else:
            caches.append({"attn": attention.init_kv_cache(
                cfg, batch_size, max_len, dtype, dev)})
        if cfg.is_encoder_decoder:
            caches[-1]["cross_kv"] = None
    return caches


def _row_bytes(cfg, dtype) -> int:
    """Bytes one cached token row (K and V, all kv heads, scale planes
    included) takes in one layer."""
    hd, kvh, bits = cfg.resolved_head_dim, cfg.num_kv_heads, cfg.quant.kv_bits
    if bits == 8:
        return 2 * kvh * hd + 2 * kvh * 2
    if bits in (4, 2):
        return 2 * kvh * -(-hd // (32 // bits)) * 4 + 2 * kvh * 2
    return 2 * kvh * hd * torch.empty((), dtype=dtype).element_size()


def _state_bytes(cfg, kind) -> int:
    """Bytes one slot's f32 recurrent state takes in a ``kind`` layer."""
    d, nh = cfg.d_model, cfg.num_heads
    if kind == "mamba":
        di = cfg.ssm_expand * d
        return 4 * di * (cfg.ssm_conv_width - 1 + cfg.ssm_state_dim)
    if kind == "mlstm":
        hd = int(cfg.mlstm_proj_factor * d) // nh
        return 4 * nh * (hd * hd + hd + 1)
    return 4 * 4 * d                                     # slstm: c, n, h, m


def cache_bytes(cfg, batch_size, max_len, dtype=torch.bfloat16) -> int:
    """Device bytes of an ``init_caches`` tree, without allocating it: the
    attention layers' rows (a sliding-window config's rings hold
    ``min(max_len, window)`` of them) and the recurrent layers' states.
    An encoder-decoder's ``cross_kv`` is None there and counts nothing, as
    the reference's abstract count of a None leaf gives 0."""
    check_supported(cfg)
    rows = attention.cache_size(cfg, max_len) * _row_bytes(cfg, dtype)
    return batch_size * sum(
        rows if cfg.layer_kind(i) == "attn"
        else _state_bytes(cfg, cfg.layer_kind(i))
        for i in range(cfg.num_layers))


def cache_page_bytes(cfg, page_size, dtype=torch.bfloat16) -> int:
    """Device bytes one pool page (``page_size`` token rows) occupies,
    summed over the attention layers, scale planes included: the paged
    engine's capacity unit (budget // cache_page_bytes pages).  Recurrent
    states are not paged, so an attention-free stack gives 0.  Computed
    from shapes, like :func:`cache_bytes`."""
    check_supported(cfg)
    n_attn = sum(cfg.layer_kind(i) == "attn" for i in range(cfg.num_layers))
    return n_attn * page_size * _row_bytes(cfg, dtype)


def loss_fn(logits, labels, aux=0.0, aux_weight=0.01):
    """Masked cross-entropy (labels < 0 are padding) plus the weighted aux
    term; returns (loss, ce), f32."""
    logits = logits.to(torch.float32)
    labels = torch.as_tensor(labels, device=logits.device).to(torch.int64)
    mask = labels >= 0
    logp = F.log_softmax(logits, dim=-1)
    # -logp[label]: nll_loss picks the same values as a gather, and its
    # backward writes each row once (deterministic on the card)
    nll = F.nll_loss(logp.reshape(-1, logp.shape[-1]),
                     torch.clamp(labels, min=0).reshape(-1),
                     reduction="none").reshape(labels.shape)
    denom = torch.clamp(mask.sum(), min=1)
    ce = torch.where(mask, nll, 0.0).sum() / denom
    return ce + aux_weight * aux, ce
