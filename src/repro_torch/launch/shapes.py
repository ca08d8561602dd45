"""Assigned input shapes x architecture applicability, and shape-only
stand-ins for every model input (counterpart of ``repro/launch/shapes.py``):
tensors on the ``meta`` device, which hold a shape and a dtype and no
memory, so the dry run can plan full-width cells without allocating.

Shapes:
  train_4k     seq=4096    global_batch=256   -> train_step
  prefill_32k  seq=32768   global_batch=32    -> serve prefill
  decode_32k   seq=32768   global_batch=128   -> serve decode (1 new token,
                                                 KV cache of seq_len)
  long_500k    seq=524288  global_batch=1     -> decode; sub-quadratic archs
                                                 only
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.models import lm


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str          # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES = {
    "train_4k": ShapeSpec("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524288, 1),
}

# Architectures with sub-quadratic decode paths (SSM / hybrid / SWA).
LONG_CONTEXT_ARCHS = {"xlstm-1.3b", "jamba-1.5-large-398b",
                      "mixtral-8x22b", "mixtral-8x7b"}


def cell_is_live(arch_name: str, shape_name: str):
    """(live, reason-if-skipped) for one (arch x shape) cell."""
    if shape_name == "long_500k" and arch_name not in LONG_CONTEXT_ARCHS:
        return False, ("pure full-attention arch: 512k dense-attention "
                       "decode is skipped per assignment")
    return True, ""


def _sd(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


def _vlm_prefix(shape: ShapeSpec) -> int:
    return min(256, shape.seq_len // 4)


def _enc_len(shape: ShapeSpec) -> int:
    return max(8, shape.seq_len // 4)


def train_input_specs(cfg, shape: ShapeSpec):
    gb, s = shape.global_batch, shape.seq_len
    batch = {"tokens": _sd((gb, s), torch.int32),
             "labels": _sd((gb, s), torch.int32)}
    if cfg.frontend == "vision":
        si = _vlm_prefix(shape)
        batch["tokens"] = _sd((gb, s - si), torch.int32)
        batch["embeds"] = _sd((gb, si, cfg.frontend_dim), torch.bfloat16)
        batch["positions"] = _sd((gb, s), torch.int32)
        batch["positions3"] = _sd((3, gb, s), torch.int32)
        batch["labels"] = _sd((gb, s), torch.int32)
    if cfg.frontend == "audio":
        batch["enc_embeds"] = _sd((gb, _enc_len(shape), cfg.frontend_dim),
                                  torch.bfloat16)
    return batch


def prefill_input_specs(cfg, shape: ShapeSpec):
    gb, s = shape.global_batch, shape.seq_len
    batch = {"tokens": _sd((gb, s), torch.int32)}
    if cfg.frontend == "vision":
        si = _vlm_prefix(shape)
        batch["tokens"] = _sd((gb, s - si), torch.int32)
        batch["embeds"] = _sd((gb, si, cfg.frontend_dim), torch.bfloat16)
        batch["positions"] = _sd((gb, s), torch.int32)
        batch["positions3"] = _sd((3, gb, s), torch.int32)
    if cfg.frontend == "audio":
        batch["enc_embeds"] = _sd((gb, _enc_len(shape), cfg.frontend_dim),
                                  torch.bfloat16)
    return batch


def decode_input_specs(cfg, shape: ShapeSpec):
    """Decode step inputs: one new token + caches sized for seq_len."""
    gb, s = shape.global_batch, shape.seq_len
    caches = lm.init_caches(cfg, gb, s, dtype=torch.bfloat16, device="meta")
    if cfg.is_encoder_decoder:
        hd = cfg.resolved_head_dim
        se = _enc_len(shape)
        for c in caches:
            c["cross_kv"] = (
                _sd((gb, se, cfg.num_kv_heads, hd), torch.bfloat16),
                _sd((gb, se, cfg.num_kv_heads, hd), torch.bfloat16))
    batch = {"tokens": _sd((gb, 1), torch.int32)}
    if cfg.mrope:
        batch["positions3"] = _sd((3, gb, 1), torch.int32)
    return {"batch": batch, "caches": caches,
            "index": _sd((), torch.int32)}


def input_specs(cfg, shape_name: str):
    shape = SHAPES[shape_name]
    if shape.kind == "train":
        return train_input_specs(cfg, shape)
    if shape.kind == "prefill":
        return prefill_input_specs(cfg, shape)
    return decode_input_specs(cfg, shape)
