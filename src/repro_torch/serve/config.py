"""EngineConfig and SamplingParams (counterpart of ``repro/serve/config.py``).

The fields mirror the reference's: the paged cache (``paged``,
``page_size``, ``prefix_sharing``), the bit-dense weight store
(``dense_store``), speculative decoding (``speculative_k``,
``draft_w_bits``, ``draft_kv_bits``) and the autotuner's warm-tune pass
(``autotune``, kernels/autotune.py) included.  ``EngineConfig.from_args``
is the one way the serving CLI (launch/serve.py) builds its config, with
the reference's budget rules.
"""

from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """Per-request decoding control; temperature <= 0 means greedy."""
    temperature: float = 0.0
    top_k: int = 0
    seed: int = 0

    def __post_init__(self):
        if not math.isfinite(self.temperature):
            raise ValueError(
                f"sampling temperature must be finite, got "
                f"{self.temperature}")
        if self.top_k < 0:
            raise ValueError(f"top_k must be >= 0, got {self.top_k}")

    @property
    def greedy(self) -> bool:
        return self.temperature <= 0.0


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Frozen construction config for one :class:`ServingEngine`.

    * ``max_batch`` -- concurrent batch slots [sequences]; with an
      ``hbm_cache_budget`` the slot count is :meth:`slots_for`.
    * ``max_len`` [tokens] -- per-slot cache extent; every request must
      satisfy ``len(prompt) + max_new_tokens <= max_len``.
    * ``packed`` -- serve through the packed integer kernels.
    * ``prefill_chunk`` [tokens] -- chunked-prefill window width.
    * ``max_queue`` -- backpressure cap on queued requests (None =
      unbounded).
    * ``hbm_cache_budget`` [bytes] -- KV-cache budget converted to slots
      (unpaged) or to pool pages (paged).
    * ``paged`` -- a page pool behind per-slot block tables instead of
      slot-contiguous caches; ``page_size`` [token rows] per page (a
      multiple of the sub-byte word-packing tail); ``prefix_sharing`` --
      share prompt-prefix pages through the radix index (copy-on-write).
    * ``dense_store`` -- keep the packed weights bit-dense (int32 words,
      w_bits a value) instead of as lanes; requires ``packed``.
    * ``autotune`` -- warm-tune every serving signature the active tuning
      cache lacks before the plans are built and the steps captured
      (kernels/autotune.py); requires ``packed``.
    * ``speculative_k`` [tokens] -- > 0 turns every pure-decode pass into
      a speculative cycle: a copy of the model re-packed at
      ``draft_w_bits`` (weights and activations) drafts up to k tokens a
      slot, and the target scores them in one [B, k+1] window
      (serve/speculative.py).  ``draft_kv_bits`` overrides the draft's KV
      precision (None: the target's).  Both only matter on a packed
      engine; the stack must be pure attention (checked at engine init).
    """

    max_batch: int = 4
    max_len: int = 512
    packed: bool = True
    dense_store: bool = False
    prefill_chunk: int = 16
    max_queue: int | None = None
    sampling: SamplingParams = SamplingParams()
    hbm_cache_budget: int | None = None
    autotune: bool = False
    paged: bool = False
    page_size: int = 16
    prefix_sharing: bool = True
    speculative_k: int = 0
    draft_w_bits: int = 2
    draft_kv_bits: int | None = None

    def __post_init__(self):
        if self.max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {self.max_batch}")
        if self.max_len < 1:
            raise ValueError(f"max_len must be >= 1, got {self.max_len}")
        if self.prefill_chunk < 1:
            raise ValueError(
                f"prefill_chunk must be >= 1, got {self.prefill_chunk}")
        if self.max_queue is not None and self.max_queue < 1:
            raise ValueError(
                f"max_queue must be None (unbounded) or >= 1, got "
                f"{self.max_queue}")
        if self.hbm_cache_budget is not None and self.hbm_cache_budget < 1:
            raise ValueError(
                f"hbm_cache_budget must be None or a positive byte count, "
                f"got {self.hbm_cache_budget}")
        if not isinstance(self.sampling, SamplingParams):
            raise TypeError(
                f"sampling must be a SamplingParams, got "
                f"{type(self.sampling).__name__}")
        if self.dense_store and not self.packed:
            raise ValueError(
                "dense_store selects the bit-dense packed weight layout; "
                "it requires packed=True")
        if self.autotune and not self.packed:
            raise ValueError(
                "autotune warm-tunes the packed kernel signatures; it "
                "requires packed=True")
        if self.page_size < 1:
            raise ValueError(
                f"page_size must be >= 1, got {self.page_size}")
        if self.speculative_k < 0:
            raise ValueError(
                f"speculative_k must be >= 0 (0 = off), got "
                f"{self.speculative_k}")
        if self.speculative_k:
            if self.draft_w_bits not in (1, 2, 3, 4):
                raise ValueError(
                    f"draft_w_bits must be a packable sub-byte width in "
                    f"{{1, 2, 3, 4}}, got {self.draft_w_bits}")
            if self.draft_kv_bits not in (None, 0, 2, 4, 8, 16):
                raise ValueError(
                    f"draft_kv_bits must be None (inherit target) or one "
                    f"of 0/16/8/4/2, got {self.draft_kv_bits}")

    def slots_for(self, cache_bytes_per_slot: int) -> int:
        """Admitted batch slots: with no budget ``max_batch`` stands; with
        one, ``budget // bytes-per-slot`` concurrent sequences."""
        if self.hbm_cache_budget is None:
            return self.max_batch
        slots = int(self.hbm_cache_budget // cache_bytes_per_slot)
        if slots < 1:
            raise ValueError(
                f"hbm_cache_budget {self.hbm_cache_budget} < one slot's "
                f"cache ({cache_bytes_per_slot} bytes at max_len "
                f"{self.max_len})")
        return slots

    def pages_for(self, page_bytes: int, pages_per_slot: int) -> int:
        """Physical page count: the paged-pool capacity rule.

        With no budget the pool is sized so ``max_batch`` worst-case
        (no-sharing, full-extent) slots fit; with one, the budget buys
        ``budget // bytes-per-page`` pages.  Either way the pool must hold
        at least one worst-case slot or no request could ever admit.
        """
        if self.hbm_cache_budget is None:
            return self.max_batch * pages_per_slot
        pages = int(self.hbm_cache_budget // page_bytes)
        if pages < pages_per_slot:
            raise ValueError(
                f"hbm_cache_budget {self.hbm_cache_budget} < one worst-case "
                f"slot's pages ({pages_per_slot} pages x {page_bytes} bytes "
                f"at max_len {self.max_len}, page_size {self.page_size})")
        return pages

    @classmethod
    def from_args(cls, args) -> "EngineConfig":
        """Build from launch/serve.py's argparse namespace: the CLI derives
        its engine side through this method alone, so the flags and the
        programmatic construction cannot drift.  ``--hbm-cache-budget-mb``
        0 or below means no budget; a positive budget that rounds to under
        one byte is refused rather than read as unlimited."""
        mb = getattr(args, "hbm_cache_budget_mb", None)
        if mb is None or mb <= 0:
            budget = None
        else:
            budget = int(mb * 2**20)
            if budget < 1:
                raise ValueError(
                    f"--hbm-cache-budget-mb {mb} is positive but rounds to "
                    f"under one byte; use 0 to disable the budget")
        return cls(
            max_batch=args.max_batch,
            max_len=args.max_len,
            packed=not args.no_packed,
            dense_store=getattr(args, "dense_store", False),
            prefill_chunk=args.prefill_chunk,
            max_queue=args.max_queue or None,
            sampling=SamplingParams(temperature=args.temperature,
                                    top_k=args.top_k),
            hbm_cache_budget=budget,
            autotune=args.autotune,
            paged=getattr(args, "paged_kv", False),
            page_size=getattr(args, "page_size", 16),
            prefix_sharing=not getattr(args, "no_prefix_sharing", False),
            speculative_k=getattr(args, "speculative_k", 0),
            draft_w_bits=getattr(args, "draft_w_bits", 2),
            draft_kv_bits=(None if getattr(args, "draft_kv_bits", -1) < 0
                           else args.draft_kv_bits))
