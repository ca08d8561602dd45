"""Replica-fleet request Router: the system's single client API
(counterpart of ``repro/serve/router.py``).

One ``ServingEngine`` has a bounded queue; the :class:`Router` scales the
front door out over N engine replicas -- one per row of a ``('data',
'model')`` serving mesh (``launch/mesh.replica_meshes``, each replica
tensor-parallel over its own row), or N process-local replicas on one
device when no mesh is given -- and clients talk only to the Router:

* **submit(prompt, sampling) -> Handle** -- least-loaded placement over
  ``queue depth + occupied slots``, ties to the lowest replica index.
* **Session affinity** -- a request carrying a ``session`` key pins to the
  replica that served that session before, overriding least-loaded; a
  full pinned queue makes the request wait in spillover for its replica;
  the pin dissolves when the replica drains.
* **Per-replica backpressure -> router spillover** -- a replica whose
  bounded queue is full is never offered the request (its ``rejected``
  counter stays a true client-visible count); the request waits in the
  Router's spillover queue and is re-placed FIFO as replicas free up.
  TTFT clocks start at fleet admission, so spillover wait is part of the
  latency a client sees.
* **Drain / restore** -- ``drain(r)`` stops admitting to replica ``r``,
  re-routes its queued requests through spillover, lets its live slots
  retire, hands its params off through ``train/checkpoint.save`` (a paged
  replica also its page pools and prefix index), and detaches the engine,
  whose memory -- packed params, caches, CUDA graphs and their pools -- is
  released.  ``restore(r)`` reads the checkpoint back and rebuilds the
  replica on its mesh row, token-for-token identical to a never-drained
  replica (packing is deterministic); a paged replica comes back with its
  prefix cache warm.

On the card each replica is a graphed engine with its own static buffers
and CUDA graphs.  The fleet report sums per-replica tok/s (replicas model
disjoint hardware; replicas sharing one card make that sum a model, not
a measurement) and merges the TTFT / TPOT samples before taking
percentiles, drained replicas' history included.
"""

from __future__ import annotations

import dataclasses
import gc
import itertools
import time
from collections import deque

import numpy as np

from repro_torch.launch import mesh as mesh_lib
from repro_torch.serve.config import EngineConfig, SamplingParams
from repro_torch.serve.engine import Metrics, Request, ServingEngine
from repro_torch.train import checkpoint


@dataclasses.dataclass
class Handle:
    """Client-side view of one fleet request (what ``submit`` returns)."""

    request: Request
    session: str | None = None
    replica: int | None = None      # set at placement; None while spilled
    spilled: bool = False           # ever waited in the spillover queue

    @property
    def uid(self) -> int:
        return self.request.uid

    @property
    def done(self) -> bool:
        return self.request.done

    @property
    def output(self) -> list:
        return list(self.request.output)


def aggregate_reports(metrics_list) -> dict:
    """Merge per-replica :class:`Metrics` into one fleet report.

    Counters sum; per-phase tok/s is the SUM of per-replica rates (each
    replica owns its devices, so fleet throughput is additive -- on one
    card this models disjoint hardware rather than measuring it);
    occupancy, admission wait and acceptance re-divide from the summed
    numerators; TTFT / TPOT distributions merge the raw per-request
    samples before taking percentiles."""
    def div(a, b):
        return a / b if b else 0.0

    ms = list(metrics_list)
    ttft = [s for m in ms for s in m.ttft_s]
    tpot = [s for m in ms for s in m.tpot_s]
    return {
        "prefill_tokens": sum(m.prefill_tokens for m in ms),
        "generated_tokens": sum(m.generated_tokens for m in ms),
        "decode_tokens": sum(m.decode_tokens for m in ms),
        "prefill_tok_s": round(sum(div(m.prefill_tokens, m.prefill_time_s)
                                   for m in ms), 1),
        "decode_tok_s": round(sum(div(m.decode_tokens, m.decode_time_s)
                                  for m in ms), 1),
        "admitted": sum(m.admitted for m in ms),
        "retired": sum(m.retired for m in ms),
        "rejected": sum(m.rejected for m in ms),
        "steps": sum(m.steps for m in ms),
        "occupancy": round(div(sum(m.slot_steps_live for m in ms),
                               sum(m.slot_steps_total for m in ms)), 3),
        "mean_admission_wait_s": round(div(
            sum(m.admission_wait_s for m in ms),
            sum(m.admitted for m in ms)), 5),
        "drafted_tokens": sum(m.drafted_tokens for m in ms),
        "accepted_tokens": sum(m.accepted_tokens for m in ms),
        "verify_tokens": sum(m.verify_tokens for m in ms),
        "spec_cycles": sum(m.spec_cycles for m in ms),
        "acceptance_rate": round(div(sum(m.accepted_tokens for m in ms),
                                     sum(m.drafted_tokens for m in ms)), 3),
        "ttft_s": Metrics._dist(ttft),
        "tpot_s": Metrics._dist(tpot),
    }


class Router:
    """Load-balancing front door over N ``ServingEngine`` replicas (module
    docstring)."""

    def __init__(self, cfg, params, *, config: EngineConfig | None = None,
                 mesh=None, replicas: int | None = None,
                 checkpoint_dir=None, device="cuda", backend: str = "auto"):
        """``mesh``: a ('data', 'model') serving mesh -- one replica per
        data row, each tensor-parallel over its row.  Without a mesh,
        ``replicas`` process-local engines on ``device``.
        ``checkpoint_dir`` is the default param-handoff directory for
        drain / restore; ``backend`` the engines' kernels."""
        self.cfg = cfg
        self.config = config if config is not None else EngineConfig()
        self._params = params
        if mesh is not None:
            groups = mesh_lib.replica_meshes(mesh)
            if replicas is not None and replicas != len(groups):
                raise ValueError(
                    f"replicas={replicas} contradicts the mesh's data "
                    f"axis ({len(groups)} replica groups)")
        else:
            replicas = 1 if replicas is None else replicas
            if replicas < 1:
                raise ValueError(f"replicas must be >= 1, got {replicas}")
            groups = [None] * replicas
        self.replica_meshes = groups
        self._device, self._backend = device, backend
        self.engines: list[ServingEngine | None] = [
            self._engine(g, params) for g in groups]
        self.checkpoint_dir = checkpoint_dir
        self._draining = [False] * len(groups)
        self._ckpt: dict[int, tuple] = {}      # replica -> (dir, step)
        self._ckpt_step = itertools.count()
        self._spill: deque[Handle] = deque()
        self._sessions: dict[str, int] = {}
        self._uids = itertools.count()
        self._handles: dict[int, Handle] = {}
        self._finished: list[Handle] = []
        self._history: list[Metrics] = []      # drained replicas' metrics
        self.spilled = 0
        self.spill_peak = 0
        self.drains = 0
        self.restores = 0

    def _engine(self, group, params) -> ServingEngine:
        return ServingEngine(self.cfg, params, config=self.config,
                             device=self._device, backend=self._backend,
                             mesh=group)

    # ------------------------------------------------------------------
    # Client API: submission
    # ------------------------------------------------------------------

    def submit(self, prompt, sampling: SamplingParams | None = None, *,
               max_new_tokens: int = 16, session: str | None = None,
               uid: int | None = None) -> Handle:
        """Admit one request to the fleet; returns its :class:`Handle`.

        ``prompt`` is a 1-D array of int32 token ids.  Oversize requests
        (prompt + max_new_tokens > max_len) raise at once; everything else
        is placed on a replica now or parked in the spillover queue until
        one has room."""
        prompt = np.asarray(prompt, np.int32)
        if len(prompt) + max_new_tokens > self.config.max_len:
            raise ValueError(
                f"prompt ({len(prompt)}) + max_new_tokens "
                f"({max_new_tokens}) exceeds the fleet max_len "
                f"({self.config.max_len})")
        req = Request(uid=next(self._uids) if uid is None else uid,
                      prompt=prompt, max_new_tokens=max_new_tokens,
                      sampling=sampling)
        req.submit_time = time.perf_counter()   # TTFT from fleet admission
        h = Handle(request=req, session=session)
        self._handles[req.uid] = h
        if not self._try_place(h):
            h.spilled = True
            self._spill.append(h)
            self.spilled += 1
            self.spill_peak = max(self.spill_peak, len(self._spill))
        return h

    def _attached(self):
        return [i for i, e in enumerate(self.engines)
                if e is not None and not self._draining[i]]

    def _has_room(self, i: int) -> bool:
        eng = self.engines[i]
        return eng.max_queue is None or eng.num_pending < eng.max_queue

    def _target_replica(self, h: Handle) -> int | None:
        if h.session is not None and h.session in self._sessions:
            pinned = self._sessions[h.session]
            if self.engines[pinned] is not None \
                    and not self._draining[pinned]:
                # affinity overrides least-loaded; a full pinned queue
                # means the request waits for its replica in spillover
                return pinned if self._has_room(pinned) else None
            del self._sessions[h.session]       # pin dissolved by drain
        candidates = [i for i in self._attached() if self._has_room(i)]
        if not candidates:
            return None
        return min(candidates, key=lambda i: (
            self.engines[i].num_pending + self.engines[i].num_live, i))

    def _try_place(self, h: Handle) -> bool:
        r = self._target_replica(h)
        if r is None:
            return False
        if not self.engines[r].submit(h.request):
            return False                        # raced a cap; spill
        h.replica = r
        if h.session is not None:
            self._sessions[h.session] = r
        return True

    # ------------------------------------------------------------------
    # Stepping
    # ------------------------------------------------------------------

    def step(self) -> bool:
        """One fleet tick: re-place spillover FIFO, then tick every
        attached replica once and collect its finishers.  Returns whether
        any work remains or progressed."""
        progressed = self._drain_spill()
        for eng in self.engines:
            if eng is None:
                continue
            if eng.step():
                progressed = True
            self._collect_one(eng)
        return progressed or bool(self._spill)

    def _drain_spill(self) -> bool:
        placed = False
        still: deque[Handle] = deque()
        while self._spill:
            h = self._spill.popleft()
            if self._try_place(h):
                placed = True
            else:
                still.append(h)
        self._spill = still
        return placed

    def _collect_one(self, eng: ServingEngine):
        for req in eng.take_finished():
            self._finished.append(self._handles.pop(req.uid))

    def run_to_completion(self) -> list[Handle]:
        """Serve until every queue, slot and the spillover are empty;
        returns the handles finished since the last call."""
        while True:
            if self._spill and not any(e is not None for e in self.engines):
                raise RuntimeError(
                    "spillover has pending requests but every replica is "
                    "detached -- restore() one first")
            if not self.step():
                break
        done, self._finished = self._finished, []
        return done

    # ------------------------------------------------------------------
    # Drain / restore (param handoff through train/checkpoint)
    # ------------------------------------------------------------------

    def drain(self, replica: int, directory=None) -> dict:
        """Take replica ``replica`` out of the fleet gracefully.

        Stops admitting (its session pins dissolve), re-routes its queued
        requests through spillover, runs its live slots to retirement,
        checkpoints the params for handoff (when a directory is given or
        configured; a paged replica's page pools and prefix index too),
        and detaches the engine, releasing its memory.  The replica's
        Metrics stay in the fleet report as history."""
        eng = self.engines[replica]
        if eng is None:
            raise ValueError(f"replica {replica} is already detached")
        self._draining[replica] = True
        for s in [s for s, r in self._sessions.items() if r == replica]:
            del self._sessions[s]
        requeued = eng.take_queued()
        for req in reversed(requeued):          # keep FIFO order at front
            h = self._handles[req.uid]
            h.replica = None
            h.spilled = True
            self._spill.appendleft(h)
        self.spill_peak = max(self.spill_peak, len(self._spill))
        while eng.num_live:                     # let slots retire
            eng.step()
        self._collect_one(eng)
        directory = directory if directory is not None \
            else self.checkpoint_dir
        info = {"replica": replica, "requeued": len(requeued),
                "checkpoint": None}
        if directory is not None:
            step = next(self._ckpt_step)
            state = {"params": self._params}
            extra = {"kind": "serving-params", "replica": replica}
            if eng.paged:
                # live slots just retired, so the pools hold exactly the
                # prefix index's pages: the tensors through the tree, the
                # bookkeeping through the manifest
                state["paged_kv"], extra["paged_meta"] = \
                    eng.export_paged_state()
            checkpoint.save(directory, state, step=step, extra=extra)
            del state
            self._ckpt[replica] = (directory, step)
            info["checkpoint"] = {"directory": str(directory),
                                  "step": step}
        self._history.append(eng.metrics)
        self.engines[replica] = None
        self._draining[replica] = False
        self.drains += 1
        # the engine's params, caches, static buffers and CUDA graphs (and
        # their memory pools) go with its last reference
        del eng
        gc.collect()
        return info

    def restore(self, replica: int, directory=None):
        """Reattach a drained replica: read the handoff checkpoint back
        (or, when none was written, use the in-memory params) and rebuild
        the engine on its mesh row from the read params.  A paged replica
        also re-adopts its drained page pools and prefix index (manifest
        ``paged_meta``), copied into the new engine's own tensors, so its
        captured graphs stay valid and its prefix cache is as warm as when
        it drained."""
        if self.engines[replica] is not None:
            raise ValueError(f"replica {replica} is attached; drain first")
        step = None
        if directory is None:
            directory, step = self._ckpt.get(replica,
                                             (self.checkpoint_dir, None))
        params, state, manifest = self._params, None, {}
        if directory is not None:
            group = self.replica_meshes[replica]
            dev = self._device if group is None else group.devices[0][0]
            state, manifest = checkpoint.restore(directory, step=step,
                                                 device=dev)
            params = state["params"]
        eng = self._engine(self.replica_meshes[replica], params)
        if state is not None and eng.paged and "paged_meta" in manifest:
            eng.import_paged_state(state["paged_kv"], manifest["paged_meta"])
        del state, params
        self.engines[replica] = eng
        self.restores += 1
        return eng

    # ------------------------------------------------------------------
    # Reporting
    # ------------------------------------------------------------------

    @property
    def num_pending(self) -> int:
        """Fleet-wide waiting requests (replica queues + spillover)."""
        return len(self._spill) + sum(e.num_pending for e in self.engines
                                      if e is not None)

    def metrics_report(self) -> dict:
        """The fleet report: a ``fleet`` aggregate (summed tok/s, merged
        TTFT / TPOT percentiles, spillover and drain / restore counters)
        and the per-replica reports."""
        live = [e.metrics for e in self.engines if e is not None]
        fleet = {
            "replicas": len(self.engines),
            "attached": sum(e is not None for e in self.engines),
            "spilled": self.spilled,
            "spill_peak": self.spill_peak,
            "spill_pending": len(self._spill),
            "sessions": len(self._sessions),
            "drains": self.drains,
            "restores": self.restores,
            **aggregate_reports(live + self._history),
        }
        return {
            "fleet": fleet,
            "replica_reports": [None if e is None else e.metrics.report()
                                for e in self.engines],
        }

    def capacity_report(self) -> dict:
        """Fleet capacity: per-replica slots summed, shard plans named."""
        per = [None if e is None else e.capacity_report()
               for e in self.engines]
        return {
            "replicas": len(self.engines),
            "fleet_slots": sum(p["slots"] for p in per if p is not None),
            "replica_capacity": per,
        }

    def reset_metrics(self):
        """Zero every replica's counters and the router's own (benchmark
        warm-up)."""
        for e in self.engines:
            if e is not None:
                e.metrics = Metrics()
        self._history = []
        self.spilled = self.spill_peak = 0
        self.drains = self.restores = 0
