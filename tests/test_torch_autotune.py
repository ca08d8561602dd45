"""The port's autotuner (``repro_torch/kernels/autotune.py``) on the CPU,
the counterpart of tests/test_autotune.py: the cache file, the planners'
consultation of the active cache (and their refusal of entries the
launchers would refuse), the tuners -- through a stand-in registered for
the 'cuda' backend that runs the plain version, wrong at one candidate --,
the layout sweep flowing through pack, plan and dispatch, K3 and K4
sharing one decode entry, ``measure_us`` on the host clock, and a layout
entry installed in both packages' caches giving byte-equal packed leaves
and equal engine tokens."""

import dataclasses
import json
import math
import warnings

import numpy as np

import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.core import packing  # noqa: E402
from repro_torch.core.packing import PackSpec  # noqa: E402
from repro_torch.core.quant import QuantConfig as TQ  # noqa: E402
from repro_torch.kernels import autotune, ops  # noqa: E402
from repro_torch.kernels import plan as plan_lib  # noqa: E402
from repro_torch.models import common  # noqa: E402
from repro_torch.serve import prepare as tprepare  # noqa: E402

torch.set_num_threads(2)

SP = PackSpec.parse("W2A2/int16xP2s8")
S32 = PackSpec.parse("W2A2/int32xP2s16")


@pytest.fixture(autouse=True)
def empty_port_cache():
    """Every test starts from an empty active cache and leaves none."""
    old = autotune.active_cache()
    autotune.set_active_cache(autotune.TuningCache(device="cpu"))
    yield
    autotune.set_active_cache(old)


def _install(entries: dict) -> autotune.TuningCache:
    return autotune.set_active_cache(
        autotune.TuningCache(device="cpu", entries=dict(entries)))


# ---------------------------------------------------------------------------
# The cache file
# ---------------------------------------------------------------------------

class TestCacheFile:
    def test_save_load_roundtrip(self, tmp_path):
        c = autotune.TuningCache(device="cpu", entries={
            "k": {"block_m": 8, "wall_us": 1.5}})
        path = c.save(str(tmp_path / "sub" / "c.json"))
        raw = json.loads(open(path).read())
        assert raw["schema"] == autotune.SCHEMA_VERSION == 2
        back = autotune.TuningCache.load(path)
        assert back.entries == c.entries and back.device == "cpu"
        assert back.path == path

    def test_missing_file_is_silent_none(self, tmp_path):
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            assert autotune.TuningCache.load(str(tmp_path / "no")) is None

    def test_corrupt_file_warns_and_falls_back(self, tmp_path):
        p = tmp_path / "c.json"
        p.write_text("{not json")
        with pytest.warns(UserWarning, match="corrupt"):
            assert autotune.TuningCache.load(str(p)) is None
        with pytest.warns(UserWarning, match="corrupt"):
            c = autotune.load_cache(str(p))
        assert c is autotune.active_cache() and c.entries == {}

    def test_stale_schema_warns_and_falls_back(self, tmp_path):
        p = tmp_path / "c.json"
        p.write_text(json.dumps({"schema": 1, "entries": {}}))
        with pytest.warns(UserWarning, match="schema 1"):
            assert autotune.TuningCache.load(str(p)) is None

    def test_entries_must_be_a_dict(self, tmp_path):
        p = tmp_path / "c.json"
        p.write_text(json.dumps({"schema": 2, "entries": [1, 2]}))
        with pytest.warns(UserWarning, match="no entries dict"):
            assert autotune.TuningCache.load(str(p)) is None

    def test_port_file_and_environment_variable(self, tmp_path, monkeypatch):
        """The port's own file: $REPRO_TORCH_AUTOTUNE_CACHE, else
        reports/autotune_torch_<device>.json; the reference's variable is
        not read."""
        monkeypatch.delenv(autotune.ENV_CACHE, raising=False)
        monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", str(tmp_path / "ref"))
        assert autotune.ENV_CACHE == "REPRO_TORCH_AUTOTUNE_CACHE"
        path = autotune.default_cache_path()
        assert path.endswith("reports/autotune_torch_cpu.json")
        assert autotune.device_kind() == "cpu"
        monkeypatch.setenv(autotune.ENV_CACHE, str(tmp_path / "p.json"))
        assert autotune.default_cache_path() == str(tmp_path / "p.json")
        autotune.TuningCache(device="cpu", entries={"x": {}}).save()
        autotune.reset_active_cache()
        assert autotune.active_cache().entries == {"x": {}}


# ---------------------------------------------------------------------------
# Planner consultation
# ---------------------------------------------------------------------------

def _mm(**kw):
    return plan_lib.plan_packed_matmul(64, 1024, 256, SP,
                                       weight_store="lanes", **kw)


def _mm_key(spec=SP, m=64, kp=1024, n=256):
    return autotune.matmul_key(m, kp, n, spec, backend="torch")


class TestPlannerConsultation:
    def test_hit_returns_cache_backed_plan(self):
        heur = _mm()
        assert heur.source == "heuristic"
        _install({_mm_key(): {"block_m": 16, "block_k": 128, "splits": 8}})
        p = _mm()
        assert p.source == "tuned" and p.describe()["source"] == "tuned"
        assert dataclasses.replace(p, source="heuristic") == \
            dataclasses.replace(heur, **plan_lib.mma_geometry(1024, 16, 2, 2))

    def test_miss_falls_back_to_heuristic(self):
        _install({_mm_key(m=4): {"block_m": 8, "block_k": 64, "splits": 16}})
        p = _mm()
        assert p.source == "heuristic"
        assert p == _mm(use_tuning_cache=False)

    def test_use_tuning_cache_false_bypasses_hit(self):
        _install({_mm_key(): {"block_m": 16, "block_k": 128, "splits": 8}})
        assert _mm(use_tuning_cache=False).source == "heuristic"
        assert _mm().source == "tuned"

    @pytest.mark.parametrize("entry,why", [
        ({"block_m": 12, "block_k": 128}, "block_m 12"),
        ({"block_m": 16, "block_k": 96}, "whole 64-lane"),
        ({"block_m": 16, "block_k": 16384 + 64}, "whole 64-lane"),
        ({"block_m": 16, "block_k": 128, "splits": 3}, "splits 3"),
        ({"block_m": 16}, "block_k"),
        ({"block_m": "16", "block_k": 128}, "must be an int"),
        ({"block_m": 16.0, "block_k": 128}, "must be an int"),
        ([16, 128], "not a dict"),
    ])
    def test_refused_or_malformed_entry_ignored(self, entry, why):
        _install({_mm_key(): entry})
        with pytest.warns(UserWarning, match=why):
            p = _mm()
        assert p == _mm(use_tuning_cache=False)

    def test_core_matmul_entries(self):
        """int32xP2s16 plans the tensor cores' tile too: its entries are
        the tile's (K in steps of two values: 100 lanes are 100 steps, two
        stages), and the CUDA-core K2's geometry (4-row blocks, splits of
        any lane count) is refused."""
        kw = dict(weight_store="lanes")
        key = autotune.matmul_key(4, 100, 130, S32, backend="torch")
        _install({key: {"block_m": 8, "block_k": 64, "splits": 2}})
        p = plan_lib.plan_packed_matmul(4, 100, 130, S32, **kw)
        assert p.source == "tuned" and (p.block_k, p.splits) == (64, 2)
        assert p.stages == plan_lib.mma_geometry(
            100, 8, 1, 4, plan_lib.lanes_w_tile_bytes(S32))["stages"]
        for bad in ({"block_m": 4, "block_k": 50, "splits": 2},
                    {"block_m": 8, "block_k": 50, "splits": 2},
                    {"block_m": 8, "block_k": 64, "splits": 3},
                    {"block_m": 8, "block_k": 0, "splits": 2}):
            _install({key: bad})
            with pytest.warns(UserWarning, match="ignoring autotune entry"):
                assert plan_lib.plan_packed_matmul(
                    4, 100, 130, S32, **kw).source == "heuristic"

    def test_fused_route_key_and_adoption(self, monkeypatch):
        monkeypatch.setattr(plan_lib, "resolve_backend",
                            lambda backend="auto", device="cpu":
                            "torch" if backend == "torch" else "cuda")
        plan_lib.clear_plan_cache()
        key = autotune.quantized_linear_key(64, 2048, 256, SP, 2,
                                            backend="cuda")
        _install({key: {"block_m": 32, "block_k": 256, "splits": 4}})
        p = plan_lib.plan_quantized_linear(64, 2048, 256, SP, torch.bfloat16,
                                           weight_store="lanes")
        assert (p.op, p.source, p.block_m, p.splits) == (
            "quantized_linear", "tuned", 32, 4)
        assert p.stages == plan_lib.mma_geometry(1024, 32, 4, 4)["stages"]
        # f32 x has its own key: the bf16 entry is not read for it
        assert plan_lib.plan_quantized_linear(
            64, 2048, 256, SP, torch.float32,
            weight_store="lanes").source == "heuristic"
        plan_lib.clear_plan_cache()

    def test_conv_hit_and_refusal(self):
        xs, ws = (8, 64, 64, 16), (7, 7, 16, 64)
        key = autotune.conv2d_key(xs, ws, SP, padding="SAME",
                                  backend="torch")
        heur = plan_lib.plan_packed_conv2d(xs, ws, SP)
        _install({key: {"block_co": 32, "block_w": 16}})
        p = plan_lib.plan_packed_conv2d(xs, ws, SP)
        assert (p.source, p.block_co, p.block_w, p.block_h) == (
            "tuned", 32, 16, 32)
        assert p.smem_bytes == plan_lib.conv_mma_smem_bytes(7, 7, 32, 16, 32,
                                                            32)
        for bad in ({"block_co": 128, "block_w": 16},
                    {"block_co": 32, "block_w": 8}, {"block_co": 32}):
            _install({key: bad})
            with pytest.warns(UserWarning, match="ignoring autotune entry"):
                assert plan_lib.plan_packed_conv2d(xs, ws, SP) == heur
        # int8xP2s4 tunes the tensor-core tile too (its raw slot counted);
        # a shape past the resident weight block tunes it in channel
        # chunks, and an entry tuned for the CUDA-core tile (no block_w)
        # is stale: ignored with a warning
        s4 = PackSpec.parse("W1A1/int8xP2s4")
        key = autotune.conv2d_key(xs, ws, s4, padding="SAME",
                                  backend="torch")
        _install({key: {"block_co": 8, "block_w": 16}})
        p = plan_lib.plan_packed_conv2d(xs, ws, s4)
        assert (p.source, p.route, p.block_co, p.block_w) == (
            "tuned", "tensor_cores", 8, 16)
        assert p.smem_bytes == plan_lib.conv_mma_smem_bytes(
            7, 7, 32, 16, 8, 32, plan_lib.conv_mma_raw_c(16, s4))
        xb, wb = (1, 8, 8, 512), (7, 7, 512, 8)
        key = autotune.conv2d_key(xb, wb, SP, padding="SAME",
                                  backend="torch")
        _install({key: {"block_co": 8}})
        with pytest.warns(UserWarning, match="ignoring autotune entry"):
            p = plan_lib.plan_packed_conv2d(xb, wb, SP)
        assert (p.source, p.route) == ("heuristic", "tensor_cores")
        assert p.chunks > 1 and p.threads == plan_lib.CONV_MMA_THREADS
        _install({key: {"block_co": 8, "block_w": 16}})
        p = plan_lib.plan_packed_conv2d(xb, wb, SP)
        assert (p.source, p.route, p.block_co, p.block_w) == (
            "tuned", "tensor_cores", 8, 16)
        assert p.chunks > 1

    def test_plan_selection_deterministic_given_fixed_cache(self):
        entries = {_mm_key(): {"block_m": 32, "block_k": 512, "splits": 2}}
        _install(entries)
        a = _mm()
        _install(entries)
        assert _mm() == a

    def test_attention_chunk_lookup(self):
        assert autotune.attention_chunk_for(1, 8, 8, 4, 4, 16, 4) == 512
        _install({autotune.attention_key(1, 8, 8, 4, 4, 16, 4):
                  {"q_chunk": 32}})
        assert autotune.attention_chunk_for(1, 8, 8, 4, 4, 16, 4) == 32
        _install({autotune.attention_key(1, 8, 8, 4, 4, 16, 4):
                  {"q_chunk": "x"}})
        assert autotune.attention_chunk_for(1, 8, 8, 4, 4, 16, 4) == 512


class TestAttentionDecodeEntry:
    """K3 and K4 read one entry, keyed by the logical shape."""

    SHAPE = (4, 1, 512, 32, 32, 64, 4)

    def _plans(self, page_size=16):
        return (plan_lib.plan_attention_decode(*self.SHAPE),
                plan_lib.plan_attention_decode(*self.SHAPE,
                                               page_size=page_size))

    def test_k3_and_k4_resolve_one_entry(self):
        key = autotune.attention_decode_key(*self.SHAPE, backend="torch")
        assert "ps=" not in key and "page" not in key
        _install({key: {"tile_rows": 64, "split_rows": 128, "splits": 4}})
        p3, p4 = self._plans()
        for p in (p3, p4):
            assert (p.source, p.tile_rows, p.split_rows, p.splits) == (
                "tuned", 64, 128, 4)
        assert p4.smem_bytes > p3.smem_bytes      # the split's table
        assert p3.block_k == plan_lib.plan_attention_decode(
            *self.SHAPE, use_tuning_cache=False).block_k

    def test_split_not_whole_pages_refused_by_k4_only(self):
        key = autotune.attention_decode_key(*self.SHAPE, backend="torch")
        _install({key: {"tile_rows": 32, "split_rows": 96, "splits": 6}})
        with pytest.warns(UserWarning, match="pages of 64"):
            p3, p4 = self._plans(page_size=64)
        assert p3.source == "tuned" and p4.source == "heuristic"

    @pytest.mark.parametrize("entry", [
        {"tile_rows": 48, "split_rows": 96},          # not a warp tile
        {"tile_rows": 32, "split_rows": 32},          # 16 splits > 8
        {"tile_rows": 64, "split_rows": 96},          # not whole tiles
        {"tile_rows": 64, "split_rows": 128, "splits": 3},
        {"split_rows": 128}])
    def test_refused_entries(self, entry):
        key = autotune.attention_decode_key(*self.SHAPE, backend="torch")
        _install({key: entry})
        with pytest.warns(UserWarning, match="ignoring autotune entry"):
            p3 = plan_lib.plan_attention_decode(*self.SHAPE)
        assert p3 == plan_lib.plan_attention_decode(*self.SHAPE,
                                                    use_tuning_cache=False)

    @pytest.mark.parametrize("paged", [False, True])
    def test_candidates_are_whole_pages_and_legal(self, paged):
        """K3's candidates are whole pages of 16 with K3's shared memory
        (no table); K4's hold the split's table."""
        kw = dict(page_size=16) if paged else dict(align=16)
        cands = plan_lib.attention_decode_candidates(*self.SHAPE, **kw)
        assert len(cands) > 4
        heur = plan_lib.plan_attention_decode(
            *self.SHAPE, page_size=16 if paged else None)
        assert any(g == {f: getattr(heur, f) for f in g} for g in cands)
        for g in cands:
            assert g["split_rows"] % 16 == 0
            assert g["split_rows"] % g["tile_rows"] == 0
            assert 1 <= g["splits"] <= plan_lib.ATTN_MAX_SPLITS
            assert g["smem_bytes"] <= plan_lib.ATTN_SMEM_MAX
            assert g == plan_lib.attention_decode_geometry(
                *self.SHAPE, tile_rows=g["tile_rows"],
                split_rows=g["split_rows"],
                page_size=16 if paged else None)


class TestAttentionTileEntry:
    """The tile path (a 16-row prefill chunk of stablelm's heads): its
    candidates and tuned entries are tiles of 16 .. 128 rows."""

    SHAPE = (4, 16, 512, 32, 32, 64, 4)

    @pytest.mark.parametrize("paged", [False, True])
    def test_candidates_are_tile_path_tiles(self, paged):
        kw = dict(page_size=16) if paged else dict(align=16)
        cands = plan_lib.attention_decode_candidates(*self.SHAPE, **kw)
        heur = plan_lib.plan_attention_decode(
            *self.SHAPE, page_size=16 if paged else None)
        assert not plan_lib.attention_warp_path(heur.block_m, 64)
        assert any(g == {f: getattr(heur, f) for f in g} for g in cands)
        assert {g["tile_rows"] for g in cands} == set(
            plan_lib.ATTN_TILE_TILES)
        for g in cands:
            assert g["block_m"] == 16
            assert g["split_rows"] % math.lcm(g["tile_rows"], 16) == 0
            assert g["smem_bytes"] <= plan_lib.ATTN_SMEM_MAX
            assert g == plan_lib.attention_decode_geometry(
                *self.SHAPE, tile_rows=g["tile_rows"],
                split_rows=g["split_rows"],
                page_size=16 if paged else None)

    def test_tuned_tile_adopted_by_k3_and_k4(self):
        key = autotune.attention_decode_key(*self.SHAPE, backend="torch")
        _install({key: {"tile_rows": 32, "split_rows": 128, "splits": 4}})
        for ps in (None, 16):
            p = plan_lib.plan_attention_decode(*self.SHAPE, page_size=ps)
            assert (p.source, p.tile_rows, p.split_rows, p.splits) == (
                "tuned", 32, 128, 4)

    @pytest.mark.parametrize("entry", [
        {"tile_rows": 8, "split_rows": 128},     # the old f32 tile path's
        {"tile_rows": 4, "split_rows": 64},      # tiles: no k16 step
        {"tile_rows": 48, "split_rows": 96}])    # not a power-of-two tile
    def test_stale_tiles_fall_back(self, entry):
        key = autotune.attention_decode_key(*self.SHAPE, backend="torch")
        _install({key: entry})
        with pytest.warns(UserWarning, match="ignoring autotune entry"):
            p = plan_lib.plan_attention_decode(*self.SHAPE)
        assert p == plan_lib.plan_attention_decode(*self.SHAPE,
                                                   use_tuning_cache=False)


# ---------------------------------------------------------------------------
# Tuners, through a 'cuda' stand-in that runs the plain version
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_standin(monkeypatch):
    """'auto' and 'cuda' resolve to 'cuda' on CPU tensors, and the 'cuda'
    K2, fused route, K5 and K3 run their plain versions -- except at the
    geometry put in ``wrong``, where K2 and the fused route add one."""
    monkeypatch.setattr(plan_lib, "resolve_backend",
                        lambda backend="auto", device="cpu":
                        "torch" if backend == "torch" else "cuda")
    wrong = {}
    plain = {op: plan_lib.get_backend(op, "torch")
             for op in ("packed_matmul", "packed_conv2d",
                        "attention_decode")}

    def bad(plan):
        return wrong and all(getattr(plan, f) == v
                             for f, v in wrong.items())

    def packed(plan, a2, w):
        out = plain["packed_matmul"](plan, a2, w)
        return out + 1 if bad(plan) else out

    def fused(plan, x2, w, cs, a_scale, a_zp, w_scale, w_zp, *, bias,
              out_dtype):
        out = ops.quantized_linear(x2, w, cs, a_scale, a_zp, w_scale, w_zp,
                                   plan.spec, bias=bias, backend="torch",
                                   weight_store=plan.weight_store,
                                   out_dtype=out_dtype)
        return out + 1 if bad(plan) else out

    monkeypatch.setitem(plan_lib._BACKENDS, ("packed_matmul", "cuda"),
                        packed)
    monkeypatch.setitem(plan_lib._BACKENDS, ("quantized_linear", "cuda"),
                        fused)
    for op in ("packed_conv2d", "attention_decode"):
        monkeypatch.setitem(plan_lib._BACKENDS, (op, "cuda"), plain[op])
    plan_lib.clear_plan_cache()
    yield wrong
    plan_lib.clear_plan_cache()


class TestTuners:
    def test_tune_fused_stores_winner_and_plan_adopts_it(self, cuda_standin):
        m, k, n = 64, 512, 64
        cands = plan_lib.packed_matmul_candidates(
            m, k // 2, n, SP, x_dtype=torch.float32)
        heur = plan_lib.plan_quantized_linear(m, k, n, SP, torch.float32,
                                              weight_store="lanes")
        wrong = next(c for c in cands
                     if (c["block_m"], c["block_k"]) != (heur.block_m,
                                                         heur.block_k))
        cuda_standin.update(block_m=wrong["block_m"],
                            block_k=wrong["block_k"])
        with pytest.warns(UserWarning, match="disagrees"):
            e = autotune.tune_quantized_linear(m, k, n, SP, torch.float32,
                                               device="cpu", repeats=1)
        assert e["bit_equal"] is False and e["candidates"] == len(cands)
        assert (e["block_m"], e["block_k"]) != (wrong["block_m"],
                                                wrong["block_k"])
        assert e["heuristic_us"] > 0 and e["wall_us"] <= e["heuristic_us"]
        key = autotune.quantized_linear_key(m, k, n, SP, 4, backend="cuda")
        assert autotune.active_cache().lookup(key) is e
        p = plan_lib.plan_quantized_linear(m, k, n, SP, torch.float32,
                                           weight_store="lanes")
        assert p.source == "tuned" and (p.block_m, p.block_k, p.splits,
                                        p.stages) == (
            e["block_m"], e["block_k"], e["splits"], e["stages"])
        # a second call hits the cache; force re-measures
        assert autotune.tune_quantized_linear(m, k, n, SP, torch.float32,
                                              device="cpu") is e

    def test_core_route_splits(self, cuda_standin):
        """int32xP2s16 tunes on the tensor cores' grid, as int16xP2s8."""
        cands = plan_lib.packed_matmul_candidates(8, 1024, 40, S32)
        assert {c["splits"] for c in cands} >= {1, 2, 3, 4}
        assert all(c["block_k"] % 64 == 0 for c in cands)
        cuda_standin.update(splits=2)
        with pytest.warns(UserWarning, match="disagrees"):
            e = autotune.tune_packed_matmul(8, 1024, 40, S32, device="cpu",
                                            repeats=1)
        assert e["splits"] != 2 and not e["bit_equal"]
        assert set(e) >= {"block_m", "block_k", "splits", "stages",
                          "wall_us", "heuristic_us", "candidates"}
        p = plan_lib.plan_packed_matmul(8, 1024, 40, S32,
                                        weight_store="lanes")
        assert p.source == "tuned" and p.splits == e["splits"]

    def test_store_into_active_cache_invalidates_memoized_plans(
            self, cuda_standin):
        before = plan_lib.plan_packed_matmul(8, 64, 32, SP,
                                             weight_store="lanes")
        assert before.source == "heuristic"
        e = autotune.tune_packed_matmul(8, 64, 32, SP, device="cpu",
                                        repeats=1)
        assert e["bit_equal"]
        after = plan_lib.plan_packed_matmul(8, 64, 32, SP,
                                            weight_store="lanes")
        assert after.source == "tuned" and after is not before
        # a store into another cache leaves the memoized plans alone
        other = autotune.TuningCache(device="cpu")
        autotune.tune_packed_matmul(4, 64, 32, SP, device="cpu", cache=other,
                                    repeats=1)
        assert plan_lib.plan_packed_matmul(8, 64, 32, SP,
                                           weight_store="lanes") is after

    def test_conv_and_attention_tuners(self, cuda_standin):
        e = autotune.tune_packed_conv2d((1, 12, 12, 4), (3, 3, 4, 24), SP,
                                        device="cpu", repeats=1)
        assert e["bit_equal"] and e["candidates"] == len(
            plan_lib.packed_conv2d_candidates((1, 12, 12, 4), (3, 3, 4, 24),
                                              SP))
        p = plan_lib.plan_packed_conv2d((1, 12, 12, 4), (3, 3, 4, 24), SP)
        assert p.source == "tuned" and p.block_co == e["block_co"]
        e = autotune.tune_attention_decode(2, 1, 64, 4, 2, 16, kv_bits=4,
                                           device="cpu", repeats=1)
        assert e["within_tol"] and e["candidates"] > 1
        assert e["max_err"] <= autotune.ATTN_TOL
        for ps in (None, 16):
            p = plan_lib.plan_attention_decode(2, 1, 64, 4, 2, 16, 4,
                                               page_size=ps)
            assert p.source == "tuned" and p.split_rows == e["split_rows"]

    def test_torch_backend_measures_the_heuristic_alone(self):
        e = autotune.tune_quantized_linear(8, 128, 32, SP, torch.float32,
                                           device="cpu", repeats=1)
        assert e["candidates"] == 1 and e["bit_equal"]
        assert e["wall_us"] == e["heuristic_us"]
        assert autotune.active_cache().lookup(autotune.matmul_key(
            8, 64, 32, SP, backend="torch")) is e
        p = plan_lib.plan_quantized_linear(8, 128, 32, SP, torch.float32,
                                           weight_store="lanes")
        assert p.op == "packed_matmul" and p.source == "tuned"
        assert dataclasses.replace(p, source="heuristic") == \
            plan_lib.plan_quantized_linear(8, 128, 32, SP, torch.float32,
                                           weight_store="lanes",
                                           use_tuning_cache=False)

    def test_attention_chunk_tuner(self):
        e = autotune.tune_attention_chunk(1, 64, 64, 4, 2, 16, device="cpu",
                                          dtype=torch.float32, repeats=1)
        assert e["q_chunk"] in (32, 64, 512) and e["candidates"] == 3
        assert autotune.attention_chunk_for(1, 64, 64, 4, 2, 16) == \
            e["q_chunk"]


# ---------------------------------------------------------------------------
# The layout sweep
# ---------------------------------------------------------------------------

def _layout_key(k, n, **kw):
    return autotune.matmul_layout_key(k, n, 2, 2, backend="torch", **kw)


class TestLayoutTuner:
    def test_tune_matmul_layout_stores_verified_winner(self):
        e = autotune.tune_matmul_layout(4, 64, 32, SP, device="cpu",
                                        x_dtype=torch.float32, repeats=1)
        family = packing.layout_family(2, 2, SP)
        assert e["candidates"] == len(family) and e["bit_equal"]
        assert e["base_spec"] == str(SP) and e["base_us"] > 0
        assert PackSpec.parse(e["spec"]) in family
        assert autotune.active_cache().lookup(_layout_key(64, 32)) is e
        assert autotune.matmul_layout_for(64, 32, SP) == \
            PackSpec.parse(e["spec"])

    def test_failing_layout_is_excluded(self, monkeypatch):
        real = ops.packed_matmul

        def corrupt(a, w, spec, **kw):
            out = real(a, w, spec, **kw)
            return out + 1 if spec.lane_dtype == torch.int32 else out

        monkeypatch.setattr(ops, "packed_matmul", corrupt)
        with pytest.warns(UserWarning, match="failed bit-exactness"):
            e = autotune.tune_matmul_layout(4, 64, 32, SP, device="cpu",
                                            x_dtype=torch.float32,
                                            repeats=1)
        assert e["spec"] == str(SP) and e["candidates"] == 1
        assert e["bit_equal"] is False

    def test_tune_conv2d_layout_stores_verified_winner(self):
        e = autotune.tune_conv2d_layout((1, 8, 8, 8), (3, 3, 8, 8), SP,
                                        device="cpu", repeats=1)
        assert e["bit_equal"] and e["candidates"] == len(
            packing.layout_family(2, 2, SP))
        assert autotune.conv2d_layout_for((1, 8, 8, 8), (3, 3, 8, 8), SP) \
            == PackSpec.parse(e["spec"])

    def test_layout_for_defaults_to_base_on_miss(self):
        assert autotune.matmul_layout_for(64, 32, SP) == SP
        assert autotune.conv2d_layout_for((1, 8, 8, 8), (3, 3, 8, 8),
                                          SP) == SP

    @pytest.mark.parametrize("entry", [{"spec": "W3A3/int16xP2s8"},
                                       {"spec": "garbage"}, {"spec": 3},
                                       "W2A2/int32xP4s8"])
    def test_layout_for_ignores_unusable_entries(self, entry):
        _install({_layout_key(64, 32): entry})
        assert autotune.matmul_layout_for(64, 32, SP) == SP

    def test_layout_key_excludes_rows(self):
        e = autotune.tune_matmul_layout(4, 64, 32, SP, device="cpu",
                                        x_dtype=torch.float32, repeats=1)
        assert autotune.tune_matmul_layout(16, 64, 32, SP, device="cpu") is e
        assert "m=" not in _layout_key(64, 32)

    def test_chosen_layout_flows_pack_plan_dispatch(self, monkeypatch):
        chosen = PackSpec.parse("W2A2/int32xP4s8")
        _install({_layout_key(64, 24): {"spec": str(chosen)}})
        q = TQ(enabled=True, w_bits=2, a_bits=2)
        gen = torch.Generator().manual_seed(0)
        raw = {"kernel": torch.randn(64, 24, generator=gen),
               "w_step": torch.tensor(0.05), "a_step": torch.tensor(0.3)}
        p = common.pack_dense_params(raw, q)
        assert p["w_packed"].dtype == torch.int32
        assert p["w_packed"].shape == (16, 24)
        cfg = tconfigs.get_config("stablelm-1.6b", reduced=True).replace(
            quant=q)
        plans = tprepare.build_layer_plans({"l": p}, cfg, batch_rows=3)
        assert plans["l"].spec == chosen
        seen = []
        real = ops.quantized_linear

        def spy(*args, **kw):
            seen.append(args[7])
            return real(*args, **kw)

        monkeypatch.setattr(ops, "quantized_linear", spy)
        x = torch.randn(3, 64, generator=gen)
        got = common.dense_apply(p, x, qcfg=q, quant_mode="packed",
                                 compute_dtype=torch.float32)
        assert seen == [chosen]
        # the integer core is exact in any layout: equal to the base's
        _install({})
        base = common.pack_dense_params(raw, q)
        assert base["w_packed"].dtype == torch.int16
        assert torch.equal(got, common.dense_apply(
            base, x, qcfg=q, quant_mode="packed",
            compute_dtype=torch.float32))

    def test_stale_layout_cache_falls_back_on_packed_evidence(self):
        q = TQ(enabled=True, w_bits=2, a_bits=2)
        raw = {"kernel": torch.randn(64, 24), "w_step": torch.tensor(0.05),
               "a_step": torch.tensor(0.3)}
        p = common.pack_dense_params(raw, q)            # base layout
        _install({_layout_key(64, 24): {"spec": "W2A2/int32xP4s8"}})
        assert common.dense_layer_spec(64, 24, q, w_packed=p["w_packed"]) \
            == SP
        assert common.dense_layer_spec(64, 24, q) != SP


# ---------------------------------------------------------------------------
# Timing
# ---------------------------------------------------------------------------

class TestMeasure:
    def test_median_of_repeats_scales_batch_to_min_time(self):
        calls = []
        us = autotune.measure_us(lambda: calls.append(1), repeats=3,
                                 min_time_s=1e-3, max_calls=64)
        assert us > 0
        assert 64 < len(calls) <= 1 + 64 * 4 + 64

    def test_zero_min_time_keeps_the_list(self):
        seen = []
        fns = [lambda i=i: seen.append(i) for i in range(3)]
        autotune.measure_us(fns, repeats=2, min_time_s=0)
        assert seen == [0, 1, 2] * 3       # warm-up, then two batches

    def test_copies_rotate_past_the_l2(self):
        assert autotune.copies_for(autotune.L2_BYTES) == 2
        assert autotune.copies_for(1) == 32
        assert autotune.copies_for(10 * autotune.L2_BYTES) == 1


# ---------------------------------------------------------------------------
# Parity with the reference under one non-default layout entry
# ---------------------------------------------------------------------------

def test_layout_entry_parity_with_reference():
    """A cache that picks W2A2/int32xP4s8 for reduced stablelm's (64, 64)
    projections, installed in both packages' caches: the packed leaves
    are byte-equal and the engines' greedy tokens equal, the reference's
    steps run op by op."""
    jax = pytest.importorskip("jax")
    from repro import configs as jconfigs
    from repro.core.quant import QuantConfig as JQ
    from repro.kernels import autotune as jautotune
    from repro.models import lm as jlm
    from repro.serve import engine as jengine
    from repro.serve import prepare as jprepare
    from repro_torch import bridge
    from repro_torch.serve import engine as tengine

    kw = dict(param_dtype="float32", compute_dtype="float32")
    jcfg = jconfigs.get_config("stablelm-1.6b", reduced=True).replace(
        quant=JQ(enabled=True, w_bits=2, a_bits=2, kv_bits=4), **kw)
    tcfg = tconfigs.get_config("stablelm-1.6b", reduced=True).replace(
        quant=TQ(enabled=True, w_bits=2, a_bits=2, kv_bits=4), **kw)
    k = n = tcfg.d_model
    assert tcfg.num_heads * tcfg.resolved_head_dim == n
    chosen = "W2A2/int32xP4s8"
    old = jautotune.active_cache()
    jautotune.set_active_cache(jautotune.TuningCache(device="cpu", entries={
        jautotune.matmul_layout_key(k, n, 2, 2, backend="xla"):
            {"spec": chosen}}))
    _install({_layout_key(k, n): {"spec": chosen}})
    try:
        jp = jlm.init_params(jax.random.PRNGKey(3), jcfg)
        tp = bridge.from_repro(jax.device_get(jp), device="cpu")
        jpk = jax.device_get(jprepare.prepare_serving_params(jp, jcfg))
        tpk = tprepare.prepare_serving_params(tp, tcfg, device="cpu")
        qj, qt = jpk["layers"][0]["attn"]["q"], tpk["layers"][0]["attn"]["q"]
        assert qt["w_packed"].dtype == torch.int32
        assert qt["w_packed"].shape[0] == k // 4
        n_leaves = 0
        for lj, lt in zip(jpk["layers"], tpk["layers"]):
            for block in ("attn", "mlp"):
                for name, nj in lj[block].items():
                    if not isinstance(nj, dict) or "w_packed" not in nj:
                        continue
                    wj = np.asarray(nj["w_packed"])
                    wt = lt[block][name]["w_packed"].numpy()
                    assert wj.dtype == wt.dtype and wj.tobytes() == \
                        wt.tobytes(), (block, name)
                    n_leaves += 1
        assert n_leaves == 7 * tcfg.num_layers and qj["w_packed"] is not None
        rng = np.random.default_rng(5)
        prompts = [rng.integers(0, tcfg.vocab_size, m).astype(np.int32)
                   for m in (6, 11, 3)]
        ecfg = dict(max_batch=2, max_len=32, prefill_chunk=4)

        def serve(module, cfg, params, **kw2):
            eng = module.ServingEngine(cfg, params,
                                       config=module.EngineConfig(**ecfg),
                                       **kw2)
            for i, p in enumerate(prompts):
                eng.submit(module.Request(i, p, max_new_tokens=5))
            return {r.uid: list(r.output) for r in eng.run_to_completion()}

        got = serve(tengine, tcfg, tp, device="cpu")
        with jax.disable_jit():
            want = serve(jengine, jcfg, jp)
    finally:
        jautotune.set_active_cache(old)
    assert got == want
