"""The port's roofline (``repro_torch.roofline``) against
``repro.roofline.analysis``: ``model_flops`` equal for every arch x shape;
``roofline_terms`` / ``dominant_term`` / ``summarize_cell`` equal to the
reference's with ``repro.roofline.hw`` patched to the port's H100
constants; ``collective_bytes`` on the reference's own HLO lines; the
shard-join counter (``analysis.join_bytes``) over one two-shard decode
pass on the CPU, against the joins that pass must make; ``hw``'s
constants and ``bound_ms`` as ``chip_smoke.py`` has printed them."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs  # noqa: E402
from repro_torch.core.quant import QuantConfig  # noqa: E402
from repro_torch.launch import shapes as tshapes  # noqa: E402
from repro_torch.launch.mesh import ServingMesh  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.roofline import analysis, hw  # noqa: E402

torch.set_num_threads(2)

HLO = """
  %all-reduce.1 = bf16[16,4096]{1,0} all-reduce(%add.5), channel_id=1, replica_groups=[16,16]<=[256], use_global_device_ids=true, to_apply=%sum
  %ag = f32[256,1024]{1,0} all-gather(%p0), channel_id=2, replica_groups=[16,16]<=[256], dimensions={0}
  %rs = f32[16,64]{1,0} reduce-scatter(%p1), channel_id=3, replica_groups=[4,4]<=[16], to_apply=%sum
  %ags = (f32[16,1024]{1,0}, f32[256,1024]{1,0}) all-gather-start(%p2), channel_id=4, replica_groups=[16,16]<=[256], dimensions={0}
  %agd = f32[256,1024]{1,0} all-gather-done(%ags)
  %cp = s8[4,4]{1,0} collective-permute(%p3), source_target_pairs={{0,1}}
  %a2a = u32[8]{0} all-to-all(%p4), replica_groups=[2,4]<=[8]
"""


@pytest.fixture(autouse=True)
def empty_port_cache():
    from repro_torch.kernels import autotune
    old = autotune.active_cache()
    autotune.set_active_cache(autotune.TuningCache(device="cpu"))
    yield
    autotune.set_active_cache(old)


@pytest.fixture(scope="module")
def ref():
    pytest.importorskip("jax")
    from repro import configs as jconfigs
    from repro.launch import shapes as jshapes
    from repro.roofline import analysis as janalysis
    from repro.roofline import hw as jhw
    return jconfigs, jshapes, janalysis, jhw


@pytest.mark.parametrize("arch", configs.ARCH_NAMES)
def test_model_flops_equal(ref, arch):
    jconfigs, jshapes, janalysis, _ = ref
    for name in tshapes.SHAPES:
        got = analysis.model_flops(configs.get_config(arch),
                                   tshapes.SHAPES[name])
        want = janalysis.model_flops(jconfigs.get_config(arch),
                                     jshapes.SHAPES[name])
        assert got == want, (arch, name)


def test_terms_and_summary_equal_with_the_port_constants(ref, monkeypatch):
    _, _, janalysis, jhw = ref
    monkeypatch.setattr(jhw, "PEAK_FLOPS_BF16", hw.PEAK_FLOPS_BF16)
    monkeypatch.setattr(jhw, "HBM_BW", hw.HBM_BW)
    monkeypatch.setattr(jhw, "ICI_BW_PER_LINK", hw.LINK_BW)
    coll = janalysis.collective_bytes(HLO)
    for cost in ({"flops": 3.2e15, "bytes accessed": 9.5e10},
                 {"flops": 1e9, "bytes accessed": 4e12}, {},
                 {"flops": 0.0, "bytes accessed": 0.0}):
        for cb in (0, 123_456_789, 10 ** 13):
            got = analysis.roofline_terms(cost, cb, 256)
            want = janalysis.roofline_terms(cost, cb, 256)
            assert got == want
            assert analysis.dominant_term(got) == \
                janalysis.dominant_term(want)
        got = analysis.summarize_cell("a", "s", "16x16", 256, cost, coll,
                                      1.5e15)
        want = janalysis.summarize_cell("a", "s", "16x16", 256, cost, coll,
                                        1.5e15)
        assert got.keys() == want.keys()
        for k in got:
            if isinstance(want[k], float) and np.isnan(want[k]):
                assert np.isnan(got[k]), k
            else:
                assert got[k] == want[k], k


def test_collective_bytes_equal(ref):
    _, _, janalysis, _ = ref
    got = analysis.collective_bytes(HLO)
    assert got == janalysis.collective_bytes(HLO)
    assert got["counts"]["all-reduce"] == 1
    assert got["all-reduce"] == 16 * 4096 * 2
    assert got["all-gather"] == 256 * 1024 * 4 // 16 + \
        (16 + 256) * 1024 * 4 // 16 // 2
    assert got["reduce-scatter"] == 16 * 64 * 4 * 4
    assert got["collective-permute"] == 16 and got["all-to-all"] == 32
    assert got["total"] == sum(got[k] for k in analysis._COLLECTIVES)


def test_join_bytes_of_a_two_shard_decode_pass():
    """Every column-split Dense of a stablelm decode pass joins its two
    shards' columns, and the attention its two shards' heads: per layer q,
    k, v, the heads, o, gate, up and down, then the LM head -- all-gathers
    whose per-device operand is half the joined rows' bytes.  One shard
    joins nothing."""
    from repro_torch.serve.engine import EngineConfig, Request, \
        ServingEngine
    cfg = configs.get_config("stablelm-1.6b", reduced=True).replace(
        quant=QuantConfig(enabled=True, w_bits=2, a_bits=2,
                          lane_dtype="int16", kv_bits=4))
    params = lm.init_params(cfg, torch.Generator().manual_seed(3),
                            device="cpu")
    counted = {}
    for shards in (2, 1):
        eng = ServingEngine(cfg, params, device="cpu",
                            mesh=ServingMesh([["cpu"] * shards]),
                            config=EngineConfig(max_batch=3, max_len=48,
                                                prefill_chunk=4))
        eng.submit(Request(0, np.arange(1, 4, dtype=np.int32),
                           max_new_tokens=4))
        eng.step()                          # the prompt's chunk
        with analysis.join_bytes() as got:
            eng.step()                      # one decode pass
        counted[shards] = got
    rows, esize = 3, torch.empty((), dtype=getattr(
        torch, cfg.compute_dtype)).element_size()
    h, kvh, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    per_layer = (2 * h * hd + 2 * kvh * hd + 2 * cfg.d_model
                 + 2 * cfg.d_ff)
    whole = rows * (cfg.num_layers * per_layer + cfg.padded_vocab) * esize
    two = counted[2]
    assert two["counts"]["all-gather"] == 8 * cfg.num_layers + 1
    assert two["all-gather"] == whole // 2 == two["total"]
    assert two["all-reduce"] == 0
    assert counted[1]["total"] == 0
    assert set(two) == set(analysis.collective_bytes(""))


def test_constants_and_bound_as_chip_smoke_printed_them():
    """The SXM and PCIe peaks chip_smoke.py took bound_ms over (PERF.md §6:
    3.35 TB/s, 67 T f32, 989 T bf16, 1,979 T int8, 33.5 T int32)."""
    assert hw.card_peaks("NVIDIA H100 80GB HBM3") == {
        "hbm": 3.35e12, "f32": 67e12, "bf16": 989e12, "int8": 1979e12,
        "int32": 33.5e12}
    assert hw.card_peaks("NVIDIA H100 PCIe") == {
        "hbm": 2.0e12, "f32": 51e12, "bf16": 756e12, "int8": 1513e12,
        "int32": 25.6e12}
    assert hw.card_constants("NVIDIA H100 80GB HBM3")["variant"] == \
        "H100 SXM5 80GB"
    pcie = hw.card_constants("NVIDIA H100 PCIe")
    assert (pcie["variant"], pcie["link"], pcie["hbm_bytes"]) == \
        ("H100 PCIe 80GB", 300e9, 80e9)
    assert (hw.HBM_BW, hw.PEAK_FLOPS_BF16, hw.LINK_BW, hw.HBM_PER_CHIP) == \
        (3.35e12, 989e12, 450e9, 80e9)
    assert analysis.bound_ms(3.35e9, 0, 3.35e12, 67e12) == (1.0, "bytes")
    assert analysis.bound_ms(0, 1979e9, 3.35e12, 1979e12) == \
        (1.0, "operations")
    # K2's row in PERF.md §6: (m, kp, n) = (4, 1024, 2048) int16xP2s8,
    # 0.00126 ms (bytes): lanes of x and w, the int32 output
    t, by = analysis.bound_ms((4 * 1024 + 1024 * 2048) * 2 + 4 * 2048 * 4,
                              2 * 4 * 2048 * 2048, 3.35e12, 1979e12)
    assert by == "bytes" and round(t, 5) == 0.00126
