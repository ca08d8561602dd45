"""The port's serving CLI (``repro_torch/launch/serve.py``) on the CPU: the
parser has the reference's flags, groups, choices and defaults plus
``--device``; ``EngineConfig.from_args`` gives the reference's fields on
the same flag lists, budget edge cases included; ``main`` serves the
reduced config, saves an ``--autotune`` cache where the environment
says, and serves tensor-parallel (speculative too) and through the
replica Router."""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

from repro.launch import serve as jserve  # noqa: E402
from repro.serve import config as jconfig  # noqa: E402
from repro_torch.kernels import autotune  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.serve import config as tconfig  # noqa: E402

torch.set_num_threads(2)

CPU = ["--arch", "stablelm-1.6b", "--reduced", "--device", "cpu"]


@pytest.fixture(autouse=True)
def empty_port_cache():
    """Pin the port's tuning cache empty (tests save only under
    tmp_path)."""
    old = autotune.active_cache()
    autotune.set_active_cache(autotune.TuningCache(device="cpu"))
    yield
    autotune.set_active_cache(old)


def _actions(parser):
    """{dest: (option strings, default, choices, type, required, group)}"""
    out = {}
    for group in parser._action_groups:
        for a in group._group_actions:
            if a.dest == "help":
                continue
            out[a.dest] = (tuple(a.option_strings), a.default,
                           tuple(a.choices) if a.choices else None, a.type,
                           a.required, group.title)
    return out


def test_parser_has_the_reference_flags_plus_device():
    ref, port = _actions(jserve.build_parser()), \
        _actions(tserve.build_parser())
    assert set(port) == set(ref) | {"device"}
    for dest, want in ref.items():
        got = port[dest]
        if dest == "arch":          # the ports' registries list the same
            assert got[0] == want[0] and set(got[2]) == set(want[2])
            continue
        assert got == want, dest
    assert port["device"][:3] == (("--device",), "cuda", ("cuda", "cpu"))


FLAG_LISTS = [
    [],
    ["--max-batch", "3", "--max-len", "96", "--prefill-chunk", "8"],
    ["--max-queue", "5", "--temperature", "0.7", "--top-k", "5"],
    ["--hbm-cache-budget-mb", "0.5"],
    ["--hbm-cache-budget-mb", "0"],
    ["--hbm-cache-budget-mb", "-1"],
    ["--hbm-cache-budget-mb", "1e-300"],          # rounds to 0 bytes
    ["--paged-kv", "--page-size", "8", "--no-prefix-sharing"],
    ["--speculative-k", "3", "--draft-w-bits", "1", "--draft-kv-bits", "4"],
    ["--speculative-k", "2", "--draft-kv-bits", "-1"],
    ["--autotune"],
    ["--no-packed"],
    ["--no-packed", "--autotune"],
    ["--max-batch", "0"],
]


@pytest.mark.parametrize("flags", FLAG_LISTS,
                         ids=[" ".join(f) or "defaults" for f in FLAG_LISTS])
def test_from_args_matches_the_reference(flags):
    argv = ["--arch", "stablelm-1.6b", *flags]
    outcome = {}
    for name, parser, cls in (
            ("ref", jserve.build_parser(), jconfig.EngineConfig),
            ("port", tserve.build_parser(), tconfig.EngineConfig)):
        try:
            outcome[name] = dataclasses.asdict(
                cls.from_args(parser.parse_args(argv)))
        except ValueError as e:
            outcome[name] = ("ValueError", str(e))
    assert outcome["port"] == outcome["ref"]


def test_autotune_needs_packed_and_is_no_longer_refused():
    assert tconfig.EngineConfig(autotune=True).autotune
    with pytest.raises(ValueError, match="requires packed=True"):
        tconfig.EngineConfig(autotune=True, packed=False)


def test_main_serves_the_reduced_config_and_prints_the_summary(capsys):
    rep = tserve.main([*CPU, "--requests", "3"])
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "3 requests, 24 generated tokens"
    assert out[1].startswith("prefill ") and "decode" in out[1] \
        and out[1].endswith("(--metrics for the full report)")
    assert rep["generated_tokens"] == 24 and rep["capacity"]["slots"] == 2


def test_autotune_saves_under_the_environments_path(tmp_path, monkeypatch,
                                                    capsys):
    path = tmp_path / "tuned.json"
    monkeypatch.setenv(autotune.ENV_CACHE, str(path))
    autotune.reset_active_cache()
    rep = tserve.main([*CPU, "--requests", "2", "--autotune", "--metrics"])
    out = capsys.readouterr().out
    assert f"autotune cache saved to {path}" in out
    assert path.exists() and rep["autotune"]["tuned"] > 0
    assert {p["source"] for p in rep["plans"]} == {"tuned"}
    # a later launch plans from the saved cache and tunes nothing
    autotune.reset_active_cache()
    again = tserve.main([*CPU, "--requests", "2", "--metrics"])
    assert again["autotune"] == {"cache": str(path),
                                 "entries": rep["autotune"]["entries"],
                                 "tuned": 0}
    assert {p["source"] for p in again["plans"]} == {"tuned"}


@pytest.mark.parametrize("flag", ["--model-parallel", "--data-parallel"])
def test_parallel_flags_above_one_raise(flag, capsys):
    """The parallel flags no longer raise: on the CPU (one device) the
    serving mesh clamps to 1x1 with a warning, the CLI serves, and the
    summary names the shard or replica count it really got."""
    with pytest.warns(UserWarning, match="clamping to"):
        rep = tserve.main([*CPU, "--requests", "3", flag, "2"])
    out = capsys.readouterr().out.splitlines()
    if flag == "--model-parallel":
        assert out[0] == "3 requests, 24 generated tokens " \
                         "(model-parallel x1)"
        assert rep["capacity"]["shard_plan"]["model_shards"] == 1
    else:
        assert out[0] == "3 requests, 24 generated tokens across 1 " \
                         "replicas (mesh {'data': 1, 'model': 1})"
        assert rep["fleet"]["replicas"] == 1
        assert rep["fleet"]["retired"] == 3


def test_data_parallel_serves_through_the_router(capsys):
    """``--data-parallel`` on an explicit (data=2, model=2) mesh of cpu
    devices: two 2-way tensor-parallel replicas behind the Router, the
    requests load-balanced over both, two sessions pinned."""
    from repro_torch.launch.mesh import ServingMesh
    rep = tserve.main([*CPU, "--requests", "4", "--data-parallel", "2",
                       "--model-parallel", "2", "--metrics"],
                      mesh=ServingMesh([["cpu", "cpu"], ["cpu", "cpu"]]))
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "4 requests, 32 generated tokens across 2 replicas " \
                     "(mesh {'data': 2, 'model': 2})"
    fleet = rep["fleet"]
    assert fleet["replicas"] == fleet["attached"] == 2
    assert fleet["retired"] == 4 and fleet["sessions"] == 2
    assert all(r["retired"] == 2 for r in rep["replica_reports"])
    cap = rep["capacity"]
    assert cap["fleet_slots"] == 4
    assert [c["shard_plan"]["model_shards"]
            for c in cap["replica_capacity"]] == [2, 2]


def test_speculative_k_with_model_parallel(capsys):
    """``--speculative-k 2 --model-parallel 2`` on an explicit two-device
    cpu mesh: one speculative engine, tensor-parallel two ways, its draft
    split as its target is."""
    from repro_torch.launch.mesh import ServingMesh
    rep = tserve.main([*CPU, "--requests", "3", "--speculative-k", "2",
                       "--model-parallel", "2", "--metrics"],
                      mesh=ServingMesh([["cpu", "cpu"]]))
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "3 requests, 24 generated tokens (model-parallel x2)"
    cap = rep["capacity"]
    assert cap["shard_plan"]["model_shards"] == 2
    assert cap["speculative"]["speculative_k"] == 2
    split = cap["speculative"]["draft_shard_param_bytes"]["split"]
    assert len(split) == 2 and split[0] == split[1] > 0
    assert rep["spec_cycles"] > 0


def test_main_serves_reduced_mixtral(capsys):
    """The sliding-window MoE decoder from the CLI: ring caches of
    min(max_len, window) rows, the prefill chunk clamped to 1, the experts
    counted in the param bytes."""
    rep = tserve.main(["--arch", "mixtral-8x7b", "--reduced", "--device",
                       "cpu", "--requests", "2", "--max-new-tokens", "4",
                       "--metrics"])
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "2 requests, 8 generated tokens"
    cap = rep["capacity"]
    assert cap["step_graphs"] is False and cap["paged"] is False
    assert rep["generated_tokens"] == 8
    assert {p["layer"].split("/")[1] for p in rep["plans"]} == {"attn"}


def test_main_serves_reduced_xlstm(capsys):
    """The attention-free recurrent stack from the CLI: per-slot mLSTM /
    sLSTM states, plans for the packed projections alone."""
    rep = tserve.main(["--arch", "xlstm-1.3b", "--reduced", "--device",
                       "cpu", "--requests", "3", "--max-new-tokens", "3",
                       "--metrics"])
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "3 requests, 9 generated tokens"
    cap = rep["capacity"]
    assert cap["paged"] is False and cap["step_graphs"] is False
    assert {p["layer"].split("/")[1] for p in rep["plans"]} \
        == {"mlstm", "slstm"}


def test_unsupported_arch_raises_through_check_supported():
    """Every LM config serves; the CNN, which is no LM, is refused."""
    with pytest.raises(NotImplementedError, match="CNN"):
        tserve.main(["--arch", "sparq-cnn", "--reduced", "--device", "cpu"])


@pytest.mark.parametrize("arch", ["qwen2-vl-2b", "seamless-m4t-medium"])
def test_main_serves_reduced_vlm_and_encdec(arch, capsys):
    """qwen2-vl text-only (t = h = w) and seamless decoder-only, as the
    reference CLI serves them: plans for the packed leaves (seamless's
    encoder and cross sublayers included), none for the float frontend
    projection."""
    rep = tserve.main(["--arch", arch, "--reduced", "--device", "cpu",
                       "--requests", "2", "--max-new-tokens", "3",
                       "--metrics"])
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "2 requests, 6 generated tokens"
    layers = {p["layer"].split("/")[0] for p in rep["plans"]}
    assert not any("frontend_proj" in p["layer"] for p in rep["plans"])
    if arch == "seamless-m4t-medium":
        assert "encoder" in layers
        assert any("/cross/" in p["layer"] for p in rep["plans"])


def test_default_device_is_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tserve.main(["--arch", "stablelm-1.6b", "--reduced"])
