"""The hybrid family's train step against the reference's
(``torch_train_reference.check_train_step``): jamba-1.5-large-398b
reduced (mamba and attention layers, MoE every other layer; 8-bit
moments, as its full config keeps them, and f32), remat 'block', two
microbatches, 8-token rows (the reference's selective scan runs step by
step op by op); and the CLI trainer."""

import pytest

torch = pytest.importorskip("torch")

import torch_train_cases as cases  # noqa: E402
import torch_train_reference as reference  # noqa: E402

ARCHS = ("jamba-1.5-large-398b",)


@pytest.fixture(autouse=True)
def empty_port_cache():
    """Pin the port's tuning cache empty."""
    from repro_torch.kernels import autotune
    old = autotune.active_cache()
    autotune.set_active_cache(autotune.TuningCache(device="cpu"))
    yield
    autotune.set_active_cache(old)


@pytest.mark.parametrize("case", cases.cases(ARCHS), ids=cases.case_id)
def test_train_step_matches_reference(case):
    reference.check_train_step(*case)


@pytest.mark.parametrize("name", ARCHS)
def test_cli_trains_and_checkpoints(tmp_path, name):
    cases.cli_trains(tmp_path, name)
