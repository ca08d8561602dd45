"""The dense family's train step against the reference's
(``torch_train_reference.check_train_step``): qwen1.5-32b (QKV bias; 8-bit
moments as its config keeps them, and f32), granite-3-8b (GQA, tied head)
and minicpm-2b, reduced, remat 'block', two microbatches; and the CLI
trainer for each (minicpm's default 'wsd' schedule)."""

import pytest

torch = pytest.importorskip("torch")

import torch_train_cases as cases  # noqa: E402
import torch_train_reference as reference  # noqa: E402

ARCHS = ("qwen1.5-32b", "granite-3-8b", "minicpm-2b")


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
