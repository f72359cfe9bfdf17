"""``correct`` comes out false for every fault a cell can have, and for the
control, on the tiny cells on the CPU: the harness runs as it does on the
card, with the timed path broken underneath."""

from __future__ import annotations

import pytest

from benchmark.tests.fixtures_bench import (  # noqa: F401
    run_tiny, tiny_bench, tiny_root, torch_threads)


@pytest.mark.parametrize("cell,fault", [
    ("tiny_clip", "state_unchanged"),  # the DiT step hands back its input
    ("tiny_clip", "answer_altered"),  # a frame altered where it is made
    ("tiny_train", "state_unchanged"),  # the optimizer moves nothing
    ("tiny_train", "half_batch"),  # half the rows left out
])
def test_a_planted_fault_is_not_correct(run_tiny, cell, fault):
    out = run_tiny(cell, fault=fault)
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("cell,variant", [
    ("tiny_clip", "int8-dit"),  # the program's W8A8 DiT in place of float32
    ("tiny_clip", "fp8-vae"),  # the reference with float8 VAE convolutions
    ("tiny_train", "fp8"),  # the reference in float8 in the program's place
])
def test_the_control_is_not_correct(run_tiny, cell, variant):
    out = run_tiny(cell, variant=variant)
    assert not out["correct"], out["checks"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell,variant", [
    ("5b_bf16_clip32", "fp8"),
    ("5b_bf16_clip32", "fp8-vae"),
    ("5b_train_s1", "fp8"),
])
def test_the_control_at_the_cells_size_is_not_correct(cell, variant):
    """On the card: the control at the cell's own size against its limits."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs the card")
    from benchmark import harness

    out = harness.run(cell, 2**31 + 4242, 0.0, False, device="cuda", variant=variant,
                      warm=False)
    assert not out["correct"], out["checks"]
