"""A run whose timed path is broken underneath comes out not correct: the
check sees each fault a serving cell can have.  The harness's look for a
card is skipped (the CPU, a small configuration in bf16, the cell's own
limits)."""

import pytest
import torch

from portbench import harness
from portbench.tests.small import SEED, small

CELLS = [w["name"] for w in harness.manifest()["workloads"]]


def half_the_batch(pipe):
    """The trunk computes half the canvases and hands their features on for
    the rest too."""
    trunk = pipe.model.trunk
    forward = trunk.forward

    def half(x):
        h = max(1, x.shape[0] // 2)
        y = forward(x[:h])
        return torch.cat([y] * (-(-x.shape[0] // h)))[:x.shape[0]]
    trunk.forward = half


def altered_answer(pipe):
    """One served detection's class changed where the post-processing
    produces it."""
    run_batch = pipe._run_batch

    def altered(*args, **kwargs):
        out = run_batch(*args, **kwargs)
        with torch.inference_mode():
            out["classes"][0, 0] = out["classes"][0, 0] % 4 + 1
        return out
    pipe._run_batch = altered


def altered_mask(pipe):
    """One served detection's canvas mask inverted where it is packed."""
    run_batch = pipe._run_batch

    def altered(*args, **kwargs):
        out = run_batch(*args, **kwargs)
        with torch.inference_mode():
            out["canvas_masks"][0, 0] = ~out["canvas_masks"][0, 0]
        return out
    pipe._run_batch = altered


def shifted_features(pipe):
    """The trunk's features off by a tenth."""
    trunk = pipe.model.trunk
    forward = trunk.forward
    trunk.forward = lambda x: forward(x) * 1.1


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    assert harness.run(cell, SEED, 0.2, False, device="cpu", adjust=small())["correct"]


@pytest.mark.parametrize("fault", [half_the_batch, altered_answer, altered_mask,
                                   shifted_features], ids=lambda f: f.__name__)
@pytest.mark.parametrize("cell", CELLS)
def test_fault_is_not_correct(cell, fault):
    res = harness.run(cell, SEED, 0.2, False, device="cpu", adjust=small(), tamper=fault)
    assert not res["correct"], res["checks"]
