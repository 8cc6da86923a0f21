"""On the card: the control, the port's own int8 path in place of bf16, at
the cell's own size, comes out not correct, and the program itself
correct.  Run on the machine with the card:

    python3 -m pytest -p no:cacheprovider -o addopts="" portbench/tests/test_portbench_control.py
"""

import pytest

from portbench import calibrate, check, harness

CELLS = [w["name"] for w in harness.manifest()["workloads"]]


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda"


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_and_program_passes(card, cell):
    import json

    limits = json.loads((harness.ROOT / "limits" / f"{cell}.json").read_text())["limits"]
    (_, ctrl, _), = calibrate.readings(cell, [2**31 + 501], 1.0, True, device=card)
    assert not check.verdict(ctrl, limits), ctrl
    (_, prog, _), = calibrate.readings(cell, [2**31 + 502], 1.0, False, device=card)
    assert check.verdict(prog, limits), prog
