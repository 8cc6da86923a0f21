"""Nothing the benchmark runs loads JAX or the JAX package, by whole
top-level names; the reference loads nothing of the port either."""

import subprocess
import sys
from pathlib import Path

from portbench import harness

REPO = Path(__file__).resolve().parents[2]


def test_top_level_names_compare_whole():
    mods = {"mnc_tpu_torch": 1, "mnc_tpu_torch.ops.nms": 1, "mnc_tpu_tools": 1, "jaxtyping": 1,
            "torch": 1}
    assert harness.forbidden_modules(mods) == []
    mods.update({"mnc_tpu": 1, "mnc_tpu.ops": 1, "jax.numpy": 1, "jaxlib": 1, "flax.linen": 1})
    assert harness.forbidden_modules(mods) == ["flax.linen", "jax.numpy", "jaxlib", "mnc_tpu",
                                               "mnc_tpu.ops"]


def _loaded_after(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys\nprint(sorted({m.split('.')[0]"
                          " for m in sys.modules}))"], cwd=REPO, capture_output=True, text=True,
                         check=True, timeout=600)
    return set(eval(out.stdout.strip().splitlines()[-1]))


def test_the_reference_imports_neither_jax_nor_the_port():
    tops = _loaded_after("import portbench.reference.mnc, portbench.check, portbench.flops, "
                         "portbench.weights, portbench.generator")
    assert not tops & {"jax", "jaxlib", "flax", "mnc_tpu", "mnc_tpu_torch"}


def test_a_whole_run_loads_no_jax():
    tops = _loaded_after(
        "from portbench import harness\n"
        "from portbench.tests.small import SEED, small\n"
        "harness.run('vgg16_voc.serve_b4', SEED, 0.2, False, device='cpu', adjust=small())")
    assert "mnc_tpu_torch" in tops
    assert not tops & {"jax", "jaxlib", "flax", "mnc_tpu"}
