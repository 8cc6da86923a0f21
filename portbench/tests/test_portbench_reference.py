"""The reference against the port's plain CPU path, at a small size: every
parameter spec, configuration file and compared number agrees."""

import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from portbench import check, harness, weights
from portbench.tests.small import SEED, small

REPO = Path(__file__).resolve().parents[2]
CELLS = [w["name"] for w in harness.manifest()["workloads"]]


@pytest.mark.parametrize("cell", CELLS)
def test_float32_port_matches_the_reference(cell):
    """In f32 on the CPU the port's plain versions and the reference do the
    same arithmetic: every number compared is (near) zero."""
    res = harness.run(cell, SEED, 0.3, False, device="cpu", adjust=small("float32"))
    assert res["correct"]
    for k in check.NUMBERS:
        assert res["checks"][k]["value"] <= 1e-5, (k, res["checks"])


@pytest.mark.parametrize("cell", CELLS)
def test_param_spec_is_the_port_state_dict(cell):
    from mnc_tpu_torch.models.mnc import MNC

    _, config, traffic = harness.resolve(cell, harness.manifest())
    small("float32")(config, traffic)
    net = config["net"]
    state = weights.draw(net, SEED, "cpu", torch.float32)
    pipe = harness.build_system(net, config["post"], state, "cpu")
    assert isinstance(pipe.model, MNC)
    got = {k: tuple(v.shape) for k, v in pipe.model.state_dict().items()}
    assert got == {k: tuple(v.shape) for k, v in state.items()}
    for k, v in pipe.model.state_dict().items():
        assert torch.equal(v.float(), state[k].float()), k
    bn = [k for k in state if k.endswith(".bn3.scale")]
    assert all(state[k].abs().min() > 0 for k in bn)


def test_weights_depend_on_the_seed_alone():
    net = json.loads((REPO / "portbench/configs/vgg16_voc.json").read_text())["net"]
    net = dict(net, fc_dim=64, mask_fc_dim=32)
    a, b = weights.draw(net, SEED, "cpu"), weights.draw(net, SEED, "cpu")
    c = weights.draw(net, SEED + 1, "cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["trunk.conv1_1.weight"], c["trunk.conv1_1.weight"])


@pytest.mark.parametrize("name", ["vgg16_voc", "resnet101_coco_conv5"])
def test_configuration_file_is_what_the_port_reads_from_its_cfg(name):
    """The file's shapes are what the port's own ``from_cfg`` makes of the
    named cfg file and overrides (a fresh interpreter: the cfg is global)."""
    conf = json.loads((REPO / "portbench/configs" / f"{name}.json").read_text())
    code = f"""
import json, dataclasses
from mnc_tpu_torch.config import cfg_from_file, cfg_from_list
from mnc_tpu_torch.models.mnc import MNCArch
from mnc_tpu_torch.pipeline.inference import PostCfg
cfg_from_file({conf['cfg_file']!r})
over = {conf['overrides']!r}
cfg_from_list([x for k, v in over.items() for x in (k, v)])
a, p = MNCArch.from_cfg(), PostCfg.from_cfg()
print(json.dumps({{'arch': {{k: (str(v).replace('torch.', '') if k == 'compute_dtype' else v)
                            for k, v in dataclasses.asdict(a).items()}},
                  'post': dataclasses.asdict(p)}}))
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         check=True, timeout=300)
    got = json.loads(out.stdout.strip().splitlines()[-1])
    arch, post = got["arch"], got["post"]
    net = conf["net"]
    rename = {"stride_in_3x3": "resnet_stride_in_3x3", "int8": "int8_inference"}
    for k, v in net.items():
        want = arch[rename.get(k, k)]
        assert (list(want) if isinstance(want, (list, tuple)) else want) == v, k
    for k, v in conf["post"].items():
        assert post[k] == v, k
