"""Operations and bytes counted from shapes, against PERF.md's figures and
published counts."""

import json
from pathlib import Path

import pytest

from portbench import flops

CONFIGS = Path(__file__).resolve().parents[1] / "configs"


def _cfg(name):
    return json.loads((CONFIGS / f"{name}.json").read_text())


def test_roi_warp_bytes_at_four_by_304_rois():
    net = _cfg("vgg16_voc")["net"]
    assert flops.roi_warp_bytes(net, 4) == pytest.approx(254.5e6, rel=1e-3)


def test_paste_bytes_at_400_detections():
    c = _cfg("vgg16_voc")
    assert flops.paste_bytes(c["net"], c["post"], 4) == pytest.approx(318.9e6, rel=1e-3)
    assert flops.paste_bytes(c["net"], c["post"], 1) == pytest.approx(79.7e6, rel=1e-3)


def test_vgg16_trunk_at_224_is_the_published_15_3_gmac():
    net = dict(_cfg("vgg16_voc")["net"], canvas=[224, 224])
    assert flops.trunk_macs(net) == pytest.approx(15.35e9, rel=0.01)


def test_request_flops():
    vgg, rn = _cfg("vgg16_voc")["net"], _cfg("resnet101_coco_conv5")["net"]
    assert flops.request_flops(vgg, 4) == pytest.approx(2.361e12, rel=1e-3)
    # the conv5 head: 732 M multiply-adds a RoI, fc_mask 51 M, cls and bbox 0.8 M
    per_roi = flops.head_macs_per_roi(rn)
    assert per_roi == pytest.approx(732.2e6 + 200704 * 256 + 256 * 441 + 2048 * 405, rel=1e-3)
    assert flops.request_flops(rn, 4) == pytest.approx(4.627e12, rel=1e-3)
