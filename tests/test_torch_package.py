"""Package rules of the port: it imports neither JAX nor the JAX package (nor,
when its modules are imported, cv2, PIL or h5py, which the GPU machine lacks), its
entry points default to ``cuda`` and raise without a GPU, its kernel
wrappers take CUDA tensors only, and its cfg copy keeps every key of the JAX
package's cfg (so ``experiments/cfgs/*.yml`` load unchanged)."""

import glob
import os
import pkgutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import mnc_tpu_torch
import tests.torch_threads  # noqa: F401,E402  (torch threads per xdist worker)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _port_modules():
    return sorted(m.name for m in pkgutil.walk_packages(mnc_tpu_torch.__path__,
                                                        "mnc_tpu_torch."))


def test_port_imports_no_jax_and_no_mnc_tpu():
    """Run in a fresh interpreter: tests/conftest.py has imported jax here."""
    mods = _port_modules()
    assert {"mnc_tpu_torch.kernels._build", "mnc_tpu_torch.models.mnc",
            "mnc_tpu_torch.pipeline.inference", "mnc_tpu_torch.ops.block1",
            "mnc_tpu_torch.ops.losses", "mnc_tpu_torch.train.targets",
            "mnc_tpu_torch.train.optim", "mnc_tpu_torch.train.loop",
            "mnc_tpu_torch.data.synthetic", "mnc_tpu_torch.tools.train_net",
            "mnc_tpu_torch.profile_training", "mnc_tpu_torch.models.resnet",
            "mnc_tpu_torch.utils.weights", "mnc_tpu_torch.utils.caffemodel",
            "mnc_tpu_torch.utils.blob", "mnc_tpu_torch.data.eval_sds",
            "mnc_tpu_torch.data.synth_imdb", "mnc_tpu_torch.tools.test_net",
            "mnc_tpu_torch.tools.demo", "mnc_tpu_torch.tools.fabricate_caffemodel",
            "mnc_tpu_torch.utils.vis", "mnc_tpu_torch.models.cfm", "mnc_tpu_torch.data.loader",
            "mnc_tpu_torch.tools.prepare_mcg_maskdb", "mnc_tpu_torch.data.coco",
            "mnc_tpu_torch.data.pascal_voc", "mnc_tpu_torch.utils.png",
            "mnc_tpu_torch.tools.make_coco_synth", "mnc_tpu_torch.native",
            "mnc_tpu_torch.ops.mask_voting", "mnc_tpu_torch.ops.roi_warp",
            "mnc_tpu_torch.tools.e2e_synth_demo",
            "mnc_tpu_torch.tools.ablation_study", "mnc_tpu_torch.tools.reference_parity",
            "mnc_tpu_torch.tools.workingset_study", "mnc_tpu_torch.tools.crowd_study",
            "mnc_tpu_torch.tools.mask_fidelity_study"} <= set(mods)
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m in ('jax', 'flax', 'mnc_tpu', 'cv2', "
        "'PIL', 'h5py') or m.startswith(('jax.', 'flax.', 'mnc_tpu.', 'cv2.', 'PIL.', "
        "'h5py.')))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def test_entry_points_raise_without_gpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the no-GPU behaviour cannot be shown")
    from mnc_tpu_torch.models.mnc import MNC, MNCArch
    from mnc_tpu_torch.utils.device import resolve_device

    arch = MNCArch(canvas=(96, 128), fc_dim=8, mask_fc_dim=8, pre_nms_top_n=16,
                   post_nms_top_n=8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        MNC(arch)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        MNC(arch, train=True)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device("cuda")
    assert resolve_device("cpu").type == "cpu"


def test_train_net_refuses_to_run_without_gpu(tmp_path):
    """The training entry point runs on the card unless --device cpu is
    given: without a GPU it raises, it does not move to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the no-GPU behaviour cannot be shown")
    from mnc_tpu_torch import config as cfg
    from mnc_tpu_torch.tools import train_net

    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_net.main(["--imdb", "synthetic_4", "--iters", "1"])
    small = ["NET.FC_DIM", "32", "NET.MASK_FC_DIM", "16", "NET.COMPUTE_DTYPE", "float32",
             "NET.N_STAGES", "3", "STATIC.TRAIN_PRE_NMS_TOP_N", "64",
             "STATIC.TRAIN_POST_NMS_TOP_N", "16", "TRAIN.BATCH_SIZE", "16"]
    saved = cfg.cfg.clone()
    try:
        with pytest.warns(UserWarning, match="CAPPED"):
            rc = train_net.main(["--imdb", "synthetic_4", "--iters", "2", "--device", "cpu",
                                 "--out", str(tmp_path), "--set", *small])
    finally:
        cfg.cfg.clear()
        cfg.cfg.update(saved)
    assert rc == 0 and (tmp_path / "ckpt_00000002" / "train_state.npz").exists()


@pytest.mark.parametrize("tool", ["test_net", "demo", "e2e_synth_demo", "ablation_study",
                                  "reference_parity", "workingset_study", "crowd_study",
                                  "mask_fidelity_study"])
def test_eval_entry_points_refuse_to_run_without_gpu(tool, tmp_path):
    """test_net, demo, e2e_synth_demo, ablation_study and the four studies
    run on the card unless --device cpu is given."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the no-GPU behaviour cannot be shown")
    import importlib

    main = importlib.import_module(f"mnc_tpu_torch.tools.{tool}").main
    argv = {"demo": ["--synthetic", "--out", str(tmp_path)], "test_net": ["--imdb", "synthetic_4"],
            "e2e_synth_demo": ["--iters", "1", "--out", str(tmp_path)],
            "ablation_study": ["--smoke", "--append", str(tmp_path / "a.jsonl")],
            "reference_parity": ["--dry-run"],
            "workingset_study": ["--smoke", "--append", str(tmp_path / "w.jsonl")],
            "crowd_study": ["--smoke", "--append", str(tmp_path / "c.jsonl")],
            "mask_fidelity_study": []}[tool]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(argv)
    assert not any(tmp_path.iterdir())


def test_kernel_wrappers_refuse_cpu_tensors():
    """A wrapper never runs a plain version: a CPU tensor is an error there
    (the ops modules route CPU tensors to the plain versions instead)."""
    from mnc_tpu_torch import kernels

    with pytest.raises(ValueError, match="CUDA tensor"):
        kernels.roi_warp_cuda(torch.zeros(1, 4, 4, 8), torch.zeros(1, 2, 4), (2, 2), 0.25)
    with pytest.raises(ValueError, match="CUDA tensor"):
        kernels.nms_keep_cuda(torch.zeros(1, 5, 4), torch.ones(1, 5, dtype=torch.bool), 0.5)
    with pytest.raises(ValueError, match="CUDA tensor"):
        kernels.paste_binarize_cuda(torch.zeros(1, 4, 3), torch.zeros(1, 3, 3),
                                    torch.zeros(1, 3, 4), 0.4)
    with pytest.raises(ValueError, match="CUDA tensor"):
        kernels.roi_warp_bwd_cuda(torch.zeros(1, 2, 2, 2, 8), torch.zeros(1, 4, 4, 8),
                                  torch.zeros(1, 2, 4), 0.25)
    with pytest.raises(ValueError, match="CUDA tensor"):
        bf = torch.bfloat16
        kernels.block1_cuda(torch.zeros(1, 8, 8, 3, dtype=bf), torch.zeros(64, 32, dtype=bf),
                            torch.zeros(64, dtype=bf), torch.zeros(9, 64, 64, dtype=bf),
                            torch.zeros(64, dtype=bf))
    with pytest.raises(ValueError, match="CUDA tensor"):
        kernels.gemm_s8_cuda(torch.zeros(1, 4, 4, 16, dtype=torch.int8),
                             torch.zeros(8, 3, 3, 16, dtype=torch.int8), torch.ones(()),
                             torch.ones(8), None, 1, 1)
    with pytest.raises(ValueError, match="CUDA tensor"):
        kernels.quant_act_cuda(torch.zeros(4, 16, dtype=torch.bfloat16), per_row=True)
    with pytest.raises(ValueError, match="CUDA tensor"):
        kernels.act_scale_cuda(torch.zeros(4, 16, dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="CUDA tensor"):
        kernels.quant_with_scale_cuda(torch.zeros(4, 16, dtype=torch.bfloat16), torch.ones(()))
    assert kernels.launch_counts() == {"roi_warp_cuda": 0, "roi_warp_bwd_cuda": 0,
                                       "nms_keep_cuda": 0, "paste_binarize_cuda": 0,
                                       "block1_cuda": 0, "gemm_s8_cuda": 0,
                                       "quant_act_cuda": 0, "act_scale_cuda": 0,
                                       "quant_with_scale_cuda": 0}


def _keys(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_keys(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


def test_cfg_keeps_every_key_and_default():
    from mnc_tpu import config as jcfg
    from mnc_tpu_torch import config as cfg

    want, got = _keys(jcfg.cfg), _keys(cfg.cfg)
    assert set(got) == set(want)
    for k, v in want.items():
        if isinstance(v, np.ndarray):
            np.testing.assert_array_equal(got[k], v)
        else:
            assert got[k] == v, k
    assert cfg.COMPAT_ONLY_KEYS == jcfg.COMPAT_ONLY_KEYS


@pytest.mark.parametrize("path", sorted(glob.glob(os.path.join(REPO, "experiments",
                                                               "cfgs", "*.yml"))))
def test_experiment_yamls_load(path):
    from mnc_tpu_torch import config as cfg

    saved = cfg.cfg.clone()
    try:
        cfg.cfg_from_file(path)
        cfg.cfg_from_list(["TEST.VOTE_BOTH_PASSES", "True", "STATIC.CANVAS", "(480, 640)"])
        assert cfg.cfg.TEST.VOTE_BOTH_PASSES is True
        assert cfg.cfg.STATIC.CANVAS == (480, 640)
    finally:
        cfg.cfg.clear()
        cfg.cfg.update(saved)


def test_arch_and_post_from_cfg():
    from mnc_tpu.models.mnc import MNCArch as JArch
    from mnc_tpu.pipeline.inference import PostCfg as JPostCfg
    from mnc_tpu_torch.models.mnc import MNCArch
    from mnc_tpu_torch.pipeline.inference import PostCfg

    a, ja = MNCArch.from_cfg(), JArch.from_cfg()
    for f in ("canvas", "num_classes", "mask_size", "warp_hw", "pooled_hw", "n_stages",
              "fc_dim", "mask_fc_dim", "pre_nms_top_n", "post_nms_top_n",
              "rpn_nms_thresh", "rpn_min_size", "nms_chunk", "bbox_means", "bbox_stds",
              "suppress_untrainable_anchors", "trunk", "dual_pathway", "roi_conv5",
              "resnet_stride_in_3x3"):
        assert getattr(a, f) == getattr(ja, f), f
    assert a.compute_dtype == torch.bfloat16
    t, jt = MNCArch.from_cfg(train=True), JArch.from_cfg(train=True)
    for f in ("pre_nms_top_n", "post_nms_top_n", "rpn_nms_thresh", "rpn_min_size",
              "nms_chunk", "trunk_frozen", "fused_block1", "test_bbox_reg"):
        assert getattr(t, f) == getattr(jt, f), f
    assert (t.pre_nms_top_n, t.post_nms_top_n, t.trunk_frozen) == (12000, 2000, 2)
    assert not t.fused_block1 and not a.fused_block1

    p, jp = PostCfg.from_cfg(dets_per_class=16), JPostCfg.from_cfg(dets_per_class=16)
    for f in ("nms_thresh", "dets_per_class", "max_per_image", "use_mask_merge",
              "mask_merge_iou", "vote_top_k", "vote_boxes", "vote_both_passes",
              "score_thresh", "paste", "binarize_thresh", "vote_impl"):
        assert getattr(p, f) == getattr(jp, f), f
    assert a.remat_trunk == ja.remat_trunk is False


def test_from_cfg_honours_fused_block1():
    from mnc_tpu_torch import config as cfg
    from mnc_tpu_torch.models.mnc import MNCArch

    saved = cfg.cfg.clone()
    try:
        cfg.cfg_from_list(["NET.FUSED_BLOCK1", "True", "NET.TRUNK_FROZEN", "0"])
        a = MNCArch.from_cfg(train=True)
        assert a.fused_block1 and a.trunk_frozen == 0
    finally:
        cfg.cfg.clear()
        cfg.cfg.update(saved)
