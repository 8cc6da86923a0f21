"""One-command real-data parity check against the Caffe-MNC reference — the
port's counterpart of ``tools/reference_parity.py``.

The day the VOC/SBD data and the released ``.caffemodel`` are on disk,
parity is one command:

    python3 -m mnc_tpu_torch.tools.reference_parity \\
        --sbd-root /path/to/sbd --caffemodel /path/to/mnc_model.caffemodel.h5

which runs the full import → test_net → AP-table pipeline as a subprocess
(``python3 -m mnc_tpu_torch.tools.test_net``, the command a user would
run), parses the printed mAP^r line and diffs it against the expected
reference numbers (BASELINE.md) within ``--tol`` (0.3 points).  Exit 0:
parity; 1: out of tolerance; 2: the pipeline failed.

``--dry-run`` proves the plumbing without the data: it builds a miniature
SBD tree (``GTinst`` / ``GTcls`` structs written by ``scipy.io.savemat``,
the same draws as the JAX tool's), runs the identical command path with
random weights on a 192×256 canvas, and exercises the parse and the diff
(expected := measured, so the dry run passes iff the pipeline runs end to
end).  The pictures are PNG bytes under the reference's ``.jpg`` names
(``utils/png.py``, which needs neither cv2 nor PIL), so they are lossless
where the JAX tool's are JPEG.  ``--fabricate proto|h5`` adds a full-size
seeded caffemodel (``tools/fabricate_caffemodel.py``) through the real
import path; ``h5`` needs ``h5py``.

Expected values default to the paper's 5-stage VGG-16 row (63.5 / 41.5);
``--released`` takes the recalled README released-model row (65.0 / 46.3,
low confidence), ``--expected AP50 AP70`` any other.  ``test_net`` runs on
``--device`` (the GPU unless ``--device cpu`` is given; this tool raises
without one).
"""

from __future__ import annotations

import argparse
import os
import os.path as osp
import re
import subprocess
import sys
import tempfile

REPO = osp.dirname(osp.dirname(osp.dirname(osp.abspath(__file__))))

PAPER_EXPECTED = {"0.5": 63.5, "0.7": 41.5}      # CVPR16 paper, 5-stage VGG-16
RELEASED_EXPECTED = {"0.5": 65.0, "0.7": 46.3}   # README recall, LOW confidence
MAP_LINE = re.compile(r"mAP\^r@0\.5 = ([0-9.]+)\s+mAP\^r@0\.7 = ([0-9.]+)")
# the dry run's canvas and working set: it proves the plumbing, not the speed
DRY_SET = ["STATIC.CANVAS", "[192,256]", "STATIC.TEST_PRE_NMS_TOP_N", "512",
           "TEST.RPN_PRE_NMS_TOP_N", "512", "TEST.RPN_POST_NMS_TOP_N", "64",
           "TEST.MAX_PER_IMAGE", "32"]


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description="reference parity check (PyTorch port)")
    ap.add_argument("--sbd-root", default=None,
                    help="SBD root (contains benchmark_RELEASE/dataset and "
                         "val.txt); default cfg.DATA_DIR/sbd")
    ap.add_argument("--caffemodel", default=None,
                    help="released reference weights (.caffemodel/.h5)")
    ap.add_argument("--npz", default=None, help="alternative: npz weights")
    ap.add_argument("--imdb", default="voc_2012_seg_val")
    ap.add_argument("--cfg", default="experiments/cfgs/mnc_5stage.yml")
    ap.add_argument("--tol", type=float, default=0.3,
                    help="max |measured - expected| in mAP points "
                         "(BASELINE.json target: 0.3)")
    ap.add_argument("--released", action="store_true",
                    help="diff against the released-model README row "
                         "(65.0/46.3 — LOW-confidence recall) instead of the "
                         "paper row (63.5/41.5)")
    ap.add_argument("--expected", nargs=2, type=float, default=None,
                    metavar=("AP50", "AP70"), help="override expected values")
    ap.add_argument("--cache", default="output/parity/detections.pkl")
    ap.add_argument("--dry-run", action="store_true",
                    help="run the identical pipeline on a generated "
                         "miniature SBD with random weights (plumbing proof)")
    ap.add_argument("--fabricate", choices=("proto", "h5"), default=None,
                    help="with --dry-run: fabricate a FULL-SIZE fake "
                         ".caffemodel (recalled layer names, VGG-16 shapes, "
                         "MASK_SIZE 28) and run the real import → "
                         "auto-config → test_net path against it")
    ap.add_argument("--fabricate-rename", nargs="*", default=[],
                    metavar="OLD=NEW",
                    help="misname layers in the fabricated file (rehearses "
                         "the shape-fallback / --remap seam)")
    ap.add_argument("--extra", nargs="*", default=[],
                    help="extra args passed through to test_net")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    return ap.parse_args(argv)


def build_mini_sbd(root: str, n_images: int = 4, hw=(96, 128)) -> list:
    """A miniature SBD tree under ``root``: ``GTinst`` / ``GTcls`` structs
    of two rectangles an image and a random picture, drawn from
    ``RandomState(0)`` in the JAX tool's order (so the arrays and the ids
    are its), the picture written as PNG bytes under ``img/<id>.jpg``
    (lossless, where the JAX tool writes JPEG); ``val.txt`` lists the ids.
    Returns the ids."""
    import numpy as np
    from scipy.io import savemat

    from mnc_tpu_torch.utils import png

    ds = osp.join(root, "benchmark_RELEASE", "dataset")
    for d in ("inst", "cls", "img"):
        os.makedirs(osp.join(ds, d), exist_ok=True)
    rs = np.random.RandomState(0)
    ids = []
    h, w = hw
    for i in range(n_images):
        index = f"2008_{i:06d}"
        ids.append(index)
        inst = np.zeros((h, w), np.uint8)
        clsm = np.zeros((h, w), np.uint8)
        for k in range(1, 3):
            y0, x0 = rs.randint(0, h - 40), rs.randint(0, w - 40)
            bh, bw = rs.randint(24, 40), rs.randint(24, 40)
            inst[y0:y0 + bh, x0:x0 + bw] = k
            clsm[y0:y0 + bh, x0:x0 + bw] = rs.randint(1, 21)
        savemat(osp.join(ds, "inst", f"{index}.mat"), {"GTinst": {"Segmentation": inst}})
        savemat(osp.join(ds, "cls", f"{index}.mat"), {"GTcls": {"Segmentation": clsm}})
        img = rs.randint(0, 255, (h, w, 3), dtype=np.uint8)
        png.imwrite(osp.join(ds, "img", f"{index}.jpg"), img)
    with open(osp.join(root, "val.txt"), "w") as f:
        f.write("\n".join(ids) + "\n")
    return ids


def fabricate(tmp: str, kind: str, rename) -> str:
    """A full-size seeded caffemodel (mask size 28, 21 classes) under
    ``tmp``, layers renamed by ``rename`` (OLD=NEW); its path.  ``h5``
    needs h5py."""
    from mnc_tpu_torch.tools.fabricate_caffemodel import fabricate_blobs
    from mnc_tpu_torch.utils.caffemodel import write_caffemodel, write_caffemodel_h5

    blobs = fabricate_blobs(mask_size=28, num_classes=21)
    for pair in rename:
        old, new = pair.split("=", 1)
        blobs[new] = blobs.pop(old)
    path = osp.join(tmp, "mnc_model.caffemodel")
    if kind == "h5":
        path += ".h5"
        write_caffemodel_h5(path, blobs)
    else:
        write_caffemodel(path, blobs)
    return path


def net_argv(args, sbd_root: str | None, dry: bool) -> list:
    """The arguments of ``mnc_tpu_torch.tools.test_net`` for this run."""
    argv = ["--imdb", args.imdb, "--stages", "5", "--cache", args.cache]
    set_cfgs = []
    if sbd_root:
        # the imdb resolves SBD under DATA_DIR/sbd: point DATA_DIR at the
        # PARENT so that an external tree needs no copying
        set_cfgs += ["DATA_DIR", osp.dirname(osp.abspath(sbd_root))]
        if osp.basename(osp.abspath(sbd_root)) != "sbd" and not dry:
            raise ValueError("--sbd-root must be a directory named 'sbd' (or symlink one)")
    if dry:
        set_cfgs += DRY_SET
    else:
        argv += ["--cfg", osp.join(REPO, args.cfg)]
    if args.device:
        argv += ["--device", args.device]
    if args.caffemodel:
        argv += ["--caffemodel", args.caffemodel]
    elif args.npz:
        argv += ["--npz", args.npz]
    if set_cfgs:
        argv += ["--set"] + set_cfgs
    return argv + list(args.extra)


def parse_map(stdout: str) -> tuple[float, float] | None:
    """test_net's ``mAP^r@0.5 = … mAP^r@0.7 = …`` line, in points (×100),
    or None where the output has none."""
    m = MAP_LINE.search(stdout)
    return None if m is None else (float(m.group(1)) * 100.0, float(m.group(2)) * 100.0)


def diff(measured: tuple[float, float], expected: dict, tol: float) -> tuple[list, bool]:
    """The report lines of measured (AP50, AP70) against ``expected``
    {"0.5", "0.7"} within ``tol`` points, and whether both are within it."""
    lines, ok = [], True
    for key, meas in zip(("0.5", "0.7"), measured):
        exp = expected[key]
        delta = meas - exp
        status = "OK" if abs(delta) <= tol else "FAIL"
        ok &= status == "OK"
        lines.append(f"mAP^r@{key}: measured {meas:.2f}  expected {exp:.2f}  "
                     f"delta {delta:+.2f}  (tol {tol})  {status}")
    return lines, ok


def run_test_net(argv: list) -> tuple[float, float] | None:
    """test_net as a subprocess, its output echoed; the parsed (AP50, AP70)
    in points, or None (with the reason printed) where it failed."""
    cmd = [sys.executable, "-m", "mnc_tpu_torch.tools.test_net", *argv]
    print("+", " ".join(cmd), flush=True)
    proc = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True)
    sys.stdout.write(proc.stdout)
    sys.stderr.write(proc.stderr)
    if proc.returncode != 0:
        print(f"PARITY: test_net failed (rc={proc.returncode})")
        return None
    aps = parse_map(proc.stdout)
    if aps is None:
        print("PARITY: could not parse mAP line from test_net output")
    return aps


def dry_run(args, tmp: str) -> tuple[float, float] | None:
    """The dry run in the directory ``tmp``: the miniature tree, the
    fabricated caffemodel (``--fabricate``), test_net; its (AP50, AP70) or
    None."""
    root = osp.join(tmp, "sbd")
    build_mini_sbd(root)
    print(f"dry run: miniature SBD at {root}")
    args.cache = osp.join(tmp, "detections.pkl")
    if args.fabricate:
        # the full-dress rehearsal: full-size fabricated reference weights
        # through the real import path (wire parse → auto-config of
        # MASK_SIZE 28 from the blob shapes → load)
        try:
            args.caffemodel = fabricate(tmp, args.fabricate, args.fabricate_rename)
        except ImportError as e:
            print(f"PARITY: --fabricate {args.fabricate} cannot write the file: {e}")
            return None
        print(f"fabricated full-size reference weights: {args.caffemodel}")
    return run_test_net(net_argv(args, root, dry=True))


def main(argv=None) -> int:
    args = parse_args(argv)
    from mnc_tpu_torch.utils.device import resolve_device

    resolve_device(args.device)  # raises without a GPU unless --device cpu
    if args.dry_run:
        with tempfile.TemporaryDirectory(prefix="mini_sbd_") as tmp:
            aps = dry_run(args, tmp)
        if aps is None:
            return 2
        expected = {"0.5": aps[0], "0.7": aps[1]}  # self-diff: the machinery's proof
    else:
        if not (args.caffemodel or args.npz):
            print("need --caffemodel or --npz (or --dry-run)")
            return 2
        try:
            test_argv = net_argv(args, args.sbd_root, dry=False)
        except ValueError as e:
            print(f"PARITY: {e}")
            return 2
        aps = run_test_net(test_argv)
        if aps is None:
            return 2
        expected = (dict(zip(("0.5", "0.7"), args.expected)) if args.expected
                    else RELEASED_EXPECTED if args.released else PAPER_EXPECTED)

    print("\n=== reference parity ===")
    lines, ok = diff(aps, expected, args.tol)
    for line in lines:
        print(line)
    print("PARITY:", "PASS" if ok else "FAIL")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
