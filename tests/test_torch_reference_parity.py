"""``mnc_tpu_torch/tools/reference_parity.py`` against the JAX package's
``tools/reference_parity.py``, on the CPU.

- ``--dry-run --device cpu``: the miniature SBD tree, ``test_net`` as a
  subprocess on a 192×256 canvas with random full-width VGG-16 weights, the
  parse and the self-diff: exit 0 and ``PARITY: PASS``; an unknown
  ``--imdb`` makes ``test_net`` fail: exit 2.
- The parse and the diff on captured ``test_net`` output (the subprocess
  replaced by the captured lines in both tools): the same report lines and
  the same exit code as the JAX tool (0 within the tolerance, 1 outside it,
  2 without an mAP line or on a failed ``test_net``), and ``parse_map``
  equal to the JAX tool's regex.
- ``build_mini_sbd``: the ``GTinst`` / ``GTcls`` arrays and the ids equal
  the JAX tool's (the same ``RandomState(0)`` draws); the pictures are PNG
  bytes of the drawn pixels, where the JAX tool writes JPEG.
"""

import contextlib
import io
import os
import subprocess
import sys

import numpy as np
import pytest

from mnc_tpu_torch.tools import reference_parity as P
import tests.torch_threads  # noqa: F401,E402  (torch threads per xdist worker)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def jax_tool():
    sys.path.insert(0, os.path.join(REPO, "tools"))
    try:
        import reference_parity as J
    finally:
        sys.path.pop(0)
    return J


def _port(argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = P.main(argv)
    return rc, buf.getvalue()


def test_dry_run_passes_on_the_cpu():
    rc, out = _port(["--dry-run", "--device", "cpu"])
    assert rc == 0, out[-3000:]
    assert out.strip().splitlines()[-1] == "PARITY: PASS"
    assert "dry run: miniature SBD at " in out and "WARNING: random weights" in out
    aps = P.parse_map(out)
    assert aps is not None and all(np.isfinite(aps))
    assert f"mAP^r@0.5: measured {aps[0]:.2f}  expected {aps[0]:.2f}  delta +0.00" in out


def test_unknown_imdb_exits_2():
    rc, out = _port(["--dry-run", "--device", "cpu", "--imdb", "no_such_imdb"])
    assert rc == 2
    assert "PARITY: test_net failed" in out


# captured test_net output: (its stdout, its return code)
CAPTURED = {
    "paper": ("AP for x = 0.6350\nmAP^r@0.5 = 0.6350  mAP^r@0.7 = 0.4150\n", 0),
    "within": ("mAP^r@0.5 = 0.6371  mAP^r@0.7 = 0.4129  AP^r@[.5:.95] = 0.3000\n", 0),
    "outside": ("mAP^r@0.5 = 0.6390  mAP^r@0.7 = 0.4150\n", 0),
    "no_line": ("Mean AP^r = 0.1000\n", 0),
    "failed": ("Traceback ...\n", 1),
}


@pytest.mark.parametrize("case", list(CAPTURED))
def test_parse_and_diff_match_the_jax_tool(jax_tool, monkeypatch, case, tmp_path):
    stdout, rc = CAPTURED[case]
    done = subprocess.CompletedProcess([], rc, stdout=stdout, stderr="")
    monkeypatch.setattr(jax_tool.subprocess, "run", lambda *a, **k: done)
    monkeypatch.setattr(P.subprocess, "run", lambda *a, **k: done)
    argv = ["--npz", str(tmp_path / "w.npz"), "--cache", str(tmp_path / "d.pkl")]
    monkeypatch.setattr(sys, "argv", ["reference_parity.py", *argv])
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf), pytest.raises(SystemExit) as e:
        jax_tool.main()
    want_rc, want = e.value.code, buf.getvalue()
    got_rc, got = _port([*argv, "--device", "cpu"])
    assert got_rc == want_rc == {"paper": 0, "within": 0, "outside": 1, "no_line": 2,
                                 "failed": 2}[case]
    # the same lines after test_net's command line (whose program differs)
    assert got.splitlines()[1:] == want.splitlines()[1:]
    m = jax_tool.re.search(r"mAP\^r@0\.5 = ([0-9.]+)\s+mAP\^r@0\.7 = ([0-9.]+)", stdout)
    aps = P.parse_map(stdout)
    assert (aps is None) == (m is None)
    if m:
        assert aps == (float(m.group(1)) * 100.0, float(m.group(2)) * 100.0)


def test_mini_sbd_equals_the_jax_tools(jax_tool, tmp_path):
    from scipy.io import loadmat

    from mnc_tpu_torch.utils import png

    ids = P.build_mini_sbd(str(tmp_path / "port" / "sbd"))
    jax_tool.build_mini_sbd(str(tmp_path / "jax" / "sbd"))
    read = {}
    for side in ("port", "jax"):
        root = tmp_path / side / "sbd"
        read[side] = (root / "val.txt").read_text()
        for index in ids:
            for kind, key in (("inst", "GTinst"), ("cls", "GTcls")):
                mat = loadmat(root / "benchmark_RELEASE" / "dataset" / kind / f"{index}.mat")
                read[side, index, kind] = mat[key]["Segmentation"][0][0]
    assert read["port"] == read["jax"] == "\n".join(f"2008_{i:06d}" for i in range(4)) + "\n"
    for index in ids:
        for kind in ("inst", "cls"):
            np.testing.assert_array_equal(read["port", index, kind], read["jax", index, kind])
        assert read["port", index, "inst"].max() > 0
    # the pixels: the draws after each image's two rectangles, stored losslessly
    rs = np.random.RandomState(0)
    for index in ids:
        for _ in range(2):
            rs.randint(0, 56), rs.randint(0, 88), rs.randint(24, 40), rs.randint(24, 40)
            rs.randint(1, 21)
        want = rs.randint(0, 255, (96, 128, 3), dtype=np.uint8)
        got = png.imread(str(tmp_path / "port" / "sbd" / "benchmark_RELEASE" / "dataset"
                             / "img" / f"{index}.jpg"))
        np.testing.assert_array_equal(got, want)
