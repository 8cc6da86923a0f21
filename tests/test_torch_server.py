"""The port's HTTP front-end (``mnc_tpu_torch/pipeline/server.py``): every case
of ``tests/test_http_server.py`` against it, and ``decode_image`` against the
JAX package's on ``.npy`` bodies, on cv2-encoded PNG and JPEG bodies and on
malformed ones (equal arrays, bit for bit, and None where the JAX one gives
None).  One difference is on purpose: a ``.npy`` body that ``np.load``
cannot parse makes the JAX one raise (its handler then drops the
connection); the port's gives None, so the server answers 400."""

import io
import json
import threading
import time
import urllib.error
import urllib.request

import cv2
import numpy as np
import pytest

from mnc_tpu.pipeline.server import decode_image as j_decode_image
from mnc_tpu_torch.pipeline.server import MicroBatcher, decode_image, make_http_server


def _serve(srv):
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv


@pytest.fixture()
def server():
    calls = []

    def detect_fn(img):
        calls.append(img.shape)
        return {"instances": [{"box": [1.0, 2.0, 3.0, 4.0], "class_id": 1, "score": 0.9,
                               "shape": list(img.shape)}]}

    srv = _serve(make_http_server(detect_fn, host="127.0.0.1", port=0))
    yield srv, calls
    srv.shutdown()
    srv.server_close()


def _url(srv, path):
    return f"http://127.0.0.1:{srv.server_address[1]}{path}"


def _npy_bytes(arr):
    buf = io.BytesIO()
    np.save(buf, arr)
    return buf.getvalue()


def _post(srv, body):
    req = urllib.request.Request(_url(srv, "/detect"), data=body, method="POST")
    with urllib.request.urlopen(req, timeout=10) as r:
        return json.load(r)


@pytest.mark.parametrize("path", ["/healthz", "/health"])
def test_healthz(server, path):
    srv, _ = server
    with urllib.request.urlopen(_url(srv, path), timeout=10) as r:
        assert json.load(r) == {"status": "ok"}


def test_detect_npy_roundtrip(server):
    srv, calls = server
    img = np.random.RandomState(0).randint(0, 255, (30, 40, 3), np.uint8)
    assert _post(srv, _npy_bytes(img))["instances"][0]["shape"] == [30, 40, 3]
    assert calls == [(30, 40, 3)]


@pytest.mark.parametrize("body", [b"not an image", _npy_bytes(np.zeros((4, 4), np.uint8)),
                                  b"\x93NUMPY\x01\x00"])
def test_detect_bad_body_400(server, body):
    srv, calls = server
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(srv, body)
    assert e.value.code == 400 and calls == []


@pytest.mark.parametrize("method,path", [("GET", "/nope"), ("POST", "/nope")])
def test_unknown_path_404(server, method, path):
    srv, _ = server
    req = urllib.request.Request(_url(srv, path), method=method,
                                 data=b"x" if method == "POST" else None)
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(req, timeout=10)
    assert e.value.code == 404


def test_detect_fn_error_500():
    def boom(img):
        raise RuntimeError("kaboom")

    srv = _serve(make_http_server(boom, host="127.0.0.1", port=0))
    try:
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(srv, _npy_bytes(np.zeros((4, 4, 3), np.uint8)))
        assert e.value.code == 500
        assert "kaboom" in json.loads(e.value.read())["error"]
    finally:
        srv.shutdown()
        srv.server_close()


def test_exactly_one_detect_function():
    with pytest.raises(ValueError, match="exactly one"):
        make_http_server(host="127.0.0.1", port=0)
    with pytest.raises(ValueError, match="exactly one"):
        make_http_server(lambda im: {}, host="127.0.0.1", port=0,
                         batch_fn=lambda ims: [{}] * len(ims))


def test_decode_image_npy_shape_guard():
    assert decode_image(_npy_bytes(np.zeros((5, 5), np.uint8))) is None
    got = decode_image(_npy_bytes(np.zeros((5, 5, 3), np.uint8)))
    assert got is not None and got.shape == (5, 5, 3)


def _bodies():
    rs = np.random.RandomState(4)
    img = rs.randint(0, 256, (37, 53, 3)).astype(np.uint8)
    png = cv2.imencode(".png", img)[1].tobytes()
    jpg = cv2.imencode(".jpg", img)[1].tobytes()
    return {
        "npy uint8": _npy_bytes(img),
        "npy float (cast to uint8)": _npy_bytes(img.astype(np.float32) + 0.25),
        "png": png,
        "jpeg": jpg,
        "npy 2-d": _npy_bytes(img[..., 0]),
        "npy 4 channels": _npy_bytes(np.zeros((5, 5, 4), np.uint8)),
        "garbage": b"not an image",
        "truncated png": png[: len(png) // 2],
        "truncated jpeg header": jpg[:20],
    }


@pytest.mark.parametrize("name", list(_bodies()))
def test_decode_image_agrees_with_jax(name):
    body = _bodies()[name]
    got, want = decode_image(body), j_decode_image(body)
    if want is None:
        assert got is None
    else:
        assert got.dtype == np.uint8 and got.shape == want.shape
        np.testing.assert_array_equal(got, want)


def test_decode_image_malformed_npy_is_none_not_an_error():
    body = _npy_bytes(np.zeros((5, 5, 3), np.uint8))[:20]
    with pytest.raises(ValueError):
        j_decode_image(body)
    assert decode_image(body) is None


def test_micro_batcher_coalesces():
    """Concurrent submits coalesce into one batch_fn call; results map back
    to their submitters in order."""
    def batch_fn(imgs):
        time.sleep(0.05)  # hold the worker so submits pile up
        return [{"mean": float(np.mean(im))} for im in imgs]

    mb = MicroBatcher(batch_fn, max_batch=4, max_wait_ms=100)
    imgs = [np.full((2, 2, 3), v, np.uint8) for v in (10, 20, 30, 40, 50)]
    outs = [None] * len(imgs)

    def worker(i):
        outs[i] = mb.submit(imgs[i])

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(len(imgs))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=10)
    assert not any(t.is_alive() for t in threads)
    assert [o["mean"] for o in outs] == [10.0, 20.0, 30.0, 40.0, 50.0]
    assert max(mb.batch_sizes) > 1, mb.batch_sizes  # coalescing happened
    assert max(mb.batch_sizes) <= 4 and sum(mb.batch_sizes) == 5
    mb.close()


def test_micro_batcher_error_propagates():
    def boom(imgs):
        raise ValueError("nope")

    mb = MicroBatcher(boom, max_batch=2, max_wait_ms=1)
    with pytest.raises(ValueError):
        mb.submit(np.zeros((2, 2, 3), np.uint8))
    mb.close()


def test_micro_batcher_short_result_errors():
    """A batch_fn that returns fewer results than inputs errors every waiter
    of that batch, and strands nobody."""
    def short(imgs):
        return [{"ok": 1}] * (len(imgs) - 1) if len(imgs) > 1 else [{"ok": 1}]

    mb = MicroBatcher(short, max_batch=3, max_wait_ms=100)
    errs, outs = [], []

    def worker():
        try:
            outs.append(mb.submit(np.zeros((2, 2, 3), np.uint8)))
        except RuntimeError as e:
            errs.append(e)

    threads = [threading.Thread(target=worker) for _ in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=10)
    assert len(errs) + len(outs) == 3
    if max(mb.batch_sizes) > 1:
        assert errs and "results for" in str(errs[0])
    mb.close()


def test_micro_batcher_close_unblocks_and_rejects():
    mb = MicroBatcher(lambda imgs: [{}] * len(imgs), max_batch=2, max_wait_ms=1)
    assert mb.submit(np.zeros((2, 2, 3), np.uint8)) == {}
    mb.close()
    with pytest.raises(RuntimeError):
        mb.submit(np.zeros((2, 2, 3), np.uint8))


def test_http_server_batched_mode():
    """End-to-end: a batch_fn server answers concurrent POSTs, each with its
    own image's result."""
    def batch_fn(imgs):
        return [{"instances": [], "hw": list(im.shape[:2])} for im in imgs]

    srv = _serve(make_http_server(batch_fn=batch_fn, host="127.0.0.1", port=0, max_batch=4,
                                  max_wait_ms=50))
    results = [None] * 6

    def post(i):
        results[i] = _post(srv, _npy_bytes(np.zeros((10 + i, 20, 3), np.uint8)))

    threads = [threading.Thread(target=post, args=(i,)) for i in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=10)
    try:
        assert [r["hw"] for r in results] == [[10 + i, 20] for i in range(6)]
        assert sum(srv.batcher.batch_sizes) == 6
    finally:
        srv.batcher.close()
        srv.shutdown()
        srv.server_close()
