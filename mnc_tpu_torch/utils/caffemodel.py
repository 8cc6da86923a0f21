"""Minimal .caffemodel (NetParameter protobuf) reader and writer — the
port's own copy of ``mnc_tpu/utils/caffemodel.py`` (no caffe, no JAX).

The reference ships trained weights as ``.caffemodel`` files (serialized
``caffe.NetParameter``).  This is a clean-room reader of just the fields a
weight import needs, written against the public caffe.proto schema
(BVLC/caffe, which caffe-mnc forks):

    NetParameter: layers = 2 (V1LayerParameter, the MNC-era format)
                  layer  = 100 (LayerParameter, the 1.0 format)
    V1LayerParameter: name = 4 (string), blobs = 6
    LayerParameter:   name = 1 (string), blobs = 7
    BlobProto: data = 5 (packed float), shape = 7 (BlobShape),
               legacy dims num/channels/height/width = 1..4 (varint)
    BlobShape: dim = 1 (packed int64)

Only those fields are decoded; everything else is skipped by wire type.
Returns {layer_name: [np.ndarray, ...]} with caffe-native shapes
((O, I, kH, kW) convs, (O, I) inner products).  ``load_mnc_caffemodel``
fills a param tree in the JAX package's layout (conv HWIO, Dense (in, out),
fc inputs flattened HWC); ``utils.checkpoint.state_dict_from_jax`` carries
it into the port.  ``h5py`` is imported only by the HDF5 functions.
"""

from __future__ import annotations

import struct

import numpy as np

_VARINT, _FIXED64, _LENGTH, _FIXED32 = 0, 1, 2, 5


def _read_varint(buf: memoryview, pos: int) -> tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _skip(buf: memoryview, pos: int, wire: int) -> int:
    if wire == _VARINT:
        _, pos = _read_varint(buf, pos)
        return pos
    if wire == _FIXED64:
        return pos + 8
    if wire == _FIXED32:
        return pos + 4
    if wire == _LENGTH:
        n, pos = _read_varint(buf, pos)
        return pos + n
    raise ValueError(f"unsupported wire type {wire}")


def _fields(buf: memoryview):
    """Yield (field_number, wire_type, value_or_span) over one message."""
    pos = 0
    n = len(buf)
    while pos < n:
        tag, pos = _read_varint(buf, pos)
        field, wire = tag >> 3, tag & 7
        if wire == _LENGTH:
            ln, pos = _read_varint(buf, pos)
            yield field, wire, buf[pos:pos + ln]
            pos += ln
        elif wire == _VARINT:
            v, pos = _read_varint(buf, pos)
            yield field, wire, v
        elif wire == _FIXED32:
            yield field, wire, buf[pos:pos + 4]
            pos += 4
        elif wire == _FIXED64:
            yield field, wire, buf[pos:pos + 8]
            pos += 8
        else:
            pos = _skip(buf, pos, wire)


def _parse_blob(buf: memoryview) -> np.ndarray:
    data_chunks: list[np.ndarray] = []
    shape: list[int] = []
    legacy = {}
    for field, wire, val in _fields(buf):
        if field == 5:  # data (float, usually packed)
            if wire == _LENGTH:
                data_chunks.append(np.frombuffer(val, dtype="<f4"))
            else:  # unpacked fixed32
                data_chunks.append(np.frombuffer(val, dtype="<f4"))
        elif field == 7 and wire == _LENGTH:  # shape: BlobShape
            for f2, w2, v2 in _fields(val):
                if f2 == 1:
                    if w2 == _LENGTH:  # packed int64
                        p = 0
                        mv = v2
                        while p < len(mv):
                            d, p = _read_varint(mv, p)
                            shape.append(d)
                    else:
                        shape.append(v2)
        elif field in (1, 2, 3, 4) and wire == _VARINT:  # legacy N, C, H, W
            legacy[field] = val
    data = (np.concatenate(data_chunks) if data_chunks
            else np.zeros((0,), np.float32))
    if not shape and legacy:
        shape = [legacy.get(i, 1) for i in (1, 2, 3, 4)]
        # legacy blobs always carry 4 dims; squeeze leading 1s for fc
        while len(shape) > 1 and shape[0] == 1:
            shape = shape[1:]
    if shape and int(np.prod(shape)) == data.size:
        return data.reshape(shape)
    return data


_HDF5_MAGIC = b"\x89HDF\r\n\x1a\n"


def read_caffemodel_h5(path: str) -> dict[str, list[np.ndarray]]:
    """Read a caffe HDF5 weights file (``Net::ToHDF5`` layout).

    The RELEASED MNC model is ``mnc_model.caffemodel.h5`` — caffe's HDF5
    format, not protobuf (``data/scripts/fetch_mnc_model.sh†``): a root
    group ``/data`` with one subgroup per layer, datasets ``"0"``, ``"1"``,
    … per blob (weights, bias).  Files without the ``data`` group (bare
    ``/<layer>/<i>``) are accepted too.
    """
    import h5py

    out: dict[str, list[np.ndarray]] = {}

    def walk(name: str, grp) -> None:
        # layer names may contain '/' (rpn_conv/3x3), which HDF5 stores as
        # nested groups — a "layer" is the group whose children are all
        # integer-named datasets (the blobs)
        keys = list(grp.keys())
        if keys and all(isinstance(grp[k], h5py.Dataset) and k.isdigit()
                        for k in keys):
            out[name] = [np.asarray(grp[k], np.float32)
                         for k in sorted(keys, key=int)]
            return
        for k in keys:
            if isinstance(grp[k], h5py.Group):
                walk(f"{name}/{k}" if name else k, grp[k])

    with h5py.File(path, "r") as f:
        walk("", f["data"] if "data" in f else f)
    return out


def read_caffemodel(path: str) -> dict[str, list[np.ndarray]]:
    """Parse a .caffemodel into {layer_name: [blob arrays]} (order kept).

    Dispatches on the file magic: HDF5 files (the released
    ``mnc_model.caffemodel.h5``) go through :func:`read_caffemodel_h5`,
    anything else is parsed as a serialized ``caffe.NetParameter``.
    """
    with open(path, "rb") as f:
        head = f.read(8)
    if head == _HDF5_MAGIC:
        return read_caffemodel_h5(path)
    with open(path, "rb") as f:
        buf = memoryview(f.read())
    out: dict[str, list[np.ndarray]] = {}
    try:
        items = list(_fields(buf))
    except (ValueError, IndexError) as e:
        raise ValueError(
            f"{path} is not a caffemodel (protobuf parse failed: {e})") from e
    for field, wire, val in items:
        if wire != _LENGTH or field not in (2, 100):
            continue
        name_field = 4 if field == 2 else 1  # V1LayerParameter vs LayerParameter
        blob_field = 6 if field == 2 else 7
        name = None
        blobs = []
        for f2, w2, v2 in _fields(val):
            if f2 == name_field and w2 == _LENGTH:
                name = bytes(v2).decode("utf-8")
            elif f2 == blob_field and w2 == _LENGTH:
                blobs.append(_parse_blob(v2))
        if name is not None and blobs:
            out[name] = blobs
    return out


# --------------------------------------------------------------------------- #
# Writers (the inverse wire format) — used by the parity-day full-dress
# rehearsal (mnc_tpu_torch/tools/fabricate_caffemodel.py) and to EXPORT a trained model
# back to the reference's weight formats.
# --------------------------------------------------------------------------- #


def _write_varint(v: int) -> bytes:
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _write_len_field(field: int, payload: bytes) -> bytes:
    return (_write_varint((field << 3) | _LENGTH)
            + _write_varint(len(payload)) + payload)


def _write_blob(arr: np.ndarray) -> bytes:
    arr = np.asarray(arr, np.float32)
    shape_payload = _write_len_field(
        1, b"".join(_write_varint(int(d)) for d in arr.shape))
    return (_write_len_field(7, shape_payload)
            + _write_len_field(5, arr.tobytes()))  # packed float data


def write_caffemodel(path: str, blobs: dict[str, list[np.ndarray]],
                     v1: bool = True) -> None:
    """Serialize {layer_name: [arrays]} as a caffe ``NetParameter``.

    ``v1=True`` emits the MNC-era ``layers`` (field 2, V1LayerParameter:
    name=4 blobs=6) format; ``v1=False`` the 1.0 ``layer`` (field 100:
    name=1 blobs=7) format.  Round-trips through :func:`read_caffemodel`.
    """
    layer_field, name_field, blob_field = (2, 4, 6) if v1 else (100, 1, 7)
    out = bytearray()
    for lname, arrs in blobs.items():
        payload = _write_len_field(name_field, lname.encode("utf-8"))
        for a in arrs:
            payload += _write_len_field(blob_field, _write_blob(a))
        out += _write_len_field(layer_field, bytes(payload))
    with open(path, "wb") as f:
        f.write(bytes(out))


def write_caffemodel_h5(path: str, blobs: dict[str, list[np.ndarray]]) -> None:
    """Write caffe's ``Net::ToHDF5`` layout (``/data/<layer>/<i>``)."""
    import h5py

    with h5py.File(path, "w") as f:
        data = f.create_group("data")
        for lname, arrs in blobs.items():
            grp = data.create_group(lname)
            for i, a in enumerate(arrs):
                grp.create_dataset(str(i), data=np.asarray(a, np.float32))


def infer_arch_overrides(blobs: dict[str, list[np.ndarray]]) -> dict:
    """Infer MNCArch fields from caffemodel blob shapes (auto-config).

    Resolves the survey's open conventions from the weights themselves —
    most importantly MASK_SIZE (21-in-code vs 28-in-paper, SURVEY §8.2):
    ``mask_pred`` is an inner product with M² output rows.  Only fields
    that are confidently derivable from an exact-name match are returned;
    a remap (if any) must be applied to ``blobs`` first.
    """
    out: dict = {}

    def w(name):
        b = blobs.get(name)
        return np.asarray(b[0]) if b else None

    mp = w("mask_pred")
    if mp is not None and mp.ndim == 2:
        m = int(round(mp.shape[0] ** 0.5))
        if m * m == mp.shape[0]:
            out["mask_size"] = m
    cs = w("cls_score")
    if cs is not None and cs.ndim == 2:
        out["num_classes"] = int(cs.shape[0])
    fc6 = w("fc6")
    if fc6 is not None and fc6.ndim == 2:
        out["fc_dim"] = int(fc6.shape[0])
    fm = w("fc6_maskest")
    if fm is not None and fm.ndim == 2:
        out["mask_fc_dim"] = int(fm.shape[0])
        if fm.shape[1] % 512 == 0:  # (mask_fc, warp·warp·512)
            hw = int(round((fm.shape[1] // 512) ** 0.5))
            if hw * hw * 512 == fm.shape[1]:
                out["warp_hw"] = hw
    return out


# --------------------------------------------------------------------------- #
# MNC weight import
# --------------------------------------------------------------------------- #

# caffe layer name → (params path under ["params"], kind)
# kind: "conv" (O,I,kH,kW → kH,kW,I,O), "fc" (O, CHW → HWC,O with spatial
# input), "fc_flat" (O,I → I,O, no spatial reorder)
_MNC_LAYER_MAP = {
    **{n: (("trunk", n), "conv") for n in (
        "conv1_1", "conv1_2", "conv2_1", "conv2_2",
        "conv3_1", "conv3_2", "conv3_3",
        "conv4_1", "conv4_2", "conv4_3",
        "conv5_1", "conv5_2", "conv5_3")},
    "rpn_conv/3x3": (("rpn_head", "rpn_conv"), "conv"),
    "rpn_conv_3x3": (("rpn_head", "rpn_conv"), "conv"),
    "rpn_cls_score": (("rpn_head", "rpn_cls_score"), "conv"),
    "rpn_bbox_pred": (("rpn_head", "rpn_bbox_pred"), "conv"),
    "fc6": (("classify_head", "fc6"), "fc"),
    "fc7": (("classify_head", "fc7"), "fc_flat"),
    "cls_score": (("classify_head", "cls_score"), "fc_flat"),
    "bbox_pred": (("classify_head", "bbox_pred"), "fc_flat"),
    # mask branch (⚠ names recalled from the public prototxt; unmatched
    # layers are reported, not silently dropped)
    "fc6_maskest": (("mask_head", "fc_mask"), "fc"),
    "mask_pred": (("mask_head", "mask_pred"), "fc_flat"),
}


def _dig(tree: dict, path: tuple[str, ...]) -> dict | None:
    for p in path:
        if not isinstance(tree, dict) or p not in tree:
            return None
        tree = tree[p]
    return tree


def _convert_weight(w: np.ndarray, kind: str, dst: dict):
    """Convert one caffe blob to our layout. Returns (array, None) or
    (None, reason)."""
    if kind == "conv":
        if w.ndim != 4:
            return None, f"conv wants 4-d, got {w.shape}"
        return np.transpose(w, (2, 3, 1, 0)), None
    if w.ndim != 2:
        return None, f"fc wants 2-d, got {w.shape}"
    if kind == "fc":
        o, i = w.shape
        tgt_i = dst["kernel"].shape[0]
        if i != tgt_i:
            return None, f"in {i} != {tgt_i}"
        # infer (C, H, W) from the destination's HWC flatten
        # dst input is H*W*C with square H=W
        c = None
        for ch in (512, 1024, 2048, 256, 128):
            if i % ch == 0 and int(round((i // ch) ** 0.5)) ** 2 == i // ch:
                c = ch
                break
        if c is None:
            return None, f"cannot infer CHW of {i}"
        hw = int(round((i // c) ** 0.5))
        return (w.reshape(o, c, hw, hw).transpose(0, 2, 3, 1)
                .reshape(o, i).T), None
    return w.T, None  # fc_flat


def load_mnc_caffemodel(path: str, params: dict, strict: bool = False,
                        remap: dict[str, str] | None = None,
                        blobs: dict[str, list[np.ndarray]] | None = None) -> dict:
    """Import a reference .caffemodel into an MNC param tree.

    Converts conv kernels (O,I,kH,kW)→(kH,kW,I,O) and inner products
    (O,I)→(I,O), permuting spatially-flattened fc inputs from caffe's CHW
    order to our HWC order (the load-bearing subtlety: fc6 reads the
    7×7×512 pooled features, flattened in different axis orders).

    ``remap`` maps source layer names in the file to the canonical names of
    ``_MNC_LAYER_MAP`` (the ``--remap old=new`` escape hatch for the
    recalled-name seam, e.g. the mask-branch fc names).  After exact-name
    matching, any leftover weighted layer is **shape-matched**: if its
    converted weights fit exactly one still-unfilled destination, it is
    imported there with a loud note; ambiguous candidates are reported.

    Returns updated params; prints a report of matched/skipped layers.
    """
    import copy

    if blobs is None:
        blobs = read_caffemodel(path)
    if remap:
        unknown = [v for v in remap.values() if v not in _MNC_LAYER_MAP]
        if unknown:
            raise ValueError(
                f"--remap targets not in the known layer map: {unknown}; "
                f"known: {sorted(_MNC_LAYER_MAP)}")
        blobs = {remap.get(k, k): v for k, v in blobs.items()}
    params = copy.deepcopy(params)
    matched, skipped, mismatched, notes = [], [], [], []
    filled: set[tuple] = set()  # destination paths already written

    def try_import(lname, bs, path_keys, kind, tag=""):
        dst = _dig(params["params"], path_keys)
        if dst is None:
            skipped.append(f"{lname} (no {'/'.join(path_keys)} in model)")
            return False
        w = np.asarray(bs[0], np.float32)
        b = np.asarray(bs[1], np.float32) if len(bs) > 1 else None
        w, err = _convert_weight(w, kind, dst)
        if err is not None:
            mismatched.append(f"{lname}: {err}")
            return False
        if dst["kernel"].shape != w.shape:
            mismatched.append(
                f"{lname}: {w.shape} vs model {dst['kernel'].shape}")
            return False
        dst["kernel"] = w
        if b is not None and "bias" in dst and dst["bias"].shape == b.shape:
            dst["bias"] = b
        matched.append(lname + tag)
        filled.add(path_keys)
        return True

    leftovers = []
    for lname, bs in blobs.items():
        if not bs:
            continue
        if lname in _MNC_LAYER_MAP:
            path_keys, kind = _MNC_LAYER_MAP[lname]
            try_import(lname, bs, path_keys, kind)
        else:
            leftovers.append((lname, bs))

    # shape-based fallback for unmatched names (the day-one recalled-name seam)
    for lname, bs in leftovers:
        w = np.asarray(bs[0], np.float32)
        b = np.asarray(bs[1], np.float32) if len(bs) > 1 else None
        candidates = []
        for cname, (path_keys, kind) in _MNC_LAYER_MAP.items():
            if path_keys in filled:
                continue
            dst = _dig(params["params"], path_keys)
            if dst is None:
                continue
            conv, err = _convert_weight(w, kind, dst)
            if err is not None or dst["kernel"].shape != conv.shape:
                continue
            if b is not None and ("bias" not in dst
                                  or dst["bias"].shape != b.shape):
                continue
            candidates.append((cname, path_keys, kind))
        # unique by destination path (rpn_conv/3x3 + rpn_conv_3x3 alias)
        dests = {c[1] for c in candidates}
        if len(dests) == 1:
            cname, path_keys, kind = candidates[0]
            if try_import(lname, bs, path_keys, kind,
                          tag=f"→{cname} (shape-matched)"):
                notes.append(f"{lname} shape-matched to {cname}")
                continue
        if len(dests) > 1:
            skipped.append(f"{lname} (ambiguous shape match: "
                           f"{sorted(c[0] for c in candidates)}; use --remap)")
        else:
            skipped.append(lname)

    print(f"caffemodel import: {len(matched)} layers matched"
          + (f"; shape-matched: {notes}" if notes else "")
          + (f"; skipped {skipped}" if skipped else "")
          + (f"; MISMATCHED {mismatched}" if mismatched else ""))
    if strict and (skipped or mismatched):
        raise ValueError(f"caffemodel import incomplete: skipped={skipped} "
                         f"mismatched={mismatched}")
    return params
