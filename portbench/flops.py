"""Operations and bytes that a request needs, counted from the
configuration's shapes alone (not from what implements them).

Model FLOPs are 2 × the multiply-adds of every convolution and dense layer:
the trunk at the canvas, the RPN head at the feature map, and both passes
of the mask and classify heads over every proposal of every canvas.  A
kernel's bytes are its inputs read once and its output written once, in the
dtypes of its contract.
"""

from __future__ import annotations

from portbench.reference.mnc import RESNET_DEPTHS, VGG16_BLOCKS

_DTYPE_BYTES = {"bfloat16": 2, "float32": 4}


def _conv_macs(h, w, cin, cout, k, stride=1):
    oh, ow = -(-h // stride), -(-w // stride)
    return oh * ow * cin * cout * k * k, oh, ow


def _bottleneck_macs(h, w, cin, f, stride, project, stride_in_3x3=False):
    s1, s2 = (1, stride) if stride_in_3x3 else (stride, 1)
    m1, h1, w1 = _conv_macs(h, w, cin, f, 1, s1)
    m2, h2, w2 = _conv_macs(h1, w1, f, f, 3, s2)
    m3, _, _ = _conv_macs(h2, w2, f, 4 * f, 1)
    mp = _conv_macs(h, w, cin, 4 * f, 1, stride)[0] if project else 0
    return m1 + m2 + m3 + mp, h2, w2


def trunk_macs(net: dict) -> int:
    """Multiply-adds of the trunk on one canvas."""
    h, w = net["canvas"]
    total = 0
    if net["trunk"] == "vgg16":
        cin = 3
        for b, (block, cout) in enumerate(zip(VGG16_BLOCKS, (64, 128, 256, 512, 512))):
            for _ in block:
                total += _conv_macs(h, w, cin, cout, 3)[0]
                cin = cout
            if b < 4:
                h, w = h // 2, w // 2
        return total
    depths = RESNET_DEPTHS[int(net["trunk"][len("resnet"):])]
    m, h, w = _conv_macs(h, w, 3, 64, 7, 2)
    total += m
    h, w = -(-h // 2), -(-w // 2)  # the 3x3/2 max pool
    cin = 64
    for s, (n, f) in enumerate(zip(depths[:3], (64, 128, 256))):
        for i in range(n):
            m, h, w = _bottleneck_macs(h, w, cin, f, (1 if s == 0 else 2) if i == 0 else 1,
                                       i == 0, net["stride_in_3x3"])
            total += m
            cin = 4 * f
    return total


def feat_channels(net: dict) -> int:
    return 512 if net["trunk"] == "vgg16" else 1024


def rpn_macs(net: dict) -> int:
    fh, fw = net["canvas"][0] // net["feat_stride"], net["canvas"][1] // net["feat_stride"]
    a = len(net["anchor_scales"]) * len(net["anchor_ratios"])
    return fh * fw * 512 * (feat_channels(net) * 9 + 6 * a)


def head_macs_per_roi(net: dict) -> int:
    """Multiply-adds of one RoI through the mask head and the classify head."""
    p, m, c = net["warp_hw"], net["mask_size"], net["num_classes"]
    fc_in = p * p * feat_channels(net)
    total = fc_in * net["mask_fc_dim"] + net["mask_fc_dim"] * m * m
    if net["roi_conv5"]:
        depths = RESNET_DEPTHS[int(net["trunk"][len("resnet"):])]
        h = w = p
        cin = feat_channels(net)
        for i in range(depths[3]):
            mm, h, w = _bottleneck_macs(h, w, cin, 512, 2 if i == 0 else 1, i == 0,
                                        net["stride_in_3x3"])
            total += mm
            cin = 2048
        head_in = 2048
    else:
        total += (net["pooled_hw"] ** 2 * feat_channels(net) * net["fc_dim"]
                  + net["fc_dim"] * net["fc_dim"])
        head_in = net["fc_dim"]
    return total + head_in * 5 * c


def request_flops(net: dict, canvases: int) -> float:
    """Model FLOPs of one request of ``canvases`` canvases."""
    passes = 2 if net["n_stages"] == 5 else 1
    rois = canvases * net["post_nms_top_n"] * passes
    return 2.0 * (canvases * (trunk_macs(net) + rpn_macs(net))
                  + rois * head_macs_per_roi(net))


def roi_warp_bytes(net: dict, canvases: int) -> int:
    """Kernel A, one call: the feature map and the RoIs read, the warped
    RoIs written (features in the compute dtype, RoIs f32)."""
    e = _DTYPE_BYTES[net["compute_dtype"]]
    fh, fw = net["canvas"][0] // net["feat_stride"], net["canvas"][1] // net["feat_stride"]
    c, n, p = feat_channels(net), net["post_nms_top_n"], net["warp_hw"]
    return canvases * (fh * fw * c * e + n * 4 * 4 + n * p * p * c * e)


def paste_bytes(net: dict, post: dict, canvases: int) -> int:
    """Kernel C, one call over every detection of the request: the f32 row
    and column hats and soft masks read, the bool canvases written."""
    h, w = net["canvas"]
    m = net["mask_size"]
    k = min(post["max_per_image"], (net["num_classes"] - 1)
            * min(post["dets_per_class"], net["post_nms_top_n"]))
    n = canvases * k
    return n * (h * m * 4 + m * m * 4 + m * w * 4 + h * w)
