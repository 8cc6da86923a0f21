"""Fabricate a full-size seeded MNC ``.caffemodel`` / ``.caffemodel.h5`` —
the port's counterpart of ``tools/fabricate_caffemodel.py`` (the same
layers, shapes and seeded values, written by the port's own writer).

The released weights (``mnc_model.caffemodel.h5``) are not in the repo and
nothing is downloaded, so this emits a file with the same layer-name set,
blob shapes and wire format — VGG-16 trunk + RPN + mask/classify heads under
the reference prototxt's names — filled with seeded random values.  Running
the import → auto-config → detect / test_net pipeline on it exercises every
step short of the numbers themselves.

    python3 -m mnc_tpu_torch.tools.fabricate_caffemodel out.caffemodel \\
        [--h5 out.h5] [--mask-size 28] [--num-classes 21] [--seed 0] \\
        [--rename OLD=NEW ...]

``--rename`` emits a layer under another name, to exercise the importer's
shape fallback and ``--remap``.
"""

from __future__ import annotations

import argparse

import numpy as np

# (name, out channels, in channels) of the 3x3 convs, caffe layout (O, I, kH, kW)
_VGG16_CONVS = [
    ("conv1_1", 64, 3), ("conv1_2", 64, 64),
    ("conv2_1", 128, 64), ("conv2_2", 128, 128),
    ("conv3_1", 256, 128), ("conv3_2", 256, 256), ("conv3_3", 256, 256),
    ("conv4_1", 512, 256), ("conv4_2", 512, 512), ("conv4_3", 512, 512),
    ("conv5_1", 512, 512), ("conv5_2", 512, 512), ("conv5_3", 512, 512),
]


def mnc_blob_shapes(mask_size=21, num_classes=21, warp_hw=14, fc_dim=4096,
                    mask_fc_dim=256, num_anchors=9, pool_window=2):
    """{layer_name: [weight_shape, bias_shape]} of the 5-stage VGG-16 MNC in
    caffe's layouts: conv (O, I, kH, kW), inner product (O, I) with
    CHW-flattened inputs."""
    pooled = warp_hw // pool_window
    shapes = {name: [(o, i, 3, 3), (o,)] for name, o, i in _VGG16_CONVS}
    shapes["rpn_conv/3x3"] = [(512, 512, 3, 3), (512,)]
    shapes["rpn_cls_score"] = [(2 * num_anchors, 512, 1, 1), (2 * num_anchors,)]
    shapes["rpn_bbox_pred"] = [(4 * num_anchors, 512, 1, 1), (4 * num_anchors,)]
    shapes["fc6_maskest"] = [(mask_fc_dim, warp_hw * warp_hw * 512), (mask_fc_dim,)]
    shapes["mask_pred"] = [(mask_size * mask_size, mask_fc_dim), (mask_size * mask_size,)]
    shapes["fc6"] = [(fc_dim, pooled * pooled * 512), (fc_dim,)]
    shapes["fc7"] = [(fc_dim, fc_dim), (fc_dim,)]
    shapes["cls_score"] = [(num_classes, fc_dim), (num_classes,)]
    shapes["bbox_pred"] = [(4 * num_classes, fc_dim), (4 * num_classes,)]
    return shapes


def fabricate_blobs(mask_size=21, num_classes=21, warp_hw=14, fc_dim=4096,
                    mask_fc_dim=256, seed=0, scale=0.01):
    """Seeded random blobs under the reference layer names (the same values
    as the JAX package's fabricator for the same arguments)."""
    rs = np.random.RandomState(seed)
    return {name: [rs.randn(*ws).astype(np.float32) * scale,
                   rs.randn(*bs).astype(np.float32) * scale]
            for name, (ws, bs) in mnc_blob_shapes(mask_size, num_classes, warp_hw, fc_dim,
                                                  mask_fc_dim).items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="write a seeded full-size MNC caffemodel")
    ap.add_argument("out", help=".caffemodel path (protobuf wire format)")
    ap.add_argument("--h5", default=None, help="also write caffe's HDF5 layout here")
    ap.add_argument("--mask-size", type=int, default=28)
    ap.add_argument("--num-classes", type=int, default=21)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--rename", nargs="*", default=[], metavar="OLD=NEW",
                    help="emit layer OLD under the name NEW")
    args = ap.parse_args(argv)

    from mnc_tpu_torch.utils.caffemodel import write_caffemodel, write_caffemodel_h5

    blobs = fabricate_blobs(mask_size=args.mask_size, num_classes=args.num_classes,
                            seed=args.seed)
    for pair in args.rename:
        old, new = pair.split("=", 1)
        blobs[new] = blobs.pop(old)
    write_caffemodel(args.out, blobs)
    n_params = sum(int(np.prod(a.shape)) for bs in blobs.values() for a in bs)
    print(f"wrote {args.out}: {len(blobs)} layers, {n_params / 1e6:.1f}M params "
          f"(mask_size={args.mask_size}, num_classes={args.num_classes})")
    if args.h5:
        write_caffemodel_h5(args.h5, blobs)
        print(f"wrote {args.h5} (caffe HDF5 layout)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
