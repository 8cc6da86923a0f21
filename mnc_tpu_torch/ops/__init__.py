"""Geometry, NMS, RoI warp, mask paste and voting — plain functions on
tensors.  Ops that the JAX package gave a Pallas kernel (``nms``,
``roi_warp``, ``masks``) launch the port's CUDA kernel for CUDA tensors and
run their plain PyTorch version for CPU tensors."""

from mnc_tpu_torch.ops.roi_warp import roi_pool  # noqa: F401
