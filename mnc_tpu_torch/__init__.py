"""mnc_tpu_torch — Multi-task Network Cascades in PyTorch, with CUDA kernels.

The PyTorch/CUDA port of ``mnc_tpu``.  It mirrors that package's layout so
each module's counterpart is easy to find, and imports nothing of it (nor of
JAX): the port keeps its own copies of what it needs.

    mnc_tpu_torch.config    — the cfg tree (same keys, YAML loaded lazily)
    mnc_tpu_torch.ops       — geometry, NMS, RoI warp, masks, voting, losses, block 1
    mnc_tpu_torch.models    — VGG-16 trunk, RPN / mask / classify heads, MNC
    mnc_tpu_torch.pipeline  — post-processing and the canvas-space server API
    mnc_tpu_torch.train     — targets, the solver, the multi-task loss and step
    mnc_tpu_torch.data      — the synthetic shapes dataset
    mnc_tpu_torch.tools     — entry points (``python3 -m ...tools.train_net``)
    mnc_tpu_torch.utils     — device normalization, the JAX weight bridge
    mnc_tpu_torch.kernels   — build, load and launch the CUDA kernels (csrc/)

Public functions keep the JAX package's layouts and padded shapes: NHWC
feature maps, ``rois (B, N, 4)`` with ``roi_valid``, NHWC flatten order into
the fc layers.  Every op that the JAX package gave a Pallas kernel has a
hand-written CUDA kernel here; a tensor on the CPU goes through the op's
plain PyTorch version instead.
"""

__version__ = "0.1.0"
