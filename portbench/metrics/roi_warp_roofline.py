"""Kernel A's device time against its bound: the bytes of its inputs read
once and its output written once (``portbench.flops.roi_warp_bytes``, one
call a head pass) at the card's HBM bandwidth, over the device time of the
kernels named ``roi_warp_fwd*`` in the trace, in percent."""

from portbench.flops import roi_warp_bytes

KERNELS = ("roi_warp_fwd",)


def read(ctx):
    if ctx.trace is None or ctx.n_traced == 0:
        return None
    dev_s = ctx.trace.kernels_s(KERNELS)
    if dev_s <= 0:
        return None
    calls = ctx.n_traced * (2 if ctx.net["n_stages"] == 5 else 1)
    bound_s = calls * roi_warp_bytes(ctx.net, ctx.canvases) / ctx.peaks["hbm_bytes"]
    return 100.0 * bound_s / dev_s
