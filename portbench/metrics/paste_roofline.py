"""Kernel C's device time against its bound: the bytes of its hats and soft
masks read once and its bool canvases written once
(``portbench.flops.paste_bytes``, one call a request) at the card's HBM
bandwidth, over the device time of the kernels named ``paste_extent*`` and
``paste_band*`` in the trace, in percent."""

from portbench.flops import paste_bytes

KERNELS = ("paste_extent", "paste_band")


def read(ctx):
    if ctx.trace is None or ctx.n_traced == 0:
        return None
    dev_s = ctx.trace.kernels_s(KERNELS)
    if dev_s <= 0:
        return None
    calls = ctx.n_traced * (1)
    bound_s = calls * paste_bytes(ctx.net, ctx.post, ctx.canvases) / ctx.peaks["hbm_bytes"]
    return 100.0 * bound_s / dev_s
