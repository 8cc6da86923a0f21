"""Model FLOPs a request needs (``portbench.flops``, from the configuration's
shapes) over the traced window's time per request at the card's peak in the
compute dtype, in percent."""

from portbench.flops import request_flops


def read(ctx):
    if ctx.trace is None or ctx.n_traced == 0:
        return None
    peak = ctx.peaks[{"bfloat16": "bf16_flops", "float32": "f32_flops"}[ctx.net["compute_dtype"]]]
    flops = request_flops(ctx.net, ctx.canvases) * ctx.n_traced
    return 100.0 * flops / (ctx.trace.window_s * peak)
