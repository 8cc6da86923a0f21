"""Device milliseconds per request of the postprocess span (CUDA events at the
boundaries recorded by the harness's module hooks), averaged over the
requests of the traced run's window."""


def read(ctx):
    return ctx.span_ms("postprocess")
