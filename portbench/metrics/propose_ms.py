"""Device milliseconds a request of the program's ``mnc.propose`` span (RPN head,
proposals: sort, kernel B, top-K), timed by its CUDA events, over the
requests of the device-only traced window."""

from portbench.metrics.program_spans import read_device_ms


def read(ctx):
    return read_device_ms(ctx, "mnc.propose")
