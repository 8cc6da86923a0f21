"""Device idle milliseconds a request while the host was inside the program's
``mnc.heads`` spans (both head passes, kernel A included), over the
device-only traced window."""

from portbench.metrics.program_spans import read_gap_ms


def read(ctx):
    return read_gap_ms(ctx, "mnc.heads")
