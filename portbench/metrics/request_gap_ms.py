"""Device idle milliseconds a request while the host was inside the program's
``mnc.request`` span (all of ``_run_batch``), over the device-only traced window."""

from portbench.metrics.program_spans import read_gap_ms


def read(ctx):
    return read_gap_ms(ctx, "mnc.request")
