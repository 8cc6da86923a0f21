"""Host seconds of the program's ``mnc.first_request`` set-up span: the served
pipeline's first ``_run_batch`` (kernel libraries loaded, cuDNN's first calls)."""

from portbench.metrics.program_spans import read_setup_s


def read(ctx):
    return read_setup_s(ctx, "mnc.first_request")
