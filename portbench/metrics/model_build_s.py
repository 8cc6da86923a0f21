"""Host seconds of the program's ``mnc.build`` set-up span: all of
``MNC.__init__`` for the served model (layers on ``meta``, ``to_empty``, casts)."""

from portbench.metrics.program_spans import read_setup_s


def read(ctx):
    return read_setup_s(ctx, "mnc.build")
