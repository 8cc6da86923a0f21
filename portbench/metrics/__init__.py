"""Per-layer metric readers, one module per metric of ``BENCHMARK.json``.

Each module defines ``read(ctx) -> float | None``, where ``ctx`` is a
:class:`portbench.harness.LayerContext` of a traced run; a reader that
finds nothing to read returns ``None`` and the metric is left out.
"""

import importlib


def reader(name: str):
    """The ``read`` function of the metric ``name``."""
    return importlib.import_module(f"portbench.metrics.{name}").read
