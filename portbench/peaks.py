"""Published peaks of the cards the benchmark runs on (NVIDIA's data sheet,
SXM part, dense rates without sparsity, at the full power limit of 700 W)."""

from __future__ import annotations

PEAKS = {
    "H100": {"bf16_flops": 989e12, "f32_flops": 67e12, "hbm_bytes": 3.35e12},
}


def peaks_for(device_name: str) -> dict:
    """The peaks of the card whose name (``torch.cuda.get_device_name``)
    contains a key of :data:`PEAKS`; raises for a card not in the table."""
    for key, table in PEAKS.items():
        if key in device_name:
            return table
    raise KeyError(f"no peaks for {device_name!r}")
