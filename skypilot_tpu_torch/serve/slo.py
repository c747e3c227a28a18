"""The cumulative-bucket histogram the serving metrics render.

Copy of ``fmt_le`` and ``Histogram`` from ``skypilot_tpu/serve/slo.py``
(the port imports nothing of the reference): a replica's ``/metrics``
text must stay in the Prometheus form that the serve controller's SLO
monitor parses, so the bucket math and the rendering are the
reference's, line for line.
"""
from __future__ import annotations

from typing import List, Sequence


def fmt_le(le: float) -> str:
    return '+Inf' if le == float('inf') else f'{le:g}'


class Histogram:
    """Cumulative-bucket histogram rendering the Prometheus text format."""

    def __init__(self, buckets: Sequence[float]) -> None:
        self.les = tuple(buckets)
        self.counts = [0] * len(self.les)
        self.total = 0.0
        self.n = 0

    def observe(self, value: float) -> None:
        for i, le in enumerate(self.les):
            if value <= le:
                self.counts[i] += 1
        self.total += value
        self.n += 1

    def render(self, name: str) -> List[str]:
        lines = [f'# TYPE {name} histogram']
        for i, le in enumerate(self.les):
            lines.append(
                f'{name}_bucket{{le="{fmt_le(le)}"}} {self.counts[i]}')
        lines.append(f'{name}_sum {self.total:.6f}')
        lines.append(f'{name}_count {self.n}')
        return lines
