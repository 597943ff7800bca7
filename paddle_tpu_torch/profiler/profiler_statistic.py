"""Summary tables — port of ``paddle_tpu/profiler/profiler_statistic.py``.

Aggregates the host event buffer into an overview (time per category) and
a per-event table (calls, total / avg / min / max), sortable by
``SortedKeys``. The device side (kernels) is in the exported trace.
"""
from __future__ import annotations

from collections import defaultdict
from enum import Enum


class SortedKeys(Enum):
    CPUTotal = 0
    CPUAvg = 1
    CPUMax = 2
    CPUMin = 3
    GPUTotal = 4
    GPUAvg = 5
    GPUMax = 6
    GPUMin = 7


_UNITS = {"s": 1e9, "ms": 1e6, "us": 1e3, "ns": 1.0}


class _Stat:
    __slots__ = ("calls", "total", "mn", "mx")

    def __init__(self):
        self.calls = 0
        self.total = 0.0
        self.mn = float("inf")
        self.mx = 0.0

    def add(self, dur: float):
        self.calls += 1
        self.total += dur
        self.mn = min(self.mn, dur)
        self.mx = max(self.mx, dur)


def _collect(events):
    by_name = defaultdict(_Stat)
    by_cat = defaultdict(_Stat)
    for ev in events:
        dur = ev.end_ns - ev.start_ns
        by_name[(ev.category, ev.name)].add(dur)
        by_cat[ev.category].add(dur)
    return by_name, by_cat


_SORT_KEY = {
    SortedKeys.CPUTotal: lambda s: s.total,
    SortedKeys.CPUAvg: lambda s: s.total / max(s.calls, 1),
    SortedKeys.CPUMax: lambda s: s.mx,
    SortedKeys.CPUMin: lambda s: s.mn,
}


def _fmt_row(cols, widths):
    return "  ".join(str(c).ljust(w) for c, w in zip(cols, widths))


def gen_summary_tables(events, time_unit: str = "ms", sorted_by=None) -> str:
    if not events:
        return "No profiler events recorded."
    div = _UNITS.get(time_unit, 1e6)
    key = _SORT_KEY.get(sorted_by or SortedKeys.CPUTotal,
                        _SORT_KEY[SortedKeys.CPUTotal])
    by_name, by_cat = _collect(events)

    lines = []
    # overview: per-category totals
    lines.append("---- Overview Summary ----")
    widths = (28, 10, 14)
    lines.append(_fmt_row(("Category", "Calls", f"Total({time_unit})"), widths))
    for cat, st in sorted(by_cat.items(), key=lambda kv: -kv[1].total):
        lines.append(_fmt_row(
            (cat, st.calls, f"{st.total / div:.3f}"), widths))
    lines.append("")

    # per-event table
    lines.append("---- Event Summary ----")
    widths = (40, 8, 12, 12, 12, 12)
    lines.append(_fmt_row(
        ("Name", "Calls", f"Total({time_unit})", f"Avg({time_unit})",
         f"Max({time_unit})", f"Min({time_unit})"), widths))
    for (cat, name), st in sorted(by_name.items(), key=lambda kv: -key(kv[1])):
        lines.append(_fmt_row(
            (name[:40], st.calls, f"{st.total / div:.3f}",
             f"{st.total / max(st.calls, 1) / div:.3f}",
             f"{st.mx / div:.3f}", f"{st.mn / div:.3f}"), widths))
    return "\n".join(lines)
