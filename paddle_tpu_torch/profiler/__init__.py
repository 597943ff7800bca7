"""Profiler — port of ``paddle_tpu/profiler/``.

Host ``RecordEvent`` ranges, the observability spans and the serving
engine's request lanes feed one event buffer (``record.py``); the
:class:`Profiler` facade opens recording windows on a scheduler, and
``export_chrome_tracing`` writes each window as one Chrome trace. With
``ProfilerTarget.GPU`` the window also runs ``torch.profiler`` over the
CUDA device, and the trace carries the device's kernels beside the host
ranges (see ``profiler.py``). ``Benchmark`` is the throughput timer.
"""
from .profiler import (Profiler, ProfilerState, ProfilerTarget,
                       export_chrome_tracing, export_protobuf,
                       make_scheduler)
from .profiler_statistic import SortedKeys
from .timer import Benchmark, benchmark
from .utils import RecordEvent, in_profiler_mode, load_profiler_result

__all__ = [
    "Profiler", "ProfilerState", "ProfilerTarget", "make_scheduler",
    "export_chrome_tracing", "export_protobuf", "RecordEvent", "Benchmark",
    "benchmark", "SortedKeys", "load_profiler_result", "in_profiler_mode",
]
