"""Phase timers and profiler traces (counterpart of
``gptq_v2_tpu/utils.py``; the JAX compilation cache has no counterpart).

:class:`PhaseTimer` accumulates named wall-clock phases, each also a
``torch.profiler.record_function`` span, so a trace taken with
:func:`profile_trace` (``--profile-dir``) shows the phases on its host
timeline.
"""
from __future__ import annotations

import contextlib
import time
from pathlib import Path
from typing import Dict

import torch


@contextlib.contextmanager
def profile_trace(trace_dir: str | None):
    """Record a ``torch.profiler`` trace (CPU, and CUDA when a card is
    present) of the block into ``{trace_dir}/trace.json``; a no-op when
    ``trace_dir`` is falsy.  Yields a dict that on exit holds the trace's
    device time (``device_ms``, the sum of its CUDA ops' self time) and its
    count of CUDA ops (``device_ops``); it stays empty when not tracing."""
    summary: Dict[str, float] = {}
    if not trace_dir:
        yield summary
        return
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    Path(trace_dir).mkdir(parents=True, exist_ok=True)
    with profile(activities=acts) as prof:
        yield summary
    dev = [e for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    summary["device_ms"] = sum(e.self_device_time_total for e in dev) / 1e3
    summary["device_ops"] = sum(e.count for e in dev)
    prof.export_chrome_trace(str(Path(trace_dir) / "trace.json"))


class PhaseTimer:
    """``with timer("quantize"): ...`` accumulates wall seconds per phase;
    :meth:`summary` returns ``{phase: seconds}``."""

    def __init__(self) -> None:
        self.seconds: Dict[str, float] = {}

    @contextlib.contextmanager
    def __call__(self, phase: str):
        t0 = time.time()
        with torch.profiler.record_function(phase):
            yield
        self.seconds[phase] = self.seconds.get(phase, 0.0) + time.time() - t0

    def summary(self) -> Dict[str, float]:
        return {k: round(v, 3) for k, v in self.seconds.items()}
