"""The program's own spans and counters of the traced window, for the
readers of the ``program_span`` and ``program_counter`` metrics.

While ``torch.profiler`` records the window, the port's instrumented
functions record their spans and counters into the profiler-bound
tracer of ``repro_torch.obs.trace``: each span's host interval, its
parent and, on the card, its CUDA-event time (``device_s``). The first
reader drains that tracer (``take_profiled``, after the window's last
synchronize) and keeps the dict on the run as ``run.program``, where
the readers after it find it (``Run`` has no such field: the attribute
is set on the instance). A program without that tracer gives None, and
so does every reader of it.
"""
from __future__ import annotations


def program(run):
    """The program's trace dict of the run's window, or None."""
    d = getattr(run, "program", None)
    if d is None and run.trace is not None:
        from repro_torch.obs import trace as obs_trace

        take = getattr(obs_trace, "take_profiled", None)
        d = take() if take is not None else None
        if d is not None:
            run.program = d
    return d


def device_share(run, names):
    """100 x the summed ``device_s`` of the spans named ``names`` over
    the window; None where no such span has a device time."""
    d = program(run)
    if d is None:
        return None
    times = [s["device_s"] for s in d["spans"]
             if s["name"] in names and s.get("device_s") is not None]
    if not times:
        return None
    return 100.0 * sum(times) / run.window_s


def counter(run, name):
    """The program's counter ``name`` over the window, or None."""
    d = program(run)
    return None if d is None else d["counters"].get(name)
