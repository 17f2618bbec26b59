"""What the metric readers (``metrics/*.py``) share.  A reader returns its
metric, or None where its run holds nothing to read (no traced window, no
unit of the kind it reads, a card without published peaks): the harness
then leaves the metric out of the line."""
from __future__ import annotations

K6 = ("flash_tc", "flash_fwd")                        # flash_attention*.cu


def rate(run, key: str) -> float | None:
    """All the work of the window over all its time."""
    return sum(u[key] for u in run.units) / run.window_s if run.units else None


def traced(run):
    """(index, unit) of each unit the profiler window covered."""
    if run.trace is None:
        return []
    return [(i, run.all_units[i]) for i in run.trace.units()]


def idle(run) -> float | None:
    if run.trace is None or run.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)


def share(work: float, peak_rate: float, seconds: float) -> float | None:
    """The least time of ``work`` at ``peak_rate`` over ``seconds``, in %."""
    return 100.0 * work / peak_rate / seconds if work > 0 and seconds > 0 else None
