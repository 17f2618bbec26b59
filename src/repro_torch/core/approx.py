"""Approximate / progressive execution (paper §6.1.3).

Online-aggregation-style progressive evaluation: aggregates are computed one
row-block at a time; after each block the running estimate is re-scaled and a
CLT confidence interval is attached, so the user sees a result converge
instead of waiting for the full pass.  Works for sum/count/mean per group
(the paper's "produce an estimate of the first k groups" is the
``first_k_groups`` helper).

This is the immediate-feedback counterpart to the exact prefix computation in
``executor.evaluate_prefix`` — semantics change (estimates, not answers), in
exchange for latency proportional to the blocks consumed.

Each block's column comes to the host once; the running sums and the
interval are float64 host arithmetic, as in the reference, so the estimates
are the same numbers whatever device the blocks live on.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Iterator, Sequence

import numpy as np

from .frame import host
from .partition import PartitionedFrame

__all__ = ["Estimate", "progressive_aggregate", "first_k_groups"]

_Z95 = 1.96


@dataclasses.dataclass
class Estimate:
    value: float
    ci_low: float
    ci_high: float
    rows_seen: int
    rows_total: int
    final: bool

    @property
    def fraction(self) -> float:
        return self.rows_seen / max(1, self.rows_total)


def progressive_aggregate(pf: PartitionedFrame, column: Any,
                          func: str = "sum") -> Iterator[Estimate]:
    """Yield progressively refined estimates of an aggregate over ``column``.

    Block order is the frame's row order — for order-correlated data a
    production system would randomize block order first (online aggregation
    [35]); we keep frame order so the estimate composes with prefix semantics.
    """
    assert func in ("sum", "count", "mean")
    total_rows = pf.nrows
    pf1 = pf.repartition(col_parts=1)
    if pf1.row_parts == 0 or total_rows == 0:
        # zero-block / zero-row frame: the block loop would yield NOTHING,
        # so a caller draining until final=True never terminates.  Emit one
        # final exact estimate: the empty sum/count are 0, the empty mean is
        # undefined (NaN).
        value = float("nan") if func == "mean" else 0.0
        yield Estimate(value, value, value, 0, total_rows, True)
        return
    seen = 0
    vals_sum = 0.0
    vals_sumsq = 0.0
    vals_cnt = 0
    for i in range(pf1.row_parts):
        block = pf1.parts[i][0].induce()
        c = block.col(column)
        v = host(c.data).astype(np.float64)
        valid = host(c.valid_mask())
        v = v[valid]
        seen += block.nrows
        vals_sum += float(v.sum())
        vals_sumsq += float((v * v).sum())
        vals_cnt += int(v.size)
        final = i == pf1.row_parts - 1

        n = max(1, vals_cnt)
        mean = vals_sum / n
        var = max(0.0, vals_sumsq / n - mean * mean)
        se_mean = math.sqrt(var / n)
        if func == "mean":
            est, se = mean, se_mean
        elif func == "sum":
            scale = total_rows * (vals_cnt / max(1, seen))  # est. valid rows
            est, se = mean * scale, se_mean * scale
        else:  # count (valid rows)
            frac = vals_cnt / max(1, seen)
            est = frac * total_rows
            # CI denominator: the VALID-row count, consistently with the
            # n used for the mean/variance estimates above — the previous
            # max(1, seen) denominator understated the interval on sparse
            # (mostly-null) columns
            se = total_rows * math.sqrt(frac * (1 - frac) / max(1, vals_cnt))
        if final:
            if func == "mean":
                # the exact mean of zero valid rows is undefined, not the
                # running 0.0 the estimator would report
                est, se = (mean if vals_cnt else float("nan")), 0.0
            elif func == "sum":
                est, se = vals_sum, 0.0
            else:
                est, se = float(vals_cnt), 0.0
        yield Estimate(est, est - _Z95 * se, est + _Z95 * se, seen, total_rows, final)


def first_k_groups(pf: PartitionedFrame, key: Any, k: int) -> list:
    """§6.1.3: the approximate *structure* of a GROUP BY — the first k groups
    in input order, from the input prefix, without computing any aggregates
    ("placeholder" output: row-wise groups without values)."""
    pf1 = pf.repartition(col_parts=1)
    seen: list = []
    seen_set = set()
    for i in range(pf1.row_parts):
        block = pf1.parts[i][0].induce()
        for v in block.col(key).to_pylist():
            if v is not None and v not in seen_set:
                seen_set.add(v)
                seen.append(v)
                if len(seen) >= k:
                    return seen
    return seen
