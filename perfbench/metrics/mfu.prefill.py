"""The forward's model FLOPs (cost.prefill_flops: the layers' products,
causal attention at each batch's S, the last position's unembedding) over
the traced window, against the card's bf16 peak."""
from perfbench import cost
from perfbench.readers import share, traced


def read(run):
    if run.peaks is None or run.trace is None:
        return None
    cfg = run.cell.config
    work = sum(cost.prefill_flops(cfg, u["batch"], u["seq"]) for _, u in traced(run))
    return share(work, run.peaks["bf16_flops"], run.trace.window_s)
