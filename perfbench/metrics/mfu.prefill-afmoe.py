"""An AFMoE prefill's model FLOPs (cost_afmoe.prefill_flops: every layer's
products, the router and the routed and shared experts among them,
attention over the windowed and causal visible pairs, the last position's
unembedding) over the traced window, against the card's bf16 peak."""
from perfbench import cost_afmoe
from perfbench.readers import share, traced


def read(run):
    if run.peaks is None or run.trace is None:
        return None
    cfg = run.cell.config
    work = sum(cost_afmoe.prefill_flops(cfg, u["batch"], u["seq"]) for _, u in traced(run))
    return share(work, run.peaks["bf16_flops"], run.trace.window_s)
