"""The routed experts' grouped products: their FLOPs
(cost_afmoe.experts_flops, 6·d·moe_intermediate_size for each of a
token's experts, every MoE layer) at the card's bf16 peak over the device
time launched in the program's ``repro:experts`` ranges alone (self time:
the three grouped products and the SwiGLU between them).  Beside
``moe_roofline.prefill-afmoe`` it shows what routing, combine and the
shared experts cost."""
from perfbench import cost_afmoe, ranges
from perfbench.readers import share, traced


def read(run):
    secs = ranges.seconds(run, "repro:experts")
    if run.peaks is None or secs is None:
        return None
    cfg = run.cell.config
    work = sum(cost_afmoe.experts_flops(cfg, u["batch"], u["seq"]) for _, u in traced(run))
    return share(work, run.peaks["bf16_flops"], sum(secs.values()))
