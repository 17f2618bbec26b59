"""The MoE layers whole: the routed and the shared experts' FLOPs
(cost_afmoe.moe_flops, 6·d·moe_intermediate_size for each of a token's
experts and the shared ones, every MoE layer) at the card's bf16 peak over
the device time launched in the program's ``repro:moe`` ranges and those
inside them (routing, the grouped products, the combine, the shared
experts)."""
from perfbench import cost_afmoe, ranges
from perfbench.readers import share, traced

RANGES = ("repro:moe", "repro:route", "repro:experts", "repro:combine", "repro:shared")


def read(run):
    secs = [ranges.seconds(run, r) for r in RANGES]
    if run.peaks is None or secs[0] is None:
        return None
    cfg = run.cell.config
    work = sum(cost_afmoe.moe_flops(cfg, u["batch"], u["seq"]) for _, u in traced(run))
    return share(work, run.peaks["bf16_flops"], sum(sum(s.values()) for s in secs))
