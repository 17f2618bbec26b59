"""Flash attention by the program's own range: causal attention's FLOPs
(cost.flash_flops, every layer) at the card's bf16 peak over the device time
launched in ``repro:kernel:flash_attention`` (the call as the model makes
it).  The same share as ``k6_roofline.prefill``, without naming a kernel."""
from perfbench import cost, ranges
from perfbench.readers import share, traced


def read(run):
    secs = ranges.seconds(run, "repro:kernel:flash_attention")
    if run.peaks is None or secs is None:
        return None
    cfg = run.cell.config
    work = 0.0
    for _, u in traced(run):
        work += cfg["num_hidden_layers"] * cost.flash_flops(cfg, u["batch"], u["seq"])
    return share(work, run.peaks["bf16_flops"], sum(secs.values()))
