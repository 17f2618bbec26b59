"""K6 (flash attention): causal attention's FLOPs (cost.flash_flops, every
layer) at the card's bf16 peak over K6's device time (kernels named in
readers.K6)."""
from perfbench import cost
from perfbench.readers import K6, share, traced


def read(run):
    if run.peaks is None:
        return None
    cfg = run.cell.config
    work = secs = 0.0
    for i, u in traced(run):
        work += cfg["num_hidden_layers"] * cost.flash_flops(cfg, u["batch"], u["seq"])
        secs += run.trace.device_s(i, K6)
    return share(work, run.peaks["bf16_flops"], secs)
