"""Flash attention (K6) in an AFMoE prefill by the program's own range:
q·k and p·v over the visible pairs, windowed on the sliding layers and
causal on the full ones (cost_afmoe.flash_flops), at the card's bf16 peak
over the device time launched in ``repro:kernel:flash_attention``."""
from perfbench import cost_afmoe, ranges
from perfbench.readers import share, traced


def read(run):
    secs = ranges.seconds(run, "repro:kernel:flash_attention")
    if run.peaks is None or secs is None:
        return None
    cfg = run.cell.config
    work = sum(cost_afmoe.flash_flops(cfg, u["batch"], u["seq"]) for _, u in traced(run))
    return share(work, run.peaks["bf16_flops"], sum(secs.values()))
