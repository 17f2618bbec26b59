"""The MLP (SwiGLU): its three products' FLOPs, gate, up and down at
2·d·ff each (6·d·ff a token a layer), at the card's bf16 peak over the
device time launched in the program's ``repro:mlp`` ranges (self time: the
GEMMs and the SiLU chain between them)."""
from perfbench import ranges
from perfbench.readers import share, traced


def read(run):
    secs = ranges.seconds(run, "repro:mlp")
    if run.peaks is None or secs is None:
        return None
    cfg = run.cell.config
    per_token = 6 * cfg["hidden_size"] * cfg["intermediate_size"] * cfg["num_hidden_layers"]
    work = 0.0
    for _, u in traced(run):
        work += per_token * u["batch"] * u["seq"]
    return share(work, run.peaks["bf16_flops"], sum(secs.values()))
