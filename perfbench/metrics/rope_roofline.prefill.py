"""RoPE: the bytes it must move, q's and k's heads in and out in bf16
(4·(H + KV)·head_dim a token a layer), at the card's memory bandwidth over
the device time launched in the program's ``repro:rope`` ranges (self
time)."""
from perfbench import cost, ranges
from perfbench.readers import share, traced


def read(run):
    secs = ranges.seconds(run, "repro:rope")
    if run.peaks is None or secs is None:
        return None
    cfg = run.cell.config
    heads = cfg["num_attention_heads"] + cfg["num_key_value_heads"]
    per_token = 4 * heads * cost.head_dim(cfg) * cfg["num_hidden_layers"]
    work = 0.0
    for _, u in traced(run):
        work += per_token * u["batch"] * u["seq"]
    return share(work, run.peaks["hbm_bytes"], sum(secs.values()))
