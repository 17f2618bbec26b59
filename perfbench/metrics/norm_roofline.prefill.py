"""The norms (RMSNorm): the bytes a norm must move, a bf16 row in and out
(4·d a token), two a layer over every token plus the final norm over the
last position's rows, at the card's memory bandwidth over the device time
launched in the program's ``repro:norm`` ranges (self time)."""
from perfbench import ranges
from perfbench.readers import share, traced


def read(run):
    secs = ranges.seconds(run, "repro:norm")
    if run.peaks is None or secs is None:
        return None
    cfg = run.cell.config
    row = 4 * cfg["hidden_size"]
    work = 0.0
    for _, u in traced(run):
        work += row * (2 * cfg["num_hidden_layers"] * u["batch"] * u["seq"] + u["batch"])
    return share(work, run.peaks["hbm_bytes"], sum(secs.values()))
