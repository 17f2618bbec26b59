"""Set-up: process start to the first timed unit (imports, kernels built or
loaded, inputs and weights made, the cell's shapes warmed)."""


def read(run):
    return run.setup_s
