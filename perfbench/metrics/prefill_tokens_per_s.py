"""Prompt tokens through Model.prefill a second over the whole window."""
from perfbench.readers import rate


def read(run):
    return rate(run, "tokens")
