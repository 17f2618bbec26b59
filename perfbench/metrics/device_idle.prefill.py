"""The share of the traced window in which no operation ran on the card."""
from perfbench.readers import idle


def read(run):
    return idle(run)
