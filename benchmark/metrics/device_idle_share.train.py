"""The share of the traced window in which no operation ran on the card,
in percent (device trace, busy time as the union of the operations'
intervals)."""

from benchmark.layers import idle_share


def read(run):
    return idle_share(run, "train")
