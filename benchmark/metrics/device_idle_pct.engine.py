"""The share of the traced window in which nothing ran on the card, %."""
from benchmark.metrics._common import idle_pct


def read(trace):
    return idle_pct(trace)
