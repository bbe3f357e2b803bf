"""The share of the card's idle time in the traced window that falls
while the host is inside the fused engine's step (its span engine.step),
%: the idle time the step's own host code leaves, against that of the
caller around it."""
from benchmark.metrics._spans import idle_in_step_pct


def read(trace):
    return idle_in_step_pct(trace)
