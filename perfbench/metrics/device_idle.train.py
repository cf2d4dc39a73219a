"""Share of the traced slice in which no kernel, copy or memset ran on the
card (%): one minus the union of their intervals over the slice."""

from perfbench.readers import idle_pct


def read(data):
    return idle_pct(data)
