"""Share of the traced window with no operation on the device
(``device_idle_pct.<loop>``)."""

from benchmark.core.readers import idle_pct


def read(run):
    return idle_pct(run)
