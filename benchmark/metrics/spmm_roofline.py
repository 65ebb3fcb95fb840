"""One multiply's byte floor over the device time of what one multiply
launches (the loop's ``Loop.MULTIPLY_SPAN``), in percent
(``spmm_roofline.<loop>``)."""

from benchmark.core.readers import roofline_pct


def read(run):
    return roofline_pct(run, run.multiply_span)
