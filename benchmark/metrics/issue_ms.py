"""Host milliseconds to issue one multiply, inside the span the loop
marks its multiply with (``Loop.MULTIPLY_SPAN``: a chain body, or the
``spmm`` callable of a PageRank iteration), with the device out of the
way (``issue_ms.<loop>``)."""

from benchmark.core.readers import issue_ms


def read(run):
    return issue_ms(run, run.multiply_span)
