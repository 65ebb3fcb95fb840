"""Judge a chain of multiplies ``x_{i+1} = A x_i`` against float64.

Two numbers, each the largest elementwise error of a multiply's output
relative to ``|A| |x|`` (the size its rounding scales with):

* ``start_err``: the outputs of the window's first bodies against
  ``A^j v0``, worked out here from the seed alone: encode, the first
  bodies and decode.
* ``step_err``: each sampled body later in the window against ``A x``
  for its own input state ``x``, as the program held it (decoded). A
  chain of tens of thousands of multiplies cannot be followed in float64
  in a run's time, so these steps start from the program's state; the
  start is checked by ``start_err`` on its own.
"""

from __future__ import annotations

import numpy as np

from .generate import generate_fat_vector
from .operators import as_scipy, operator

__all__ = ["judge"]


def _rel_err(y, ref, scale) -> float:
    scale = np.where(scale > 0, scale, 1.0)
    return float(np.max(np.abs(np.asarray(y, np.float64) - ref) / scale))


def judge(config: dict, traffic: dict, seed: int, samples: dict) -> dict:
    """``samples``: ``start`` (decoded outputs of bodies 0, 1, ...) and
    ``steps`` (``(index, x_in, y_out)`` decoded). Returns one ``{name:
    reading}`` per judged body."""
    a = as_scipy(operator(config, seed))
    abs_a = abs(a)
    x = generate_fat_vector(a.shape[1], traffic["k"], seed)
    out = []
    for y in samples["start"]:
        scale = abs_a @ np.abs(x)
        x = a @ x
        out.append({"start_err": _rel_err(y, x, scale)})
    for _, x_in, y in samples["steps"]:
        x_in = np.asarray(x_in, np.float64)
        out.append({"step_err": _rel_err(y, a @ x_in, abs_a @ np.abs(x_in))})
    return out


def control(inputs, device):
    """The loop's ``wrap`` that puts the TF32 control in place of the
    program's encode, body and decode (the state a plain float32 ``n x
    k`` array)."""
    from .control import tf32_multiply

    multiply = tf32_multiply(inputs.matrix, device)

    def wrap(enc, body, dec):
        return ((lambda v, op: v.float()), (lambda x, op: multiply(x)),
                (lambda x, op: x))

    return wrap
