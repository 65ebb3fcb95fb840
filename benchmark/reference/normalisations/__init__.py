"""Operator normalisations that configurations name and
``reference/operators.py::NORMALISATIONS`` does not hold, one file each:
``<name>.py`` with ``normalise(a: Csr) -> Csr``, which returns float64
values on ``a``'s pattern (``a._replace(values=...)``), for any stand-in's
matrix: ``benchmark/tests/test_benchmark_contract.py`` runs every
normalisation here on each stand-in's at scale 0.01 and checks that
nothing of the program was loaded.

``reference/operators.py::find_normalisation`` loads a file by its path
when a configuration's ``operator`` names it. Like every file of the
reference, a normalisation imports nothing of the program or the JAX
package.
"""
