"""Stand-in generators that configurations name and
``reference/generate.py::GENERATORS`` does not hold, one file each:
``<name>.py`` with ``generate(seed, dtype, scale) -> Csr``, where ``seed``
is the configuration's ``pattern_seed``, ``dtype`` float64 and ``scale``
the configuration's ``scale``. A helper that a generator imports is a
file whose name starts with ``_``, which no configuration can name.

``reference/operators.py::find_generator`` loads a file by its path when
a configuration's ``generator`` names it. Like every file of the
reference, a generator imports nothing of the program or the JAX
package: a stand-in that the program also has is a frozen copy, checked
bit for bit against the program's by a test of its own.
``benchmark/tests/test_benchmark_contract.py`` runs every generator here
at scale 0.01 and checks that nothing of the program was loaded.
"""
