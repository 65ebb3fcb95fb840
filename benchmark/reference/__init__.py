"""The benchmark's plain reference: NumPy and SciPy in float64 on the host.

Nothing here imports the program under test (the ``_torch`` port) or the
JAX package, and nothing here takes an array the program made: each
operator and each state the program is judged against is worked out
again from the seed, and the program's outputs are read only to be
judged.
"""
