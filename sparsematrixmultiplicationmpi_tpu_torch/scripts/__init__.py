"""The results, models and scaling scripts of the port (counterparts of
the JAX package's ``scripts/`` of the same file names), each run as

    python -m sparsematrixmultiplicationmpi_tpu_torch.scripts.<name>

* ``run_models_bench``: GCN training, a CG solve and PageRank, timed;
* ``run_results_sweep``: the matrix x k x strategy sweep, its re-measure
  pass, ``REPORT.md`` and the figures;
* ``render_results``: ``REPORT.md`` and the figures from a sweep CSV;
* ``launch_multihost``: the ``torchrun`` launcher for ``spmm-torch``;
* ``run_scaling_sweep``: every strategy at several ranks on gloo, with
  the collective counter's kinds, counts and bytes;
* ``project_weak_scaling``: a weak-scaling projection from those bytes.

Each has a ``main(argv)``; the ones that multiply take ``--device
{cuda,cpu}`` and write under ``--out-dir`` (default ``results/h100/``).
"""
