"""Benchmark figures (port of
``sparsematrixmultiplicationmpi_tpu/bench/plots.py``), the
analysis-notebook layer.

Replaces the reference's 15-cell Jupyter notebook + 55 PNGs
(``results/visualisation_fat_vector.ipynb``; figures embedded at
``report/425500_Report.tex:699-1023``) with library functions that render
the same figure families straight from sweep records:

* execution time vs device count, per strategy (strong scaling)
* speedup + efficiency vs device count
* throughput (GFLOP/s, Gnnz/s) vs fat-vector width k
* matrix-impact comparison at fixed k
* computation-vs-communication split per strategy (the reference's
  ``results_debug.csv`` figure family, ``get_csv_debug.sh:7``)

Design rules: one axis per figure, fixed per-strategy color assignment
(never cycled), thin 2px lines with >=8px markers, recessive grid,
legend + direct end labels. ``matplotlib`` is imported inside each
function: the package runs without it, and a figure asks for it.
"""

from __future__ import annotations

from typing import Iterable, List, Optional, Sequence

from .harness import BenchRecord

__all__ = [
    "plot_time_vs_devices", "plot_speedup", "plot_throughput_vs_k",
    "plot_matrix_impact", "plot_comm_comp", "render_all",
]

# Fixed categorical assignment (validated palette; color follows the
# strategy identity, never rank or order of appearance). Slots are
# assigned in the strategies' alphabetical order — the order they appear
# side by side in grouped bars and legends — so visually adjacent marks
# use the palette's adjacency-validated hue sequence.
STRATEGY_COLORS = {
    "auto": "#2a78d6",
    "banded_row_wise": "#eb6834",
    "column_wise": "#1baf7a",
    "grid2d": "#eda100",
    "library": "#e87ba4",
    "nnz": "#008300",
    "row_wise": "#4a3aa7",
    "sequential": "#e34948",
}
_FALLBACK = "#9a9a94"

_STRATEGY_LABELS = {
    "sequential": "Sequential",
    "row_wise": "Row-wise",
    "column_wise": "Column-wise",
    "nnz": "Non-zero element",
    "library": "Library (torch.sparse)",
    "auto": "Auto (band/ELL)",
    "banded_row_wise": "Banded row-wise",
}


def _style(ax, title, xlabel, ylabel):
    ax.set_title(title, fontsize=11)
    ax.set_xlabel(xlabel, fontsize=9)
    ax.set_ylabel(ylabel, fontsize=9)
    ax.grid(True, alpha=0.25, linewidth=0.5)
    ax.spines["top"].set_visible(False)
    ax.spines["right"].set_visible(False)
    ax.tick_params(labelsize=8)


def _by(records, key):
    groups = {}
    for r in records:
        groups.setdefault(key(r), []).append(r)
    return groups


def _save(fig, path):
    fig.tight_layout()
    fig.savefig(path, dpi=130)
    import matplotlib.pyplot as plt

    plt.close(fig)
    return path


def plot_time_vs_devices(records: Iterable[BenchRecord], path: str,
                         matrix: Optional[str] = None,
                         k: Optional[int] = None) -> str:
    """Strong scaling: execution time vs mesh size, one line per strategy
    (the reference's 'Execution time of the Algorithms' figure family)."""
    import matplotlib.pyplot as plt

    recs = [r for r in records
            if (matrix is None or r.matrix == matrix)
            and (k is None or r.k == k)]
    fig, ax = plt.subplots(figsize=(6, 4))
    for name, rs in sorted(_by(recs, lambda r: r.strategy).items()):
        rs = sorted(rs, key=lambda r: r.devices)
        color = STRATEGY_COLORS.get(name, _FALLBACK)
        ax.plot([r.devices for r in rs],
                [r.execution_time * 1e3 for r in rs],
                marker="o", markersize=4, linewidth=2, color=color,
                label=_STRATEGY_LABELS.get(name, name))
    _style(ax, f"SpMM execution time — {matrix or 'all'}"
               + (f", k={k}" if k else ""),
           "devices", "time per SpMM [ms]")
    ax.set_yscale("log")
    if len(recs) > 1:
        ax.legend(fontsize=8, frameon=False)
    return _save(fig, path)


def plot_speedup(records: Iterable[BenchRecord], path: str,
                 baseline_time: float, matrix: Optional[str] = None,
                 k: Optional[int] = None) -> str:
    """Speedup vs devices relative to ``baseline_time`` (serial), plus the
    ideal-scaling reference line (the reference's speedup/efficiency
    figures)."""
    import matplotlib.pyplot as plt

    recs = [r for r in records
            if (matrix is None or r.matrix == matrix)
            and (k is None or r.k == k)]
    fig, ax = plt.subplots(figsize=(6, 4))
    max_dev = max((r.devices for r in recs), default=1)
    ax.plot([1, max_dev], [1, max_dev], linestyle="--", linewidth=1,
            color="#9a9a94", label="ideal")
    for name, rs in sorted(_by(recs, lambda r: r.strategy).items()):
        rs = sorted(rs, key=lambda r: r.devices)
        color = STRATEGY_COLORS.get(name, _FALLBACK)
        ax.plot([r.devices for r in rs],
                [baseline_time / r.execution_time for r in rs],
                marker="o", markersize=4, linewidth=2, color=color,
                label=_STRATEGY_LABELS.get(name, name))
    _style(ax, f"Speedup vs serial — {matrix or 'all'}"
               + (f", k={k}" if k else ""),
           "devices", "speedup")
    ax.legend(fontsize=8, frameon=False)
    return _save(fig, path)


def plot_throughput_vs_k(records: Iterable[BenchRecord], path: str,
                         matrix: Optional[str] = None,
                         devices: Optional[int] = None) -> str:
    """Throughput vs fat-vector width (the notebook's performance-vs-k
    FLOPS figure, cell 14)."""
    import matplotlib.pyplot as plt

    recs = [r for r in records
            if (matrix is None or r.matrix == matrix)
            and (devices is None or r.devices == devices)]
    fig, ax = plt.subplots(figsize=(6, 4))
    for name, rs in sorted(_by(recs, lambda r: r.strategy).items()):
        rs = sorted(rs, key=lambda r: r.k)
        color = STRATEGY_COLORS.get(name, _FALLBACK)
        ax.plot([r.k for r in rs], [r.gflops for r in rs],
                marker="o", markersize=4, linewidth=2, color=color,
                label=_STRATEGY_LABELS.get(name, name))
    _style(ax, f"Throughput vs k — {matrix or 'all'}",
           "fat-vector columns k", "GFLOP/s")
    ax.legend(fontsize=8, frameon=False)
    return _save(fig, path)


def plot_matrix_impact(records: Iterable[BenchRecord], path: str,
                       k: Optional[int] = None,
                       devices: Optional[int] = None) -> str:
    """Grouped bars: per-matrix best time per strategy (the reference's
    matrix-impact sweep, ``results/analysis.csv``)."""
    import matplotlib.pyplot as plt
    import numpy as np

    recs = [r for r in records
            if (k is None or r.k == k)
            and (devices is None or r.devices == devices)]
    matrices = sorted({r.matrix for r in recs})
    strategies = sorted({r.strategy for r in recs})
    fig, ax = plt.subplots(figsize=(7, 4))
    width = 0.8 / max(len(strategies), 1)
    x = np.arange(len(matrices))
    for si, name in enumerate(strategies):
        times = []
        for mat in matrices:
            cand = [r.execution_time for r in recs
                    if r.matrix == mat and r.strategy == name]
            times.append(min(cand) * 1e3 if cand else float("nan"))
        ax.bar(x + si * width, times, width * 0.92,
               color=STRATEGY_COLORS.get(name, _FALLBACK),
               label=_STRATEGY_LABELS.get(name, name))
    ax.set_xticks(x + 0.4 - width / 2)
    ax.set_xticklabels(matrices, fontsize=8, rotation=15, ha="right")
    _style(ax, "Best execution time by matrix", "", "time per SpMM [ms]")
    ax.set_yscale("log")
    ax.legend(fontsize=8, frameon=False)
    return _save(fig, path)


def plot_comm_comp(records: Iterable[BenchRecord], path: str, *,
                   matrix: str, k: int):
    """Stacked computation/communication bars per strategy — the
    reference's debug-timer figure family (``results_debug.csv``,
    scraped by ``get_csv_debug.sh:49-52``), from the differential
    profiler split (``utils/profiling.py::comm_comp_split``)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    rows = [r for r in records
            if r.matrix == matrix and r.k == k
            and r.comp_time is not None and r.comm_time is not None
            and r.comp_time == r.comp_time]
    if not rows:
        return None
    rows.sort(key=lambda r: r.strategy)
    names = [_STRATEGY_LABELS.get(r.strategy, r.strategy) for r in rows]
    comp = [r.comp_time * 1e3 for r in rows]
    comm = [r.comm_time * 1e3 for r in rows]
    fig, ax = plt.subplots(figsize=(6.4, 0.6 + 0.5 * len(rows)))
    y = range(len(rows))
    ax.barh(y, comp, height=0.55, color="#2a78d6", label="computation")
    ax.barh(y, comm, height=0.55, left=comp, color="#eb6834",
            label="communication/other")
    ax.set_yticks(list(y))
    ax.set_yticklabels(names, fontsize=8)
    ax.invert_yaxis()
    _style(ax, f"{matrix}: comp vs comm per SpMM (k={k})",
           "time per SpMM [ms]", "")
    ax.legend(fontsize=8, frameon=False)
    return _save(fig, path)


def render_all(records: Sequence[BenchRecord], out_dir: str) -> List[str]:
    """Render the full figure set for a sweep (one per matrix x k for
    scaling figures + the cross-matrix comparison)."""
    import os

    os.makedirs(out_dir, exist_ok=True)
    paths = []
    matrices = sorted({r.matrix for r in records})
    ks = sorted({r.k for r in records})
    for mat in matrices:
        safe = mat.replace("/", "_").replace(":", "_")
        for k in ks:
            sub = [r for r in records if r.matrix == mat and r.k == k]
            if not sub:
                continue
            paths.append(plot_time_vs_devices(
                sub, os.path.join(out_dir, f"time_{safe}_k{k}.png"),
                matrix=mat, k=k))
        sub_k = [r for r in records if r.matrix == mat]
        paths.append(plot_throughput_vs_k(
            sub_k, os.path.join(out_dir, f"throughput_{safe}.png"),
            matrix=mat))
    # Comm/comp split at the largest k that has populated split columns.
    for mat in matrices:
        safe = mat.replace("/", "_").replace(":", "_")
        with_split = [r for r in records if r.matrix == mat
                      and r.comp_time is not None]
        if with_split:
            k_split = max(r.k for r in with_split)
            p = plot_comm_comp(
                with_split,
                os.path.join(out_dir, f"commcomp_{safe}_k{k_split}.png"),
                matrix=mat, k=k_split)
            if p:
                paths.append(p)
    if len(matrices) > 1:
        paths.append(plot_matrix_impact(
            records, os.path.join(out_dir, "matrix_impact.png")))
    return paths
