"""Markdown benchmark report (port of
``sparsematrixmultiplicationmpi_tpu/bench/report.py``): the reference
report's results section, generated from sweep records.

Per-matrix tables (best time per strategy and k), the correctness tally
(the reference's "Number of errors" notebook cell), the failed jobs, and
for a cop20k matrix a comparison with the MPI reference's best published
throughput. The hardware line names the device the records ran on.
"""

from __future__ import annotations

from typing import Optional, Sequence

from .harness import BenchRecord

__all__ = ["render_report"]

#: The MPI reference's best measured throughput on cop20k_A: row-wise,
#: k = 12, on 60 Xeon CPU cores (0.1023 s, ``BASELINE.md``). A CPU
#: cluster's number, not one of this port's devices.
REFERENCE_BEST_GNNZ = 2_624_331 / 0.1023 / 1e9


def _fmt_seconds(s: float) -> str:
    if s < 1e-3:
        return f"{s * 1e6:.0f} µs"
    return f"{s * 1e3:.3f} ms"


def _fmt_cell(cand) -> str:
    """Best resolved time of the candidate records; '< bound' when every
    candidate is below timing resolution (a tiny matrix, the reference's
    cage4 class, has no time and no throughput); 'failed' for failed jobs
    only."""
    if not cand:
        return "—"
    resolved = [r.execution_time for r in cand
                if r.execution_time == r.execution_time]
    if resolved:
        return _fmt_seconds(min(resolved))
    bounds = [r.time_upper_bound for r in cand
              if r.correct is not False and r.time_upper_bound]
    if bounds:
        return f"< {_fmt_seconds(min(bounds))} (below resolution)"
    return "failed"


def render_report(records: Sequence[BenchRecord],
                  path: Optional[str] = None, *,
                  title: str = "Benchmark report") -> str:
    lines = [f"# {title}", ""]
    if records:
        r0 = records[0]
        lines += [
            f"Hardware: {r0.device_kind} ({r0.devices} device(s) per job "
            f"unless noted); dtype {r0.dtype}.",
            "",
        ]

    total = len(records)
    checked = [r for r in records if r.correct is not None]
    bad = [r for r in checked if not r.correct]
    lines += [
        f"**Correctness:** {len(checked) - len(bad)}/{len(checked)} checked "
        "jobs match the host float64 oracle"
        + (f" — {len(bad)} MISMATCH/failed: "
           + ", ".join(f"{r.matrix}/k={r.k}/{r.strategy}" for r in bad[:10])
           + (f", and {len(bad) - 10} more" if len(bad) > 10 else "")
           if bad else " (0 errors)."),
        "",
    ]
    errored = [r for r in records if r.error]
    if errored:
        # A failure is diagnosable from the report itself.
        lines += ["**Failed jobs:**", ""]
        for r in errored[:20]:
            lines.append(
                f"- `{r.matrix}/k={r.k}/{r.strategy}/p={r.devices}`: "
                f"{r.error}")
        if len(errored) > 20:
            lines.append(f"- ... and {len(errored) - 20} more "
                         "(full list in the CSV's `error` column)")
        lines.append("")

    matrices = sorted({r.matrix for r in records})
    for mat in matrices:
        sub = [r for r in records if r.matrix == mat]
        r0 = sub[0]
        lines += [
            f"## {mat}",
            "",
            f"{r0.m:,} x {r0.n:,}, {r0.nnz:,} nonzeros",
            "",
        ]
        ks = sorted({r.k for r in sub})
        strategies = sorted({r.strategy for r in sub})
        header = "| strategy | " + " | ".join(f"k={k}" for k in ks) + " |"
        sep = "|---" * (len(ks) + 1) + "|"
        lines += [header, sep]
        for s in strategies:
            cells = []
            for k in ks:
                cells.append(_fmt_cell(
                    [r for r in sub if r.strategy == s and r.k == k]
                ))
            lines.append(f"| {s} | " + " | ".join(cells) + " |")
        # "Best" takes only resolved timings (a sub-resolution row has no
        # throughput) that are physically possible: a row above 100 % of
        # the byte roofline is a measurement artifact, listed for
        # re-measure (``harness.remeasure_record``) and never headlined.
        resolved_sub = [r for r in sub
                        if r.execution_time == r.execution_time]
        impossible = [r for r in resolved_sub
                      if r.roofline_fraction and r.roofline_fraction > 1.0]
        plausible = [r for r in resolved_sub if r not in impossible]
        if impossible:
            lines += [""] + [
                f"> measurement artifact (> 100% of roofline — excluded "
                f"from Best, needs re-measure): `{r.strategy}` k={r.k} "
                f"{_fmt_seconds(r.execution_time)} "
                f"({r.roofline_fraction * 100:.1f}%)"
                for r in impossible]
        if plausible:
            best = min(plausible, key=lambda r: r.execution_time)
            remeas = (f" (median of {best.remeasured} runs, spread "
                      f"±{best.spread_rel * 50:.0f}%)"
                      if best.remeasured and best.spread_rel is not None
                      else "")
            lines += [
                "",
                f"Best: **{best.strategy}** at k={best.k}: "
                f"{_fmt_seconds(best.execution_time)} = "
                f"{best.gnnz_per_s:.3f} Gnnz/s, {best.gflops:.1f} GFLOP/s"
                + (f", {best.roofline_fraction * 100:.1f}% of the per-chip "
                   "roofline" if best.roofline_fraction else "")
                + remeas,
                "",
            ]
        elif not resolved_sub:
            lines += [
                "",
                "All timings below measurement resolution (matrix too "
                "small for the per-chip timer) — no throughput claimed.",
                "",
            ]
        else:
            lines += [
                "",
                "Every resolved timing exceeds the byte roofline — all "
                "artifacts; no throughput claimed pending re-measure.",
                "",
            ]
        if "cop20k" in mat:
            k32 = [r for r in plausible if r.k == 32]
            if k32:
                fastest = min(k32, key=lambda r: r.execution_time)
                ratio = fastest.gnnz_per_s / REFERENCE_BEST_GNNZ
                lines += [
                    f"vs the reference's best measured throughput on "
                    f"cop20k_A (row-wise, k=12, 60 Xeon cores: "
                    f"{REFERENCE_BEST_GNNZ:.4f} Gnnz/s): "
                    f"**{ratio:.1f}x** on one chip.",
                    "",
                ]

    text = "\n".join(lines)
    if path:
        with open(path, "w") as f:
            f.write(text)
    return text
