"""The reference's measured v5e gather-path calibration records (round
5), the gather records of ``formats/cost.py::V5E``.

Anchor grid for :func:`ops.auto.gather_class_estimates`: every record is
one hardware measurement from ``scripts/exp_gather_calib3.py``
(artifact ``results/gather_calib3.json`` — amortized two-point timing,
validated against the host f64 oracle). Replaces the round-2 flat
constants (COO 11.5 ns/nnz, ELL 2.5 ns/slot), which were 4.5-13x
optimistic at large m (roadnet COO estimated
17.9 ms, measured 80; roadnet_like k=32 measures 245.7 ms — strongly
superlinear in m*k, unreachable by any per-unit constant).

Estimator: log-space power-law prior (fit over this table) plus an
inverse-distance-weighted residual correction — exact on the anchor
grid (the sweep families), leave-one-out median ratio error 1.23-1.25x
off-grid (see the probe's fit section for per-record residuals).

Rows: (path, m, work, k, seconds) with work = nnz for the COO path and
padded slots for the bucketed-ELL path.
"""

GATHER_CALIB_RECORDS = (
    ("coo", 20000, 199956, 1, 2.395443e-03),  # uniform_random_20k
    ("coo", 20000, 199956, 6, 2.097619e-03),  # uniform_random_20k
    ("coo", 20000, 199956, 32, 2.064091e-03),  # uniform_random_20k
    ("coo", 100000, 805933, 1, 1.046401e-02),  # powerlaw_100k
    ("coo", 100000, 1199927, 1, 1.395652e-02),  # uniform_random_100k
    ("coo", 100000, 805933, 6, 8.984051e-03),  # powerlaw_100k
    ("coo", 100000, 1199927, 6, 1.261856e-02),  # uniform_random_100k
    ("coo", 100000, 805933, 32, 9.008627e-03),  # powerlaw_100k
    ("coo", 100000, 1199927, 32, 1.241857e-02),  # uniform_random_100k
    ("coo", 116835, 766389, 1, 8.550632e-03),  # dc1_like
    ("coo", 116835, 766389, 6, 8.539272e-03),  # dc1_like
    ("coo", 116835, 766389, 32, 7.952572e-03),  # dc1_like
    ("coo", 262111, 1120454, 1, 1.605344e-02),  # amazon0302_like
    ("coo", 262111, 1120454, 6, 1.387430e-02),  # amazon0302_like
    ("coo", 262111, 1120454, 32, 1.499715e-02),  # amazon0302_like
    ("coo", 327276, 462568, 1, 6.653047e-03),  # roadnet_03
    ("coo", 327276, 462568, 6, 2.263733e-02),  # roadnet_03
    ("coo", 327276, 462568, 32, 6.949246e-03),  # roadnet_03
    ("coo", 1090920, 1541898, 1, 2.082427e-02),  # roadnet_like
    ("coo", 1090920, 1541898, 6, 8.076642e-02),  # roadnet_like
    ("coo", 1090920, 1541898, 32, 2.457143e-01),  # roadnet_like
    ("ell", 20000, 275840, 1, 6.082146e-04),  # uniform_random_20k
    ("ell", 20000, 275840, 6, 4.870947e-04),  # uniform_random_20k
    ("ell", 20000, 275840, 32, 5.476714e-04),  # uniform_random_20k
    ("ell", 100000, 5116800, 1, 1.436767e-02),  # powerlaw_100k
    ("ell", 100000, 1639808, 1, 5.292212e-03),  # uniform_random_100k
    ("ell", 100000, 5116800, 6, 1.062848e-02),  # powerlaw_100k
    ("ell", 100000, 1639808, 6, 4.082131e-03),  # uniform_random_100k
    ("ell", 100000, 1639808, 32, 3.840393e-03),  # uniform_random_100k
    ("ell", 116835, 1407744, 1, 4.993714e-03),  # dc1_like
    ("ell", 116835, 1407744, 6, 3.928969e-03),  # dc1_like
    ("ell", 116835, 1407744, 32, 3.941846e-03),  # dc1_like
    ("ell", 262111, 2095168, 1, 2.022251e-02),  # amazon0302_like
    ("ell", 262111, 2095168, 6, 2.050422e-02),  # amazon0302_like
    ("ell", 262111, 2095168, 32, 1.998595e-02),  # amazon0302_like
    ("ell", 327276, 2131776, 1, 1.341700e-02),  # roadnet_03
    ("ell", 327276, 2131776, 6, 1.733155e-02),  # roadnet_03
    ("ell", 327276, 2131776, 32, 2.925867e-02),  # roadnet_03
    ("ell", 1090920, 7107392, 1, 4.220204e-02),  # roadnet_like
    ("ell", 1090920, 7107392, 6, 5.135348e-02),  # roadnet_like
    ("ell", 1090920, 7107392, 32, 2.260169e-01),  # roadnet_like
)
