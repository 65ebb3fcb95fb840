"""The H100 gather-route calibration records: ``(path, m, work, k,
seconds)`` as the table of ``formats/cost.py::H100`` reads them.

Written by ``exp_gather_calib3 --render`` (the port's ``scripts/``) from
``results/h100/gather_calib3.json`` (NVIDIA H100 80GB HBM3, 700.00 W): COO
through ``spmm_coo``, bucketed ELL through kernel B7, one call timed
with CUDA events after its oracle check.
"""

GATHER_CALIB_RECORDS_H100 = (
    ("coo", 100000, 1199927, 1, 4.981920e-05, 29),  # uniform_random_100k
    ("coo", 100000, 1199927, 32, 1.157042e-03, 29),  # uniform_random_100k
    ("coo", 100000, 1199927, 6, 1.215584e-04, 29),  # uniform_random_100k
    ("coo", 100000, 1748795, 1, 7.515840e-05, 18),  # fem_banded_100k
    ("coo", 100000, 1748795, 32, 1.673064e-03, 18),  # fem_banded_100k
    ("coo", 100000, 1748795, 6, 1.693424e-04, 18),  # fem_banded_100k
    ("coo", 100000, 805933, 1, 3.151664e-04, 99680),  # powerlaw_100k
    ("coo", 100000, 805933, 32, 1.228285e-03, 99680),  # powerlaw_100k
    ("coo", 100000, 805933, 6, 5.533312e-04, 99680),  # powerlaw_100k
    ("coo", 1090920, 1541898, 1, 5.611360e-05, 6),  # roadnet_like
    ("coo", 1090920, 1541898, 32, 1.537310e-03, 6),  # roadnet_like
    ("coo", 1090920, 1541898, 6, 1.787088e-04, 6),  # roadnet_like
    ("coo", 116835, 766389, 1, 9.744800e-05, 40896),  # dc1_like
    ("coo", 116835, 766389, 32, 8.541280e-04, 40896),  # dc1_like
    ("coo", 116835, 766389, 6, 1.724784e-04, 40896),  # dc1_like
    ("coo", 121192, 2624330, 1, 8.106240e-05, 27),  # cop20k_like
    ("coo", 121192, 2624330, 32, 2.497427e-03, 27),  # cop20k_like
    ("coo", 121192, 2624330, 6, 2.436048e-04, 27),  # cop20k_like
    ("coo", 20000, 199956, 1, 7.247200e-05, 26),  # uniform_random_20k
    ("coo", 20000, 199956, 32, 2.003232e-04, 26),  # uniform_random_20k
    ("coo", 20000, 199956, 6, 7.368480e-05, 26),  # uniform_random_20k
    ("coo", 262111, 1120454, 1, 4.571360e-05, 5),  # amazon0302_like
    ("coo", 262111, 1120454, 32, 1.092826e-03, 5),  # amazon0302_like
    ("coo", 262111, 1120454, 6, 1.159216e-04, 5),  # amazon0302_like
    ("coo", 327276, 462568, 1, 4.823200e-05, 7),  # roadnet_03
    ("coo", 327276, 462568, 32, 4.762704e-04, 7),  # roadnet_03
    ("coo", 327276, 462568, 6, 7.168800e-05, 7),  # roadnet_03
    ("coo", 9, 49, 1, 5.336800e-05, 8),  # cage4_like
    ("coo", 9, 49, 32, 4.696640e-05, 8),  # cage4_like
    ("coo", 9, 49, 6, 5.700640e-05, 8),  # cage4_like
    ("ell", 100000, 1639808, 1, 6.014080e-05, 32),  # uniform_random_100k
    ("ell", 100000, 1639808, 32, 1.075952e-04, 32),  # uniform_random_100k
    ("ell", 100000, 1639808, 6, 7.508160e-05, 32),  # uniform_random_100k
    ("ell", 100000, 2330432, 1, 7.581920e-05, 24),  # fem_banded_100k
    ("ell", 100000, 2330432, 32, 1.391584e-04, 24),  # fem_banded_100k
    ("ell", 100000, 2330432, 6, 9.718400e-05, 24),  # fem_banded_100k
    ("ell", 100000, 5116800, 1, 6.077264e-04, 99680),  # powerlaw_100k
    ("ell", 100000, 5116800, 32, 2.841526e-03, 99680),  # powerlaw_100k
    ("ell", 100000, 5116800, 6, 4.562730e-03, 99680),  # powerlaw_100k
    ("ell", 1090920, 7107392, 1, 5.687040e-05, 8),  # roadnet_like
    ("ell", 1090920, 7107392, 32, 8.250288e-04, 8),  # roadnet_like
    ("ell", 1090920, 7107392, 6, 2.811136e-04, 8),  # roadnet_like
    ("ell", 116835, 1407744, 1, 1.918656e-04, 40896),  # dc1_like
    ("ell", 116835, 1407744, 32, 1.336064e-03, 40896),  # dc1_like
    ("ell", 116835, 1407744, 6, 1.439541e-03, 40896),  # dc1_like
    ("ell", 121192, 3688640, 1, 5.155680e-05, 32),  # cop20k_like
    ("ell", 121192, 3688640, 32, 1.657440e-04, 32),  # cop20k_like
    ("ell", 121192, 3688640, 6, 1.181984e-04, 32),  # cop20k_like
    ("ell", 20000, 275840, 1, 8.683040e-05, 32),  # uniform_random_20k
    ("ell", 20000, 275840, 32, 6.208320e-05, 32),  # uniform_random_20k
    ("ell", 20000, 275840, 6, 4.924320e-05, 32),  # uniform_random_20k
    ("ell", 262111, 2095168, 1, 4.624800e-05, 8),  # amazon0302_like
    ("ell", 262111, 2095168, 32, 2.295904e-04, 8),  # amazon0302_like
    ("ell", 262111, 2095168, 6, 8.254240e-05, 8),  # amazon0302_like
    ("ell", 327276, 2131776, 1, 4.819360e-05, 8),  # roadnet_03
    ("ell", 327276, 2131776, 32, 2.680304e-04, 8),  # roadnet_03
    ("ell", 327276, 2131776, 6, 8.834720e-05, 8),  # roadnet_03
    ("ell", 9, 128, 1, 5.794400e-05, 8),  # cage4_like
    ("ell", 9, 128, 32, 4.297920e-05, 8),  # cage4_like
    ("ell", 9, 128, 6, 6.199040e-05, 8),  # cage4_like
)

#: The linear model the H100 table prices the gather routes with:
#: ``ops/auto.py::gather_features``' coefficients, fit to the
#: records above.
GATHER_COEFS_H100 = (
    ("coo", (
        4.757735476328618e-05,
        7.347958786015526e-12,
        6.825850694098604e-13,
        1.9528724674226935e-09,
    )),
    ("ell", (
        5.071674041124276e-05,
        0.0,
        2.2249958111887803e-11,
        2.8169649380818238e-08,
        5.03428215787023e-09,
    )),
)
