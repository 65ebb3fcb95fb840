"""The kernels' floor counts the configuration's CSR, v and the output."""

import pytest

from benchmark.core.floors import PEAKS, floor_seconds, multiply_bytes

H100 = "NVIDIA H100 80GB HBM3"


@pytest.mark.parametrize("m, nnz, k, mb, us", [
    (121_192, 2_624_330, 32, 52.50, 15.67),    # cop20k_A at k = 32
    (121_192, 2_624_330, 1, 22.45, 6.70),      # cop20k_A at k = 1
    (262_111, 1_234_877, 1, 13.02, 3.89),      # amazon0302 at k = 1
])
def test_floor_bytes(m, nnz, k, mb, us):
    b = multiply_bytes(m, m, nnz, k)
    assert b / 1e6 == pytest.approx(mb, abs=0.005)
    assert floor_seconds(m, m, nnz, k, H100) * 1e6 == pytest.approx(us, abs=0.005)


def test_cop20k_parts():
    csr = 2_624_330 * 8 + 121_193 * 4
    assert csr == 21_479_412
    assert multiply_bytes(121_192, 121_192, 2_624_330, 32) == csr + 2 * 15_512_576


def test_unknown_card_has_no_floor():
    assert floor_seconds(10, 10, 10, 1, "some other card") is None
    assert PEAKS[H100]["hbm_bytes_per_s"] == 3.35e12
