"""The arithmetic of the end-to-end metrics over a window with a stall."""

import statistics

import numpy as np
import pytest

from portbench import stats


@pytest.mark.parametrize("q", [0, 50, 90, 95, 99, 100])
def test_percentile_matches_numpy_linear(q):
    rs = np.random.RandomState(4)
    v = list(rs.exponential(10.0, 333))
    assert stats.percentile(v, q) == pytest.approx(float(np.percentile(v, q)), rel=1e-12)


def test_a_stall_moves_the_tail_and_the_rate_not_the_median():
    steady = [0.010] * 99
    one = steady + [0.500]
    assert stats.percentile(one, 95) == pytest.approx(0.010)
    ten = [0.010] * 90 + [0.500] * 10
    assert stats.percentile(ten, 95) == pytest.approx(0.500)
    # closed loop: the window holds every request back to back, the stall too
    window = sum(one)
    assert stats.rate(4 * len(one), 0.0, window) == pytest.approx(400 / 1.49)
    assert statistics.median(one) == pytest.approx(0.010)


def test_rate_refuses_an_empty_window():
    with pytest.raises(ValueError):
        stats.rate(1, 2.0, 2.0)

