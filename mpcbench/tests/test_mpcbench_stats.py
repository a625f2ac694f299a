"""The end-to-end arithmetic is taken over every sample of a window."""

import numpy as np
import pytest

from mpcbench import stats


def test_mean_is_the_window_over_its_cycles():
    assert stats.mean_ms(3.0, 100) == pytest.approx(30.0)
    with pytest.raises(ValueError):
        stats.mean_ms(1.0, 0)


def test_p95_takes_every_cycle():
    times = [0.030] * 94 + [0.055] * 6
    assert stats.p95_ms(times) == pytest.approx(1e3 * np.percentile(times, 95))
    assert stats.p95_ms(times) > 30.0  # the tail is in
    assert stats.p95_ms(times[:94]) == pytest.approx(30.0)


def test_rate_is_the_window_s_work_over_its_seconds():
    assert stats.rate(2048, 0.1) == pytest.approx(20480.0)
    with pytest.raises(ValueError):
        stats.rate(1, 0.0)
