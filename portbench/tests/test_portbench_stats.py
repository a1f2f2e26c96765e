"""The yardstick's arithmetic against hand-computed cases."""
import math

import pytest

from harness import peaks, stats


@pytest.mark.parametrize("values, q, want", [
    ([1, 2, 3, 4], 50, 2.5),
    ([10.0], 95, 10.0),
    (list(range(1, 101)), 95, 95.05),  # rank 99 * 0.95 = 94.05 between 95 and 96
    (list(range(1, 11)), 90, 9.1),  # rank 8.1
    ([5, 1, 4, 2, 3], 0, 1.0),
    ([5, 1, 4, 2, 3], 100, 5.0),
    ([0.2, 0.1], 25, 0.125),
])
def test_percentile(values, q, want):
    assert stats.percentile(values, q) == pytest.approx(want, rel=1e-12)


def test_percentile_refuses_nothing_and_bad_q():
    with pytest.raises(ValueError):
        stats.percentile([], 50)
    with pytest.raises(ValueError):
        stats.percentile([1], 101)


@pytest.mark.parametrize("count, seconds, want", [(30, 1.5, 20.0), (0, 2.0, 0.0), (59776, 6.003, 59776 / 6.003)])
def test_rate(count, seconds, want):
    assert stats.rate(count, seconds) == pytest.approx(want)


def test_rate_refuses_empty_window():
    with pytest.raises(ValueError):
        stats.rate(1, 0.0)


@pytest.mark.parametrize("values, want", [
    ([1, 2, 3, 4, 5], 1.0),  # quartiles 1.5 and 4.5 (exclusive method), median 3
    ([10, 10, 10, 10], 0.0),
    ([100, 101, 102, 103, 104, 105], 3.5 / 102.5),  # q1 100.75, q3 104.25, median 102.5
])
def test_spread(values, want):
    assert stats.spread(values) == pytest.approx(want, rel=1e-9)


def test_bound_picks_the_larger_term():
    # 1,979e9 ops take 1 ms; 3.35e9 bytes take 1 ms
    assert peaks.bound_s(1979e9, 0.0) == pytest.approx(1e-3)
    assert peaks.bound_s(0.0, 3.35e9) == pytest.approx(1e-3)
    assert peaks.bound_s(1979e9, 6.7e9) == pytest.approx(2e-3)


def test_roofline_and_mfu():
    assert peaks.roofline_pct(0.5e-3, 2e-3) == pytest.approx(25.0)
    assert peaks.roofline_pct(1e-3, 0.0) is None
    assert peaks.mfu_pct(1979e12, 2.0) == pytest.approx(50.0)
    assert peaks.mfu_pct(0.0, 2.0) is None
    assert math.isclose(peaks.INT8_OPS_PER_S, 1979e12) and math.isclose(peaks.HBM_BYTES_PER_S, 3.35e12)


class _Timeline:
    def __init__(self, seconds, traced):
        self.result = (seconds, traced)

    def kernel_seconds(self, part):
        return self.result


def _ctx(work, counted, seconds, traced):
    import types

    return types.SimpleNamespace(work={"launches": {"qmatmul": work}, "bound_s": {"qmatmul": 1e-3}},
                                 launches={"qmatmul": counted - counted // 2, "qmatmul_packed": counted // 2},
                                 timeline=_Timeline(seconds, traced), notes=[])


@pytest.mark.parametrize("work, counted, traced, want", [
    (2880, 2880, 2880, 25.0),  # 1 ms of bounds over 4 ms of device time
    (2880, 2880, 2879, 25.0 * 2879 / 2880),  # one launch lost: its time taken as the mean
    (2880, 2880, 2870, None),  # more lost than the trace may lose
    (2880, 2881, 2881, None),  # a launch the work model does not account for
    (0, 0, 0, None),
])
def test_roofline_reading(work, counted, traced, want):
    from harness import readers

    got = readers.roofline(_ctx(work, counted, 4e-3, traced), "qmatmul")
    assert got == pytest.approx(want) if want is not None else got is None
