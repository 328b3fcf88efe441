"""The metric arithmetic on synthetic inputs: the rate over the window,
the idle share and gaps from intervals, the device time inside a range,
and the counts and DI bounds against chip_smoke's for the same shapes."""

import os
import sys

import numpy as np
import pytest

from portbench import manifest, roofline, trace

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


class Ctx:
    def __init__(self, **kw):
        self.__dict__.update(kw)

    def per_read(self, s):
        return s / self.reads if self.reads else None


def test_rate_is_reads_in_window_over_window():
    r = manifest.Manifest(ROOT).reader("reads_per_s")
    assert r.read(Ctx(reads=60, seconds=20.0)) == 3.0
    assert r.read(Ctx(reads=0, seconds=20.0)) is None


def test_per_read_timers():
    man = manifest.Manifest(ROOT)
    ctx = Ctx(reads=50, seconds=10.0, timers={"walks": 10.0, "range": 5.0, "dp_wait": 0.5,
                                              "dp_fill": 1.0},
              counters={"speculative_queries": 1000, "walk_fallback_queries": 7}, cpu_s=40.0)
    assert man.reader("walk_s_per_read").read(ctx) == 0.2
    assert man.reader("di_s_per_read").read(ctx) == 0.1
    assert man.reader("dp_wait_s_per_read").read(ctx) == 0.01
    assert man.reader("host_dp_s_per_read").read(ctx) == 0.02
    assert man.reader("host_cpu_s_per_read").read(ctx) == 0.8
    assert man.reader("walk_host_route_share").read(ctx) == pytest.approx(0.7)


def events():
    """Thread 1: a counts range [100, 200] (corr 4) holding an aten op
    [110, 120] (corr 5); a walks range [400, 700] (corr 6) with a DI range
    inside on thread 2 [450, 500] (corr 7).  Device: a kernel launched
    from the range itself (linked 4) [150, 170], one from the op inside it
    (linked 5) [180, 190], one from the DI range (linked 7) [460, 480],
    one from no range (linked 99) [800, 820]."""
    return [
        ("cpu", "bench.counts#0", 100, 200, 1, 4, None),
        ("cpu", "aten::copy_", 110, 120, 1, 5, None),
        ("cpu", "bench.walks", 400, 700, 1, 6, None),
        ("cpu", "bench.di_device#1", 450, 500, 2, 7, None),
        ("cpu", "aten::empty", 900, 901, 3, 99, None),
        ("dev", "counts_kernel", 150, 170, None, None, 4),
        ("dev", "Memcpy HtoD", 180, 190, None, None, 5),
        ("dev", "di_kernel", 460, 480, None, None, 7),
        ("dev", "other", 800, 820, None, None, 99),
        ("dev", "before the span", -50, -10, None, None, 99),
    ]


def test_idle_share_and_gaps():
    s = trace.summarize(events(), 0, 1000, {0: ("bench.counts", 3e9, 0), 1: ("bench.di_device", 0, 1e6)})
    assert s.busy_ns == 20 + 10 + 20 + 20
    r = manifest.Manifest(ROOT).reader("device_idle_share")
    assert r.read(Ctx(trace=s)) == pytest.approx(100 * (1 - 70 / 1000))
    gaps = s.idle_gaps()
    # gaps: [0, 150], [170, 180], [190, 460], [480, 800], [820, 1000]
    assert [g[1] for g in gaps] == [pytest.approx(x * 1e-9) for x in (320, 270, 180, 150, 10)]
    assert gaps[0][0] == "bench.walks"  # the middle of [480, 800] is inside the walks
    assert gaps[1][0] == "host outside the ranges"
    assert gaps[4][0] == "bench.counts"


def test_range_device_time_and_roofline():
    work = {0: ("bench.counts", 3e9, 0), 1: ("bench.di_device", 0, 1e6)}
    s = trace.summarize(events(), 0, 1000, work)
    assert s.range_dev_ns["bench.counts#0"] == 30
    assert s.range_dev_ns["bench.di_device#1"] == 20
    assert s.unattributed_dev_ns == 20
    least, dev, bounds = s.roofline("bench.counts")
    assert dev == pytest.approx(30e-9)
    assert least == pytest.approx(3e9 / roofline.INT32_OPS_PER_S)
    assert bounds == {"operations": 1}
    least, dev, bounds = s.roofline("bench.di_device")
    assert least == pytest.approx(1e6 / roofline.HBM_BYTES_PER_S) and bounds == {"bytes": 1}
    assert s.roofline("bench.consensus") is None


@pytest.fixture(scope="module")
def chip_smoke():
    sys.path.insert(0, ROOT)
    try:
        import chip_smoke as cs
    finally:
        sys.path.remove(ROOT)
    return cs


def test_counts_bound_matches_chip_smoke(chip_smoke):
    rng = np.random.default_rng(5)
    for n, unit in ((3, 100), (4096, 100), (1024, 200), (256, 400)):
        scal = np.zeros((n, 8), np.int32)
        scal[:, 0] = rng.integers(1, 32768, n)
        scal[:, 1] = unit
        ms, bound, _cells = chip_smoke.counts_bound(scal)
        s, mine = roofline.least_s(*roofline.counts_work(scal))
        assert s * 1e3 == pytest.approx(ms, rel=1e-12) and mine == bound


def test_di_bound_matches_chip_smoke(chip_smoke):
    L = 118160
    rsl = L // 10
    di_len = L + 2 * rsl
    for k, max_w in ((1, 20), (3, 80), (5, 10240)):
        ws = []
        w = 5
        while w <= max_w and w < L // 2:
            ws.append(w)
            w *= 2
        for manhattan, kind in ((True, "l1"), (False, "pcc")):
            passes = roofline.di_passes(di_len, ws, k, rsl, manhattan)
            ms, bound = chip_smoke.di_bound(kind, [n for n, _ in passes], [w for _, w in passes])
            s, mine = roofline.least_s(*roofline.di_work(passes, manhattan))
            assert s * 1e3 == pytest.approx(ms, rel=1e-12) and mine == bound


def test_peaks():
    assert roofline.INT32_OPS_PER_S == pytest.approx(16.72704e12)
    assert roofline.HBM_BYTES_PER_S == 3.35e12
