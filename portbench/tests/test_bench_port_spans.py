"""The readers of the port's spans and counters, and portbench.port_spans
on synthetic spans, gaps and anchors: per-read sums over the window,
nothing read from a program without the spans, clipping to the profiled
span (spans across its edges), stage B's walks nested in it, coverage by
role, the idle gaps named by the innermost span of each role (and a gap
with none), and the move onto the profiler's clock."""

import os

import pytest

from portbench import manifest, port_spans
from portbench.port_spans import Span

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
NEW = ("reader_wait_s_per_read", "schemes_s_per_read", "polish_s_per_read",
       "wave_host_s_per_read", "hybrid_wait_s_per_read", "walk_hit_share")


class Ctx:
    def __init__(self, **kw):
        self.trace = None
        self.__dict__.update(kw)

    def per_read(self, s):
        return s / self.reads if self.reads else None


class NoSpans:
    """The recorder of a program that keeps no spans."""
    t: dict = {}
    counters: dict = {}


def readers():
    man = manifest.Manifest(ROOT)
    return {name: man.reader(name) for name in NEW}


def test_readers_over_the_window():
    timers = {"mtr.read.wait_walks": 2.0, "mtr.read.wait_stage_b": 3.0,
              "mtr.stage_b.schemes": 4.0, "mtr.stage_b.polish": 1.5,
              "mtr.stage_b.select": 0.5, "mtr.stage_b.ksweep": 0.25,
              "mtr.stage_b.replay": 0.125, "mtr.stage_b.next_wave": 0.0,
              "mtr.stage_b.chaining": 0.125, "mtr.dp.hybrid_wait": 0.75,
              "walks": 9.0}
    ctx = Ctx(reads=10, timers=timers,
              counters={"walk_hit_queries": 30, "speculative_queries": 1200})
    r = readers()
    assert r["reader_wait_s_per_read"].read(ctx) == 0.5
    assert r["schemes_s_per_read"].read(ctx) == 0.4
    assert r["polish_s_per_read"].read(ctx) == 0.15
    assert r["wave_host_s_per_read"].read(ctx) == 0.1
    assert r["hybrid_wait_s_per_read"].read(ctx) == 0.075
    assert r["walk_hit_share"].read(ctx) == 2.5


def test_readers_read_nothing_without_the_spans():
    """The parent's program: timers and counters without the port's
    spans; every reader returns None and none raises, trace or not."""
    ctx = Ctx(reads=10, timers={"walks": 1.0, "range": 2.0},
              counters={"speculative_queries": 100})
    for name, r in readers().items():
        assert r.read(ctx) is None, name
    assert port_spans.take(NoSpans()) is None


def spans():
    """The profiled span is [1000, 2000].  Reader thread 1: an input
    [900, 1100] across the start, a wait for stage B [1100, 1900].  Walk
    thread 2: a batch [1200, 2100] across the end, its collect [1200,
    1300] and engine [1300, 2050].  Stage B thread 3: a batch [1000,
    1800] holding schemes [1000, 1400], polish [1400, 1600] and an extra
    wave's walks [1600, 1790] with their engine [1610, 1780].  Device
    leg thread 4, started from the schemes: [1050, 1350], its launch
    [1060, 1340]."""
    return [
        Span("mtr.read.input", 900, 1100, 1, "reader", 2, None),       # 0
        Span("mtr.read.wait_stage_b", 1100, 1900, 1, "reader", 1, None),
        Span("mtr.walk.batch", 1200, 2100, 2, "walks", 2, None),       # 2
        Span("mtr.walk.collect", 1200, 1300, 2, "walks", 2, 2),
        Span("mtr.walk.native", 1300, 2050, 2, "walks", 2, 2),
        Span("mtr.stage_b.batch", 1000, 1800, 3, "stage_b", 1, None),  # 5
        Span("mtr.stage_b.schemes", 1000, 1400, 3, "stage_b", 1, 5),
        Span("mtr.stage_b.polish", 1400, 1600, 3, "stage_b", 1, 5),
        Span("mtr.walk.batch", 1600, 1790, 3, "stage_b", 1, 5),        # 8
        Span("mtr.walk.native", 1610, 1780, 3, "stage_b", 1, 8),
        Span("mtr.dp.device_leg", 1050, 1350, 4, "dp_device", 1, 6),   # 10
        Span("mtr.dp.launch", 1060, 1340, 4, "dp_device", 1, 10),
    ]


def test_sums_clip_to_the_window_and_keep_roles_apart():
    s = port_spans.sums(spans(), 1000, 2000)
    assert s[("reader", "mtr.read.input")] == (pytest.approx(100e-9),) * 2
    assert s[("walks", "mtr.walk.batch")] == pytest.approx((800e-9, 0.0))
    assert s[("walks", "mtr.walk.native")][0] == pytest.approx(700e-9)
    # the extra wave's walks are stage B's, not the walk thread's
    assert s[("stage_b", "mtr.walk.batch")] == pytest.approx((190e-9, 20e-9))
    b, b_self = s[("stage_b", "mtr.stage_b.batch")]
    assert b == pytest.approx(800e-9)
    assert b_self == pytest.approx((800 - 400 - 200 - 190) * 1e-9)
    # the device leg is a child on another thread: not taken from schemes
    assert s[("stage_b", "mtr.stage_b.schemes")] == pytest.approx((400e-9,) * 2)


def test_coverage_by_role():
    cov = port_spans.coverage(spans(), 1000, 2000)
    assert cov["walks"] == pytest.approx((800e-9, 800e-9))
    assert cov["stage_b"] == pytest.approx((790e-9, 800e-9))
    assert cov["dp_device"] == pytest.approx((280e-9, 300e-9))
    # the reader from its first kept span (clipped to the start) to the end
    assert cov["reader"] == pytest.approx((900e-9, 1000e-9))


def test_idle_gaps_by_port_span():
    gaps = [(1000, 1040),   # mid 1020: reader input, stage B schemes
            (1300, 1320),   # mid 1310: + the walk engine, the launch
            (1690, 1710),   # mid 1700: the extra wave's walk engine
            (1950, 2000)]   # mid 1975: the walk engine only
    out = dict(port_spans.idle_by_port_span(gaps, spans()))
    assert out["reader:mtr.read.input"] == pytest.approx(40e-9)
    assert out["stage_b:mtr.stage_b.schemes"] == pytest.approx(60e-9)
    assert out["reader:mtr.read.wait_stage_b"] == pytest.approx(40e-9)
    assert out["walks:mtr.walk.native"] == pytest.approx((20 + 20 + 50) * 1e-9)
    assert out["dp_device:mtr.dp.launch"] == pytest.approx(20e-9)
    assert out["stage_b:mtr.walk.native"] == pytest.approx(20e-9)
    assert "no port span" not in out
    none = port_spans.idle_by_port_span([(2200, 2400)], spans())
    assert none == [["no port span", pytest.approx(200e-9)]]
    top = port_spans.idle_by_port_span(gaps, spans(), top=2)
    assert [k for k, _ in top] == ["walks:mtr.walk.native",
                                   "stage_b:mtr.stage_b.schemes"]


def test_innermost_skips_spans_that_ended():
    line = port_spans.Timeline([s for s in spans() if s.role == "stage_b"])
    assert line.innermost(1700).name == "mtr.walk.native"
    assert line.innermost(1785).name == "mtr.walk.batch"
    assert line.innermost(1795).name == "mtr.stage_b.batch"
    assert line.innermost(1900) is None and line.innermost(500) is None


def test_profiler_clock_by_the_anchors():
    s = [Span("mtr.x", 1_000, 3_000, 1, "reader", None, None)]
    # wall = perf + 10_000 at the start, + 10_200 at the end (the wall
    # clock slewed 200 ns over 2,000 ns)
    out = port_spans.on_profiler_clock(s, ((11_000, 1_000), (13_200, 3_000)))
    assert (out[0].start_ns, out[0].end_ns) == (11_000, 13_200)
    mid = port_spans.on_profiler_clock(
        [s[0]._replace(start_ns=2_000)], ((11_000, 1_000), (13_200, 3_000)))
    assert mid[0].start_ns == 12_100


class Recorder:
    def __init__(self, kept, anchors):
        self.kept, self.anchors = kept, anchors

    def record(self):
        pass

    def stop(self):
        return self.kept, self.anchors


class Trace:
    lo, hi = 11_000, 12_000
    gaps = [(11_300, 11_320)]


def test_report_logs_once(capsys):
    # the profiler's clock reads 10,000 ns ahead of the recorder's
    rec = Recorder(spans(), ((10_000, 0), (10_000, 0)))
    ctx = Ctx(reads=2, timers={"mtr.stage_b.batch": 1.0, "walks": 3.0},
              trace=Trace())
    port_spans.report(ctx, rec)
    port_spans.report(ctx, rec)
    err = capsys.readouterr().err
    assert err.count("idle_by_port_span") == 1
    # the window's port spans a read, the -c accumulators left out
    assert 'over the window {"mtr.stage_b.batch": 0.5}\n' in err
    assert "port span coverage walks 100.00%" in err
    assert "walks:mtr.walk.native" in err
