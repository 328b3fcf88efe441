"""The port's span recorder (mtr_tpu_torch/utils/timers.py) and the spans
placed at its layer boundaries: nothing kept while recording is off, and
no torch imported by the recorder; run_file's spans under the host
engine, the device backend's plain ops on CPU tensors and the torch
hybrid with a CPU device leg, each nested on its thread, with batch ids
that tie the reader's waits to the stage threads; the anchors that put a
span on torch.profiler's clock; exact counts and sums from many threads;
and -c's reference lines."""

import contextlib
import io
import os
import random
import subprocess
import sys
import threading
import time
from collections import defaultdict

import pytest
import torch

from mtr_tpu_torch import cli
from mtr_tpu_torch import pipeline as tp
from mtr_tpu_torch.config import MTRConfig
from mtr_tpu_torch.utils.timers import TIMERS, Timers

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# spans every run_file path reaches
COMMON = {
    "mtr.read.input", "mtr.read.di", "mtr.read.wait_walks",
    "mtr.read.wait_stage_b", "mtr.read.emit", "mtr.walk.batch",
    "mtr.walk.collect", "mtr.walk.hits", "mtr.stage_b.batch",
    "mtr.stage_b.upload", "mtr.stage_b.ranges", "mtr.stage_b.schemes", "mtr.stage_b.select",
    "mtr.stage_b.polish", "mtr.polish.repeat", "mtr.polish.consensus",
    "mtr.polish.score", "mtr.stage_b.ksweep", "mtr.stage_b.replay",
    "mtr.stage_b.chaining",
}
# the device DI plug-in's spans on the CPU route (no pinned staging), and
# the pairing of a k's passes after it, all on the reader thread
DEVICE_DI = {"mtr.di.device", "mtr.di.widen", "mtr.di.finish", "mtr.di.pair"}
DEVICE_DP = {"mtr.dp.pack", "mtr.dp.launch", "mtr.dp.wait", "mtr.dp.collect"}
PATHS = {
    "host": COMMON | {"mtr.walk.native", "mtr.dp.host",
                      "mtr.stage_b.next_wave"},
    "device": COMMON | DEVICE_DP | DEVICE_DI | {
        "mtr.walk.device", "mtr.walk.upload",
        "mtr.walk.stage_a", "mtr.walk.kernel", "mtr.walk.rows"},
    "hybrid": COMMON | DEVICE_DP | {
        "mtr.walk.native", "mtr.dp.host", "mtr.dp.hybrid_wait",
        "mtr.dp.device_leg", "mtr.dp.upload"},
}
# stage B's phases: every direct child of mtr.stage_b.batch
PHASES = {"mtr.stage_b.upload", "mtr.stage_b.ranges", "mtr.stage_b.schemes",
          "mtr.stage_b.select", "mtr.stage_b.polish", "mtr.stage_b.ksweep",
          "mtr.stage_b.replay", "mtr.stage_b.next_wave",
          "mtr.stage_b.chaining", "mtr.walk.batch"}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def fasta(tmp_path_factory):
    """Three 1,100-base reads, each a 23-base unit repeated 11 times
    (one substitution) between random flanks: polished, on every path."""
    rnd = random.Random(13)
    path = tmp_path_factory.mktemp("spans") / "three.fasta"
    with open(path, "w") as f:
        for r in range(3):
            flank = lambda n: "".join(rnd.choice("ACGT") for _ in range(n))
            unit = flank(23)
            seq = (flank(300) + unit * 5 + unit[:9] + "T" + unit[10:]
                   + unit * 5 + flank(300 + 40 * r))
            f.write(f">r{r}\n{seq}\n")
    return str(path)


def _recorded(fasta, path, monkeypatch):
    cfg = MTRConfig(backend="host", reads_per_batch=1)
    batcher = None
    if path == "host":
        monkeypatch.setenv("MTR_TPU_WAVES", "1")  # extra waves in stage B
    elif path == "device":
        cfg = MTRConfig(backend="device", reads_per_batch=1,
                        device_di_threshold=500)
        batcher = tp.TorchDPBatcher(torch.device("cpu"))
    else:
        cfg = MTRConfig(backend="hybrid", reads_per_batch=1)
        batcher = tp.TorchHybridDPBatcher(torch.device("cpu"),
                                          cell_threshold=0,
                                          min_device_cells=0)
    before = TIMERS.snapshot()[1]
    TIMERS.record()
    try:
        out = io.StringIO()
        tp.run_file(fasta, cfg, out, batcher=batcher)
    finally:
        spans, anchors = TIMERS.stop()
    after = TIMERS.snapshot()[1]
    host = io.StringIO()
    tp.run_file(fasta, MTRConfig(backend="host"), host)
    assert out.getvalue() == host.getvalue() and out.getvalue()
    return spans, anchors, {k: after[k] - before.get(k, 0) for k in after}


def test_nothing_kept_while_off_and_no_torch_imported():
    tm = Timers()
    with tm.span("mtr.test.a", "acc"):
        with tm.span("mtr.test.b"):
            pass
    assert tm._records == [] and tm.stop()[0] == []
    assert tm.t["mtr.test.a"] >= tm.t["mtr.test.b"] >= 0
    assert tm.t["acc"] == tm.t["mtr.test.a"]
    tm.record()
    with tm.span("mtr.test.c"):
        pass
    spans, (start, end) = tm.stop()
    assert [s.name for s in spans] == ["mtr.test.c"]
    assert start[1] <= spans[0].start_ns <= spans[0].end_ns <= end[1]
    with tm.span("mtr.test.d"):
        pass
    assert tm.stop()[0] == []
    code = ("import sys\nfrom mtr_tpu_torch.utils.timers import TIMERS\n"
            "with TIMERS.span('mtr.x', 'y'):\n    pass\n"
            "TIMERS.count('z')\nTIMERS.print_summary(sys.stdout)\n"
            "assert 'torch' not in sys.modules, 'torch imported'\n"
            "print('NO_TORCH_OK')\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=60)
    assert r.returncode == 0 and "NO_TORCH_OK" in r.stdout, r.stderr


@pytest.mark.parametrize("path", ["host", "device", "hybrid"])
def test_run_file_spans(fasta, path, monkeypatch):
    spans, anchors, grew = _recorded(fasta, path, monkeypatch)
    names = {s.name for s in spans}
    assert PATHS[path] <= names, sorted(PATHS[path] - names)
    assert all(s.name.startswith("mtr.") for s in spans)
    assert grew["batches"] == 3
    assert 0 < grew["walk_hit_queries"] <= grew["speculative_queries"]
    assert grew["polish_items"] > 0
    roles = defaultdict(set)
    for s in spans:
        roles[s.role].add(s.name)
        assert s.start_ns <= s.end_ns
        if s.parent is None:
            continue
        p = spans[s.parent]
        # a child lies inside its parent, on its thread; the hybrid's
        # device leg starts under the stage B phase that waits for it
        assert p.start_ns <= s.start_ns and s.end_ns <= p.end_ns, (s, p)
        if s.name == "mtr.dp.device_leg":
            assert p.role == "stage_b" and s.role == "dp_device"
            assert p.tid != s.tid and p.batch == s.batch
        else:
            assert p.tid == s.tid and p.role == s.role, (s, p)
    assert roles["reader"] == {
        "mtr.read.input", "mtr.read.di", "mtr.read.wait_walks",
        "mtr.read.wait_stage_b", "mtr.read.emit"} | (
            DEVICE_DI if path == "device" else set())
    assert "mtr.walk.batch" in roles["walks"]
    assert "mtr.stage_b.batch" in roles["stage_b"]
    if path == "hybrid":
        assert "mtr.dp.device_leg" in roles["dp_device"]
        assert {"mtr.dp.launch", "mtr.dp.wait"} <= roles["dp_device"]
    if path == "host":
        assert any(s.name == "mtr.walk.batch" and s.role == "stage_b"
                   for s in spans), "no extra wave walked in stage B"
    # batch ids: each wait names the batch its stage thread ran
    roots = {(s.name, s.batch) for s in spans
             if s.parent is None and s.role in ("walks", "stage_b")}
    for wait, root in (("mtr.read.wait_walks", "mtr.walk.batch"),
                       ("mtr.read.wait_stage_b", "mtr.stage_b.batch")):
        waited = sorted(s.batch for s in spans if s.name == wait)
        assert waited == [1, 2, 3], (wait, waited)
        assert all((root, b) in roots for b in waited), (root, roots)
    # stage B's phases cover its batches
    total = covered = 0
    for i, s in enumerate(spans):
        if s.name != "mtr.stage_b.batch":
            continue
        total += s.end_ns - s.start_ns
        kids = [c for c in spans if c.parent == i]
        assert {c.name for c in kids} <= PHASES
        covered += sum(c.end_ns - c.start_ns for c in kids)
    assert covered >= 0.95 * total > 0


def test_spans_meet_the_profiler_ranges():
    """Each kept span, moved to the profiler's clock by the anchors, lies
    within 1 ms of the profiler's range of the same name, on the main
    thread and on another."""
    from torch._C._profiler import _ExperimentalConfig
    from torch.profiler import ProfilerActivity, profile

    def work(tag):
        with TIMERS.span(f"mtr.clock.{tag}"):
            time.sleep(0.004)
            with TIMERS.span(f"mtr.clock.{tag}.inner"):
                torch.ones(64).sum()
                time.sleep(0.002)

    with profile(activities=[ProfilerActivity.CPU],
                 experimental_config=_ExperimentalConfig(
                     profile_all_threads=True)) as prof:
        TIMERS.record()
        work("main")
        t = threading.Thread(target=work, args=("side",))
        t.start()
        t.join(60)
        assert not t.is_alive()
        work("main2")
        spans, (start, end) = TIMERS.stop()
    # the anchors are read back to back; the wall clock runs with the
    # monotonic one over the run
    offset = start[0] - start[1]
    assert abs((end[0] - end[1]) - offset) < 1_000_000
    ranges = defaultdict(list)
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith("mtr.clock."):
            ranges[e.name()].append((e.start_ns(),
                                     e.start_ns() + e.duration_ns()))
    assert sorted(s.name for s in spans) == sorted(ranges)
    for s in spans:
        (lo, hi), = ranges[s.name]
        assert abs(s.start_ns + offset - lo) < 1_000_000, s
        assert abs(s.end_ns + offset - hi) < 1_000_000, s


def test_counts_and_sums_from_many_threads_are_exact():
    """8 threads x 10,000 of each update, switching threads as often as
    the interpreter allows: an update lost between a read and its write
    would show in the totals."""
    tm = Timers()

    def hammer():
        for _ in range(10_000):
            tm.count("n")
            tm.add("s", 1.0)
            with tm.span("mtr.hammer", "spans"):
                pass

    threads = [threading.Thread(target=hammer) for _ in range(8)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert tm.counters["n"] == 80_000
    assert tm.t["s"] == 80_000.0
    assert tm.t["spans"] == tm.t["mtr.hammer"] > 0
    assert tm.snapshot()[1] == {"n": 80_000}


REFERENCE_LINES = ["Computation time", "all", "allocating memory", "ranges",
                   "Computing periods", "Initialize the input",
                   "count table generation", "wrap around", "chaining",
                   "Count of queries"]


def test_c_summary_keeps_the_reference_lines(fasta):
    err = io.StringIO()
    with contextlib.redirect_stderr(err), \
            contextlib.redirect_stdout(io.StringIO()):
        assert cli.main(["--backend", "host", "-c", fasta]) == 0
    lines = err.getvalue().splitlines()
    assert [ln.split("\t")[-1] for ln in lines[:10]] == REFERENCE_LINES
    value = {ln.split("\t")[-1]: float(ln.split("\t")[-2])
             for ln in lines if ln.count("\t") >= 1}
    assert value["allocating memory"] == 0.0
    walks = value["Computing periods: the walk thread"]
    stage_b = value["Computing periods: stage B"]
    assert walks > 0 and stage_b > 0
    assert value["Computing periods"] == pytest.approx(walks + stage_b,
                                                       abs=2e-6)
    # every counter and every span total is printed
    for key in ("batches", "walk_hit_queries", "polish_items",
                "speculative_queries", "mtr.stage_b.batch", "mtr.walk.batch",
                "mtr.read.wait_stage_b"):
        assert key in value, key
