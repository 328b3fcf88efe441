"""The port's pipeline on the CPU: its run_file reproduces the in-repo
goldens byte for byte, on the host engine, on the torch hybrid with its
device leg engaged (and with its walk pre-filter), and on the device
backend (every DP job, DI and the DBG walks on the torch device, every
wave included), with the plain PyTorch ops on CPU tensors; backend
selection raises rather than falling back (auto included); the package
runs with JAX and mtr_tpu blocked."""

import io
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from mtr_tpu_torch import pipeline as tp
from mtr_tpu_torch.config import MTRConfig
from mtr_tpu_torch.pipeline import HostDPBatcher
from mtr_tpu_torch.utils.timers import TIMERS
from mtr_tpu_torch.ops import directional_index, wrap_dp_resident
from tests._dp_tables import dp_table

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(REPO, "tests", "golden")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def di_passes():
    return sum(TIMERS.counters[c] for c in directional_index.PASS_COUNTERS)


def _golden(name):
    with open(os.path.join(GOLDEN, f"{name}.out")) as f:
        return f.read()


def _run(name, cfg, **kw):
    out = io.StringIO()
    tp.run_file(os.path.join(GOLDEN, f"{name}.fasta"), cfg, out, **kw)
    return out.getvalue()


@pytest.mark.parametrize("name", ["multi20_100x10", "multitr_gen_2_5_10_20"])
def test_host_run_file_matches_golden(name):
    assert _run(name, MTRConfig(backend="host")) == _golden(name)


def test_cpu_hybrid_matches_golden_with_device_leg(monkeypatch):
    """Thresholds lowered so the device leg takes every job of 2^16+
    cells (676 jobs, rep_len up to 1268 on this set); on CPU tensors the
    op runs its plain version, which must then reproduce the golden."""
    calls = []
    plain = wrap_dp_resident.wrap_dp_counts_plain

    def spy(scal, rep, unit):
        calls.append((scal.shape[0], int(scal[:, 0].max())))
        return plain(scal, rep, unit)

    monkeypatch.setattr(wrap_dp_resident, "wrap_dp_counts_plain", spy)
    batcher = tp.TorchHybridDPBatcher(
        torch.device("cpu"), cell_threshold=1 << 16, min_device_cells=0)
    got = _run("multi20_100x10",
               MTRConfig(backend="hybrid", reads_per_batch=16),
               batcher=batcher)
    assert got == _golden("multi20_100x10")
    assert calls, "the device leg never ran"
    assert sum(n for n, _ in calls) == 676
    assert max(r for _, r in calls) == 1268
    assert batcher.device.cells > 0 and batcher.host_cells > 0


def _never(*args, **kw):
    raise AssertionError("mtr_tpu's walk stage was called")


def test_host_stages_get_host_backend(monkeypatch):
    """The walk stage and the wave loop are the port's own: they see the
    run's real backend, and mtr_tpu's walk_batch / process_batch (whose
    device branches import JAX) are never reached."""
    import mtr_tpu.pipeline as mp

    monkeypatch.setattr(mp, "walk_batch", _never)
    monkeypatch.setattr(mp, "process_batch", _never)
    seen = []
    for name in ("walk_batch", "process_batch"):
        real = getattr(tp, name)

        def spy(states, *args, _real=real, _name=name, **kw):
            cfg = args[1] if _name == "process_batch" else args[0]
            seen.append((_name, cfg.backend))
            return _real(states, *args, **kw)

        monkeypatch.setattr(tp, name, spy)
    got = _run("multitr_gen_2_5_10_20", MTRConfig(backend="hybrid"),
               batcher=HostDPBatcher())
    assert got == _golden("multitr_gen_2_5_10_20")
    assert {n for n, _ in seen} == {"walk_batch", "process_batch"}
    assert {b for _, b in seen} == {"hybrid"}


def test_make_batcher_backends():
    assert isinstance(tp.make_batcher(MTRConfig(backend="host")),
                      HostDPBatcher)
    if torch.cuda.is_available():
        assert isinstance(tp.make_batcher(MTRConfig(backend="device")),
                          tp.TorchDPBatcher)
    else:
        with pytest.raises(tp.BackendUnavailable, match="CUDA"):
            tp.make_batcher(MTRConfig(backend="device"))
    with pytest.raises(ValueError):
        tp.make_batcher(MTRConfig(backend="tpu"))


def test_cli_host_and_refusals(capsys):
    from mtr_tpu_torch import cli

    fasta = os.path.join(GOLDEN, "multitr_gen_2_5_10_20.fasta")
    assert cli.main(["--backend", "host", fasta]) == 0
    assert capsys.readouterr().out == _golden("multitr_gen_2_5_10_20")
    if torch.cuda.is_available():
        return  # the refusals below are those of a machine without a card
    # the CLI's device backend runs everything on the card: without one
    # it exits 1 with the no-CUDA message, and prints no record
    for backend in ("device", "hybrid", "auto"):
        assert cli.main(["--backend", backend, fasta]) == 1
        got = capsys.readouterr()
        assert "needs a CUDA device" in got.err and not got.out


def test_cuda_requests_raise_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the CPU-only "
                    "refusal")
    for backend in ("hybrid", "auto"):
        with pytest.raises(tp.BackendUnavailable, match="CUDA"):
            tp.make_batcher(MTRConfig(backend=backend))
    batcher = tp.TorchDPBatcher(torch.device("cuda"))
    with pytest.raises((RuntimeError, AssertionError)):
        batcher.begin_batch([np.zeros(100, np.int32)])


def _host_run(orgs, table):
    host = HostDPBatcher()
    host.begin_batch(orgs)
    return host.run_table(table)


def test_device_batcher_matches_host_engine():
    rng = np.random.default_rng(3)
    orgs = [rng.integers(0, 4, 2000).astype(np.int32) for _ in range(3)]
    jobs = []
    for r, org in enumerate(orgs):
        for ul in (3, 130, 300):
            qs = int(rng.integers(0, 500))
            unit = org[qs + 1 : qs + 1 + ul]
            jobs.append((r, qs, qs + int(rng.integers(ul, 1400)), unit,
                         (1, 1, 3), "counts"))
    table = dp_table(jobs)
    dev = tp.TorchDPBatcher(torch.device("cpu"))
    dev.begin_batch(orgs)
    got, _ = dev.run_table(table)
    want, _ = _host_run(orgs, table)
    np.testing.assert_array_equal(got, want)
    assert dev.cells == sum((qe - qs + 1) * len(unit)
                            for _, qs, qe, unit, _, _ in jobs)


def test_device_batcher_runs_consensus_jobs():
    """Consensus jobs run on the device path (plain version here) and
    equal the host engine's, column for column, in a mixed run with
    counts jobs."""
    rng = np.random.default_rng(11)
    orgs = [rng.integers(0, 4, 1500).astype(np.int32) for _ in range(2)]
    jobs = []
    for r, org in enumerate(orgs):
        for ul, scheme in ((4, (5, 1, 1)), (60, (1, 1, 3)), (140, (5, 1, 1)),
                           (300, (1, 1, 3))):
            qs = int(rng.integers(0, 400))
            unit = org[qs + 1 : qs + 1 + ul]
            qe = qs + int(rng.integers(ul, 900))
            jobs.append((r, qs, qe, unit, scheme, "consensus"))
            jobs.append((r, qs, qe, unit, scheme, "counts"))
    table = dp_table(jobs)
    dev = tp.TorchDPBatcher(torch.device("cpu"))
    dev.begin_batch(orgs)
    got_counts, got_cons = dev.run_table(table)
    want_counts, want_cons = _host_run(orgs, table)
    is_counts = table.mode == 0
    np.testing.assert_array_equal(got_counts[is_counts],
                                  want_counts[is_counts])
    assert len(got_cons[0]) == len(jobs) // 2
    np.testing.assert_array_equal(got_cons[0], want_cons[0])
    np.testing.assert_array_equal(got_cons[1], want_cons[1])
    assert dev.cons_cells == sum((qe - qs + 1) * len(unit)
                                 for _, qs, qe, unit, _, mode in jobs
                                 if mode == "consensus")


def test_launch_names_its_mode(monkeypatch):
    """TorchDPBatcher._launch takes the mode by name, 'counts' or
    'consensus': portbench's roofline (portbench/trace.py) counts a
    launch's work by that name."""
    seen = []
    real = tp.TorchDPBatcher._launch

    def spy(self, mode, *a):
        seen.append(mode)
        return real(self, mode, *a)

    monkeypatch.setattr(tp.TorchDPBatcher, "_launch", spy)
    org = np.random.default_rng(5).integers(0, 4, 1500).astype(np.int32)
    dev = tp.TorchDPBatcher(torch.device("cpu"))
    dev.begin_batch([org])
    dev.run_table(dp_table([(0, 10, 400, org[11:71], (1, 1, 3), mode)
                            for mode in ("consensus", "counts")]))
    assert sorted(seen) == ["consensus", "counts"]


def test_polish_rounds_run_a_shared_job_once():
    """Two polish items that share (read, range, unit), as two k values of
    one range give them: each round's consensus table and score table
    hold one row for the pair, and both records come out revised (the
    consensus mends the unit's wrong base) and equal."""
    from mtr_tpu_torch.io.fasta import Read
    from mtr_tpu_torch.records import RepeatRecord
    from mtr_tpu_torch.utils.encoding import decode_bases, encode_bases

    rng = np.random.default_rng(7)
    unit, wrong = "ACGTTGCAAC", "ACGTAGCAAC"
    codes = encode_bases(decode_bases(rng.integers(0, 4, 200).tolist())
                         + unit * 14
                         + decode_bases(rng.integers(0, 4, 200).tolist()))
    org = np.append(codes, 0).astype(np.int32)
    states = [tp.ReadState(Read("r0", codes), org, None, None, None, 0)]
    host = HostDPBatcher()
    host.begin_batch([org])
    qs, qe = 150, 400
    counts, _ = host.run_table(tp.job_table([0], [qs], [qe], [wrong],
                                            ((1, 1, 3),), "counts")[0])
    # kmer 12 > period 10: polish_repeat leaves the unit to the rounds
    rr = RepeatRecord(read_id="r0", input_len=len(codes), rep_period=10,
                      kmer=12, string=wrong, string_score=[2] * 10)
    tp.apply_counts(rr, qs, 10, (1, 1, 3), counts[0].tolist())
    before = rr.copy()
    items = [(tp.RangeQuery(0, qs, qe, 50, k), rr.copy()) for k in (12, 13)]
    tables = []
    real = host.run_table
    host.run_table = lambda t: tables.append(
        [tp.MODES[m] for m in t.mode]) or real(t)
    jobs = TIMERS.counters["dp_jobs"]
    tp._polish_phase(host, states, items, MTRConfig())
    assert tables == [["consensus"], ["counts"]] * 2
    assert TIMERS.counters["dp_jobs"] - jobs == 4
    (_, a), (_, b) = items
    assert a == b and a != before
    assert a.string == unit and a.match_ratio() > before.match_ratio()


def _golden_lines(name, read_ids):
    return "".join(line for line in _golden(name).splitlines(True)
                   if line.split("\t", 1)[0] in read_ids)


def test_device_run_file_matches_golden(monkeypatch):
    """backend="device" with the walks on the host: every DP job (counts
    and consensus) and the DI of every read (threshold lowered to 1000
    bases) go through the port's device ops, here their plain versions.
    One of the 20 reads keeps the test inside its time budget (each read
    costs 12-16 s on one CPU thread); the arena still replays every
    read."""
    cons = []
    plain = wrap_dp_resident.consensus_resident_plain

    def spy(flat, starts, scal, unit, factor):
        cons.append(scal.shape[0])
        return plain(flat, starts, scal, unit, factor)

    monkeypatch.setattr(tp, "wrap_dp_consensus",
                        lambda *a: spy(*a[:4], a[5]))
    picks = {1}
    di_before = di_passes()
    batcher = tp.TorchDPBatcher(torch.device("cpu"))
    got = _run("multi20_100x10",
               MTRConfig(backend="device", use_device_walks=False,
                         device_di_threshold=1000),
               batcher=batcher, read_filter=picks.__contains__)
    assert got == _golden_lines("multi20_100x10", {str(r) for r in picks})
    assert cons and batcher.cons_cells > 0 and batcher.cells > 0
    assert di_passes() > di_before


def test_device_backend_refuses_device_walks(monkeypatch):
    """The device walks are no longer refused: MTRConfig(backend="device")
    (mtr_tpu's default, walks on the device) on a CPU TorchDPBatcher
    reproduces the golden, with every walk query through the port's
    stage A / B and no native walk call but the host route's."""
    calls = []
    real = tp.dbg_walk_device_batch
    monkeypatch.setattr(tp, "dbg_walk_device_batch",
                        lambda *a: calls.append(a[-1]) or real(*a))
    native_walks = []
    real_native = tp.native.dbg_walk_batch2
    monkeypatch.setattr(tp.native, "dbg_walk_batch2",
                        lambda *a, **k: native_walks.append(len(a[2]))
                        or real_native(*a, **k))
    before = dict(TIMERS.counters)
    got = _run("multitr_gen_2_5_10_20", MTRConfig(backend="device"),
               batcher=tp.TorchDPBatcher(torch.device("cpu")))
    assert got == _golden("multitr_gen_2_5_10_20")
    assert calls and {d.type for d in calls} == {"cpu"}

    def grew(key):
        return TIMERS.counters[key] - before.get(key, 0)

    assert grew("stage_a_calls") > 0
    assert grew("walk_device_calls") > 0
    assert grew("walk_waits") <= 2 * grew("walk_device_calls")
    # the one host-route query of this set goes to the native engine
    assert sum(native_walks) == grew("walk_fallback_queries")


def test_device_walks_every_wave(monkeypatch):
    """MTR_TPU_WAVES=1: waves 2+ are walked inside process_batch, through
    the port's walk_batch on the device walks.  The DP runs on the host
    leg of a CPU hybrid batcher (default thresholds) and six of the 20
    reads are kept, which keeps the test short; the walk device is the
    batcher's."""
    import mtr_tpu.pipeline as mp

    monkeypatch.setenv("MTR_TPU_WAVES", "1")
    monkeypatch.setattr(mp, "walk_batch", _never)
    devices = []
    real = tp.dbg_walk_device_batch
    monkeypatch.setattr(tp, "dbg_walk_device_batch",
                        lambda *a: devices.append(a[-1]) or real(*a))
    before = TIMERS.counters["waves_extra"]
    picks = set(range(6))
    got = _run("multi20_100x10", MTRConfig(backend="device"),
               batcher=tp.TorchHybridDPBatcher(torch.device("cpu")),
               read_filter=picks.__contains__)
    assert got == _golden_lines("multi20_100x10", {str(r) for r in picks})
    assert TIMERS.counters["waves_extra"] > before
    assert len(devices) > 1 and {d.type for d in devices} == {"cpu"}


def test_hybrid_walk_prefilter(monkeypatch):
    """The port's hybrid honours MTR_TPU_MF_FILTER (here with its size and
    CUDA gates opened, so walked_mask runs on CPU tensors): the native
    engine walks only the queries the filter keeps, and the output stays
    the golden."""
    monkeypatch.setattr(tp, "_use_mf_filter", lambda cfg, n_q, device: True)
    masks = []
    real = tp.walked_mask
    monkeypatch.setattr(tp, "walked_mask",
                        lambda *a: masks.append(real(*a)) or masks[-1])
    got = _run("multi20_100x10", MTRConfig(backend="hybrid"),
               batcher=tp.TorchHybridDPBatcher(torch.device("cpu")))
    assert got == _golden("multi20_100x10")
    kept = np.concatenate(masks)
    assert 0 < kept.sum() < len(kept) // 2


def test_mf_filter_gate(monkeypatch):
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    hybrid = MTRConfig(backend="hybrid")
    n = tp.MF_FILTER_MIN_QUERIES
    monkeypatch.delenv("MTR_TPU_MF_FILTER", raising=False)
    assert not tp._use_mf_filter(hybrid, n, cuda)
    monkeypatch.setenv("MTR_TPU_MF_FILTER", "1")
    assert tp._use_mf_filter(hybrid, n, cuda)
    assert not tp._use_mf_filter(hybrid, n - 1, cuda)
    assert not tp._use_mf_filter(hybrid, n, cpu)
    assert not tp._use_mf_filter(MTRConfig(backend="host"), n, cuda)


def test_hybrid_runs_consensus_on_device_leg(monkeypatch):
    """MTR_TPU_HYBRID_CONS_CELLS=0 sends every consensus job to the
    device leg, as mtr_tpu's HybridDPBatcher does; counts jobs stay on
    the host here, so the device leg runs only the consensus op."""
    monkeypatch.setenv("MTR_TPU_HYBRID_CONS_CELLS", "0")
    seen = []
    real = tp.TorchDPBatcher.run_table

    def spy(self, table):
        seen.extend(tp.MODES[m] for m in table.mode)
        return real(self, table)

    monkeypatch.setattr(tp.TorchDPBatcher, "run_table", spy)
    batcher = tp.TorchHybridDPBatcher(
        torch.device("cpu"), cell_threshold=1 << 62, min_device_cells=0)
    got = _run("multi20_100x10", MTRConfig(backend="hybrid"),
               batcher=batcher)
    assert got == _golden("multi20_100x10")
    assert seen and set(seen) == {"consensus"}
    assert batcher.device.cons_cells > 0


def test_hybrid_reraises_device_leg_failure(monkeypatch):
    """No fallback: a device-leg fault surfaces on the caller thread."""
    def boom(self, table):
        raise RuntimeError("device leg fault")

    monkeypatch.setattr(tp.TorchDPBatcher, "run_table", boom)
    org = np.zeros(3000, np.int32)
    hy = tp.TorchHybridDPBatcher(torch.device("cpu"), cell_threshold=0,
                                 min_device_cells=0)
    hy.begin_batch([org])
    with pytest.raises(RuntimeError, match="device leg fault"):
        hy.run_table(dp_table([(0, 0, 2000, [0, 1, 2], (1, 1, 3),
                                "counts")]))


_NO_JAX = r"""
import importlib.abc, io, sys

class _Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name in ("jax", "mtr_tpu") or name.startswith(
                ("jax.", "jaxlib", "mtr_tpu.")):
            raise ImportError(f"blocked import of {name}")

sys.meta_path.insert(0, _Block())
import mtr_tpu_torch, mtr_tpu_torch.pipeline, mtr_tpu_torch.cli
from mtr_tpu_torch.config import MTRConfig
out = io.StringIO()
mtr_tpu_torch.pipeline.run_file(sys.argv[1] + ".fasta",
                                MTRConfig(backend="host"), out)
assert out.getvalue() == open(sys.argv[1] + ".out").read()
recs = mtr_tpu_torch.find_repeats("ACGTTT" * 50, MTRConfig(backend="host"))
assert len(recs) == 1
# the CLI on the CPU backends and the clustering stage; the oracle (about
# 13 s a read here) on the set's first read
import contextlib, os, tempfile
golden = open(sys.argv[1] + ".out").read()
fasta = open(sys.argv[1] + ".fasta").read().split(">")
with tempfile.NamedTemporaryFile("w", suffix=".fasta", delete=False) as f:
    f.write(">" + fasta[1])
first = "".join(l for l in golden.splitlines(True) if l.startswith("0\t"))
for argv, path, want in (
        (["--backend", "host"], sys.argv[1] + ".fasta", golden),
        (["--backend", "host", "--cluster"], sys.argv[1] + ".fasta", golden),
        (["--backend", "oracle"], f.name, first)):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert mtr_tpu_torch.cli.main(argv + [path]) == 0
    text = buf.getvalue()
    assert text.startswith(want) and want, argv
    assert ("#CLUSTER" in text) == ("--cluster" in argv), argv
os.unlink(f.name)
# the device path on CPU tensors: every DP job, the DI and the walks on
# torch
import os, random, tempfile
import torch
from mtr_tpu_torch.ops import directional_index
rnd = random.Random(5)
flank = lambda n: "".join(rnd.choice("ACGT") for _ in range(n))
unit = flank(23)
seq = flank(300) + unit * 6 + unit[:9] + "T" + unit[10:] + unit * 5 + flank(300)
with tempfile.NamedTemporaryFile("w", suffix=".fasta", delete=False) as f:
    f.write(">r\n" + seq + "\n")
outs = []
for cfg, batcher in (
        (MTRConfig(backend="device", device_di_threshold=500),
         mtr_tpu_torch.pipeline.TorchDPBatcher(torch.device("cpu"))),
        (MTRConfig(backend="host"), None)):
    out = io.StringIO()
    mtr_tpu_torch.pipeline.run_file(f.name, cfg, out, batcher=batcher)
    outs.append(out.getvalue())
os.unlink(f.name)
assert outs[0] == outs[1] and outs[0], outs
from mtr_tpu_torch.utils.timers import TIMERS
assert sum(TIMERS.counters[c] for c in directional_index.PASS_COUNTERS) > 0
assert TIMERS.counters["stage_a_calls"] > 0
from mtr_tpu_torch.ops.wrap_dp_consensus import wrap_dp_consensus
fused, best = wrap_dp_consensus(
    torch.tensor([0, 1, 2, 0, 1, 2, 0, 1], dtype=torch.int8),
    torch.zeros(1, dtype=torch.int32),
    torch.tensor([[8, 3, 5, 1, 1, 0, 0, 0]], dtype=torch.int32),
    torch.tensor([[0, 1, 2] + [-2] * 125], dtype=torch.int8), 128, 6)
assert int(fused[0, 1:4, :3].trace()) > 0
assert not any(m in ("jax", "mtr_tpu") or m.startswith(("jax.", "mtr_tpu."))
               for m in sys.modules)
print("NO_JAX_OK")
"""


def test_package_runs_with_jax_blocked():
    env = {**os.environ, "PYTHONPATH": REPO}
    r = subprocess.run(
        [sys.executable, "-c", _NO_JAX,
         os.path.join(GOLDEN, "multi20_100x10")],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=240)
    assert r.returncode == 0, r.stderr
    assert "NO_JAX_OK" in r.stdout
