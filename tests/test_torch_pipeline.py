"""The port's pipeline on the CPU: its run_file reproduces the in-repo
goldens byte for byte, on the host engine, on the torch hybrid with its
device leg engaged, and on the device backend (every DP job and DI on
the torch device), with the plain PyTorch ops on CPU tensors; backend
selection raises rather than falling back; the package runs with JAX
blocked."""

import io
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from mtr_tpu.config import MTRConfig
from mtr_tpu.pipeline import DPJob, HostDPBatcher
from mtr_tpu_torch import pipeline as tp
from mtr_tpu_torch.ops import directional_index, wrap_dp_resident

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(REPO, "tests", "golden")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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


def test_host_stages_get_host_backend(monkeypatch):
    """walk_batch / process_batch see backend="host" whatever the run's
    backend, so mtr_tpu never reaches its JAX walk paths."""
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
    assert {b for _, b in seen} == {"host"}


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
    # the CLI's device backend asks for the device walks, not yet ported
    assert cli.main(["--backend", "device", fasta]) == 1
    err = capsys.readouterr().err
    assert "walks" in err and "use_device_walks=False" in err


def test_cuda_requests_raise_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the CPU-only "
                    "refusal")
    with pytest.raises(tp.BackendUnavailable, match="CUDA"):
        tp.make_batcher(MTRConfig(backend="hybrid"))
    assert isinstance(tp.make_batcher(MTRConfig(backend="auto")),
                      HostDPBatcher)
    batcher = tp.TorchDPBatcher(torch.device("cuda"))
    with pytest.raises((RuntimeError, AssertionError)):
        batcher.begin_batch([np.zeros(100, np.int32)])


def _job(org, qs, qe, unit, mode="counts"):
    return DPJob(org, qs, qe, np.asarray(unit, np.int32), (1, 1, 3), mode)


def test_device_batcher_matches_host_engine():
    rng = np.random.default_rng(3)
    orgs = [rng.integers(0, 4, 2000).astype(np.int32) for _ in range(3)]
    jobs = []
    for org in orgs:
        for ul in (3, 130, 300):
            qs = int(rng.integers(0, 500))
            unit = org[qs + 1 : qs + 1 + ul]
            jobs.append(_job(org, qs, qs + int(rng.integers(ul, 1400)), unit))
    dev = tp.TorchDPBatcher(torch.device("cpu"))
    dev.begin_batch(orgs)
    dev.run(jobs)
    got = [j.result for j in jobs]
    HostDPBatcher().run(jobs)
    assert got == [j.result for j in jobs]
    assert dev.cells == sum((j.qe - j.qs + 1) * len(j.unit) for j in jobs)


def test_device_batcher_refuses_consensus_jobs():
    """Consensus jobs are no longer refused: they run on the device path
    (plain version here) and equal the host engine's, column for column,
    in a mixed run with counts jobs."""
    rng = np.random.default_rng(11)
    orgs = [rng.integers(0, 4, 1500).astype(np.int32) for _ in range(2)]
    jobs = []
    for org in orgs:
        for ul, scheme in ((4, (5, 1, 1)), (60, (1, 1, 3)), (140, (5, 1, 1)),
                           (300, (1, 1, 3))):
            qs = int(rng.integers(0, 400))
            unit = org[qs + 1 : qs + 1 + ul]
            qe = qs + int(rng.integers(ul, 900))
            jobs.append(DPJob(org, qs, qe, unit, scheme, "consensus"))
            jobs.append(DPJob(org, qs, qe, unit, scheme))
    dev = tp.TorchDPBatcher(torch.device("cpu"))
    dev.begin_batch(orgs)
    dev.run(jobs)
    got = [j.result for j in jobs]
    HostDPBatcher().run(jobs)
    for job, res in zip(jobs, got):
        if job.mode == "counts":
            assert res == job.result
        else:
            np.testing.assert_array_equal(res[0], job.result[0])
            np.testing.assert_array_equal(res[1], job.result[1])
    cons = [j for j in jobs if j.mode == "consensus"]
    assert dev.cons_cells == sum((j.qe - j.qs + 1) * len(j.unit)
                                 for j in cons)


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
    di_before = directional_index.CALLS
    batcher = tp.TorchDPBatcher(torch.device("cpu"))
    got = _run("multi20_100x10",
               MTRConfig(backend="device", use_device_walks=False,
                         device_di_threshold=1000),
               batcher=batcher, read_filter=picks.__contains__)
    assert got == _golden_lines("multi20_100x10", {str(r) for r in picks})
    assert cons and batcher.cons_cells > 0 and batcher.cells > 0
    assert directional_index.CALLS > di_before


def test_device_backend_refuses_device_walks():
    """Checked before the batcher is made: the same refusal with or
    without a card, and no quiet host walks."""
    with pytest.raises(tp.BackendUnavailable, match="use_device_walks"):
        _run("multitr_gen_2_5_10_20", MTRConfig(backend="device"),
             batcher=tp.TorchDPBatcher(torch.device("cpu")))


def test_hybrid_runs_consensus_on_device_leg(monkeypatch):
    """MTR_TPU_HYBRID_CONS_CELLS=0 sends every consensus job to the
    device leg, as mtr_tpu's HybridDPBatcher does; counts jobs stay on
    the host here, so the device leg runs only the consensus op."""
    monkeypatch.setenv("MTR_TPU_HYBRID_CONS_CELLS", "0")
    seen = []
    real = tp.TorchDPBatcher._run

    def spy(self, jobs):
        seen.extend(j.mode for j in jobs)
        return real(self, jobs)

    monkeypatch.setattr(tp.TorchDPBatcher, "_run", spy)
    batcher = tp.TorchHybridDPBatcher(
        torch.device("cpu"), cell_threshold=1 << 62, min_device_cells=0)
    got = _run("multi20_100x10", MTRConfig(backend="hybrid"),
               batcher=batcher)
    assert got == _golden("multi20_100x10")
    assert seen and set(seen) == {"consensus"}
    assert batcher.device.cons_cells > 0


def test_hybrid_reraises_device_leg_failure(monkeypatch):
    """No fallback: a device-leg fault surfaces on the caller thread."""
    def boom(self, jobs):
        raise RuntimeError("device leg fault")

    monkeypatch.setattr(tp.TorchDPBatcher, "_run", boom)
    org = np.zeros(3000, np.int32)
    hy = tp.TorchHybridDPBatcher(torch.device("cpu"), cell_threshold=0,
                                 min_device_cells=0)
    hy.begin_batch([org])
    with pytest.raises(RuntimeError, match="device leg fault"):
        hy.run([_job(org, 0, 2000, [0, 1, 2])])


_NO_JAX = r"""
import importlib.abc, io, sys

class _Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name == "jax" or name.startswith(("jax.", "jaxlib")):
            raise ImportError(f"blocked import of {name}")

sys.meta_path.insert(0, _Block())
import mtr_tpu_torch, mtr_tpu_torch.pipeline, mtr_tpu_torch.cli
from mtr_tpu.config import MTRConfig
out = io.StringIO()
mtr_tpu_torch.pipeline.run_file(sys.argv[1] + ".fasta",
                                MTRConfig(backend="host"), out)
assert out.getvalue() == open(sys.argv[1] + ".out").read()
recs = mtr_tpu_torch.find_repeats("ACGTTT" * 50, MTRConfig(backend="host"))
assert len(recs) == 1
# the device path on CPU tensors: every DP job and the DI on torch
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
        (MTRConfig(backend="device", use_device_walks=False,
                   device_di_threshold=500),
         mtr_tpu_torch.pipeline.TorchDPBatcher(torch.device("cpu"))),
        (MTRConfig(backend="host"), None)):
    out = io.StringIO()
    mtr_tpu_torch.pipeline.run_file(f.name, cfg, out, batcher=batcher)
    outs.append(out.getvalue())
os.unlink(f.name)
assert outs[0] == outs[1] and outs[0], outs
assert directional_index.CALLS > 0
from mtr_tpu_torch.ops.wrap_dp_consensus import wrap_dp_consensus
fused, best = wrap_dp_consensus(
    torch.tensor([0, 1, 2, 0, 1, 2, 0, 1], dtype=torch.int8),
    torch.zeros(1, dtype=torch.int32),
    torch.tensor([[8, 3, 5, 1, 1, 0, 0, 0]], dtype=torch.int32),
    torch.tensor([[0, 1, 2] + [-2] * 125], dtype=torch.int8), 128, 6)
assert int(fused[0, 1:4, :3].trace()) > 0
assert not any(m == "jax" or m.startswith("jax.") for m in sys.modules)
print("NO_JAX_OK")
"""


def test_package_runs_with_jax_blocked():
    env = {**os.environ, "PYTHONPATH": REPO}
    r = subprocess.run(
        [sys.executable, "-c", _NO_JAX,
         os.path.join(GOLDEN, "multi20_100x10")],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert "NO_JAX_OK" in r.stdout
