"""The port's pipeline on the CPU: its run_file reproduces the in-repo
goldens byte for byte, on the host engine and on the torch hybrid with
its device leg engaged (plain PyTorch op on CPU tensors); backend
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
from mtr_tpu_torch.ops import wrap_dp_resident

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
    with pytest.raises(tp.BackendUnavailable, match="not yet ported"):
        tp.make_batcher(MTRConfig(backend="device"))
    with pytest.raises(ValueError):
        tp.make_batcher(MTRConfig(backend="tpu"))


def test_cli_host_and_refusals(capsys):
    from mtr_tpu_torch import cli

    fasta = os.path.join(GOLDEN, "multitr_gen_2_5_10_20.fasta")
    assert cli.main(["--backend", "host", fasta]) == 0
    assert capsys.readouterr().out == _golden("multitr_gen_2_5_10_20")
    assert cli.main(["--backend", "device", fasta]) == 1
    assert "not yet ported" in capsys.readouterr().err


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
    org = np.zeros(100, np.int32)
    dev = tp.TorchDPBatcher(torch.device("cpu"))
    dev.begin_batch([org])
    with pytest.raises(NotImplementedError):
        dev.run([_job(org, 0, 50, [0, 1], mode="consensus")])


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
