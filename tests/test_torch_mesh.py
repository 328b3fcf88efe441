"""The port's device mesh on CPU slots: the DP step and the resident
launches cut over ["cpu"] * n against the one-device ops and against
mtr_tpu's shard_map versions on JAX's 8-device CPU mesh (Pallas in
interpret mode), and the whole pipeline under the sharded batcher against
the one-device batcher.  All results are integers or bytes: tolerance 0.

Column 7 of a counts row is the wrap value of the LAUNCH's final row (the
Pallas v1 kernel takes row r_pad, the port's kernel the launch's longest
row), so it depends on what else is in the launch.  A shard is another
launch: column 7 is compared shard by shard, every other column over the
whole batch.  Nothing in the pipeline reads it."""

import io

import numpy as np
import pytest
import torch

from mtr_tpu_torch import pipeline as tp
from mtr_tpu_torch.entry import (
    _example_args,
    dryrun_multichip,
    entry,
    sharded_pipeline_outputs,
)
from mtr_tpu_torch.ops.wrap_dp_consensus import (
    move_row_bytes,
    wrap_dp_consensus,
)
from mtr_tpu_torch.ops.wrap_dp_counts import u_span_for, wrap_dp_counts
from mtr_tpu_torch.parallel.mesh import (
    make_mesh,
    replicate,
    sharded_resident,
    sharded_wrap_dp_step,
    split_bounds,
)
from tests._dp_tables import dp_table
from tests.test_wrap_dp_pallas import build_batch

B, U, R = 8, 128, 256
NOT_7 = [c for c in range(15) if c != 7]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def cpu_mesh(n):
    return make_mesh(devices=["cpu"] * n)


def _step_batch():
    return build_batch(np.random.default_rng(61), B, U, R, (1, 1, 3))[:3]


def _one_device_step(scal, reps, units):
    """The port's counts op on rows as their own resident reads."""
    starts = torch.arange(len(scal), dtype=torch.int32) * reps.shape[1]
    return wrap_dp_counts(
        torch.from_numpy(reps.astype(np.int8)).reshape(-1), starts,
        torch.from_numpy(scal), torch.from_numpy(units.astype(np.int8)),
        units.shape[1]).numpy()


@pytest.fixture(scope="module")
def jax_step():
    """mtr_tpu's sharded step over JAX's 8 CPU devices, one job a device."""
    from mtr_tpu.parallel import mesh as ref

    counts, best = ref.sharded_wrap_dp_step(ref.make_mesh(8), B, U, R)(
        *_step_batch())
    return np.asarray(counts), np.asarray(best)


@pytest.mark.parametrize("n", [1, 2, 4])
def test_sharded_step_equals_one_device_and_jax(n, jax_step):
    scal, reps, units = _step_batch()
    counts, best = sharded_wrap_dp_step(cpu_mesh(n), B, U, R)(
        scal, reps, units)
    counts, best = counts.numpy(), best.numpy()
    assert counts.shape == (B, 15) and counts.dtype == np.int32
    np.testing.assert_array_equal(best, counts[:, 7:])
    one = _one_device_step(scal, reps, units)
    np.testing.assert_array_equal(counts[:, NOT_7], one[:, NOT_7])
    np.testing.assert_array_equal(counts[:, NOT_7], jax_step[0][:, NOT_7])
    np.testing.assert_array_equal(best[:, 1:], jax_step[1][:, 1:])
    assert (best[:, 1] > 0).all()
    # column 7, shard by shard: each shard is the launch of its own rows
    for lo, hi in zip(split_bounds(B, n), split_bounds(B, n)[1:]):
        np.testing.assert_array_equal(
            counts[lo:hi, 7],
            _one_device_step(scal[lo:hi], reps[lo:hi], units[lo:hi])[:, 7])


def test_sharded_step_refuses_a_batch_that_does_not_divide():
    with pytest.raises(ValueError, match="divide"):
        sharded_wrap_dp_step(cpu_mesh(3), 8, U, R)
    with pytest.raises(ValueError, match="u_span"):
        sharded_wrap_dp_step(cpu_mesh(2), 8, 100, R)


def test_entry_step_equals_the_jax_entry():
    import __graft_entry__ as ref

    step, args = entry("cpu")
    for a, b in zip(args, ref._example_args()):
        np.testing.assert_array_equal(a, b)
    counts, best = step(*args)
    ref_step, ref_args = ref.entry()
    want, want_best = ref_step(*ref_args)
    np.testing.assert_array_equal(counts.numpy()[:, NOT_7],
                                  np.asarray(want)[:, NOT_7])
    np.testing.assert_array_equal(best.numpy()[:, 1:],
                                  np.asarray(want_best)[:, 1:])
    assert _example_args(b=16)[0].shape == (16, 8)


def _resident_batch(unit_len, n_jobs, seed, scheme=(1, 1, 3)):
    """Periodic reads with noise as one flat array, and n_jobs jobs on
    them, longest first as the batcher orders them."""
    rng = np.random.default_rng(seed)
    unit = rng.integers(0, 4, unit_len).astype(np.int8)
    u_span = u_span_for(unit_len)
    flat, jobs, p = [], [], 0
    for _ in range(n_jobs):
        rl = int(rng.integers(unit_len + 20, unit_len + 200))
        rep = np.tile(unit, rl // unit_len + 1)[:rl].copy()
        noise = rng.integers(0, rl, max(1, rl // 8))
        rep[noise] = rng.integers(0, 4, len(noise))
        flat.append(rep)
        jobs.append((p, rl))
        p += rl
    jobs.sort(key=lambda j: -j[1])
    starts = np.array([j[0] for j in jobs], np.int32)
    scal = np.zeros((n_jobs, 8), np.int32)
    scal[:, 0] = [j[1] for j in jobs]
    scal[:, 1] = unit_len
    scal[:, 2:5] = scheme
    units = np.full((n_jobs, u_span), -2, np.int8)
    units[:, :unit_len] = unit
    return (torch.from_numpy(np.concatenate(flat)), starts, scal, units,
            u_span)


@pytest.mark.parametrize("unit_len", [7, 150, 300])
def test_sharded_resident_counts_equals_one_device(unit_len):
    """7, 150 and 300 are the unit ranges of the reference's kinds counts2,
    counts2w and counts; the port's kind `counts` takes them all."""
    flat, starts, scal, units, u_span = _resident_batch(unit_len, 7,
                                                        seed=unit_len)
    t = [torch.from_numpy(a) for a in (starts, scal, units)]
    one = wrap_dp_counts(flat, *t, u_span).numpy()
    assert one[:, 6].all() and (one[:, 8] > 0).all()
    # 3 cuts unevenly; 8 leaves a slot empty
    for n in (1, 2, 3, 4, 8) if unit_len == 7 else (2, 3, 8):
        mesh = cpu_mesh(n)
        got = sharded_resident(mesh, "counts", replicate(mesh, flat),
                               starts, scal, units, u_span).numpy()
        np.testing.assert_array_equal(got[:, NOT_7], one[:, NOT_7])
        bounds = split_bounds(len(scal), n)
        assert max(np.diff(bounds)) - min(np.diff(bounds)) <= 1
        for lo, hi in zip(bounds, bounds[1:]):
            if lo < hi:
                np.testing.assert_array_equal(
                    got[lo:hi, 7],
                    wrap_dp_counts(flat, *(x[lo:hi] for x in t),
                                   u_span).numpy()[:, 7])


@pytest.mark.parametrize("scheme", [(5, 1, 1), (1, 1, 3)],
                         ids=["511", "113"])
def test_sharded_resident_consensus_equals_one_device(scheme, monkeypatch):
    flat, starts, scal, units, u_span = _resident_batch(23, 6, seed=23,
                                                        scheme=scheme)
    factor = tp._factor([scheme])
    t = [torch.from_numpy(a) for a in (starts, scal, units)]
    want, want_best = wrap_dp_consensus(flat, *t, u_span, factor)
    assert int(want.sum()) > 0
    # a cap of two of the longest job's move scratch cuts every shard of
    # three jobs into more than one launch
    cap = 2 * int(scal[0, 0]) * move_row_bytes(23)
    for n, cap_bytes in ((2, None), (3, None), (2, cap), (8, None)):
        calls = []

        def spy(*args, _real=wrap_dp_consensus):
            calls.append(args[2].shape[0])
            return _real(*args)

        from mtr_tpu_torch.parallel import mesh as mesh_mod

        monkeypatch.setattr(mesh_mod, "wrap_dp_consensus", spy)
        mesh = cpu_mesh(n)
        got, best = sharded_resident(
            mesh, "consensus", replicate(mesh, flat), starts, scal, units,
            u_span, factor, cap_bytes)
        assert torch.equal(got, want)
        assert torch.equal(best[:, 1:], want_best[:, 1:])
        assert sum(calls) == len(scal)
        if cap_bytes is None:
            assert len(calls) == min(n, len(scal))
        else:
            assert len(calls) > n
            sizes = scal[:, 0] * move_row_bytes(23)
            lo = 0
            for k in calls:  # every launch within the cap
                assert k == 1 or sizes[lo : lo + k].sum() <= cap
                lo += k


def test_make_mesh_refuses_devices_that_are_not_there():
    have = torch.cuda.device_count()
    with pytest.raises(RuntimeError, match="CUDA devices are visible"):
        make_mesh(have + 1)
    with pytest.raises(RuntimeError, match="CUDA devices are visible"):
        make_mesh(devices=[f"cuda:{have}"])
    with pytest.raises(ValueError):
        make_mesh(3, devices=["cpu"] * 2)
    with pytest.raises(ValueError):
        make_mesh(devices=[])
    mesh = cpu_mesh(4)
    assert mesh.size == 4 and mesh.distinct == (torch.device("cpu"),)
    assert mesh.streams == (None,) * 4


def test_sharded_pipeline_equals_one_device(monkeypatch, tmp_path):
    """The dry-run set (unit 20 x 10 copies: coverage in [5, 20], period >
    5, so the polish rounds run consensus launches) under
    ShardedTorchDPBatcher(cpu x 4) against TorchDPBatcher(cpu) and the
    host backend."""
    seen = []
    real = tp.sharded_resident

    def spy(mesh, kind, flats, starts, scal, *rest):
        seen.append((kind, mesh.size, len(scal)))
        return real(mesh, kind, flats, starts, scal, *rest)

    monkeypatch.setattr(tp, "sharded_resident", spy)
    mesh = cpu_mesh(4)
    single, sharded = sharded_pipeline_outputs(mesh)
    assert single
    assert single == sharded
    kinds = {k for k, _, _ in seen}
    assert kinds == {"counts", "consensus"}, (
        "polish never reached the mesh" if "counts" in kinds else seen)
    assert all(size == 4 for _, size, _ in seen)
    assert tp.batcher_mesh(tp.ShardedTorchDPBatcher(mesh)) is mesh
    assert tp.batcher_mesh(tp.TorchDPBatcher("cpu")) is None
    assert tp.batcher_device(tp.ShardedTorchDPBatcher(mesh)).type == "cpu"

    from mtr_tpu_torch.config import MTRConfig
    from mtr_tpu_torch.testutil.rand_seq import write_fasta

    fa = str(tmp_path / "dry.fasta")
    write_fasta(fa, fa[:-6] + ".units", 20, 10, 2.0, 2.0, 2.0, 200, 200, 3,
                seed=7)
    host = io.StringIO()
    tp.run_file(fa, MTRConfig(backend="host"), host)
    assert host.getvalue() == sharded


def test_sharded_batcher_checks_every_shard(monkeypatch):
    """_check_bounds runs on each shard's arguments, and a shard past the
    bounds raises before anything is launched."""
    rng = np.random.default_rng(5)
    org = rng.integers(0, 4, 2000).astype(np.int32)
    jobs = [(0, qs, qs + 300 + 10 * qs, org[1:8], (1, 1, 3), "counts")
            for qs in range(6)]
    batcher = tp.ShardedTorchDPBatcher(cpu_mesh(3))
    checked = []
    real = batcher._check_bounds
    monkeypatch.setattr(
        batcher, "_check_bounds",
        lambda scal, starts, u_span: (checked.append(len(scal)),
                                      real(scal, starts, u_span)))
    batcher.begin_batch([org])
    got, _ = batcher.run_table(dp_table(jobs))
    assert checked == [2, 2, 2]
    host = tp.HostDPBatcher()
    host.begin_batch([org])
    want, _ = host.run_table(dp_table(jobs))
    np.testing.assert_array_equal(got, want)
    bad = (0, 1990, 2100, org[1:8], (1, 1, 3), "counts")  # past the reads
    launched = []
    monkeypatch.setattr(tp, "sharded_resident",
                        lambda *a, **k: launched.append(a))
    with pytest.raises(ValueError, match="outside the resident reads"):
        batcher.run_table(dp_table(jobs + [bad]))
    assert not launched


def test_dryrun_multichip_raises_without_the_cards():
    with pytest.raises(RuntimeError, match="CUDA devices are visible"):
        dryrun_multichip(torch.cuda.device_count() + 1)
