"""The port's plain consensus-mode DP against its JAX statement: the
Pallas fill (`make_wrap_dp_pallas`, interpret mode), the lax traceback
(`traceback_consensus_batch_n`), the resident one-dispatch pipeline
(`get_wrap_dp_consensus_resident`) and the native host engine.  Moves,
best and the (B, 500, 9) polish tensor are integers: compared with zero
tolerance."""

import numpy as np
import pytest
import torch

from mtr_tpu.ops.wrap_dp_pallas import (
    make_wrap_dp_pallas,
    traceback_consensus_batch_n,
)
from mtr_tpu.ops.wrap_dp_resident import get_wrap_dp_consensus_resident
from mtr_tpu.pipeline import DPJob, HostDPBatcher
from mtr_tpu_torch.ops import wrap_dp_consensus as op
from mtr_tpu_torch.ops.wrap_dp_consensus import (
    consensus_steps,
    traceback_consensus_plain,
    wrap_dp_consensus,
    wrap_dp_fill_plain,
)
from mtr_tpu_torch.pipeline import _factor as factor_of
from tests.test_wrap_dp_pallas import build_batch

SCHEMES = ((1, 1, 3), (1, 3, 1), (5, 1, 1))
_ids = lambda s: "".join(map(str, s))  # noqa: E731


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _factor(scheme):
    return factor_of([scheme])


def _batch(scheme, u_pad, r_pad, seed):
    """build_batch's periodic jobs plus the edge rows: unit_len 499 and
    500 (u_pad 512), rep_len 1, and rep_len 0 (the last row)."""
    rng = np.random.default_rng(seed)
    scal, reps, units, _ = build_batch(rng, 8, u_pad, r_pad, scheme)
    edges = [(1, 2), (0, 3)]
    if u_pad == 512:
        edges = [(r_pad - 1, 499), (r_pad - 9, 500)] + edges
    for q, (rl, ul) in zip(range(8 - len(edges), 8), edges):
        unit = rng.integers(0, 4, ul)
        rep = np.tile(unit, rl // ul + 1)[:rl].copy()
        noise = rng.integers(0, max(rl, 1), max(1, rl // 8))
        rep[noise[noise < rl]] = rng.integers(0, 4, int((noise < rl).sum()))
        reps[q] = -1
        reps[q, :rl] = rep
        units[q] = -2
        units[q, :ul] = unit
        scal[q, :2] = (rl, ul)
    return scal, reps, units


def _t(a):
    return torch.from_numpy(np.array(a))  # a writable copy


@pytest.mark.parametrize("u_pad", [128, 512])
@pytest.mark.parametrize("scheme", SCHEMES, ids=_ids)
def test_fill_plain_equals_pallas(scheme, u_pad):
    r_pad = 256
    scal, reps, units = _batch(scheme, u_pad, r_pad,
                               seed=10 * u_pad + SCHEMES.index(scheme))
    want_mv, want_best = make_wrap_dp_pallas(8, u_pad, r_pad,
                                             interpret=True)(scal, reps, units)
    want_mv, want_best = np.asarray(want_mv), np.asarray(want_best)
    got_mv, got_best = wrap_dp_fill_plain(_t(scal), _t(reps), _t(units))
    got_mv, got_best = got_mv.numpy(), got_best.numpy()
    # valid cells: rows < rep_len, lanes < unit_len; the plain version
    # leaves every other cell 0
    valid = ((np.arange(r_pad)[:, None, None] < scal[None, :, 0:1])
             & (np.arange(u_pad)[None, None, :] < scal[None, :, 1:2]))
    np.testing.assert_array_equal(got_mv[valid], want_mv[valid])
    assert not got_mv[~valid].any()
    assert set(np.unique(got_mv)) <= {0, 1, 2, 3}
    np.testing.assert_array_equal(got_best[:, 1:], want_best[:, 1:])
    # one row tile covers r_pad here, so the wrap column agrees as well
    np.testing.assert_array_equal(got_best[:, 0], want_best[:, 0])


TB_CASES = [(s, f) for s in SCHEMES for f in (2, 6) if f >= _factor(s)]


@pytest.mark.parametrize("scheme,factor", TB_CASES,
                         ids=[f"{_ids(s)}-f{f}" for s, f in TB_CASES])
def test_traceback_plain_equals_jax(scheme, factor):
    """Both walks start from the same Pallas moves and best."""
    u_pad, r_pad = 512, 256
    scal, reps, units = _batch(scheme, u_pad, r_pad,
                               seed=500 + SCHEMES.index(scheme))
    moves, best = make_wrap_dp_pallas(8, u_pad, r_pad,
                                      interpret=True)(scal, reps, units)
    steps = consensus_steps(r_pad, factor)
    want = np.asarray(traceback_consensus_batch_n(
        steps, u_pad, moves, reps, scal[:, 1].copy(), best))
    got = traceback_consensus_plain(
        _t(np.asarray(moves)), _t(reps), _t(scal[:, 1]),
        _t(np.asarray(best)), steps).numpy()
    np.testing.assert_array_equal(got, want)
    # every walk stopped: the per-column counts sum to the path length
    assert got.sum() > 0


def test_traceback_plain_raises_at_its_step_bound():
    scal, reps, units = _batch((5, 1, 1), 128, 256, seed=7)
    moves, best = wrap_dp_fill_plain(_t(scal), _t(reps), _t(units))
    with pytest.raises(RuntimeError, match="still going"):
        traceback_consensus_plain(moves, _t(reps), _t(scal[:, 1]), best, 3)


def _resident(scheme, u_pad, seed):
    """Six reads in one flat array; jobs are segments of them, with a
    segment running into the next read, rep_len 0 and 1, and (u_pad 512)
    unit_len 499 and 500."""
    rng = np.random.default_rng(seed)
    reads = []
    for _ in range(6):
        unit = rng.integers(0, 4, int(rng.integers(2, 30)))
        read = np.tile(unit, 700 // len(unit) + 1)[:700].copy()
        noise = rng.integers(0, 700, 60)
        read[noise] = rng.integers(0, 4, 60)
        reads.append(read.astype(np.int8))
    flat = np.concatenate(reads)
    jobs = []  # (start, rep_len, unit)
    for q in range(5):
        start = 700 * q + int(rng.integers(0, 300))
        ul = int(rng.integers(2, 60))
        jobs.append((start, int(rng.integers(ul, 500)), flat[start:start + ul]))
    jobs.append((700 * 4 + 650, 300, flat[:7]))  # runs into the next read
    jobs.append((3, 1, np.array([1, 2], np.int8)))
    jobs.append((0, 0, np.array([0, 0], np.int8)))
    if u_pad == 512:
        for ul in (499, 500):
            unit = rng.integers(0, 4, ul).astype(np.int8)
            start = int(rng.integers(0, 2000))
            jobs.append((start, 600, unit))
    b = len(jobs)
    starts = np.zeros(b, np.int32)
    scal = np.zeros((b, 8), np.int32)
    units = np.full((b, u_pad), -2, np.int8)
    for q, (start, rl, unit) in enumerate(jobs):
        starts[q] = start
        scal[q, :5] = (rl, len(unit), *scheme)
        units[q, : len(unit)] = unit
    return flat, starts, scal, units


@pytest.mark.parametrize("u_pad", [128, 512])
@pytest.mark.parametrize("scheme", SCHEMES, ids=_ids)
def test_resident_op_equals_jax_and_host(scheme, u_pad):
    flat, starts, scal, units = _resident(scheme, u_pad,
                                          seed=u_pad + SCHEMES.index(scheme))
    factor = _factor(scheme)
    b = scal.shape[0]
    r_pad = int(scal[:, 0].max())
    before = op.LAUNCHES
    got, best = wrap_dp_consensus(_t(flat), _t(starts), _t(scal), _t(units),
                                  u_pad, factor)
    got = got.numpy()
    assert op.LAUNCHES == before  # CPU tensors: the plain path
    # JAX: the flat carries r_pad of slack (dynamic_slice clamps)
    slack = np.concatenate([flat, np.zeros(r_pad, np.int8)])
    want = np.asarray(get_wrap_dp_consensus_resident(b, u_pad, r_pad, factor)(
        slack, starts, scal, units))
    np.testing.assert_array_equal(got, want)
    assert best.shape == (b, 8)

    org = flat.astype(np.int32)  # rep = org[qs + 1 : qe + 2]
    jobs = [DPJob(org, int(s) - 1, int(s) + int(rl) - 2,
                  units[q, : scal[q, 1]].astype(np.int32), scheme,
                  mode="consensus")
            for q, (s, rl) in enumerate(zip(starts, scal[:, 0])) if rl > 0]
    HostDPBatcher().run(jobs, deduped=True)
    rows = [q for q in range(b) if scal[q, 0] > 0]
    for q, job in zip(rows, jobs):
        cons, miss = job.result
        np.testing.assert_array_equal(got[q, :, :5], cons, err_msg=str(q))
        np.testing.assert_array_equal(got[q, :, 5:], miss, err_msg=str(q))


def test_op_refuses_mixed_devices():
    meta = torch.empty(4, dtype=torch.int8, device="meta")
    with pytest.raises(ValueError):
        wrap_dp_consensus(meta, torch.zeros(1, dtype=torch.int32),
                          torch.zeros((1, 8), dtype=torch.int32),
                          torch.zeros((1, 128), dtype=torch.int8), 128, 2)
