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
from mtr_tpu_torch.utils.timers import TIMERS
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
    before = TIMERS.counters["launch.wrap_dp_consensus"]
    got, best = wrap_dp_consensus(_t(flat), _t(starts), _t(scal), _t(units),
                                  u_pad, factor)
    got = got.numpy()
    # CPU tensors: the plain path
    assert TIMERS.counters["launch.wrap_dp_consensus"] == before
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


# ------------------------------------- the kernel's packed move layout


def unpack_moves(packed: torch.Tensor, mv_off: torch.Tensor,
                 scal: torch.Tensor, r_pad: int, u_pad: int) -> torch.Tensor:
    """pack_moves' inverse: -> (r_pad, B, u_pad) uint8, zero outside each
    job's rows and unit columns."""
    b_n = scal.shape[0]
    out = torch.zeros((r_pad, b_n, u_pad), dtype=torch.uint8)
    for b in range(b_n):
        n_r, ul = int(scal[b, 0]), int(scal[b, 1])
        if not n_r:
            continue
        wb = int(op.move_row_bytes(ul)) // 32
        c = max(1, -(-ul // 32))
        o = int(mv_off[b])
        byte = packed[o : o + n_r * 32 * wb].long().view(n_r, 32, wb)
        words = (byte << (8 * torch.arange(wb))).sum(2)      # (n_r, 32)
        cells = (words[:, :, None] >> (2 * torch.arange(c))) & 3
        cols = min(ul, u_pad)
        out[:n_r, b, :cols] = cells.reshape(n_r, 32 * c)[:, :cols].to(
            torch.uint8)
    return out


@pytest.mark.parametrize("form", ["list", "generator", "array"])
def test_launch_factor_takes_any_iterable_of_schemes(form):
    """A launch's traceback factor is the largest of its schemes' own,
    whether the schemes come as a list, a generator (chip_smoke's jobs) or
    a job table's (n, 3) column."""
    schemes = [(1, 1, 3), (1, 3, 1), (2, 1, 1)]
    forms = {"list": lambda s: s, "generator": lambda s: (x for x in s),
             "array": lambda s: np.array(s, np.int32)}
    assert factor_of(forms[form](schemes[:2])) == 2
    assert factor_of(forms[form](schemes)) == max(
        _factor(s) for s in schemes) == 6


def test_move_row_bytes():
    """A packed move row is 32 lanes x WB bytes, WB = 1, 2, 4 for C =
    ceil(unit_len / 32) <= 4, 8, 16."""
    units = [1, 32, 128, 129, 256, 257, 500, 512]
    want = [32, 32, 32, 64, 64, 128, 128, 128]
    assert [op.move_row_bytes(u) for u in units] == want
    assert op.move_row_bytes(torch.tensor(units)).tolist() == want
    assert op.move_row_bytes(np.array(units)).tolist() == want


@pytest.mark.parametrize("u_pad", [128, 512])
def test_packed_moves_round_trip_and_walk(u_pad):
    """pack_moves states the kernel's move scratch: the Pallas fill's
    moves (valid cells) packed 2 bits a cell at the kernel's offsets and
    unpacked again are the same tensor, and the plain traceback over the
    unpacked moves equals traceback_consensus_batch_n over the Pallas
    ones."""
    scheme, r_pad = (1, 1, 3), 256
    scal, reps, units = _batch(scheme, u_pad, r_pad, seed=900 + u_pad)
    moves, best = make_wrap_dp_pallas(8, u_pad, r_pad,
                                      interpret=True)(scal, reps, units)
    valid = ((np.arange(r_pad)[:, None, None] < scal[None, :, 0:1])
             & (np.arange(u_pad)[None, None, :] < scal[None, :, 1:2]))
    mv = np.where(valid, np.asarray(moves), 0).astype(np.uint8)
    packed, mv_off = op.pack_moves(_t(mv), _t(scal))
    sizes = scal[:, 0].astype(np.int64) * op.move_row_bytes(scal[:, 1])
    np.testing.assert_array_equal(mv_off.numpy(), np.cumsum(sizes) - sizes)
    assert packed.numel() == sizes.sum()
    back = unpack_moves(packed, mv_off, _t(scal), r_pad, u_pad)
    np.testing.assert_array_equal(back.numpy(), mv)
    steps = consensus_steps(r_pad, _factor(scheme))
    want = np.asarray(traceback_consensus_batch_n(
        steps, u_pad, moves, reps, scal[:, 1].copy(), best))
    got = traceback_consensus_plain(back, _t(reps), _t(scal[:, 1]),
                                    _t(np.asarray(best)), steps).numpy()
    np.testing.assert_array_equal(got, want)


def _mixed_consensus_jobs():
    """Consensus jobs of units 4 to 480 (C 1 to 15) over two reads, as
    (read, qs, qe, unit, scheme, mode) tuples."""
    rng = np.random.default_rng(17)
    orgs = [rng.integers(0, 4, 1400).astype(np.int32) for _ in range(2)]
    jobs = []
    for r, org in enumerate(orgs):
        for ul, scheme in ((4, (5, 1, 1)), (60, (1, 1, 3)), (140, (5, 1, 1)),
                           (300, (1, 3, 1)), (480, (1, 1, 3))):
            qs = int(rng.integers(0, 300))
            unit = org[qs + 1 : qs + 1 + ul]
            qe = qs + int(rng.integers(ul, ul + 500))
            jobs.append((r, qs, qe, unit, scheme, "consensus"))
    return orgs, jobs


@pytest.mark.parametrize("cap", [1 << 30, 60000])
def test_batcher_one_consensus_launch_for_every_width(monkeypatch, cap):
    """TorchDPBatcher hands all of a run's consensus jobs, whatever their
    unit, to one op call with rows 32 * ceil(max unit / 32) wide, longest
    first; with MOVES_BYTES_CAP lowered, to consecutive calls whose packed
    moves each fit the cap.  The (500, 9) blocks equal mtr_tpu's host
    engine either way."""
    from mtr_tpu_torch import pipeline as tp
    from tests._dp_tables import dp_table

    orgs, jobs = _mixed_consensus_jobs()
    calls = []
    real = tp.wrap_dp_consensus

    def spy(flat, starts, scal, unit, u_span, factor):
        rows = scal[:, 0].long()
        calls.append((u_span, rows.tolist(), int((
            rows * op.move_row_bytes(scal[:, 1].long())).sum())))
        return real(flat, starts, scal, unit, u_span, factor)

    monkeypatch.setattr(tp, "wrap_dp_consensus", spy)
    monkeypatch.setattr(tp, "MOVES_BYTES_CAP", cap)
    dev = tp.TorchDPBatcher(torch.device("cpu"))
    dev.begin_batch(orgs)
    _, (cons, miss) = dev.run_table(dp_table(jobs))

    ref = [DPJob(orgs[r], qs, qe, unit, scheme, mode)
           for r, qs, qe, unit, scheme, mode in jobs]
    HostDPBatcher().run(ref, deduped=True)
    for q, want in enumerate(ref):
        np.testing.assert_array_equal(cons[q], want.result[0])
        np.testing.assert_array_equal(miss[q], want.result[1])
    assert all(u_span == 480 for u_span, _, _ in calls)
    lens = [rl for _, rls, _ in calls for rl in rls]
    assert lens == sorted(lens, reverse=True) and len(lens) == len(jobs)
    if cap == 1 << 30:
        assert len(calls) == 1
    else:
        assert len(calls) > 1
        assert all(size <= cap or len(rls) == 1 for _, rls, size in calls)
