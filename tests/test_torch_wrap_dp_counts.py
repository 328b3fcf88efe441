"""The port's plain counts op against every JAX statement of the same
function: the three Pallas kernels (interpret mode), the pure-XLA op and
the scalar oracle.  DP results are integers: columns 0-10 of the
(B, 15) row must be equal, with zero tolerance (columns 11-14 hold each
TPU kernel's packed internals).  Also the resident gather against
mtr_tpu/ops/wrap_dp_resident.py::_gather_segments."""

import numpy as np
import pytest
import torch

from mtr_tpu.ops.wrap_dp_fused import get_wrap_dp_fused
from mtr_tpu.ops.wrap_dp_fused2 import get_wrap_dp_fused2
from mtr_tpu.ops.wrap_dp_fused2w import get_wrap_dp_fused2w
from mtr_tpu.ops.wrap_dp_resident import _gather_segments
from mtr_tpu.ops.wrap_dp_xla import make_wrap_dp_counts_xla
from mtr_tpu_torch.ops.wrap_dp_counts import wrap_dp_counts, wrap_dp_counts_plain
from mtr_tpu_torch.ops.wrap_dp_resident import gather_segments
from mtr_tpu_torch.utils.timers import TIMERS
from tests.test_wrap_dp_fused import SCHEMES, oracle_counts, rand_jobs

# columns the oracle reports: m, x, ins, del, scanned, i_final, best,
# max_i, max_j
ORACLE_COLS = [0, 1, 2, 3, 4, 5, 8, 9, 10]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jobs_with_units(rng, n, lo, hi, max_rep, scheme, periodic=True,
                     rep_len=None):
    """rand_jobs' recipe with unit lengths drawn from [lo, hi]: mostly
    periodic reps with errors sprinkled, the rest random."""
    jobs = []
    for _ in range(n):
        n_rep = rep_len or int(rng.integers(1, max_rep + 1))
        ul = int(rng.integers(lo, hi + 1))
        unit = rng.integers(0, 4, ul).astype(np.int32)
        if periodic and rng.random() < 0.7:
            rep = np.tile(unit, n_rep // ul + 1)[:n_rep].copy()
            idx = rng.integers(0, n_rep, max(1, n_rep // 8))
            rep[idx] = rng.integers(0, 4, len(idx))
        else:
            rep = rng.integers(0, 4, n_rep).astype(np.int32)
        jobs.append((rep, unit, scheme))
    return jobs


def _pack(jobs, b, u_pad, r_pad, dtype=np.int8):
    """JAX kernel inputs: padding rows are rep_len 0, unit_len 2, (1,1,1)."""
    reps = np.full((b, r_pad), -1, dtype)
    units = np.full((b, u_pad), -2, dtype)
    scal = np.zeros((b, 8), np.int32)
    scal[:, 1] = 2
    scal[:, 2:5] = 1
    units[:, :2] = 0
    for q, (rep, unit, scheme) in enumerate(jobs):
        reps[q, : len(rep)] = rep
        units[q, : len(unit)] = unit
        scal[q, 0] = len(rep)
        scal[q, 1] = len(unit)
        scal[q, 2:5] = scheme
    return scal, reps, units


def _plain(scal, reps, units):
    return wrap_dp_counts_plain(
        torch.from_numpy(scal), torch.from_numpy(reps.astype(np.int8)),
        torch.from_numpy(units.astype(np.int8))).numpy()


# kernel -> (batch, u_pad, r_pad, unit range, max rep_len, runner)
CASES = {
    "fused2_r128": (24, 128, 128, (2, 64), 128,
                    lambda s, r, u: get_wrap_dp_fused2(24, 128)(s, r, u)),
    "fused2_r1024": (16, 128, 1024, (2, 128), 700,
                     lambda s, r, u: get_wrap_dp_fused2(16, 1024)(s, r, u)),
    "fused2w_r1024": (16, 256, 1024, (129, 256), 1024,
                      lambda s, r, u: get_wrap_dp_fused2w(16, 1024, 256)(
                          s, r, u)),
    "fused2w_r32768": (16, 256, 32768, (129, 256), 400,
                       lambda s, r, u: get_wrap_dp_fused2w(16, 32768, 256)(
                           s, r, u)),
    "fused_u512": (8, 512, 512, (257, 500), 512,
                   lambda s, r, u: get_wrap_dp_fused(8, 512, 512)(
                       s, r.astype(np.int32), u.astype(np.int32))),
    "xla_u512": (24, 512, 512, (2, 500), 512,
                 lambda s, r, u: make_wrap_dp_counts_xla(24, 512, 512)(
                     s, r, u)),
}


@pytest.mark.parametrize("scheme", SCHEMES, ids=lambda s: "".join(map(str, s)))
@pytest.mark.parametrize("kernel", sorted(CASES))
def test_plain_equals_jax_kernel(kernel, scheme):
    b, u_pad, r_pad, (lo, hi), max_rep, run = CASES[kernel]
    seed = sorted(CASES).index(kernel) * 10 + SCHEMES.index(scheme)
    rng = np.random.default_rng(seed)
    # the last rows stay padding.  One job is deletion-heavy non-periodic
    # and the batch's longest: column 7 (wrap) is the wrap column of the
    # final row, which the v1 kernel takes at row r_pad and the others at
    # the batch's longest row, so that job spans max_rep (= r_pad for v1)
    jobs = _jobs_with_units(rng, b - 3, lo, hi, max_rep - 1, scheme)
    jobs += _jobs_with_units(rng, 1, lo, hi, max_rep, scheme, periodic=False,
                             rep_len=max_rep)
    scal, reps, units = _pack(jobs, b, u_pad, r_pad)
    want = np.asarray(run(scal, reps, units))
    got = _plain(scal, reps, units)
    np.testing.assert_array_equal(got[:, :11], want[:, :11])


@pytest.mark.parametrize("scheme", SCHEMES, ids=lambda s: "".join(map(str, s)))
def test_plain_equals_oracle(scheme):
    rng = np.random.default_rng(100 + SCHEMES.index(scheme))
    jobs = rand_jobs(rng, 12, 90, 30, scheme)
    jobs += rand_jobs(rng, 4, 90, 30, scheme, periodic=False)
    jobs += [  # degenerate: rep_len 1, unit_len 2, no match / full match
        (np.zeros(1, np.int32), np.array([1, 2], np.int32), scheme),
        (np.array([3], np.int32), np.array([3, 3], np.int32), scheme),
    ]
    scal, reps, units = _pack(jobs, len(jobs) + 2, 32, 128)
    got = _plain(scal, reps, units)
    for q, (rep, unit, sch) in enumerate(jobs):
        assert tuple(got[q, ORACLE_COLS]) == oracle_counts(rep, unit, *sch), q
    # padded rows (rep_len 0): all counts zero, done set
    np.testing.assert_array_equal(got[len(jobs):, :6], 0)
    np.testing.assert_array_equal(got[:, 6], 1)


def _resident_batch(rng, n_reads=6, read_len=300):
    reads = [rng.integers(0, 4, read_len).astype(np.int8)
             for _ in range(n_reads)]
    flat = np.concatenate(reads)
    return reads, flat


def test_gather_segments_matches_jax():
    rng = np.random.default_rng(7)
    reads, flat = _resident_batch(rng)
    r_pad = 256
    # segments inside a read, running past their read into the next, and
    # padded rows at start 0; JAX's dynamic_slice clamps at the end, so
    # the flat carries r_pad of slack as mtr_tpu's begin_batch does
    starts = np.array([0, 17, 250, 290, 600, 1199, 0, 0], np.int32)
    slack = np.concatenate([flat, np.full(r_pad, 5, np.int8)])
    want = np.asarray(_gather_segments(slack, starts, r_pad))
    got = gather_segments(torch.from_numpy(slack), torch.from_numpy(starts),
                          r_pad).numpy()
    np.testing.assert_array_equal(got, want)


def test_gather_segments_masks_past_the_end():
    flat = np.arange(10, dtype=np.int8)
    got = gather_segments(torch.from_numpy(flat),
                          torch.tensor([0, 6, 9], dtype=torch.int32),
                          6).numpy()
    np.testing.assert_array_equal(got, [
        [0, 1, 2, 3, 4, 5],
        [6, 7, 8, 9, -1, -1],   # never clamped back to flat[4:10]
        [9, -1, -1, -1, -1, -1],
    ])


@pytest.mark.parametrize("u_span", [128, 256, 512])
def test_resident_op_on_cpu_runs_plain(u_span):
    """The public op on CPU tensors: segments gathered from the flat reads,
    then the plain fill; equal to the plain op on the gathered reps and to
    the oracle, and no kernel launch is counted."""
    rng = np.random.default_rng(200 + u_span)
    reads, flat = _resident_batch(rng, n_reads=5, read_len=400)
    jobs = []
    for q, read in enumerate(reads):
        qs, rep_len = int(rng.integers(0, 100)), int(rng.integers(50, 300))
        ul = int(rng.integers(2, min(u_span, 120) + 1))
        unit = read[qs : qs + ul].astype(np.int32)
        jobs.append((q * 400 + qs, rep_len, unit, SCHEMES[q % 3]))
    b = len(jobs) + 1  # one padded row
    starts = np.zeros(b, np.int32)
    scal = np.zeros((b, 8), np.int32)
    scal[:, 1] = 2
    scal[:, 2:5] = 1
    units = np.full((b, u_span), -2, np.int8)
    units[:, :2] = 0
    for q, (start, rep_len, unit, scheme) in enumerate(jobs):
        starts[q] = start
        scal[q, :5] = (rep_len, len(unit), *scheme)
        units[q, : len(unit)] = unit
    before = TIMERS.counters["launch.wrap_dp_counts"]
    got = wrap_dp_counts(torch.from_numpy(flat), torch.from_numpy(starts),
                         torch.from_numpy(scal), torch.from_numpy(units),
                         u_span).numpy()
    assert TIMERS.counters["launch.wrap_dp_counts"] == before
    for q, (start, rep_len, unit, scheme) in enumerate(jobs):
        rep = flat[start : start + rep_len].astype(np.int32)
        assert tuple(got[q, ORACLE_COLS]) == oracle_counts(
            rep, unit, *scheme), q
    np.testing.assert_array_equal(got[-1, :6], 0)


def test_op_refuses_mixed_devices():
    """Only all-CPU tensors take the plain version; anything else goes to
    the kernel or raises."""
    meta = torch.empty(4, dtype=torch.int8, device="meta")
    cpu = torch.zeros((1, 8), dtype=torch.int32)
    with pytest.raises(ValueError):
        wrap_dp_counts(meta, torch.zeros(1, dtype=torch.int32), cpu,
                       torch.zeros((1, 128), dtype=torch.int8), 128)
