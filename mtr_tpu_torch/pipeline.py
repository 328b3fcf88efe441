"""PyTorch counterpart of mtr_tpu/pipeline.py: the host DP batcher, the
torch DP batcher, the hybrid engine, the walk stage, the wave loop and the
per-file main loop.

The host half (DP jobs and their dedup, the native-engine batcher, scheme
selection, polish and revision rounds, the wave selection and replay,
candidate-range queries) is this module's own copy of mtr_tpu's, on the
port's own host modules.  The device leg runs the wrap-around DP jobs on a
CUDA card (counts mode through ops/wrap_dp_counts.py, consensus mode
through ops/wrap_dp_consensus.py) and, under backend "device", the DI
sliding windows of long reads (ops/directional_index.py) and the DBG walks
(ops/dbg_device.py).  ShardedTorchDPBatcher cuts every launch over a
device mesh (parallel/mesh.py).
"""

from __future__ import annotations

import dataclasses
import os
import threading
from collections import defaultdict

import numpy as np
import torch

from mtr_tpu_torch import native
from mtr_tpu_torch.chaining import chain_records
from mtr_tpu_torch.config import DEFAULT_CONFIG, MTRConfig
from mtr_tpu_torch.io.fasta import Read, iter_fasta
from mtr_tpu_torch.ops.dbg_device import (
    dbg_walk_device_batch,
    flat_rows,
    native_walks,
)
from mtr_tpu_torch.ops.directional_index import (
    make_di_compute_k,
    make_di_manhattan_sharded,
)
from mtr_tpu_torch.ops.mf_filter import walked_mask
from mtr_tpu_torch.ops.wrap_dp_consensus import (
    cap_parts,
    move_row_bytes,
    wrap_dp_consensus,
)
from mtr_tpu_torch.ops.wrap_dp_counts import (
    R_MAX,
    VALUE_LIMIT,
    u_span_for,
    wrap_dp_counts,
)
from mtr_tpu_torch.oracle.arena import Arena
from mtr_tpu_torch.oracle.consensus import polish_repeat, rebuild_units_batch
from mtr_tpu_torch.oracle.dbg import (
    MAX_PERIOD,
    MIN_NUM_FREQ_UNIT,
    MIN_PERIOD,
    freq_2mer_array,
    walk_candidates,
)
from mtr_tpu_torch.oracle.directional_index import (
    fill_directional_index_with_end,
)
from mtr_tpu_torch.oracle.wrap_dp import _assign
from mtr_tpu_torch.parallel.mesh import (
    make_mesh,
    replicate,
    sharded_resident,
    split_bounds,
)
from mtr_tpu_torch.records import RepeatRecord, ratio_less
from mtr_tpu_torch.utils.encoding import decode_bases, encode_bases
from mtr_tpu_torch.utils.timers import TIMERS


class BackendUnavailable(RuntimeError):
    """The requested backend cannot run here (no CUDA card)."""


# the hybrid's walk pre-filter engages from this many queries per batch
# (mtr_tpu/pipeline.py:1379)
MF_FILTER_MIN_QUERIES = 32768


def _env_flag(name: str) -> bool:
    """Boolean env knob: unset, empty, and "0" are all OFF (a plain
    truthiness test would read FLAG=0 as enabled)."""
    return os.environ.get(name, "") not in ("", "0")


MOVES_BYTES_CAP = 1 << 30  # move scratch of one consensus launch
TB_FACTOR = 6  # traceback steps a rep row, for every scheme but (1, *, >=1)


_ENCODE_CACHE: dict = {}


def _encode_unit(s: str) -> np.ndarray:
    """encode_bases with memoization: the same few unit strings appear in
    thousands of DP jobs per batch.  Returned arrays are read-only by
    convention (DP job padding copies out of them)."""
    a = _ENCODE_CACHE.get(s)
    if a is None:
        if len(_ENCODE_CACHE) > 65536:
            _ENCODE_CACHE.clear()
        a = encode_bases(s)
        _ENCODE_CACHE[s] = a
    return a


@dataclasses.dataclass
class DPJob:
    """One DP job as an object: the polish phase's jobs and the tests'.  A
    batcher's run() turns a list of them into a JobTable; its result is
    the counts row (m, x, ins, del, scanned, i_final, max_i) or, in
    consensus mode, the (500, 5) consensus and (500, 4) missing blocks."""
    org: np.ndarray  # effective per-read arena view (codes + stale tail)
    qs: int
    qe: int
    unit: np.ndarray  # int32 unit codes
    scheme: tuple
    mode: str = "counts"  # 'counts' | 'consensus'
    result: object = None


MODES = ("counts", "consensus")  # a JobTable's mode column indexes this


@dataclasses.dataclass
class JobTable:
    """DP jobs as columns, one row a job: the read (its index in the list
    the batcher's begin_batch took), the range qs..qe (the segment is
    org[qs + 1 : qe + 2]), the unit (a row of `units`), the scheme (match
    gain, mismatch and indel penalties) and the mode (an index into
    MODES).  `units` holds each distinct unit's codes, -2 past its
    end."""
    read: np.ndarray    # (n,) int64
    qs: np.ndarray      # (n,) int64
    qe: np.ndarray      # (n,) int64
    unit: np.ndarray    # (n,) int64, row of units
    scheme: np.ndarray  # (n, 3) int32
    mode: np.ndarray    # (n,) int32
    units: np.ndarray   # (u, w) int32, w <= MAX_PERIOD
    ulens: np.ndarray   # (u,) int64

    def __len__(self) -> int:
        return len(self.qs)

    def take(self, rows) -> "JobTable":
        """The jobs of `rows`, in that order, over the same unit table."""
        return JobTable(self.read[rows], self.qs[rows], self.qe[rows],
                        self.unit[rows], self.scheme[rows], self.mode[rows],
                        self.units, self.ulens)

    def unit_lens(self) -> np.ndarray:
        return self.ulens[self.unit]

    def cells(self) -> np.ndarray:
        return (self.qe - self.qs + 1) * self.unit_lens()


def unit_table(codes: np.ndarray, ulens: np.ndarray) -> tuple[np.ndarray,
                                                              np.ndarray]:
    """A JobTable's (units, ulens) from the distinct units' codes, end to
    end, and their lengths."""
    w = max(int(ulens.max(initial=0)), 1)
    units = np.full((len(ulens), w), -2, np.int32)
    units[np.arange(w) < ulens[:, None]] = codes
    return units, ulens


def first_rows(keys: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """The distinct rows of keys (n, k) in the order they first appear:
    (first, inv), keys[first] distinct and keys == keys[first][inv]."""
    n = len(keys)
    # row order breaks ties: each run of equal rows starts at its first
    order = np.lexsort((np.arange(n), *keys.T[::-1]))
    sk = keys[order]
    new = np.ones(n, bool)
    new[1:] = (sk[1:] != sk[:-1]).any(axis=1)
    first = order[new]
    by_first = np.argsort(first)
    rank = np.empty(len(first), np.int64)
    rank[by_first] = np.arange(len(first))
    inv = np.empty(n, np.int64)
    inv[order] = rank[np.cumsum(new) - 1]
    return first[by_first], inv


def _jobs_table(jobs: list[DPJob], index: dict,
                dedup: bool) -> tuple[JobTable, np.ndarray]:
    """A job list as a JobTable over the batch's reads (index: id(org) ->
    read index) and, per job, its row.  Jobs equal in
    (read, range, unit, scheme, mode) share a row unless dedup is False:
    many k values discover the same unit for the same range, and the DP
    result depends only on that key."""
    n = len(jobs)
    ids: dict = {}
    codes: list = []
    cols = np.empty((n, 8), np.int64)  # read, qs, qe, unit, scheme, mode
    for i, job in enumerate(jobs):
        u = ids.setdefault(job.unit.tobytes(), len(ids))
        if u == len(codes):
            codes.append(job.unit)
        cols[i] = (index[id(job.org)], job.qs, job.qe, u, *job.scheme,
                   MODES.index(job.mode))
    if dedup:
        first, inv = first_rows(cols)
        cols = cols[first]
    else:
        inv = np.arange(n)
    units, ulens = unit_table(
        np.concatenate(codes),
        np.fromiter(map(len, codes), np.int64, len(codes)))
    return JobTable(cols[:, 0], cols[:, 1], cols[:, 2], cols[:, 3],
                    cols[:, 4:7].astype(np.int32),
                    cols[:, 7].astype(np.int32), units, ulens), inv


def _merge_legs(t: JobTable, legs) -> tuple[np.ndarray, tuple | None]:
    """One run_table result from the results of disjoint row sets of t:
    legs is [(rows, (counts, cons)), ...], a leg's cons rows those of its
    consensus jobs in the order of rows."""
    counts = np.zeros((len(t), 7), np.int64)
    is_cons = t.mode == 1
    cons = None
    if is_cons.any():
        rank = np.cumsum(is_cons) - 1  # a consensus row's place in cons
        n_cons = int(is_cons.sum())
        cons = (np.zeros((n_cons, MAX_PERIOD, 5), np.int64),
                np.zeros((n_cons, MAX_PERIOD, 4), np.int64))
    for rows, (leg_counts, leg_cons) in legs:
        counts[rows] = leg_counts
        if leg_cons is not None:
            at = rank[rows[is_cons[rows]]]
            cons[0][at] = leg_cons[0]
            cons[1][at] = leg_cons[1]
    return counts, cons


class _JobListBatcher:
    """A batcher's job-list entry point, run(jobs), on its table entry
    point, run_table(table) -> (counts, cons): counts (n, 7) int64, one
    row a job (m, x, ins, del, scanned, i_final, max_i; zeros for a
    consensus job), cons None or the consensus and missing blocks of the
    consensus jobs in table order ((c, 500, 5), (c, 500, 4)).  A job's
    read is one of the batch's (begin_batch); a job list run with no batch
    begun makes its own reads the batch."""

    _index: dict = {}  # id(org) -> read index, set by begin_batch

    def run(self, jobs: list[DPJob], deduped: bool = False) -> None:
        if not jobs:
            return
        if not self._index:
            self.begin_batch(list({id(j.org): j.org for j in jobs}.values()))
        table, inv = _jobs_table(jobs, self._index, not deduped)
        counts, cons = self.run_table(table)
        rank = np.cumsum(table.mode == 1) - 1
        rows = counts.tolist()
        for job, r in zip(jobs, inv.tolist()):
            if job.mode == "counts":
                job.result = tuple(rows[r])
            else:
                job.result = (cons[0][rank[r]], cons[1][rank[r]])


class HostDPBatcher(_JobListBatcher):
    """Native C++ wrap-DP engine (threaded scalar fills) with the same job
    interface as TorchDPBatcher: the host backend, the hybrid's host leg,
    and a cross-check.  The JAX package's degrade to the Python oracle
    when the engine cannot be built is not carried over: a failed build
    raises (native._load)."""

    def begin_batch(self, orgs: list[np.ndarray]) -> None:
        # the engine reads segments in place, through each read's address
        self._orgs = list(orgs)  # the reads as given, kept alive
        self._reads = [np.ascontiguousarray(o, np.int32) for o in orgs]
        self._index = {id(o): i for i, o in enumerate(orgs)}
        self._ptrs = np.fromiter((r.ctypes.data for r in self._reads),
                                 np.uint64, len(self._reads))

    def run_table(self, t: JobTable) -> tuple[np.ndarray, tuple | None]:
        n = len(t)
        if not n:
            return np.zeros((0, 7), np.int64), None
        # pooled: the C side reads only units[q, :ulens[q]], so stale data
        # beyond each unit is never seen
        units = native.POOL.get("dpb_units", (n, MAX_PERIOD), np.int32)
        np.take(t.units, t.unit, axis=0, out=units[:, : t.units.shape[1]],
                mode="clip")
        with TIMERS.span("mtr.dp.host", "dp_fill"):
            counts, cons, miss = native.wrap_dp_batch(
                self._ptrs[t.read], t.qs, t.qe, units, t.unit_lens(),
                t.scheme, t.mode)
        TIMERS.count("dp_jobs", n)
        is_cons = t.mode == 1
        return counts.copy(), ((cons[is_cons], miss[is_cons])
                               if is_cons.any() else None)


def apply_counts(rr: RepeatRecord, qs: int, unit_len: int, scheme,
                 row) -> None:
    """Fill record fields from a counts-mode DP result, the counts row
    (m, x, ins, del, scanned, i_final, max_i) of a job over qs.. with a
    unit of unit_len (wrap_around_DP.c:337-350)."""
    n_m, n_x, n_i, n_d, scanned, i_final, max_i = row
    rr.rep_start = qs + i_final + 1
    rr.rep_end = qs + max_i
    rr.repeat_len = max_i - i_final
    rr.num_freq_unit = scanned // unit_len if unit_len else 0
    rr.num_matches = n_m
    rr.num_mismatches = n_x
    rr.num_insertions = n_i
    rr.num_deletions = n_d
    rr.match_gain, rr.mismatch_penalty, rr.indel_penalty = scheme


@dataclasses.dataclass
class RangeQuery:
    read_idx: int
    qs: int
    qe: int
    w: int
    k: int
    candidates: list = dataclasses.field(default_factory=list)
    found: int = 0
    result: RepeatRecord | None = None  # the selected record, or None


@dataclasses.dataclass
class ReadState:
    read: Read
    org: np.ndarray  # effective arena view, length L+1
    di: np.ndarray
    di_end: np.ndarray
    di_w: np.ndarray
    ridx: int = -1   # file-order read index (multi-host merge key)



SCHEMES = ((1, 1, 3), (1, 3, 1))  # a candidate's two jobs, in this order


@dataclasses.dataclass
class SchemeJobs:
    """A wave's walk candidates as one job table: a job pair a distinct
    (read, range, unit), SCHEMES[0] then SCHEMES[1], in the order the
    candidates first show them (query order, then candidate order)."""
    jobs: JobTable
    cand_query: np.ndarray  # (c,) int64: a candidate's query
    cand_pos: np.ndarray    # (c,) int64: its place in the query's list
    cand_pair: np.ndarray   # (c,) int64: its job pair (jobs rows 2p, 2p+1)


def scheme_jobs(queries: list) -> SchemeJobs:
    """The job table of the queries' candidates.  Only the unit of each
    candidate is read, and interned; everything else is per query."""
    ids: dict = {}
    keys: list = []  # a candidate's (read, qs, qe, unit id)
    cand_query: list = []
    for qi, q in enumerate(queries):
        r, qs, qe = q.read_idx, q.qs, q.qe
        for cand in q.candidates:
            keys.append((r, qs, qe, ids.setdefault(cand.string, len(ids))))
            cand_query.append(qi)
    keys = np.array(keys, np.int64).reshape(-1, 4)
    first, pair = first_rows(keys)
    k = np.repeat(keys[first], 2, axis=0)
    n = len(k)
    units, ulens = unit_table(encode_bases("".join(ids)),
                              np.fromiter(map(len, ids), np.int64, len(ids)))
    TIMERS.count("scheme_candidates", len(keys))
    TIMERS.count("scheme_pairs", len(first))
    cand_query = np.array(cand_query, np.int64)
    cand_pos = np.arange(len(cand_query)) - np.searchsorted(cand_query,
                                                            cand_query)
    jobs = JobTable(k[:, 0], k[:, 1], k[:, 2], k[:, 3],
                    np.tile(np.array(SCHEMES, np.int32), (n // 2, 1)),
                    np.zeros(n, np.int32), units, ulens)
    return SchemeJobs(jobs, cand_query, cand_pos, pair)


def _ratios(counts: np.ndarray) -> np.ndarray:
    """Each counts row's match ratio, (float)m / (m + x + ins + del) in
    float32 as C computes it: the denominator is 0 only where m is, so the
    one singular case is 0/0, NaN."""
    with np.errstate(invalid="ignore"):
        return (counts[:, 0].astype(np.float32)
                / counts[:, :4].sum(axis=1).astype(np.float32))


def select_schemes(counts: np.ndarray) -> np.ndarray:
    """Per job pair (rows 2p, 2p+1 of counts), the row of the scheme a
    candidate keeps, or -1 for neither (wrap_around_DP.c:357-429).  The
    scalar loop over ratio_less reduces to: SCHEMES[1] iff its ratio is
    not NaN and SCHEMES[0]'s is NaN or strictly smaller; else SCHEMES[0]
    if its ratio is not NaN; else neither."""
    r = _ratios(counts)
    r0, r1 = r[0::2], r[1::2]
    nan0, nan1 = np.isnan(r0), np.isnan(r1)
    pick1 = ~nan1 & (nan0 | (r1 > r0))
    pick0 = ~pick1 & ~nan0
    base = 2 * np.arange(len(r0))
    return np.where(pick1, base + 1, np.where(pick0, base, -1))


def select_directions(sj: SchemeJobs, counts: np.ndarray, pick: np.ndarray,
                      n_queries: int, min_match_ratio: float) -> np.ndarray:
    """Per query, the candidate select_dp_candidate keeps, or -1
    (consensus.c:562-578): the first candidate, in the query's order, whose
    kept scheme's ratio is strictly above every earlier survivor's (so the
    first wins a tie), at least min_match_ratio, with more than
    MIN_NUM_FREQ_UNIT units scanned and MIN_PERIOD <= period < MAX_PERIOD.
    A candidate with no kept scheme never survives."""
    win = np.full(n_queries, -1, np.int64)
    if not len(sj.cand_pair):
        return win
    job = pick[sj.cand_pair]
    has = job >= 0
    job = np.where(has, job, 0)
    ratio = _ratios(counts).astype(np.float64)[job]
    period = sj.jobs.unit_lens()[job]
    ok = (has & (min_match_ratio <= ratio)
          & (counts[job, 4] // period > MIN_NUM_FREQ_UNIT)
          & (MIN_PERIOD <= period) & (period < MAX_PERIOD))
    best = np.full(n_queries, -1.0)
    for pos in range(int(sj.cand_pos.max()) + 1):
        c = np.flatnonzero(ok & (sj.cand_pos == pos))
        q = sj.cand_query[c]
        up = best[q] < ratio[c]
        best[q[up]] = ratio[c[up]]
        win[q[up]] = c[up]
    return win


def _polish_phase(batcher, states, polish_set, cfg) -> None:
    """Phase 5: polish_repeat then two revision rounds, batched.

    Each item of polish_set is (query, record); records are revised in
    place.  Mirrors revise_representative_unit (consensus.c:1048-1087):
    both rounds compare against the PRE-revision ratio."""
    if not polish_set:
        return
    TIMERS.count("polish_items", len(polish_set))
    items = []
    with TIMERS.span("mtr.polish.repeat"):
        for q, rr in polish_set:
            org = states[q.read_idx].org
            input_len = states[q.read_idx].read.length
            polish_repeat(org, input_len, rr)
            items.append((q, rr, rr.match_ratio()))

    for scheme in ((5, 1, 1), (1, 1, 3)):
        with TIMERS.span("mtr.polish.consensus"):
            # consensus DP on current units
            consjobs = []
            tmps = []
            for q, rr, base_ratio in items:
                org = states[q.read_idx].org
                tmp = rr.copy()
                tmp.match_gain, tmp.mismatch_penalty, tmp.indel_penalty = scheme
                consjobs.append(
                    DPJob(org, tmp.rep_start, tmp.rep_end,
                          _encode_unit(tmp.string), scheme, mode="consensus")
                )
                tmps.append(tmp)
            batcher.run(consjobs)
            # host rebuild (batched argmax), then re-score the revised units
            rebuild_units_batch(tmps, [job.result for job in consjobs])
        with TIMERS.span("mtr.polish.score"):
            scorejobs = []
            score_meta = []
            for (q, rr, base_ratio), tmp, job in zip(items, tmps, consjobs):
                if tmp.rep_period < MAX_PERIOD:
                    org = states[q.read_idx].org
                    sj = DPJob(org, tmp.rep_start, tmp.rep_end,
                               _encode_unit(tmp.string), scheme)
                    scorejobs.append(sj)
                    score_meta.append(((q, rr, base_ratio), tmp, sj))
            batcher.run(scorejobs)
            for (q, rr, base_ratio), tmp, sj in score_meta:
                apply_counts(tmp, sj.qs, len(sj.unit), sj.scheme, sj.result)
                if ratio_less(base_ratio, tmp.match_ratio()):
                    _assign(rr, tmp)



def _live_positions(st) -> np.ndarray:
    """Candidate-range start positions of a read (collection-time live
    set: di_end in [0, L) — handle_one_read.c:227-246)."""
    L = st.read.length
    return np.nonzero((st.di_end > -1) & (st.di_end < L))[0]


def waves_enabled(force=None) -> bool:
    """Wave-pruning switch: MTR_TPU_WAVES=1 forces on, MTR_TPU_NO_WAVES
    forces off; otherwise `force` (the adaptive policy's verdict)
    decides, defaulting to off."""
    if _env_flag("MTR_TPU_NO_WAVES"):
        return False
    if _env_flag("MTR_TPU_WAVES"):
        return True
    return bool(force)


def waves_policy(walk_s: float | None, dev_idle_s: float | None) -> bool:
    """Adaptive wave pruning (VERDICT r4 #6): full speculation hides
    ALL walk work behind the device leg, so pruning only pays when the
    walk queue is the scarce resource — i.e. the previous batch spent
    clearly more wall time walking than it spent idle-waiting on the
    device.  Measured on the 2-core box the device wait dominates and
    waves lose ~3-8% (PERF.md round 4); on many-core hosts feeding one
    chip the inequality flips."""
    if walk_s is None or dev_idle_s is None:
        return False
    return walk_s > 2.0 * dev_idle_s + 0.2


def wave1_positions(states, cfg=None, force=None):
    """Wave-1 selection for suppression pruning: the positions that NO
    earlier range can ever suppress.  A range q < p can only suppress p
    when its accepted repeat reaches past p's end (rep_end > qe_p with
    rep_end <= qe_q — handle_one_read.c:178-188), so p is safe iff the
    running max of earlier ends <= qe_p.

    Default OFF (every position becomes wave 1): pruning cuts total
    work 20%+ on repeat-dense sets, but on the shipping hybrid engine
    the wave-2 walks serialize against the device leg that full
    speculation overlaps, and measured end-to-end it loses ~3-8%
    (PERF.md round-4 notes).  MTR_TPU_WAVES=1 enables pruning — the
    right trade when walk CPU is the scarce resource (e.g. many-core
    hosts feeding one chip, or host-only runs at parity)."""
    sel = []
    waves = waves_enabled(force)
    for st in states:
        pos = _live_positions(st)
        if not waves or not len(pos):
            sel.append(pos)
            continue
        qe = st.di_end[pos].astype(np.int64)
        runmax = np.maximum.accumulate(qe)
        excl = np.empty_like(runmax)
        excl[0] = -1
        excl[1:] = runmax[:-1]
        # strict <: an equal-end earlier range CAN still suppress p
        # (rep_end = qs + max_i may reach qe_q + 1, so rep_end > qe_p
        # is possible when qe_q == qe_p); keeping such positions out of
        # wave 1 preserves the "no earlier range can suppress" invariant
        sel.append(pos[excl < qe])
    return sel


def _collect_queries(states, cfg, pos_sel=None):
    """Phase 2a: flat (read_idx, qs, qe, w, k) arrays for every candidate
    range x k, built with vectorized repeats (the k sweep is a function
    of w only — config.k_sweep / handle_one_read.c:104-118).  RangeQuery
    objects are only materialized for the few % of queries whose walk
    finds a unit.  pos_sel optionally restricts each read to an explicit
    position subset (wave pruning)."""
    lo_small = cfg.min_kmer - 3
    lo_big = cfg.min_kmer
    hi_small = cfg.max_kmer - 5
    hi_mid = cfg.max_kmer - 3
    hi_big = cfg.max_kmer
    chunks = []
    for ridx, st in enumerate(states):
        pos = (_live_positions(st) if pos_sel is None else pos_sel[ridx])
        if not len(pos):
            continue
        qe = st.di_end[pos].astype(np.int64)
        w = st.di_w[pos].astype(np.int64)
        k_lo = np.where(w < 1000, lo_small, lo_big)
        k_hi = np.where(w < 100, hi_small, np.where(w < 1000, hi_mid, hi_big))
        counts = k_hi - k_lo + 1
        total = int(counts.sum())
        # per-segment aranges: offset within each range's k run
        seg_start = np.repeat(np.cumsum(counts) - counts, counts)
        ks = np.repeat(k_lo, counts) + (np.arange(total) - seg_start)
        chunks.append((
            np.full(total, ridx, np.int32),
            np.repeat(pos, counts).astype(np.int32),
            np.repeat(qe, counts).astype(np.int32),
            np.repeat(w, counts).astype(np.int32),
            ks.astype(np.int32),
        ))
    if not chunks:
        z = np.zeros(0, np.int32)
        return z, z, z, z, z
    return tuple(np.concatenate([c[i] for c in chunks]) for i in range(5))



def _accepts(rr: RepeatRecord | None) -> bool:
    """Acceptance gate of handle_one_read.c:239-240."""
    return (
        rr is not None
        and rr.repeat_len > 0
        and rr.rep_start + MIN_PERIOD * MIN_NUM_FREQ_UNIT < rr.rep_end
    )


def _process_wave(states, batcher, cfg, queries, range_result) -> None:
    """Phases 3-6a for one wave of walk queries: batched DP scheme
    selection, acceptance gates, polish/revision rounds, k-sweep
    selection.  Merges per-range winners into range_result (keyed
    (read_idx, qs, qe); value None = computed but no qualifying
    record)."""
    # phase 3+4a: both schemes' DP for every distinct candidate, and the
    # scheme each keeps
    with TIMERS.span("mtr.stage_b.schemes"):
        sj = scheme_jobs(queries)
        if len(sj.jobs):
            counts, _ = batcher.run_table(sj.jobs)
            pick = select_schemes(counts)

    # phase 4b: direction selection + gates -> per-query result; build
    # polish set.  A query without a winner gets None: the empty record
    # the reference clears it to never passes the k sweep's filters
    with TIMERS.span("mtr.stage_b.select"):
        polish_set = []
        for q in queries:
            q.result = None
        if len(sj.jobs):
            win = select_directions(sj, counts, pick, len(queries),
                                    cfg.min_match_ratio)
            qi = np.flatnonzero(win >= 0)
            c = win[qi]
            job = pick[sj.cand_pair[c]]
            period = sj.jobs.unit_lens()[job]
            # the wrap_dp_size gate on the winner's period (its unit's
            # length) and the query's width
            width = np.array([queries[i].qe - queries[i].qs + 1
                              for i in qi.tolist()], np.int64)
            keep = period * width <= cfg.wrap_dp_size
            qi, c, job, period = qi[keep], c[keep], job[keep], period[keep]
            for i, pos, j, row, ratio, unit_len in zip(
                    qi.tolist(), sj.cand_pos[c].tolist(), job.tolist(),
                    counts[job].tolist(),
                    _ratios(counts[job]).astype(np.float64).tolist(),
                    period.tolist()):
                q = queries[i]
                if q.found == 0:
                    continue
                cand = q.candidates[pos]
                apply_counts(cand, q.qs, unit_len, SCHEMES[j % 2], row)
                st = states[q.read_idx]
                rr = RepeatRecord()
                rr.read_id = st.read.read_id
                rr.input_len = st.read.length
                rr.kmer = q.k
                _assign(rr, cand)
                rr._rk = (sum(row[:4]), row[0], ratio)  # match_ratio's cache
                q.result = rr
                coverage = rr.repeat_len // rr.rep_period
                if 5 <= coverage <= 20 and rr.rep_period > 5:
                    polish_set.append((q, rr))

    # phase 5: polish + revision rounds
    with TIMERS.span("mtr.stage_b.polish", "polish"):
        _polish_phase(batcher, states, polish_set, cfg)

    # phase 6a: k-sweep selection per range
    with TIMERS.span("mtr.stage_b.ksweep"):
        by_range: dict[tuple[int, int, int], list[RangeQuery]] = \
            defaultdict(list)
        for q in queries:
            by_range[(q.read_idx, q.qs, q.qe)].append(q)
        for key, qs_list in by_range.items():
            best = None
            max_ratio = -1.0
            for q in sorted(qs_list, key=lambda x: x.k):
                tmp = q.result
                if tmp is None:
                    continue  # cleared records never pass the filters below
                r = tmp.match_ratio()
                if (
                    ratio_less(max_ratio, r)
                    and cfg.min_match_ratio <= r
                    and tmp.num_freq_unit > MIN_NUM_FREQ_UNIT
                    and MIN_PERIOD <= tmp.rep_period
                ):
                    max_ratio = r
                    best = tmp
            range_result[key] = best


MAX_WAVES = 6


def _factor(schemes) -> int:
    """Traceback step factor of a consensus launch of (mg, mm, ip)
    schemes, any iterable of them (mtr_tpu/pipeline.py:706-711): 1 +
    ceil(mg/ip) bounds a path's steps per rep row, quantized to {2,
    TB_FACTOR}."""
    schemes = np.asarray(list(schemes), np.int64).reshape(-1, 3)
    mg, ip = schemes[:, 0], schemes[:, 2]
    factor = 1 + int((-(-mg // ip)).max())
    return 2 if factor <= 2 else TB_FACTOR


def _cap_parts(move_bytes: list[int]) -> list[int]:
    """Cut a longest-first consensus group so that each launch's move
    scratch (each job's packed moves, rep_len x move_row_bytes) stays
    within MOVES_BYTES_CAP; returns the cut points."""
    return cap_parts(move_bytes, MOVES_BYTES_CAP)


class TorchDPBatcher(_JobListBatcher):
    """DP jobs on one torch device (counterpart of
    mtr_tpu.pipeline.WrapDPBatcher).  The batch's reads are uploaded once
    (begin_batch); each run sorts its jobs longest first, launches the
    counts kernel once for all counts jobs and the consensus kernel once
    for all consensus jobs (cut to MOVES_BYTES_CAP of move scratch), every
    unit width in one launch, and copies each mode's results back to the
    host in one transfer.  On a CPU device the ops run their plain
    versions (tests)."""

    def __init__(self, device):
        self.device = torch.device(device)
        self._seq = 0
        # host staging for the flat reads, double-buffered: the previous
        # batch's non-blocking copy may still be reading its buffer
        self._host: list = [None, None]
        self._flat: torch.Tensor | None = None
        self._base = np.zeros(0, np.int64)  # a read's offset into flat
        self.cells = 0            # DP cells computed here, counts jobs
        self.cons_cells = 0       # ... and consensus jobs

    def begin_batch(self, orgs: list[np.ndarray]) -> None:
        total = sum(len(o) for o in orgs)
        self._seq += 1
        k = self._seq % 2
        buf = self._host[k]
        if buf is None or buf.numel() < total:
            cap = 1 << max(20, (max(total, 1) - 1).bit_length())
            buf = torch.empty(cap, dtype=torch.int8,
                              pin_memory=self.device.type == "cuda")
            self._host[k] = buf
        view = buf.numpy()
        base = np.zeros(len(orgs), np.int64)
        p = 0
        for i, o in enumerate(orgs):
            view[p : p + len(o)] = o
            base[i] = p
            p += len(o)
        self._index = {id(o): i for i, o in enumerate(orgs)}
        self._base = base
        self._flat = self._upload(buf[:total])

    def _upload(self, flat: torch.Tensor) -> torch.Tensor:
        """The batch's flat reads on the device."""
        return flat.to(self.device, non_blocking=True, copy=True)

    def run_table(self, t: JobTable) -> tuple[np.ndarray, tuple | None]:
        # one launch a mode for every unit width (each kernel sizes a
        # job's columns a lane itself); consensus launches cut to
        # MOVES_BYTES_CAP of move scratch
        outs: list = []  # (mode, rows, device result)
        for mode in range(len(MODES)):
            rows = np.flatnonzero(t.mode == mode)
            if not len(rows):
                continue
            with TIMERS.span("mtr.dp.pack"):
                ulens = t.ulens[t.unit[rows]]
                u_span = u_span_for(int(ulens.max()))
                # longest-first: the longest jobs start first
                order = np.argsort(t.qs[rows] - t.qe[rows], kind="stable")
                rows = rows[order]
                cuts = ([len(rows)] if mode == 0 else _cap_parts(
                    ((t.qe[rows] - t.qs[rows] + 1)
                     * move_row_bytes(ulens[order])).tolist()))
            lo = 0
            for hi in cuts:
                outs.append((mode, rows[lo:hi],
                             self._dispatch(t, rows[lo:hi], u_span, mode)))
                lo = hi
        with TIMERS.span("mtr.dp.wait", "dp_wait"):
            # one device->host copy per mode
            res = {}
            for mode in sorted({m for m, _, _ in outs}):
                res[mode] = torch.cat(
                    [o for m, _, o in outs if m == mode]).cpu().numpy()
        with TIMERS.span("mtr.dp.collect"):
            legs = []
            for mode, fused in res.items():
                rows = np.concatenate([r for m, r, _ in outs if m == mode])
                if mode == 0:
                    if not fused[:, 6].all():
                        raise RuntimeError(
                            "counts kernel left a job unfinished")
                    legs.append((rows, (fused[:, [0, 1, 2, 3, 4, 5, 9]],
                                        None)))
                else:
                    legs.append((rows, (np.zeros((len(rows), 7), np.int64),
                                        (fused[:, :, :5], fused[:, :, 5:]))))
            return _merge_legs(t, legs)

    def _dispatch(self, t: JobTable, part, u_span, mode) -> torch.Tensor:
        n = len(part)
        with TIMERS.span("mtr.dp.pack"):
            qs, qe = t.qs[part], t.qe[part]
            starts = self._base[t.read[part]] + qs + 1
            rep_len = qe - qs + 1
            scal = np.zeros((n, 8), np.int32)
            scal[:, 0] = rep_len
            scal[:, 1] = t.ulens[t.unit[part]]
            scal[:, 2:5] = t.scheme[part]
            units = np.full((n, u_span), -2, np.int8)
            w = min(u_span, t.units.shape[1])
            units[:, :w] = t.units[t.unit[part], :w]
            factor = _factor(t.scheme[part]) if mode == 1 else 0
        with TIMERS.span("mtr.dp.launch", "dp_dispatch"):
            out = self._launch(MODES[mode], starts, scal, units, u_span,
                               factor)
        TIMERS.count("dp_jobs", n)
        TIMERS.count("dp_chunks")
        cells = int((rep_len * scal[:, 1]).sum())
        if mode == 0:
            self.cells += cells
        else:
            self.cons_cells += cells
        return out

    def _launch(self, mode, starts, scal, units, u_span,
                factor) -> torch.Tensor:
        """One launch of the mode's op ('counts' or 'consensus', the name
        that the benchmark's roofline reads) on a part's host arrays."""
        self._check_bounds(scal, starts, u_span)
        dev = self.device
        args = (
            self._flat,
            torch.from_numpy(starts.astype(np.int32)).to(dev),
            torch.from_numpy(scal).to(dev),
            torch.from_numpy(units).to(dev),
            u_span,
        )
        if mode == "counts":
            return wrap_dp_counts(*args)
        return wrap_dp_consensus(*args, factor)[0]

    def _check_bounds(self, scal, starts, u_span) -> None:
        """The kernels' own bounds (unpacked int32), the same for both:
        rep_len <= R_MAX (2^20: the consensus kernel's traceback log keeps
        a 20-bit row), unit_len <= u_span <= 512, and per job the scan value
        D[j] + ip*j carried over 32*C columns, C = ceil(unit_len / 32)."""
        rep_len = scal[:, 0].astype(np.int64)
        mg, ip = scal[:, 2].astype(np.int64), scal[:, 4].astype(np.int64)
        if (rep_len > R_MAX).any():
            raise ValueError(f"rep_len above {R_MAX}")
        if (scal[:, 1] > u_span).any():
            raise ValueError(f"unit_len above the span {u_span}")
        if (ip < 1).any():
            raise ValueError("indel penalty must be >= 1")
        span = 32 * np.maximum(1, -(-scal[:, 1].astype(np.int64) // 32))
        if (rep_len * mg + ip * span >= VALUE_LIMIT).any():
            raise ValueError("rep_len*mg + ip*span overflows int32")
        if (starts < 0).any() or (starts + rep_len > len(self._flat)).any():
            raise ValueError("rep segment outside the resident reads")


class ShardedTorchDPBatcher(TorchDPBatcher):
    """TorchDPBatcher whose launches are cut over a device mesh
    (counterpart of mtr_tpu.pipeline.ShardedWrapDPBatcher): the batch's
    flat reads go once to every distinct device of the mesh, and each
    part's jobs are split evenly and contiguously over the mesh's slots,
    one launch a slot (parallel/mesh.sharded_resident; no job is padded or
    dropped).  Results concatenate on the batch axis, so the output equals
    the one-device batcher's bit for bit.  It is reached by handing it to
    run_file(..., batcher=...), which also cuts the Manhattan DI of long
    reads over its mesh."""

    def __init__(self, mesh):
        super().__init__(mesh.devices[0])
        self.mesh = mesh
        self._flats: dict = {}

    def _upload(self, flat: torch.Tensor) -> torch.Tensor:
        self._flats = replicate(self.mesh, flat)
        return self._flats[self.device]

    def _launch(self, mode, starts, scal, units, u_span,
                factor) -> torch.Tensor:
        bounds = split_bounds(len(scal), self.mesh.size)
        for lo, hi in zip(bounds, bounds[1:]):
            self._check_bounds(scal[lo:hi], starts[lo:hi], u_span)
        out = sharded_resident(
            self.mesh, mode, self._flats, starts.astype(np.int32), scal,
            units, u_span, factor, MOVES_BYTES_CAP)
        return out if mode == "counts" else out[0]


class TorchHybridDPBatcher(_JobListBatcher):
    """Big counts-mode DP jobs go to the torch device, small jobs to the
    native host engine, overlapped: the device leg runs in a thread while
    the host threads chew the small jobs.  Consensus jobs ride the device
    only above MTR_TPU_HYBRID_CONS_CELLS (default: never).  Every engine
    is bit-exact, so the split is pure scheduling (counterpart of
    mtr_tpu.pipeline.HybridDPBatcher, whose thresholds and env names it
    keeps).

    Deliberately not carried over: the tiny-v1-group demotion (a padded
    TPU v1 chunk cost b_pad x max_rep; here every job is its own block)
    and the self-degrade / budget abandonment (a device-leg exception is
    re-raised on the caller thread: a host fallback would hide a kernel
    fault)."""

    def __init__(self, device, cell_threshold: int | None = None,
                 min_device_cells: int | None = None):
        self.device = TorchDPBatcher(device)
        self.host = HostDPBatcher()
        if cell_threshold is None:
            env_cells = os.environ.get("MTR_TPU_HYBRID_CELLS")
            if env_cells is not None:
                cell_threshold = int(env_cells)
            else:
                cell_threshold = 1 << 18
                if not native.available():
                    # the host leg's oracle fallback is far slower than
                    # any device launch: ship every counts job
                    cell_threshold = 0
        self.cell_threshold = cell_threshold
        if min_device_cells is None:
            min_device_cells = int(os.environ.get(
                "MTR_TPU_MIN_DEVICE_CELLS", str(1 << 26)))
        self.min_device_cells = min_device_cells
        # consensus (polish) jobs ride the device only above this; the
        # default keeps them on the host
        self.cons_threshold = int(
            os.environ.get("MTR_TPU_HYBRID_CONS_CELLS", str(1 << 62)))
        self.dev_idle_s = 0.0
        self.host_cells = 0  # counts-mode cells run by the host leg
        self._batch_orgs = None

    def pop_dev_idle(self) -> float:
        """Host-idle-waiting-on-device seconds since the last call."""
        v = self.dev_idle_s
        self.dev_idle_s = 0.0
        return v

    def begin_batch(self, orgs: list[np.ndarray]) -> None:
        # the device leg's flat upload is deferred to its thread, once a
        # device-bound job set materializes
        self.host.begin_batch(orgs)
        self._index = self.host._index
        self._batch_orgs = orgs

    def run_table(self, t: JobTable) -> tuple[np.ndarray, tuple | None]:
        cells = t.cells()
        is_counts = t.mode == 0
        # a consensus job of no cells is held to the counts threshold
        counts_like = is_counts | (cells == 0)
        thr = self.cell_threshold
        if counts_like.any() and cells[counts_like].max() < thr:
            # small-job workloads would otherwise never touch the device
            thr = max(thr >> 4, 1 << 14)
        big = np.where(counts_like, cells >= thr, cells >= self.cons_threshold)
        # engagement gate: a device round costs a roughly fixed launch +
        # copy latency whatever it carries
        if big.any() and cells[big & is_counts].sum() < self.min_device_cells:
            big[:] = False
        self.host_cells += int(cells[~big & is_counts].sum())
        if not big.any():
            return self.host.run_table(t)
        small_rows, big_rows = np.flatnonzero(~big), np.flatnonzero(big)
        out: list = []
        err: list = []
        batch, parent = TIMERS.batch(), TIMERS.current()

        def dev_run():
            with TIMERS.thread("dp_device", batch, parent), \
                    TIMERS.span("mtr.dp.device_leg"):
                try:
                    if self._batch_orgs is not None:
                        with TIMERS.span("mtr.dp.upload"):
                            self.device.begin_batch(self._batch_orgs)
                        self._batch_orgs = None
                    out.append(self.device.run_table(t.take(big_rows)))
                except Exception as e:  # re-raised on the caller thread
                    err.append(e)

        th = threading.Thread(target=dev_run)
        th.start()
        host = self.host.run_table(t.take(small_rows))
        with TIMERS.span("mtr.dp.hybrid_wait") as waited:
            th.join()
        self.dev_idle_s += waited.seconds
        if err:
            raise err[0]
        return _merge_legs(t, [(small_rows, host), (big_rows, out[0])])


def _need_cuda(backend: str) -> None:
    if not torch.cuda.is_available():
        raise BackendUnavailable(
            f"--backend {backend} needs a CUDA device; "
            "torch.cuda.is_available() is false")


def make_batcher(cfg: MTRConfig):
    """Pick the DP engine: `host` is the native engine, `hybrid` (and
    `auto`, the default) the torch hybrid on the CUDA card, `device` every
    DP job on the card.  Without a card, auto raises as hybrid and device
    do: the CPU is asked for by name (`host`, or a TorchDPBatcher on a
    CPU device)."""
    if cfg.backend == "host":
        return HostDPBatcher()
    if cfg.backend in ("hybrid", "auto"):
        _need_cuda(cfg.backend)
        return TorchHybridDPBatcher(torch.device("cuda"))
    if cfg.backend == "device":
        _need_cuda("device")
        return TorchDPBatcher(torch.device("cuda"))
    raise ValueError(f"unknown backend {cfg.backend!r}")


def batcher_device(batcher) -> torch.device:
    """The torch device a port batcher runs on; CUDA for any other batcher
    (device DI and device walks need a card)."""
    if isinstance(batcher, TorchHybridDPBatcher):
        batcher = batcher.device
    if isinstance(batcher, TorchDPBatcher):
        return batcher.device
    return torch.device("cuda")


def batcher_mesh(batcher):
    """The mesh a port batcher cuts its launches over, or None."""
    return getattr(batcher, "mesh", None)


def _use_mf_filter(cfg: MTRConfig, n_q: int, device) -> bool:
    """The hybrid's opt-in walk pre-filter (MTR_TPU_MF_FILTER): batches of
    MF_FILTER_MIN_QUERIES queries or more, on a CUDA device.  OPT-IN as in
    mtr_tpu, where the device filter paid only when host cores were scarce
    against the chip (mtr_tpu/pipeline.py:1382-1392)."""
    return (cfg.backend == "hybrid" and _env_flag("MTR_TPU_MF_FILTER")
            and n_q >= MF_FILTER_MIN_QUERIES and device.type == "cuda")


def _filtered_walks(orgs, lens, ridx_a, qs_a, qe_a, k_a, device):
    """The native walks of the queries walked_mask keeps; the rest get the
    unwalked result (found 0, no rows).  A device fault raises."""
    n_q = len(ridx_a)
    sub = np.nonzero(walked_mask(orgs, lens, ridx_a, qs_a, qe_a, k_a,
                                 device))[0]
    TIMERS.count("mf_filtered_queries", n_q - len(sub))
    r = native_walks(orgs, lens, ridx_a[sub], qs_a[sub], qe_a[sub], k_a[sub])
    res = {"units": r["units"], "scores": r["scores"]}
    for key in ("fwd_row", "bwd_row", "fwd_period", "bwd_period",
                "found_last"):
        res[key] = np.full(n_q, -1 if key.endswith("row") else 0, np.int32)
        res[key][sub] = r[key]
    return res


def _hit_queries(states, res, ridx_a, qs_a, qe_a, w_a, k_a):
    """RangeQuery objects for the queries whose walk found a unit, with
    their candidate records (mtr_tpu/pipeline.py:1419-1462).  res is in
    flat_rows' form: a walk's unit is units[off : off + period]."""
    n_q = len(ridx_a)
    f_off, b_off = res["fwd_off"], res["bwd_off"]
    units, scores = res["units"], res["scores"]
    unit_cache: dict = {}  # unit bytes -> (string, freq_2mer)
    hits = np.nonzero((f_off[:n_q] >= 0) | (b_off[:n_q] >= 0))[0]
    h_ridx = ridx_a[hits].tolist()
    h_qs = qs_a[hits].tolist()
    h_qe = qe_a[hits].tolist()
    h_w = w_a[hits].tolist()
    h_k = k_a[hits].tolist()
    h_f = f_off[hits].tolist()
    h_b = b_off[hits].tolist()
    h_fp = res["fwd_period"][hits].tolist()
    h_bp = res["bwd_period"][hits].tolist()
    h_found = res["found_last"][hits].tolist()
    cand_proto = RepeatRecord().__dict__
    queries: list[RangeQuery] = []
    for hi in range(len(hits)):
        st = states[h_ridx[hi]]
        q = RangeQuery(h_ridx[hi], h_qs[hi], h_qe[hi], h_w[hi], h_k[hi])
        q.found = h_found[hi]
        for off, period in ((h_f[hi], h_fp[hi]), (h_b[hi], h_bp[hi])):
            if off < 0:
                continue
            seg = units[off : off + period]
            ukey = seg.tobytes()
            ent = unit_cache.get(ukey)
            if ent is None:
                unit = seg.tolist()
                ent = (decode_bases(unit), freq_2mer_array(unit))
                unit_cache[ukey] = ent
            cand = RepeatRecord.__new__(RepeatRecord)
            cand.__dict__.update(cand_proto)
            cand.read_id = st.read.read_id
            cand.input_len = st.read.length
            cand.kmer = q.k
            cand.rep_period = period
            cand.string = ent[0]
            cand.string_score = scores[off : off + period].copy()
            cand.freq_2mer = list(ent[1])
            q.candidates.append(cand)
        queries.append(q)
    return queries


def walk_batch(states: list[ReadState], cfg: MTRConfig, pos_sel=None,
               device=None) -> list[RangeQuery]:
    """Phase 2, the (range, k) walk queries of a batch or of one wave
    (mtr_tpu/pipeline.py:1347-1487): on `device` (CUDA when None) through
    ops/dbg_device.py under backend "device" with use_device_walks, else
    on the native engine (behind the device pre-filter under "hybrid"
    with MTR_TPU_MF_FILTER), else the oracle.

    Its span is the walk share of -c's "Computing periods": the walk
    thread's, or, for an extra wave walked inside stage B, stage B's."""
    nested = TIMERS.role() == "stage_b"
    with TIMERS.span("mtr.walk.batch", "period.nested_walks" if nested
                     else "period.walks"):
        with TIMERS.span("mtr.walk.collect"):
            ridx_a, qs_a, qe_a, w_a, k_a = _collect_queries(
                states, cfg, pos_sel)
        n_q = len(ridx_a)
        device = torch.device("cuda") if device is None else device
        orgs = [st.org for st in states]
        lens = [st.read.length for st in states]

        # "walks": the walk engine and the hits, as -c has always read it
        res = None
        if cfg.backend == "device" and cfg.use_device_walks and n_q:
            with TIMERS.span("mtr.walk.device", "walks"):
                res = dbg_walk_device_batch(orgs, lens, ridx_a, qs_a, qe_a,
                                            k_a, device)
        elif cfg.use_native and native.available() and n_q:
            with TIMERS.span("mtr.walk.native", "walks"):
                if _use_mf_filter(cfg, n_q, device):
                    res = _filtered_walks(orgs, lens, ridx_a, qs_a, qe_a,
                                          k_a, device)
                else:
                    res = native_walks(orgs, lens, ridx_a, qs_a, qe_a, k_a)
                res = flat_rows(res)
        with TIMERS.span("mtr.walk.hits", "walks"):
            if res is not None:
                queries = _hit_queries(states, res, ridx_a, qs_a, qe_a, w_a,
                                       k_a)
            else:
                queries = []
                for i in range(n_q):
                    st = states[int(ridx_a[i])]
                    q = RangeQuery(int(ridx_a[i]), int(qs_a[i]),
                                   int(qe_a[i]), int(w_a[i]), int(k_a[i]))
                    template = RepeatRecord()
                    template.read_id = st.read.read_id
                    template.input_len = st.read.length
                    template.kmer = q.k
                    q.candidates, q.found = walk_candidates(
                        st.org, st.read.length, q.qs, q.qe, template)
                    if q.candidates:
                        queries.append(q)

        if native.available():
            # the walk engine's measured init / count-table sections (zeros
            # unless -c enabled them)
            init_s, count_s, _walk_s = native.read_stage_timers()
            TIMERS.add("initialize", init_s)
            TIMERS.add("count_table", count_s)
        TIMERS.count("speculative_queries", n_q)
        TIMERS.count("walk_hit_queries", len(queries))
    return queries


def _replay(states, all_pos, cursor, computed, nq, accepted,
            range_result) -> bool:
    """Exact replay of one wave: advance each read's cursor over its
    ranges in order, applying the accepted records' kills to the live
    arrays, up to the first range a later wave must compute.  True once
    every read is done."""
    alldone = True
    for ridx, st in enumerate(states):
        di, di_end, di_w = st.di, st.di_end, st.di_w
        pos = all_pos[ridx]
        c = cursor[ridx]
        comp = computed[ridx]
        while c < len(pos):
            p = int(pos[c])
            qe = int(di_end[p])
            if qe < 0:
                # suppressed before its turn; never computed means
                # skipped exactly as the reference skips it
                TIMERS.count("suppressed_ranges")
                if not comp[p]:
                    TIMERS.count("pruned_ranges")
                c += 1
                continue
            if not comp[p]:
                break  # a later wave must compute this position
            nq[ridx] += 1  # reference query_counter: per live range
            rr = range_result.get((ridx, p, qe))
            if _accepts(rr):
                accepted[ridx].append(rr)
                span = np.arange(rr.rep_start, rr.rep_end)
                kill = span[(di[span] != -1) & (di_end[span] < rr.rep_end)]
                di[kill] = -1.0
                di_end[kill] = -1
                di_w[kill] = -1
            c += 1
        cursor[ridx] = c
        if c < len(pos):
            alldone = False
    return alldone


def _next_wave(states, all_pos, cursor, computed, range_result, wave):
    """The next wave's positions a read: an optimistic simulation from
    each cursor (everything still alive once wave reaches MAX_WAVES)."""
    pos_sel = []
    n_new = 0
    for ridx, st in enumerate(states):
        pos = all_pos[ridx]
        c = cursor[ridx]
        if c >= len(pos):
            pos_sel.append(pos[:0])
            continue
        comp = computed[ridx]
        if wave >= MAX_WAVES:
            # bound the wave count: compute everything still alive
            rem = pos[c:]
            live = rem[(st.di_end[rem] >= 0) & ~comp[rem]]
            pos_sel.append(live)
            n_new += len(live)
            continue
        di_s = st.di.copy()
        de_s = st.di_end.copy()
        need: list[int] = []
        for p in pos[c:]:
            p = int(p)
            qe = int(de_s[p])
            if qe < 0:
                continue
            if not comp[p]:
                need.append(p)
                continue
            rr = range_result.get((ridx, p, qe))
            if _accepts(rr):
                span = np.arange(rr.rep_start, rr.rep_end)
                kill = span[(di_s[span] != -1) & (de_s[span] < rr.rep_end)]
                di_s[kill] = -1.0
                de_s[kill] = -1
        pos_sel.append(np.asarray(need, dtype=pos.dtype))
        n_new += len(need)
    if n_new == 0:  # a raise, not an assert: -O would drop it and
        # turn a stall into an endless loop
        raise RuntimeError("wave selection stalled with unfinished reads")
    return pos_sel


def process_batch(states: list[ReadState], batcher, cfg: MTRConfig,
                  queries: list[RangeQuery] | None = None, pos_sel=None,
                  device=None):
    """Wave-pruned batch processing (mtr_tpu/pipeline.py:1560-1705, whose
    docstring describes the waves), with every wave's walks through this
    module's walk_batch on `device`.  Its span less the walks inside it is
    stage B's share of -c's "Computing periods" (main.c:113)."""
    with TIMERS.span("mtr.stage_b.batch"):
        with TIMERS.span("mtr.stage_b.upload"):
            batcher.begin_batch([st.org for st in states])

        with TIMERS.span("mtr.stage_b.ranges"):
            all_pos = [_live_positions(st) for st in states]
            TIMERS.count("ranges_total", sum(len(p) for p in all_pos))
            computed = [np.zeros(len(st.di_end), bool) for st in states]
        if queries is None:
            pos_sel = wave1_positions(states, cfg)
            queries = walk_batch(states, cfg, pos_sel, device)
        elif pos_sel is None:
            pos_sel = all_pos  # callers that pre-walk every position

        range_result: dict[tuple[int, int, int], RepeatRecord | None] = {}
        cursor = [0] * len(states)
        accepted: list[list[RepeatRecord]] = [[] for _ in states]
        nq = [0] * len(states)
        wave = 0
        while True:
            wave += 1
            with TIMERS.span("mtr.stage_b.ranges"):
                for ridx, ps in enumerate(pos_sel):
                    if len(ps):
                        computed[ridx][ps] = True
                        TIMERS.count("computed_ranges", len(ps))
            _process_wave(states, batcher, cfg, queries, range_result)

            with TIMERS.span("mtr.stage_b.replay"):
                alldone = _replay(states, all_pos, cursor, computed, nq,
                                  accepted, range_result)
            if alldone:
                break
            with TIMERS.span("mtr.stage_b.next_wave"):
                pos_sel = _next_wave(states, all_pos, cursor, computed,
                                     range_result, wave)
            TIMERS.count("waves_extra")
            queries = walk_batch(states, cfg, pos_sel, device)

        TIMERS.count("queries", sum(nq))
        with TIMERS.span("mtr.stage_b.chaining", "chaining"):
            return [chain_records(acc) for acc in accepted]


def run_file(
    path: str,
    cfg: MTRConfig = DEFAULT_CONFIG,
    out=None,
    checkpoint: str | None = None,
    strict: bool = True,
    record_sink=None,
    read_filter=None,
    read_meta=None,
    batcher=None,
):
    """The per-file main loop of mtr_tpu.pipeline.run_file over this module's
    batcher (make_batcher(cfg) unless one is given); arguments as there.

    Under backend "device", DI of reads of cfg.device_di_threshold bases
    or more, and the DBG walks unless cfg.use_device_walks is False, run
    on the batcher's device (CUDA unless the batcher is a TorchDPBatcher
    on another device), as mtr_tpu does; every other backend keeps DI
    and the walks on the host, the hybrid's opt-in walk pre-filter
    aside.  The Manhattan DI is cut by position over a mesh of more than
    one slot (ops/directional_index.make_di_manhattan_sharded): the mesh
    of a ShardedTorchDPBatcher, or every card when no batcher is given
    and there is more than one (mtr_tpu/pipeline.py:1723-1728); Pearson
    stays on one device, where every pass of one k is one launch
    (ops/directional_index.make_di_compute_k)."""
    import gc
    import sys

    if out is None:
        out = sys.stdout
    # millions of small acyclic records per batch: widen the gc
    # thresholds while running
    _gc_thresh = gc.get_threshold()
    gc.set_threshold(200_000, 50, 50)
    if cfg.print_computation_time:
        native.enable_stage_timers()
    arena = Arena(cfg.max_input_length)
    if batcher is None:
        batcher = make_batcher(cfg)
        # as mtr_tpu: more than one card cuts the long reads' Manhattan DI
        # over all of them
        mesh = (make_mesh() if cfg.backend == "device"
                and torch.cuda.device_count() > 1 else None)
    else:
        mesh = batcher_mesh(batcher)
    device = batcher_device(batcher)
    di_compute_k = None
    if cfg.backend == "device":
        if cfg.manhattan_distance and mesh is not None and mesh.size > 1:
            di_compute_k = make_di_manhattan_sharded(mesh)
        else:
            di_compute_k = make_di_compute_k(device, cfg.manhattan_distance)
    batch: list[ReadState] = []
    done_reads = 0
    skip = 0
    if checkpoint:
        try:
            with open(checkpoint) as f:
                skip = int(f.read().strip() or 0)
        except FileNotFoundError:
            skip = 0

    # Two-stage batch pipeline: stage A (walks, host CPU) overlaps the
    # previous batch's stage B (DP + polish + selection, owns the
    # batcher); emission stays in order because B batches are serialized.
    # Batches are numbered at flush(); each stage's thread runs under its
    # role and its batch's number (utils/timers.py).
    pending_a = None  # (thread, states, holderA, batch number)
    pending_b = None  # (thread, states, holderB, batch number)
    n_batches = 0

    def drain_b():
        nonlocal pending_b, done_reads
        if pending_b is None:
            return
        t, states, holder, n = pending_b
        with TIMERS.span("mtr.read.wait_stage_b", batch=n):
            t.join()
        pending_b = None
        if "error" in holder:
            if strict:
                raise holder["error"]
            print(
                f"warning: batch of {len(states)} reads failed "
                f"({holder['error']}); skipped",
                file=sys.stderr,
            )
            holder["results"] = [[] for _ in states]
        with TIMERS.span("mtr.read.emit", batch=n):
            for st, records in zip(states, holder["results"]):
                for rec in records:
                    out.write(rec.format_record() + "\n")
                    if record_sink is not None:
                        record_sink(rec)
                    if cfg.print_alignment:
                        from mtr_tpu_torch.pretty import (
                            pretty_print_alignment,
                        )

                        out.write("\n")
                        pretty_print_alignment(st.org, rec, out)
                if read_meta is not None:
                    read_meta(st.ridx, len(records))
                done_reads += 1
            out.flush()
            if checkpoint:
                with open(checkpoint, "w") as f:
                    f.write(str(done_reads + skip))

    def promote_a():
        nonlocal pending_a, pending_b
        if pending_a is None:
            return
        t, states, ha, n = pending_a
        with TIMERS.span("mtr.read.wait_walks", batch=n):
            t.join()
        pending_a = None
        drain_b()
        hb: dict = {}

        def work_b():
            with TIMERS.thread("stage_b", n):
                try:
                    if "error" in ha:
                        raise ha["error"]
                    hb["results"] = process_batch(
                        states, batcher, cfg, queries=ha["queries"],
                        pos_sel=ha["pos_sel"], device=device)
                except Exception as e:  # reported or re-raised by drain_b
                    hb["error"] = e

        t2 = threading.Thread(target=work_b)
        t2.start()
        pending_b = (t2, states, hb, n)

    # adaptive wave pruning from the previous batch's walk time vs
    # host-idle-on-device wait (waves_policy); output is identical
    adapt = {"walk_s": None, "on": False}

    def flush():
        nonlocal batch, pending_a, n_batches
        if not batch:
            return
        promote_a()
        pop_idle = getattr(batcher, "pop_dev_idle", None)
        if pop_idle is not None:
            adapt["on"] = waves_policy(adapt["walk_s"], pop_idle())
        states = batch
        batch = []
        ha: dict = {}
        n_batches += 1
        n = n_batches
        TIMERS.count("batches")
        TIMERS.set_batch(n + 1)  # the reader fills the next batch

        def work_a():
            with TIMERS.thread("walks", n):
                try:
                    ha["pos_sel"] = wave1_positions(
                        states, cfg, force=adapt["on"])
                    # the walk thread alone adds to "period.walks"
                    walked = TIMERS.seconds("period.walks")
                    ha["queries"] = walk_batch(states, cfg, ha["pos_sel"],
                                               device)
                    adapt["walk_s"] = TIMERS.seconds("period.walks") - walked
                except Exception as e:  # re-raised by work_b
                    ha["error"] = e

        t = threading.Thread(target=work_a)
        t.start()
        pending_a = (t, states, ha, n)

    min_rsl = 100
    own = 0
    batch_bases = 0
    reads = enumerate(iter_fasta(path, cfg.max_input_length))
    try:
        with TIMERS.thread("reader", 1):
            while True:
                with TIMERS.span("mtr.read.input"):
                    item = next(reads, None)
                    if item is not None:
                        # keep arena reuse semantics even when skipping
                        arena.load_read(item[1].codes)
                if item is None:
                    break
                ridx, read = item
                if read_filter is not None and not read_filter(ridx):
                    continue
                own += 1
                if own <= skip:
                    continue
                L = read.length
                org_eff = arena.org_input[: L + 1].copy()
                rsl = min_rsl if L < min_rsl * 10 else L // 10
                with TIMERS.span("mtr.read.di", "range"):
                    # the reader thread's DI shares the card with stage B's
                    # DP
                    di, di_end, di_w = fill_directional_index_with_end(
                        arena, L, rsl, manhattan=cfg.manhattan_distance,
                        di_compute_k=(di_compute_k if
                                      L >= cfg.device_di_threshold else None),
                        use_native=cfg.use_native,
                    )
                batch.append(ReadState(read, org_eff, di, di_end, di_w, ridx))
                batch_bases += L
                if (len(batch) >= cfg.reads_per_batch
                        or batch_bases >= cfg.bases_per_batch):
                    flush()
                    batch_bases = 0
            flush()
            promote_a()
            drain_b()
    finally:
        gc.set_threshold(*_gc_thresh)
