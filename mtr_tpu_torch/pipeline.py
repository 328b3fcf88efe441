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
import time
from collections import defaultdict

import numpy as np
import torch

from mtr_tpu_torch import native
from mtr_tpu_torch.chaining import chain_records
from mtr_tpu_torch.config import DEFAULT_CONFIG, MTRConfig
from mtr_tpu_torch.io.fasta import Read, iter_fasta
from mtr_tpu_torch.ops.dbg_device import dbg_walk_device_batch, native_walks
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
    select_dp_candidate,
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


def dedup_jobs(jobs: list["DPJob"]) -> tuple[list["DPJob"], list[int]]:
    """Many k values discover the SAME unit for the same range, and the
    DP result depends only on (read segment, unit, scheme, mode) — so
    identical jobs are computed once and fanned out.  Returns the unique
    job list and, per original job, its index into it."""
    uniq: dict = {}
    uniq_jobs: list[DPJob] = []
    remap: list[int] = []
    for job in jobs:
        key = (
            id(job.org), job.qs, job.qe,
            job.unit.tobytes(), job.scheme, job.mode,
        )
        idx = uniq.get(key)
        if idx is None:
            idx = len(uniq_jobs)
            uniq[key] = idx
            uniq_jobs.append(job)
        remap.append(idx)
    return uniq_jobs, remap


@dataclasses.dataclass
class DPJob:
    org: np.ndarray  # effective per-read arena view (codes + stale tail)
    qs: int
    qe: int
    unit: np.ndarray  # int32 unit codes
    scheme: tuple
    mode: str = "counts"  # 'counts' | 'consensus'
    result: object = None


class HostDPBatcher:
    """Native C++ wrap-DP engine (threaded scalar fills) with the same job
    interface as TorchDPBatcher: the host backend, the hybrid's host leg,
    and a cross-check.  The JAX package's degrade to the Python oracle
    when the engine cannot be built is not carried over: a failed build
    raises (native._load)."""

    def begin_batch(self, orgs: list[np.ndarray]) -> None:
        pass  # host engine reads segments in place

    def run(self, jobs: list[DPJob], deduped: bool = False) -> None:
        if deduped:
            self._run(jobs)
            return
        uniq_jobs, remap = dedup_jobs(jobs)
        self._run(uniq_jobs)
        if len(uniq_jobs) != len(jobs):
            for job, ui in zip(jobs, remap):
                job.result = uniq_jobs[ui].result

    def _run(self, jobs: list[DPJob]) -> None:
        if not jobs:
            return
        n = len(jobs)
        # pooled: the C side reads only units[q, :ulens[q]], so stale data
        # beyond each unit is never seen
        units = native.POOL.get("dpb_units", (n, 500), np.int32)
        ulens = np.zeros(n, np.int32)
        schemes = np.zeros((n, 3), np.int32)
        modes = np.zeros(n, np.int32)
        orgs, qss, qes = [], [], []
        for q, job in enumerate(jobs):
            units[q, : len(job.unit)] = job.unit
            ulens[q] = len(job.unit)
            schemes[q] = job.scheme
            modes[q] = 0 if job.mode == "counts" else 1
            orgs.append(np.ascontiguousarray(job.org, np.int32))
            qss.append(job.qs)
            qes.append(job.qe)
        with TIMERS.section("dp_fill"):
            counts, cons, miss = native.wrap_dp_batch(
                orgs, qss, qes, units, ulens, schemes, modes)
        TIMERS.count("dp_jobs", n)
        clist = counts[:n].tolist()  # one C-level conversion for all rows
        for q, job in enumerate(jobs):
            if job.mode == "counts":
                m, x, ins, dele, scanned, i_final, max_i = clist[q]
                job.result = ((m, x, ins, dele, scanned), i_final, max_i)
            else:
                job.result = (cons[q], miss[q])


def apply_counts(rr: RepeatRecord, job: DPJob) -> None:
    """Fill record fields from a counts-mode DP result
    (wrap_around_DP.c:337-350)."""
    (n_m, n_x, n_i, n_d, scanned), i_final, max_i = job.result
    rr.rep_start = job.qs + i_final + 1
    rr.rep_end = job.qs + max_i
    rr.repeat_len = max_i - i_final
    rr.num_freq_unit = scanned // len(job.unit) if len(job.unit) else 0
    rr.num_matches = n_m
    rr.num_mismatches = n_x
    rr.num_insertions = n_i
    rr.num_deletions = n_d
    rr.match_gain, rr.mismatch_penalty, rr.indel_penalty = job.scheme


@dataclasses.dataclass
class RangeQuery:
    read_idx: int
    qs: int
    qe: int
    w: int
    k: int
    candidates: list = dataclasses.field(default_factory=list)
    found: int = 0
    result: RepeatRecord | None = None  # post-selection record (or cleared)


@dataclasses.dataclass
class ReadState:
    read: Read
    org: np.ndarray  # effective arena view, length L+1
    di: np.ndarray
    di_end: np.ndarray
    di_w: np.ndarray
    ridx: int = -1   # file-order read index (multi-host merge key)



def _wrap_dp_schemes(batcher, queries_with_candidates) -> None:
    """Phase 3+4a: batched wrap_around_DP (both schemes) for every walk
    candidate; per candidate keep the higher-ratio scheme
    (wrap_around_DP.c:357-429).

    Candidates are deduplicated by (read, range, unit) BEFORE job
    construction — different k values routinely discover the same unit,
    and the DP + scheme selection depend only on this key — so each
    unique candidate builds one job pair and runs one selection."""
    dpjobs: list[DPJob] = []
    uniq: dict = {}           # key -> index into selections
    sel_jobs: list = []       # per unique key: (job113, job131)
    meta: list = []           # per candidate: (cand, uniq_idx)
    for q, org_arr in queries_with_candidates:
        for cand in q.candidates:
            unit = _encode_unit(cand.string)
            key = (id(org_arr), q.qs, q.qe, cand.string)
            ui = uniq.get(key)
            if ui is None:
                ui = len(sel_jobs)
                uniq[key] = ui
                j113 = DPJob(org_arr, q.qs, q.qe, unit, (1, 1, 3))
                j131 = DPJob(org_arr, q.qs, q.qe, unit, (1, 3, 1))
                dpjobs.append(j113)
                dpjobs.append(j131)
                sel_jobs.append((j113, j131))
            meta.append((cand, ui))
    # dpjobs is already unique under the batcher's dedup key (one job
    # pair per (org, range, unit); schemes differ within a pair)
    batcher.run(dpjobs, deduped=True)
    # one scheme selection per unique candidate, vectorized: the scalar
    # loop's semantics (wrap_around_DP.c:357-429 via ratio_less) reduce
    # to: take (1,3,1) iff its ratio is non-NaN and either (1,1,3)'s is
    # NaN or strictly smaller; else (1,1,3) if non-NaN; else neither.
    n_sel = len(sel_jobs)
    if n_sel:
        cnt = np.empty((2 * n_sel, 2), np.int64)
        for idx, job in enumerate(dpjobs):
            (n_m, n_x, n_i, n_d, _scanned), _, _ = job.result
            cnt[idx, 0] = n_m
            cnt[idx, 1] = n_m + n_x + n_i + n_d
        with np.errstate(invalid="ignore"):
            # denom == 0 implies m == 0 (counts are nonnegative), so the
            # only singular case is 0/0 -> NaN, exactly C float math
            r = cnt[:, 0].astype(np.float32) / cnt[:, 1].astype(np.float32)
        r113, r131 = r[0::2], r[1::2]
        nan113, nan131 = np.isnan(r113), np.isnan(r131)
        pick131 = ~nan131 & (nan113 | (r131 > r113))
        pick113 = ~pick131 & ~nan113
        rs = r.astype(np.float64)
        ms = cnt[:, 0].tolist()
        ds = cnt[:, 1].tolist()
    empty = RepeatRecord()
    for cand, ui in meta:
        if pick131[ui]:
            best_job, ji = sel_jobs[ui][1], 2 * ui + 1
        elif pick113[ui]:
            best_job, ji = sel_jobs[ui][0], 2 * ui
        else:
            _assign(cand, empty)
            continue
        # apply_counts touches exactly the fields set_rr would copy
        # from a counts-updated clone, so write cand directly
        apply_counts(cand, best_job)
        cand._rk = (ds[ji], ms[ji], float(rs[ji]))  # pre-fill ratio cache


def _polish_phase(batcher, states, polish_set, cfg) -> None:
    """Phase 5: polish_repeat then two revision rounds, batched.

    Each item of polish_set is (query, record); records are revised in
    place.  Mirrors revise_representative_unit (consensus.c:1048-1087):
    both rounds compare against the PRE-revision ratio."""
    if not polish_set:
        return
    items = []
    for q, rr in polish_set:
        org = states[q.read_idx].org
        input_len = states[q.read_idx].read.length
        polish_repeat(org, input_len, rr)
        items.append((q, rr, rr.match_ratio()))

    for scheme in ((5, 1, 1), (1, 1, 3)):
        # consensus DP on current units
        consjobs = []
        tmps = []
        for q, rr, base_ratio in items:
            org = states[q.read_idx].org
            tmp = rr.copy()
            tmp.match_gain, tmp.mismatch_penalty, tmp.indel_penalty = scheme
            consjobs.append(
                DPJob(org, tmp.rep_start, tmp.rep_end, _encode_unit(tmp.string),
                      scheme, mode="consensus")
            )
            tmps.append(tmp)
        batcher.run(consjobs)
        # host rebuild (batched argmax), then re-score the revised units
        rebuild_units_batch(tmps, [job.result for job in consjobs])
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
            apply_counts(tmp, sj)
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
    # phase 3+4a: scheme selection for every candidate
    _wrap_dp_schemes(batcher, [(q, states[q.read_idx].org) for q in queries])

    # phase 4b: direction selection + gates -> per-query result; build
    # polish set (queries without candidates were never materialized =
    # cleared records)
    polish_set = []
    for q in queries:
        if not q.candidates or q.found == 0:
            q.result = None
            continue
        st = states[q.read_idx]
        rr = RepeatRecord()
        rr.read_id = st.read.read_id
        rr.input_len = st.read.length
        rr.kmer = q.k
        select_dp_candidate(rr, q.candidates, cfg.min_match_ratio)
        if rr.rep_period * (q.qe - q.qs + 1) > cfg.wrap_dp_size:
            q.result = None
            continue
        q.result = rr
        coverage = rr.repeat_len // rr.rep_period
        if 5 <= coverage <= 20 and rr.rep_period > 5:
            polish_set.append((q, rr))

    # phase 5: polish + revision rounds
    with TIMERS.section("polish"):
        _polish_phase(batcher, states, polish_set, cfg)

    # phase 6a: k-sweep selection per range
    by_range: dict[tuple[int, int, int], list[RangeQuery]] = defaultdict(list)
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
    """Traceback step factor of a consensus launch (mtr_tpu/pipeline.py:
    706-711): 1 + ceil(mg/ip) bounds a path's steps per rep row,
    quantized to {2, TB_FACTOR}."""
    factor = 1 + max(-(-mg // ip) for mg, _, ip in schemes)
    return 2 if factor <= 2 else TB_FACTOR


def _cap_parts(move_bytes: list[int]) -> list[int]:
    """Cut a longest-first consensus group so that each launch's move
    scratch (each job's packed moves, rep_len x move_row_bytes) stays
    within MOVES_BYTES_CAP; returns the cut points."""
    return cap_parts(move_bytes, MOVES_BYTES_CAP)


class TorchDPBatcher:
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
        self._offsets: dict = {}  # id(org) -> offset into flat
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
        off: dict = {}
        p = 0
        for o in orgs:
            view[p : p + len(o)] = o
            off[id(o)] = p
            p += len(o)
        self._offsets = off
        self._flat = self._upload(buf[:total])

    def _upload(self, flat: torch.Tensor) -> torch.Tensor:
        """The batch's flat reads on the device."""
        return flat.to(self.device, non_blocking=True, copy=True)

    def run(self, jobs: list[DPJob], deduped: bool = False) -> None:
        uniq_jobs, remap = (jobs, None) if deduped else dedup_jobs(jobs)
        self._run(uniq_jobs)
        if remap is not None and len(uniq_jobs) != len(jobs):
            for job, ui in zip(jobs, remap):
                job.result = uniq_jobs[ui].result

    def _run(self, jobs: list[DPJob]) -> None:
        if not jobs:
            return
        # one launch a mode for every unit width (each kernel sizes a
        # job's columns a lane itself); consensus launches cut to
        # MOVES_BYTES_CAP of move scratch
        groups: dict = {"counts": [], "consensus": []}
        for idx, job in enumerate(jobs):
            groups[job.mode].append(idx)
        parts: dict = {"counts": [], "consensus": []}
        outs: dict = {"counts": [], "consensus": []}
        for mode, idxs in groups.items():
            if not idxs:
                continue
            u_span = u_span_for(max(len(jobs[i].unit) for i in idxs))
            # longest-first: the longest jobs start first
            idxs.sort(key=lambda i: jobs[i].qs - jobs[i].qe)
            cuts = ([len(idxs)] if mode == "counts" else _cap_parts(
                [(jobs[i].qe - jobs[i].qs + 1) * move_row_bytes(
                    len(jobs[i].unit)) for i in idxs]))
            lo = 0
            for hi in cuts:
                parts[mode].append(idxs[lo:hi])
                outs[mode].append(
                    self._dispatch(jobs, idxs[lo:hi], u_span, mode))
                lo = hi
        with TIMERS.section("dp_wait"):
            # one device->host copy per mode
            res = {mode: torch.cat(o).cpu().numpy()
                   for mode, o in outs.items() if o}
        for mode, mode_parts in parts.items():
            off = 0
            for part in mode_parts:
                chunk = res[mode][off : off + len(part)]
                if mode == "counts":
                    self._collect_counts(jobs, part, chunk)
                else:
                    for idx, fused in zip(part, chunk):
                        jobs[idx].result = (fused[:, :5], fused[:, 5:])
                off += len(part)

    def _dispatch(self, jobs, part, u_span, mode) -> torch.Tensor:
        n = len(part)
        qs = np.fromiter((jobs[i].qs for i in part), np.int64, n)
        qe = np.fromiter((jobs[i].qe for i in part), np.int64, n)
        base = np.fromiter(
            (self._offsets[id(jobs[i].org)] for i in part), np.int64, n)
        starts = base + qs + 1
        rep_len = qe - qs + 1
        scal = np.zeros((n, 8), np.int32)
        scal[:, 0] = rep_len
        scal[:, 2:5] = [jobs[i].scheme for i in part]
        units = np.full((n, u_span), -2, np.int8)
        by_unit: dict = defaultdict(list)
        for row, idx in enumerate(part):
            by_unit[jobs[idx].unit.tobytes()].append(row)
        for rows in by_unit.values():
            unit = jobs[part[rows[0]]].unit
            units[np.asarray(rows), : len(unit)] = unit
            scal[rows, 1] = len(unit)
        factor = (_factor(jobs[i].scheme for i in part)
                  if mode == "consensus" else 0)
        with TIMERS.section("dp_dispatch"):
            out = self._launch(mode, starts, scal, units, u_span, factor)
        TIMERS.count("dp_jobs", n)
        TIMERS.count("dp_chunks")
        cells = int((rep_len * scal[:, 1]).sum())
        if mode == "counts":
            self.cells += cells
        else:
            self.cons_cells += cells
        return out

    def _launch(self, mode, starts, scal, units, u_span,
                factor) -> torch.Tensor:
        """One launch of the mode's op on a part's host arrays."""
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

    def _collect_counts(self, jobs, part, fused) -> None:
        if not fused[:, 6].all():
            raise RuntimeError("counts kernel left a job unfinished")
        for idx, row in zip(part, fused.tolist()):
            m, x, ins, dele, scanned, i_final = row[:6]
            jobs[idx].result = ((m, x, ins, dele, scanned), i_final, row[9])


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


class TorchHybridDPBatcher:
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
        # deferred: the flat upload happens on the device thread, once a
        # device-bound job set materializes
        self._batch_orgs = orgs

    def run(self, jobs: list[DPJob], deduped: bool = False) -> None:
        uniq_jobs, remap = (jobs, None) if deduped else dedup_jobs(jobs)
        cells = [
            (j.qe - j.qs + 1) * len(j.unit) if j.mode == "counts"
            else -(j.qe - j.qs + 1) * len(j.unit)
            for j in uniq_jobs
        ]
        thr = self.cell_threshold
        counts_cells = [c for c in cells if c >= 0]
        if counts_cells and max(counts_cells) < thr:
            # small-job workloads would otherwise never touch the device
            thr = max(thr >> 4, 1 << 14)

        def to_device(c):
            if c >= 0:
                return c >= thr
            return -c >= self.cons_threshold

        big = [j for j, c in zip(uniq_jobs, cells) if to_device(c)]
        small = [j for j, c in zip(uniq_jobs, cells) if not to_device(c)]
        if big:
            # engagement gate: a device round costs a roughly fixed
            # launch + copy latency whatever it carries
            dev_cells = sum((j.qe - j.qs + 1) * len(j.unit) for j in big
                            if j.mode == "counts")
            if dev_cells < self.min_device_cells:
                small.extend(big)
                big = []
        self.host_cells += sum((j.qe - j.qs + 1) * len(j.unit)
                               for j in small if j.mode == "counts")
        if big:
            err: list = []

            def dev_run():
                try:
                    if self._batch_orgs is not None:
                        self.device.begin_batch(self._batch_orgs)
                        self._batch_orgs = None
                    self.device._run(big)
                except Exception as e:  # re-raised on the caller thread
                    err.append(e)

            t = threading.Thread(target=dev_run)
            t.start()
            self.host._run(small)
            t_host_done = time.time()
            t.join()
            self.dev_idle_s += time.time() - t_host_done
            if err:
                raise err[0]
        else:
            self.host._run(small)
        if remap is not None and len(uniq_jobs) != len(jobs):
            for job, ui in zip(jobs, remap):
                job.result = uniq_jobs[ui].result


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
    their candidate records (mtr_tpu/pipeline.py:1419-1462)."""
    n_q = len(ridx_a)
    frow, brow = res["fwd_row"], res["bwd_row"]
    units_rows, scores_rows = res["units"], res["scores"]
    unit_cache: dict = {}  # unit bytes -> (string, freq_2mer)
    hits = np.nonzero((frow[:n_q] >= 0) | (brow[:n_q] >= 0))[0]
    h_ridx = ridx_a[hits].tolist()
    h_qs = qs_a[hits].tolist()
    h_qe = qe_a[hits].tolist()
    h_w = w_a[hits].tolist()
    h_k = k_a[hits].tolist()
    h_f = frow[hits].tolist()
    h_b = brow[hits].tolist()
    h_fp = res["fwd_period"][hits].tolist()
    h_bp = res["bwd_period"][hits].tolist()
    h_found = res["found_last"][hits].tolist()
    cand_proto = RepeatRecord().__dict__
    queries: list[RangeQuery] = []
    for hi in range(len(hits)):
        st = states[h_ridx[hi]]
        q = RangeQuery(h_ridx[hi], h_qs[hi], h_qe[hi], h_w[hi], h_k[hi])
        q.found = h_found[hi]
        for row, period in ((h_f[hi], h_fp[hi]), (h_b[hi], h_bp[hi])):
            if row < 0:
                continue
            ukey = units_rows[row][:period].tobytes()
            ent = unit_cache.get(ukey)
            if ent is None:
                unit = units_rows[row][:period].tolist()
                ent = (decode_bases(unit), freq_2mer_array(unit))
                unit_cache[ukey] = ent
            cand = RepeatRecord.__new__(RepeatRecord)
            cand.__dict__.update(cand_proto)
            cand.read_id = st.read.read_id
            cand.input_len = st.read.length
            cand.kmer = q.k
            cand.rep_period = period
            cand.string = ent[0]
            cand.string_score = scores_rows[row][:period].copy()
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
    with MTR_TPU_MF_FILTER), else the oracle."""
    _t_period = time.time()  # walk share of "Computing periods"
    ridx_a, qs_a, qe_a, w_a, k_a = _collect_queries(states, cfg, pos_sel)
    n_q = len(ridx_a)
    device = torch.device("cuda") if device is None else device
    orgs = [st.org for st in states]
    lens = [st.read.length for st in states]

    _t_walk = time.time()
    res = None
    if cfg.backend == "device" and cfg.use_device_walks and n_q:
        res = dbg_walk_device_batch(orgs, lens, ridx_a, qs_a, qe_a, k_a,
                                    device)
    elif cfg.use_native and native.available() and n_q:
        if _use_mf_filter(cfg, n_q, device):
            res = _filtered_walks(orgs, lens, ridx_a, qs_a, qe_a, k_a, device)
        else:
            res = native_walks(orgs, lens, ridx_a, qs_a, qe_a, k_a)
    if res is not None:
        queries = _hit_queries(states, res, ridx_a, qs_a, qe_a, w_a, k_a)
    else:
        queries = []
        for i in range(n_q):
            st = states[int(ridx_a[i])]
            q = RangeQuery(int(ridx_a[i]), int(qs_a[i]), int(qe_a[i]),
                           int(w_a[i]), int(k_a[i]))
            template = RepeatRecord()
            template.read_id = st.read.read_id
            template.input_len = st.read.length
            template.kmer = q.k
            q.candidates, q.found = walk_candidates(
                st.org, st.read.length, q.qs, q.qe, template)
            if q.candidates:
                queries.append(q)

    TIMERS.add("walks", time.time() - _t_walk)
    if native.available():
        # the walk engine's measured init / count-table sections (zeros
        # unless -c enabled them)
        init_s, count_s, _walk_s = native.read_stage_timers()
        TIMERS.add("initialize", init_s)
        TIMERS.add("count_table", count_s)
    TIMERS.count("speculative_queries", n_q)
    TIMERS.add("period", time.time() - _t_period)
    return queries


def process_batch(states: list[ReadState], batcher, cfg: MTRConfig,
                  queries: list[RangeQuery] | None = None, pos_sel=None,
                  device=None):
    """Wave-pruned batch processing (mtr_tpu/pipeline.py:1560-1705, whose
    docstring describes the waves), with every wave's walks through this
    module's walk_batch on `device`."""
    batcher.begin_batch([st.org for st in states])

    _t0 = time.time()  # DP share of "Computing periods" (main.c:113)
    _t_walks = 0.0     # walk_batch reports its own time

    all_pos = [_live_positions(st) for st in states]
    for p in all_pos:
        TIMERS.count("ranges_total", len(p))
    computed = [np.zeros(len(st.di_end), bool) for st in states]
    if queries is None:
        pos_sel = wave1_positions(states, cfg)
        _tw = time.time()
        queries = walk_batch(states, cfg, pos_sel, device)
        _t_walks += time.time() - _tw
    elif pos_sel is None:
        pos_sel = all_pos  # callers that pre-walk every position

    range_result: dict[tuple[int, int, int], RepeatRecord | None] = {}
    cursor = [0] * len(states)
    accepted: list[list[RepeatRecord]] = [[] for _ in states]
    nq = [0] * len(states)
    wave = 0
    while True:
        wave += 1
        for ridx, ps in enumerate(pos_sel):
            if len(ps):
                computed[ridx][ps] = True
                TIMERS.count("computed_ranges", len(ps))
        _process_wave(states, batcher, cfg, queries, range_result)

        # exact replay: advance cursors, apply kills to the live arrays
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
        if alldone:
            break

        # next wave: optimistic simulation from each cursor
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
        TIMERS.count("waves_extra")
        _tw = time.time()
        queries = walk_batch(states, cfg, pos_sel, device)
        _t_walks += time.time() - _tw

    TIMERS.add("period", time.time() - _t0 - _t_walks)

    out = []
    for ridx in range(len(states)):
        TIMERS.count("queries", nq[ridx])
        with TIMERS.section("chaining"):
            out.append(chain_records(accepted[ridx]))
    return out


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
    pending_a = None  # (thread, states, holderA)
    pending_b = None  # (thread, states, holderB)

    def drain_b():
        nonlocal pending_b, done_reads
        if pending_b is None:
            return
        t, states, holder = pending_b
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
        for st, records in zip(states, holder["results"]):
            for rec in records:
                out.write(rec.format_record() + "\n")
                if record_sink is not None:
                    record_sink(rec)
                if cfg.print_alignment:
                    from mtr_tpu_torch.pretty import pretty_print_alignment

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
        t, states, ha = pending_a
        t.join()
        pending_a = None
        drain_b()
        hb: dict = {}

        def work_b():
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
        pending_b = (t2, states, hb)

    # adaptive wave pruning from the previous batch's walk time vs
    # host-idle-on-device wait (waves_policy); output is identical
    adapt = {"walk_s": None, "on": False}

    def flush():
        nonlocal batch, pending_a
        if not batch:
            return
        promote_a()
        pop_idle = getattr(batcher, "pop_dev_idle", None)
        if pop_idle is not None:
            adapt["on"] = waves_policy(adapt["walk_s"], pop_idle())
        states = batch
        batch = []
        ha: dict = {}

        def work_a():
            try:
                ha["pos_sel"] = wave1_positions(
                    states, cfg, force=adapt["on"])
                _t0 = time.time()
                ha["queries"] = walk_batch(states, cfg, ha["pos_sel"], device)
                adapt["walk_s"] = time.time() - _t0
            except Exception as e:  # re-raised by work_b
                ha["error"] = e

        t = threading.Thread(target=work_a)
        t.start()
        pending_a = (t, states, ha)

    min_rsl = 100
    own = 0
    batch_bases = 0
    try:
        for ridx, read in enumerate(iter_fasta(path, cfg.max_input_length)):
            # keep arena reuse semantics even when skipping
            arena.load_read(read.codes)
            if read_filter is not None and not read_filter(ridx):
                continue
            own += 1
            if own <= skip:
                continue
            L = read.length
            org_eff = arena.org_input[: L + 1].copy()
            rsl = min_rsl if L < min_rsl * 10 else L // 10
            with TIMERS.section("range"):
                # the reader thread's DI shares the card with stage B's DP
                di, di_end, di_w = fill_directional_index_with_end(
                    arena, L, rsl, manhattan=cfg.manhattan_distance,
                    di_compute_k=(di_compute_k
                                  if L >= cfg.device_di_threshold else None),
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
