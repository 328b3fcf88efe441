"""PyTorch counterpart of mtr_tpu/pipeline.py: the device DP batcher, the
hybrid engine, the walk stage, the wave loop and the per-file main loop.

Every host stage (DI pairing and candidate ranges, polish, chaining, the
native C++ DP and walk engines) is reused from mtr_tpu as it stands; none
of them imports JAX.  What this module owns is the device leg: the
wrap-around DP jobs on a CUDA card (counts mode through
ops/wrap_dp_counts.py, consensus mode through ops/wrap_dp_consensus.py),
the hybrid split that feeds it, and, under backend "device", the DI
sliding windows of long reads (ops/directional_index.py) and the DBG
walks (ops/dbg_device.py).  walk_batch and process_batch are this
module's own copies of mtr_tpu's, whose walk branches call the port, so
that every wave's walks run where the config says.
"""

from __future__ import annotations

import os
import threading
import time
from collections import defaultdict

import numpy as np
import torch

from mtr_tpu import native
from mtr_tpu.chaining import chain_records
from mtr_tpu.config import DEFAULT_CONFIG, MTRConfig
from mtr_tpu.io.fasta import iter_fasta
from mtr_tpu.oracle.arena import Arena
from mtr_tpu.oracle.dbg import freq_2mer_array, walk_candidates
from mtr_tpu.oracle.directional_index import fill_directional_index_with_end
from mtr_tpu.pipeline import (
    MAX_WAVES,
    MOVES_BYTES_CAP,
    TB_FACTOR,
    DPJob,
    HostDPBatcher,
    RangeQuery,
    ReadState,
    _accepts,
    _collect_queries,
    _env_flag,
    _live_positions,
    _process_wave,
    dedup_jobs,
    wave1_positions,
    waves_policy,
)
from mtr_tpu.records import RepeatRecord
from mtr_tpu.utils.encoding import decode_bases
from mtr_tpu.utils.timers import TIMERS
from mtr_tpu_torch.ops.dbg_device import dbg_walk_device_batch, native_walks
from mtr_tpu_torch.ops.directional_index import make_di_compute
from mtr_tpu_torch.ops.mf_filter import walked_mask
from mtr_tpu_torch.ops.wrap_dp_consensus import wrap_dp_consensus
from mtr_tpu_torch.ops.wrap_dp_counts import (
    R_MAX,
    U_SPANS,
    VALUE_LIMIT,
    wrap_dp_counts,
)


class BackendUnavailable(RuntimeError):
    """The requested backend cannot run here (no CUDA card)."""


# the hybrid's walk pre-filter engages from this many queries per batch
# (mtr_tpu/pipeline.py:1379)
MF_FILTER_MIN_QUERIES = 32768


def _u_span(unit_len: int) -> int:
    for u in U_SPANS:
        if unit_len <= u:
            return u
    raise ValueError(f"unit_len {unit_len} exceeds the largest span "
                     f"{U_SPANS[-1]}")


def _factor(schemes) -> int:
    """Traceback step factor of a consensus launch (mtr_tpu/pipeline.py:
    706-711): 1 + ceil(mg/ip) bounds a path's steps per rep row,
    quantized to {2, TB_FACTOR}."""
    factor = 1 + max(-(-mg // ip) for mg, _, ip in schemes)
    return 2 if factor <= 2 else TB_FACTOR


def _cap_parts(rep_lens: list[int], u_span: int) -> list[int]:
    """Cut a longest-first consensus group so that each launch's move
    scratch (rep_len x u_span bytes per job) stays within
    MOVES_BYTES_CAP; returns the cut points."""
    cuts, acc = [], 0
    for q, rl in enumerate(rep_lens):
        if acc and acc + rl * u_span > MOVES_BYTES_CAP:
            cuts.append(q)
            acc = 0
        acc += rl * u_span
    return cuts + [len(rep_lens)]


class TorchDPBatcher:
    """DP jobs on one torch device (counterpart of
    mtr_tpu.pipeline.WrapDPBatcher).  The batch's reads are uploaded once
    (begin_batch); each run groups its jobs by mode and unit span, longest
    first, launches the counts kernel once per span and the consensus
    kernels once per span (cut to MOVES_BYTES_CAP of move scratch), and
    copies each mode's results back to the host in one transfer.  On a CPU
    device the ops run their plain versions (tests)."""

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
        self._flat = buf[:total].to(self.device, non_blocking=True,
                                    copy=True)

    def run(self, jobs: list[DPJob], deduped: bool = False) -> None:
        uniq_jobs, remap = (jobs, None) if deduped else dedup_jobs(jobs)
        self._run(uniq_jobs)
        if remap is not None and len(uniq_jobs) != len(jobs):
            for job, ui in zip(jobs, remap):
                job.result = uniq_jobs[ui].result

    def _run(self, jobs: list[DPJob]) -> None:
        if not jobs:
            return
        groups: dict = {"counts": defaultdict(list),
                        "consensus": defaultdict(list)}
        for idx, job in enumerate(jobs):
            groups[job.mode][_u_span(len(job.unit))].append(idx)
        parts: dict = {"counts": [], "consensus": []}
        outs: dict = {"counts": [], "consensus": []}
        for mode, by_span in groups.items():
            for u_span, idxs in sorted(by_span.items()):
                # longest-first: the longest blocks start first
                idxs.sort(key=lambda i: jobs[i].qs - jobs[i].qe)
                cuts = ([len(idxs)] if mode == "counts" else _cap_parts(
                    [jobs[i].qe - jobs[i].qs + 1 for i in idxs], u_span))
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
        self._check_bounds(scal, starts, u_span)
        with TIMERS.section("dp_dispatch"):
            dev = self.device
            args = (
                self._flat,
                torch.from_numpy(starts.astype(np.int32)).to(dev),
                torch.from_numpy(scal).to(dev),
                torch.from_numpy(units).to(dev),
                u_span,
            )
            if mode == "counts":
                out = wrap_dp_counts(*args)
            else:
                out = wrap_dp_consensus(
                    *args, _factor(jobs[i].scheme for i in part))[0]
        TIMERS.count("dp_jobs", n)
        TIMERS.count("dp_chunks")
        cells = int((rep_len * scal[:, 1]).sum())
        if mode == "counts":
            self.cells += cells
        else:
            self.cons_cells += cells
        return out

    def _check_bounds(self, scal, starts, u_span) -> None:
        """The kernels' own bounds (one block per job, unpacked int32)."""
        rep_len = scal[:, 0].astype(np.int64)
        mg, ip = scal[:, 2].astype(np.int64), scal[:, 4].astype(np.int64)
        if (rep_len > R_MAX).any():
            raise ValueError(f"rep_len above {R_MAX}")
        if (scal[:, 1] > u_span).any():
            raise ValueError(f"unit_len above the span {u_span}")
        if (ip < 1).any():
            raise ValueError("indel penalty must be >= 1")
        if (rep_len * mg + ip * u_span >= VALUE_LIMIT).any():
            raise ValueError("rep_len*mg + ip*u_span overflows int32")
        if (starts < 0).any() or (starts + rep_len > len(self._flat)).any():
            raise ValueError("rep segment outside the resident reads")

    def _collect_counts(self, jobs, part, fused) -> None:
        if not fused[:, 6].all():
            raise RuntimeError("counts kernel left a job unfinished")
        for idx, row in zip(part, fused.tolist()):
            m, x, ins, dele, scanned, i_final = row[:6]
            jobs[idx].result = ((m, x, ins, dele, scanned), i_final, row[9])


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
    """Pick the DP engine: `host` is the native engine, `hybrid` the
    torch hybrid on the CUDA card, `device` every DP job on the card,
    `auto` the hybrid where a card is present and the host engine
    elsewhere."""
    if cfg.backend == "host":
        return HostDPBatcher()
    if cfg.backend == "hybrid":
        _need_cuda("hybrid")
        return TorchHybridDPBatcher(torch.device("cuda"))
    if cfg.backend == "device":
        _need_cuda("device")
        return TorchDPBatcher(torch.device("cuda"))
    if cfg.backend == "auto":
        if torch.cuda.is_available():
            return TorchHybridDPBatcher(torch.device("cuda"))
        return HostDPBatcher()
    raise ValueError(f"unknown backend {cfg.backend!r}")


def batcher_device(batcher) -> torch.device:
    """The torch device a port batcher runs on; CUDA for any other batcher
    (device DI and device walks need a card)."""
    if isinstance(batcher, TorchHybridDPBatcher):
        batcher = batcher.device
    if isinstance(batcher, TorchDPBatcher):
        return batcher.device
    return torch.device("cuda")


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
    aside."""
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
    device = batcher_device(batcher)
    di_compute = None
    if cfg.backend == "device":
        di_compute = make_di_compute(device, cfg.manhattan_distance)
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
                    from mtr_tpu.pretty import pretty_print_alignment

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
                    di_compute=(di_compute
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
