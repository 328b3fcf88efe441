"""PyTorch counterpart of mtr_tpu/pipeline.py: the device DP batcher, the
hybrid engine and the per-file main loop.

Every host stage (DI pairing and candidate ranges, DBG walks, polish,
chaining, the native C++ DP engine) is reused from mtr_tpu as it stands;
none of them imports JAX.  What this module owns is the device leg: the
wrap-around DP jobs on a CUDA card (counts mode through
ops/wrap_dp_counts.py, consensus mode through ops/wrap_dp_consensus.py),
the hybrid split that feeds it, and, under backend "device", the DI
sliding windows of long reads (ops/directional_index.py).
"""

from __future__ import annotations

import dataclasses
import os
import threading
import time
from collections import defaultdict

import numpy as np
import torch

from mtr_tpu import native
from mtr_tpu.config import DEFAULT_CONFIG, MTRConfig
from mtr_tpu.io.fasta import iter_fasta
from mtr_tpu.oracle.arena import Arena
from mtr_tpu.oracle.directional_index import fill_directional_index_with_end
from mtr_tpu.pipeline import (
    MOVES_BYTES_CAP,
    TB_FACTOR,
    DPJob,
    HostDPBatcher,
    ReadState,
    dedup_jobs,
    process_batch,
    walk_batch,
    wave1_positions,
    waves_policy,
)
from mtr_tpu.utils.timers import TIMERS
from mtr_tpu_torch.ops.directional_index import make_di_compute
from mtr_tpu_torch.ops.wrap_dp_consensus import wrap_dp_consensus
from mtr_tpu_torch.ops.wrap_dp_counts import (
    R_MAX,
    U_SPANS,
    VALUE_LIMIT,
    wrap_dp_counts,
)


class BackendUnavailable(RuntimeError):
    """The requested backend cannot run here (no CUDA card, or a part not
    yet ported)."""


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
    or more runs on the batcher's device (CUDA unless the batcher is a
    TorchDPBatcher on another device), as mtr_tpu does; every other
    backend keeps DI on the host.  The device DBG walks are not ported:
    backend "device" needs cfg.use_device_walks False, which runs the
    walks on the native engine exactly as mtr_tpu's device backend
    does with that setting."""
    import gc
    import sys

    if cfg.backend == "device" and cfg.use_device_walks:
        raise BackendUnavailable(
            "--backend device runs the DBG walks on the device, which "
            "mtr_tpu_torch has not ported yet; run_file / find_repeats "
            "with MTRConfig(backend='device', use_device_walks=False) run "
            "every DP job and long-read DI on the card and the walks on "
            "the host (see ROADMAP.md)")
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
    di_compute = None
    if cfg.backend == "device":
        di_compute = make_di_compute(
            batcher.device if isinstance(batcher, TorchDPBatcher)
            else torch.device("cuda"), cfg.manhattan_distance)
    # mtr_tpu's walk_batch / process_batch get backend="host": there,
    # `backend` gates only the JAX device walks ("device" with
    # use_device_walks, refused above) and the JAX walk pre-filter
    # ("hybrid", whose probe imports jax for every batch of 32768+
    # queries).  Both are off under "host", so the output cannot change,
    # and no stage of the port reaches JAX.
    host_cfg = dataclasses.replace(cfg, backend="host")
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
                    states, batcher, host_cfg, queries=ha["queries"],
                    pos_sel=ha["pos_sel"])
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
                    states, host_cfg, force=adapt["on"])
                _t0 = time.time()
                ha["queries"] = walk_batch(states, host_cfg, ha["pos_sel"])
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
