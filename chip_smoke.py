#!/usr/bin/env python3
"""Smoke run of mtr_tpu_torch on one CUDA card (sm_90a: H100 / H200).

    python3 chip_smoke.py        # from the repository root

Phases, in order; any failure exits non-zero before the result line:
  1. preflight: a CUDA card, the native host engine (built with make at
     first use), the card's name and power limit, the kernels' build;
  2. the counts kernel against its plain PyTorch version on the card
     (rep_len <= 2048, every unit span, degenerate jobs) and against the
     native host engine at main-path sizes, with zero tolerance: the
     results are integers;
  2b. the consensus kernels (fill + traceback) against their plain
     versions on the card (units 2-500, three schemes, rep_len <= 2048,
     degenerate jobs: best and the (B, 500, 9) polish tensor) and against
     the native host engine at polish sizes, with zero tolerance;
  3. the hybrid path: the port's hybrid engine on the bench's 200 bp x
     200 copy set (20 reads of ~120 kb), byte-identical to mtr_tpu's host
     backend, with kernel launches and device-leg cells counted; then the
     in-repo 100x10 golden;
  2c. the DBG walk kernel against stage_b_plain on the card, with zero
     tolerance, on fuzzed jobs (periodic reads with units 2-120, k 2-15
     with ranges at the read's end, homopolymer / 2-mer tie storms, walks
     that overflow the 32-tie list, whale ranges of 2,048 to 38,371
     bases); then dbg_walk_device_batch against native.dbg_walk_batch2 on
     the first batch of the bench set (~570k queries), every query's
     result equal (it runs after phase 3, which writes the set);
  3b. the device path with the walks on the host: run_file with
     MTRConfig(backend="device", use_device_walks=False) on the same set,
     byte-identical to mtr_tpu's host backend, with counts and consensus
     launches and device-DI passes counted;
  3c. the device path whole: run_file with MTRConfig(backend="device")
     (mtr_tpu's default: DBG walks on the card) on the bench set and the
     100x10 golden, byte-identical, with the launches of all three
     kernels, stage-A passes, speculative jobs and host-route queries
     counted; then `python -m mtr_tpu_torch.cli --backend device` in a
     subprocess, same stdout;
  3d. the hybrid with MTR_TPU_MF_FILTER=1 (the walk pre-filter on the
     card), byte-identical, with the queries it filtered out;
  4. counts kernel times with CUDA events at the bench's GCUPS shapes,
     and the plain version's time at the first of them;
  4b. consensus kernel times (fill + traceback, and the fill alone) with
     CUDA events, the plain version's time, and one device-DI pass;
  4c. the walk kernel's time with CUDA events on the jobs of one bench
     chunk, and against stage_b_plain on a subset of them.

Each path of phase 3 sets the kernels' launch counts to 0 before it runs
and fails if a kernel of that path was not launched.

The next-to-last line is the kernels' JSON record, the last line
{"ok": true, "device": {...}}.  JAX is never imported: a meta-path hook
refuses it.
"""

from __future__ import annotations

import importlib.abc
import json
import os
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
SCHEMES = ((1, 1, 3), (1, 3, 1), (5, 1, 1))
UNIT_LENS = (2, 7, 100, 128, 129, 200, 256, 257, 480, 500)
# kernel columns the native engine reports: m, x, ins, del, scanned,
# i_final, max_i (mtr_tpu/pipeline.py:821)
NATIVE_COLS = [0, 1, 2, 3, 4, 5, 9]
REPLACES = ("mtr_tpu/ops/wrap_dp_fused2.py:68, "
            "mtr_tpu/ops/wrap_dp_fused2w.py:96, "
            "mtr_tpu/ops/wrap_dp_fused.py:63")
CONS_UNIT_LENS = (2, 7, 100, 128, 129, 200, 256, 257, 480, 499, 500)
CONS_REPLACES = ("mtr_tpu/ops/wrap_dp_pallas.py:52 (with "
                 "traceback_consensus_batch_n, mtr_tpu/ops/"
                 "wrap_dp_pallas.py:301)")
# (unit_len, rep_len) of the consensus checks against the native engine:
# the bench set's largest polish job, and two long ones
POLISH_SIZES = ((203, 4167), (100, 10000), (480, 10000))
BENCH_READS = 20  # the bench set's reads (bench.py:87-91)
WALK_REPLACES = "mtr_tpu/ops/dbg_device.py:132 (_stage_b)"
WALK_UNITS = (2, 3, 7, 15, 33, 60, 95, 120)
WHALE_WIDTHS = (2048, 5000, 12000, 38371)


class _NoJax(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name == "jax" or name.startswith(("jax.", "jaxlib")):
            raise ImportError(f"chip_smoke imports no JAX (asked: {name})")
        return None


class SmokeFailure(Exception):
    pass


def check(cond, what):
    if not cond:
        raise SmokeFailure(what)


def info(*parts):
    print(*parts, flush=True)


# ---------------------------------------------------------------- jobs


def periodic_rep(rng, unit, rep_len, err=0.12):
    """unit tiled to rep_len with substitutions, insertions, deletions."""
    import numpy as np

    out = []
    j = 0
    while len(out) < rep_len:
        x = rng.random()
        if x < err / 3:
            out.append(int(rng.integers(0, 4)))          # insertion
        elif x < 2 * err / 3:
            j += 1                                        # deletion
        elif x < err:
            out.append(int(rng.integers(0, 4)))          # substitution
            j += 1
        else:
            out.append(int(unit[j % len(unit)]))
            j += 1
    return np.asarray(out[:rep_len], np.int8)


def make_batch(jobs, u_span):
    """jobs: (rep int8, unit, scheme) -> resident inputs (numpy)."""
    import numpy as np

    b = len(jobs)
    flat = np.concatenate([rep for rep, _, _ in jobs] + [np.zeros(1, np.int8)])
    starts = np.zeros(b, np.int32)
    scal = np.zeros((b, 8), np.int32)
    units = np.full((b, u_span), -2, np.int8)
    p = 0
    for q, (rep, unit, scheme) in enumerate(jobs):
        starts[q] = p
        p += len(rep)
        scal[q, :5] = (len(rep), len(unit), *scheme)
        units[q, : len(unit)] = unit
    return flat, starts, scal, units


def run_kernel(batch, u_span):
    import torch

    from mtr_tpu_torch.ops.wrap_dp_counts import wrap_dp_counts

    t = [torch.from_numpy(a).cuda() for a in batch]
    out = wrap_dp_counts(*t, u_span)
    torch.cuda.synchronize()
    return out.cpu().numpy()


# -------------------------------------------------------------- phases


def preflight():
    import torch

    check(torch.cuda.is_available(), "torch.cuda.is_available() is false")
    from mtr_tpu import native

    t0 = time.perf_counter()
    check(native.available(), "native host engine (native/libmtr_host.so) "
          "did not build: the host leg would drop to the Python oracle")
    info(f"native host engine ready in {time.perf_counter() - t0:.1f} s")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    info(smi.stdout.strip().splitlines()[0])
    info(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
         f"cuda {torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    from mtr_tpu_torch.ops import _build

    t0 = time.perf_counter()
    _build.library()
    info(f"kernel build (nvcc, fresh checkout) and load: "
         f"{time.perf_counter() - t0:.2f} s")


def kernel_vs_references():
    """Returns the largest absolute difference seen (must be 0)."""
    import numpy as np
    import torch

    from mtr_tpu import native
    from mtr_tpu_torch.ops.wrap_dp_counts import wrap_dp_counts_plain
    from mtr_tpu_torch.ops.wrap_dp_resident import gather_segments
    from mtr_tpu_torch.pipeline import _u_span

    rng = np.random.default_rng(20240)
    worst = 0
    # (a) against the plain version on the card, rep_len <= 2048
    by_span: dict = {}
    for ul in UNIT_LENS:
        for scheme in SCHEMES:
            unit = rng.integers(0, 4, ul).astype(np.int8)
            rl = int(rng.integers(ul, 2049))
            by_span.setdefault(_u_span(ul), []).extend([
                (periodic_rep(rng, unit, rl), unit, scheme),
                # deletion-heavy, non-periodic
                (rng.integers(0, 4, int(rng.integers(1, 2049))).astype(
                    np.int8), unit, scheme),
            ])
    for scheme in SCHEMES:  # degenerate: rep_len 1 and 0, unit_len 2
        by_span[128] += [
            (np.array([1], np.int8), np.array([1, 2], np.int8), scheme),
            (np.array([3], np.int8), np.array([3, 3], np.int8), scheme),
            (np.zeros(0, np.int8), np.array([0, 0], np.int8), scheme),
        ]
    for u_span, jobs in sorted(by_span.items()):
        batch = make_batch(jobs, u_span)
        got = run_kernel(batch, u_span)
        flat, starts, scal, units = (torch.from_numpy(a).cuda()
                                     for a in batch)
        r_pad = max(1, int(batch[2][:, 0].max()))
        want = wrap_dp_counts_plain(
            scal, gather_segments(flat, starts, r_pad), units).cpu().numpy()
        diff = np.abs(got[:, :11].astype(np.int64) - want[:, :11])
        bad = int((diff.max(axis=1) > 0).sum())
        worst = max(worst, int(diff.max()))
        info(f"kernel vs plain on the card, u_span {u_span}: {len(jobs)} "
             f"jobs, rep_len <= {r_pad}, {bad} mismatching")
        check(bad == 0, f"kernel disagrees with the plain version "
              f"(u_span {u_span})")

    # (b) against the native host engine at main-path sizes
    sizes = ((100, 4096), (200, 32767), (200, 32768), (480, 20000),
             (100, 262000))
    jobs = []
    for ul, rl in sizes:
        unit = rng.integers(0, 4, ul).astype(np.int8)
        for scheme in SCHEMES:
            jobs.append((periodic_rep(rng, unit, rl), unit, scheme))
    by_span = {}
    for q, job in enumerate(jobs):
        by_span.setdefault(_u_span(len(job[1])), []).append(q)
    got = np.zeros((len(jobs), 15), np.int32)
    for u_span, idx in by_span.items():
        got[idx] = run_kernel(make_batch([jobs[q] for q in idx], u_span),
                              u_span)
    orgs = [np.concatenate([[0], rep]).astype(np.int32)
            for rep, _, _ in jobs]
    units = np.zeros((len(jobs), 500), np.int32)
    for q, (_, unit, _) in enumerate(jobs):
        units[q, : len(unit)] = unit
    t0 = time.perf_counter()
    counts = native.wrap_dp_batch(
        orgs, [0] * len(jobs), [len(rep) - 1 for rep, _, _ in jobs], units,
        [len(u) for _, u, _ in jobs], [s for _, _, s in jobs],
        [0] * len(jobs))[0][: len(jobs)].copy()
    diff = np.abs(got[:, NATIVE_COLS].astype(np.int64) - counts)
    bad = int((diff.max(axis=1) > 0).sum())
    worst = max(worst, int(diff.max()))
    info(f"kernel vs native host engine: {len(jobs)} jobs "
         f"(unit, rep_len) in {sizes} x 3 schemes, {bad} mismatching "
         f"(native {time.perf_counter() - t0:.1f} s)")
    check(bad == 0, "kernel disagrees with the native host engine")
    return worst


def consensus_vs_references():
    """Returns the largest absolute difference seen (must be 0)."""
    import numpy as np
    import torch

    from mtr_tpu import native
    from mtr_tpu_torch.ops.wrap_dp_consensus import wrap_dp_consensus
    from mtr_tpu_torch.ops.wrap_dp_resident import consensus_resident_plain
    from mtr_tpu_torch.pipeline import _factor, _u_span

    rng = np.random.default_rng(20241)
    worst = 0

    def run(jobs, u_span, plain=False):
        t = [torch.from_numpy(a).cuda() for a in make_batch(jobs, u_span)]
        factor = _factor(s for _, _, s in jobs)
        fn = consensus_resident_plain if plain else (
            lambda *a: wrap_dp_consensus(*a[:4], u_span, a[4]))
        fused, best = fn(*t, factor)
        torch.cuda.synchronize()
        return fused.cpu().numpy(), best.cpu().numpy()

    # (a) against the plain version on the card, rep_len <= 2048
    by_span: dict = {}
    for ul in CONS_UNIT_LENS:
        for scheme in SCHEMES:
            unit = rng.integers(0, 4, ul).astype(np.int8)
            rl = int(rng.integers(ul, 2049))
            by_span.setdefault(_u_span(ul), []).extend([
                (periodic_rep(rng, unit, rl), unit, scheme),
                (rng.integers(0, 4, int(rng.integers(1, 2049))).astype(
                    np.int8), unit, scheme),
            ])
    for scheme in SCHEMES:  # degenerate: rep_len 1 and 0, unit_len 2
        by_span[128] += [
            (np.array([1], np.int8), np.array([1, 2], np.int8), scheme),
            (np.array([3], np.int8), np.array([3, 3], np.int8), scheme),
            (np.zeros(0, np.int8), np.array([0, 0], np.int8), scheme),
        ]
    for u_span, jobs in sorted(by_span.items()):
        got, got_best = run(jobs, u_span)
        want, want_best = run(jobs, u_span, plain=True)
        diff = np.abs(got.astype(np.int64) - want).reshape(len(jobs), -1)
        diff_best = np.abs(got_best.astype(np.int64) - want_best)
        bad = int(((diff.max(axis=1) > 0) | (diff_best.max(axis=1) > 0))
                  .sum())
        worst = max(worst, int(diff.max()), int(diff_best.max()))
        info(f"consensus kernel vs plain on the card, u_span {u_span}: "
             f"{len(jobs)} jobs, rep_len <= "
             f"{max(len(r) for r, _, _ in jobs)}, {bad} mismatching")
        check(bad == 0, f"consensus kernel disagrees with the plain version "
              f"(u_span {u_span})")

    # (b) against the native host engine at polish sizes
    jobs = []
    for ul, rl in POLISH_SIZES:
        unit = rng.integers(0, 4, ul).astype(np.int8)
        for scheme in SCHEMES:
            jobs.append((periodic_rep(rng, unit, rl), unit, scheme))
    got = np.zeros((len(jobs), 500, 9), np.int32)
    for u_span in sorted({_u_span(len(u)) for _, u, _ in jobs}):
        idx = [q for q, (_, u, _) in enumerate(jobs)
               if _u_span(len(u)) == u_span]
        got[idx] = run([jobs[q] for q in idx], u_span)[0]
    orgs = [np.concatenate([[0], rep]).astype(np.int32)
            for rep, _, _ in jobs]
    units = np.zeros((len(jobs), 500), np.int32)
    for q, (_, unit, _) in enumerate(jobs):
        units[q, : len(unit)] = unit
    t0 = time.perf_counter()
    _, cons, miss = native.wrap_dp_batch(
        orgs, [0] * len(jobs), [len(rep) - 1 for rep, _, _ in jobs], units,
        [len(u) for _, u, _ in jobs], [s for _, _, s in jobs],
        [1] * len(jobs))
    want = np.concatenate([cons[: len(jobs)], miss[: len(jobs)]], axis=2)
    diff = np.abs(got.astype(np.int64) - want).reshape(len(jobs), -1)
    bad = int((diff.max(axis=1) > 0).sum())
    worst = max(worst, int(diff.max()))
    info(f"consensus kernel vs native host engine: {len(jobs)} jobs "
         f"(unit, rep_len) in {POLISH_SIZES} x 3 schemes, {bad} mismatching "
         f"(native {time.perf_counter() - t0:.1f} s)")
    check(bad == 0, "consensus kernel disagrees with the native host engine")
    return worst


def walk_chunks(orgs, lens, queries):
    """(v_pad, tables, jobs) per chunk of the queries (read, qs, qe, k),
    on the card: stage A's tables and the speculative jobs built from
    them, as dbg_walk_device_batch builds them."""
    import numpy as np
    import torch

    from mtr_tpu_torch.ops import dbg_device as dw

    q = np.asarray(queries, np.int64).reshape(-1, 4)
    ridx, qs, qe, k = q.T
    V = qe - qs + 1
    n_code = np.minimum(qe, np.asarray(lens, np.int64)[ridx] - k + 1) - qs
    lmax = np.minimum(dw.MAX_PERIOD, (qe - qs) // dw.MIN_NUM_FREQ_UNIT)
    flat, offs = dw.upload_reads(orgs, "cuda")

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.int32)).cuda()

    for v_pad, c in dw.bucket_chunks(np.arange(len(q)), V, dw.V_MAX):
        sv, adj, maxfreq, nodes, n_nodes = dw.stage_a(
            flat, torch.from_numpy(offs[ridx[c]] + qs[c]).cuda(),
            put(n_code[c]), put(V[c]), put(k[c]), v_pad)
        _, _, tq, node0, is_fwd, _ = dw.chunk_jobs(maxfreq, n_nodes, nodes)
        if len(tq):
            qi = c[tq]
            yield v_pad, (sv, adj), [put(a) for a in
                                     (tq, node0, is_fwd, k[qi], lmax[qi])]


def walk_fuzz_set(rng):
    """Reads and (read, qs, qe, k) queries of phase 2c."""
    import numpy as np

    orgs, queries = [], []

    def add(seq):
        orgs.append(np.concatenate([seq, [0]]).astype(np.int32))
        return len(orgs) - 1

    for ul in WALK_UNITS:  # periodic reads, k 2-15, ranges at the end
        unit = rng.integers(0, 4, ul).astype(np.int8)
        r = add(periodic_rep(rng, unit, 3000, err=0.1))
        for _ in range(6):
            qs = int(rng.integers(0, 1500))
            queries.append((r, qs, int(rng.integers(qs + 60, 2999)),
                            int(rng.integers(2, 16))))
        queries += [(r, 2999 - 500, 2999 - d, k) for d in (0, 2)
                    for k in (11, 13, 15)]
    for unit in ([0], [0, 1], [2, 2, 3]):  # tie storms
        seq = np.tile(unit, 700)[:700].astype(np.int8)
        seq[rng.integers(0, 700, 12)] = rng.integers(0, 4, 12)
        r = add(seq)
        queries += [(r, 5, 690, k) for k in (2, 3, 5, 7, 12)]
    # noisy unit-95 walks that dead-end in all-zero tie lists (overflow)
    unit = rng.integers(0, 4, 95).astype(np.int8)
    r = add(periodic_rep(rng, unit, 1600, err=0.15))
    queries += [(r, s, s + 823, k) for s in (100, 700) for k in range(8, 15)]
    unit = rng.integers(0, 4, 120).astype(np.int8)  # whale ranges
    r = add(periodic_rep(rng, unit, 40000, err=0.12))
    queries += [(r, 500, 500 + v - 1, k) for v in WHALE_WIDTHS
                for k in (5, 9, 13)]
    return orgs, [len(o) - 1 for o in orgs], queries


def canonical_walks(res, n):
    """Per-query view of a walk result dict (row numbers differ between
    engines): found_last, periods, each direction's unit / score row cut
    to its period."""
    import numpy as np

    out = {key: np.asarray(res[key][:n]) for key in
           ("found_last", "fwd_period", "bwd_period")}
    col = np.arange(500)[None, :]
    for d in ("fwd", "bwd"):
        row = np.asarray(res[f"{d}_row"][:n])
        has = row >= 0
        out[f"{d}_has"] = has
        keep = has[:, None] & (col < out[f"{d}_period"][:, None])
        for key in ("units", "scores"):
            full = np.zeros((n, 500), np.int64)
            full[has] = res[key][row[has]]
            out[f"{d}_{key}"] = np.where(keep, full, 0)
    return out


def bench_batch_queries(fasta):
    """The first batch of the bench set as run_file cuts it (host DI),
    and its wave-1 walk queries."""
    from mtr_tpu.config import MTRConfig
    from mtr_tpu.io.fasta import iter_fasta
    from mtr_tpu.oracle.arena import Arena
    from mtr_tpu.oracle.directional_index import (
        fill_directional_index_with_end,
    )
    from mtr_tpu.pipeline import ReadState, _collect_queries

    cfg = MTRConfig(backend="device")
    arena = Arena(cfg.max_input_length)
    states, bases = [], 0
    for ridx, read in enumerate(iter_fasta(fasta, cfg.max_input_length)):
        arena.load_read(read.codes)
        L = read.length
        di, di_end, di_w = fill_directional_index_with_end(
            arena, L, 100 if L < 1000 else L // 10, manhattan=True)
        states.append(ReadState(read, arena.org_input[: L + 1].copy(), di,
                                di_end, di_w, ridx))
        bases += L
        if len(states) >= cfg.reads_per_batch or bases >= cfg.bases_per_batch:
            break
    orgs = [st.org for st in states]
    lens = [st.read.length for st in states]
    return orgs, lens, _collect_queries(states, cfg)


def walk_vs_references(fasta):
    """Phase 2c.  Returns the largest absolute difference and the number
    of mismatching jobs (both must be 0), and the bench batch (orgs, lens,
    queries) for phase 4c."""
    import numpy as np
    import torch

    from mtr_tpu import native
    from mtr_tpu_torch.ops import dbg_device as dw

    rng = np.random.default_rng(20242)
    orgs, lens, queries = walk_fuzz_set(rng)
    worst = 0
    tot = {"jobs": 0, "found": 0, "ovf": 0, "bad": 0}
    t0 = time.perf_counter()
    for v_pad, (sv, adj), job in walk_chunks(orgs, lens, queries):
        got = dw.dbg_walk(sv, adj, *job)
        want = dw.stage_b_plain(sv, adj, *job)
        torch.cuda.synchronize()
        bad = torch.zeros(job[0].shape[0], dtype=torch.bool,
                          device=job[0].device)
        for g, w in zip(got, want):
            d = (g.long() - w.long()).abs().reshape(len(bad), -1)
            bad |= d.amax(1) > 0
            worst = max(worst, int(d.max()))
        tot["jobs"] += len(bad)
        tot["bad"] += int(bad.sum())
        tot["found"] += int(got[0].sum())
        tot["ovf"] += int(got[4].sum())
        info(f"walk kernel vs plain on the card, V bucket {v_pad}: "
             f"{len(bad)} jobs, {int(bad.sum())} mismatching")
    info(f"walk kernel vs plain: {tot['jobs']} jobs of {len(queries)} "
         f"queries, {tot['found']} found, {tot['ovf']} tie overflows, "
         f"{tot['bad']} mismatching ({time.perf_counter() - t0:.1f} s)")
    check(tot["bad"] == 0, "walk kernel disagrees with stage_b_plain")
    check(tot["ovf"] > 0, "the fuzz set set no tie overflow")
    check(tot["found"] > 0, "the fuzz set found no unit")

    b_orgs, b_lens, (ridx, qs, qe, _, k) = bench_batch_queries(fasta)
    n = len(ridx)
    t0 = time.perf_counter()
    got = dw.dbg_walk_device_batch(b_orgs, b_lens, ridx, qs, qe, k, "cuda")
    dt_dev = time.perf_counter() - t0
    t0 = time.perf_counter()
    want = native.dbg_walk_batch2(b_orgs, b_lens, ridx, qs, qe, k)
    dt_nat = time.perf_counter() - t0
    g, w = canonical_walks(got, n), canonical_walks(want, n)
    diff = [key for key in w if not np.array_equal(g[key], w[key])]
    info(f"dbg_walk_device_batch vs native on bench batch 1: {n} queries, "
         f"{int((got['fwd_row'] >= 0).sum() + (got['bwd_row'] >= 0).sum())} "
         f"unit rows, fields differing: {diff or 'none'} (device "
         f"{dt_dev:.3f} s incl. first use, native {dt_nat:.3f} s)")
    check(not diff, "dbg_walk_device_batch disagrees with the native engine")
    return worst, tot["bad"], (b_orgs, b_lens, (ridx, qs, qe, k))


def timer_snapshot():
    from mtr_tpu.utils.timers import TIMERS

    return dict(TIMERS.t)


def timer_delta(before):
    from mtr_tpu.utils.timers import TIMERS

    return {k: v - before.get(k, 0.0) for k, v in TIMERS.t.items()
            if v - before.get(k, 0.0) > 0}


def counter_delta(before):
    from mtr_tpu.utils.timers import TIMERS

    return {k: v - before.get(k, 0) for k, v in TIMERS.counters.items()}


def main_path(tmp):
    """The port's hybrid on the bench set vs mtr_tpu's host backend."""
    import io

    from mtr_tpu.config import MTRConfig
    from mtr_tpu.pipeline import run_file as host_run_file
    from mtr_tpu.testutil.rand_seq import write_fasta
    from mtr_tpu_torch.ops import wrap_dp_counts as op
    from mtr_tpu_torch.pipeline import make_batcher, run_file

    fasta = os.path.join(tmp, "bench_200x200.fasta")
    n_reads = BENCH_READS
    t0 = time.perf_counter()
    write_fasta(fasta, fasta[:-6] + ".units", 200, 200, 9.7, 2.9, 7.5,
                40000, 40000, n_reads, seed=20200)
    info(f"bench set: {n_reads} reads, {os.path.getsize(fasta)} bytes, "
         f"generated in {time.perf_counter() - t0:.1f} s")

    cfg = MTRConfig(backend="hybrid")
    batcher = make_batcher(cfg)
    op.LAUNCHES = 0
    t0 = time.perf_counter()
    port_out = io.StringIO()
    run_file(fasta, cfg, port_out, batcher=batcher)
    dt_port = time.perf_counter() - t0
    launches = op.LAUNCHES

    t0 = time.perf_counter()
    host_out = io.StringIO()
    host_run_file(fasta, MTRConfig(backend="host"), host_out)
    dt_host = time.perf_counter() - t0

    dev, host = batcher.device.cells, batcher.host_cells
    n_lines = port_out.getvalue().count("\n")
    info(f"bench set, port hybrid: {dt_port:.3f} s, "
         f"{n_reads / dt_port:.3f} reads/s, {n_lines} records, "
         f"{launches} kernel launches")
    info(f"bench set, mtr_tpu host: {dt_host:.3f} s, "
         f"{n_reads / dt_host:.3f} reads/s")
    info(f"bench set, counts DP cells: device {dev}, host {host}, "
         f"device share {dev / max(dev + host, 1):.4f}")
    check(port_out.getvalue() == host_out.getvalue(),
          "port hybrid output differs from mtr_tpu host output")
    check(n_lines > 0, "no records on the bench set")
    check(launches > 0, "the main path launched no kernel")
    check(dev > 0, "the device leg computed no DP cell")

    golden = os.path.join(HERE, "tests", "golden", "multi20_100x10")
    cfg = MTRConfig(backend="hybrid")
    batcher = make_batcher(cfg)
    t0 = time.perf_counter()
    out = io.StringIO()
    run_file(golden + ".fasta", cfg, out, batcher=batcher)
    dt = time.perf_counter() - t0
    with open(golden + ".out") as f:
        check(out.getvalue() == f.read(),
              "port hybrid output differs from the 100x10 golden")
    with open(golden + ".fasta") as f:
        n_golden = sum(line.startswith(">") for line in f)
    info(f"100x10 golden, port hybrid: identical, {dt:.3f} s, "
         f"{n_golden / dt:.1f} reads/s ({n_golden} reads), device cells "
         f"{batcher.device.cells}")
    return fasta, host_out.getvalue(), n_reads / dt_port, n_reads / dt_host


def device_path(fasta, host_out, hybrid_rate, host_rate):
    """Phase 3b: run_file under backend "device" with the walks on the host
    on the bench set vs mtr_tpu's host output."""
    import io

    from mtr_tpu.config import MTRConfig
    from mtr_tpu_torch.pipeline import make_batcher, run_file

    cfg = MTRConfig(backend="device", use_device_walks=False)
    batcher = make_batcher(cfg)
    before = timer_snapshot()
    reset_counts()
    t0 = time.perf_counter()
    out = io.StringIO()
    run_file(fasta, cfg, out, batcher=batcher)
    dt = time.perf_counter() - t0
    launches = read_counts()
    spent = timer_delta(before)
    info(f"bench set, port device: {dt:.3f} s, {BENCH_READS / dt:.3f} reads/s "
         f"(port hybrid {hybrid_rate:.3f}, mtr_tpu host {host_rate:.3f} "
         f"reads/s)")
    info(f"bench set, port device: {launches['counts']} counts launches, "
         f"{launches['consensus']} consensus launches, {launches['di']} "
         f"device-DI passes")
    info(f"bench set, port device: counts cells {batcher.cells}, "
         f"consensus cells {batcher.cons_cells}")
    info(f"bench set, port device: DI seconds {spent.get('di_device', 0.0):.3f}"
         f" (ranges stage {spent.get('range', 0.0):.3f})")
    info("bench set, port device, stage seconds (threads overlap): "
         + ", ".join(f"{k} {v:.3f}" for k, v in sorted(spent.items())))
    check(out.getvalue() == host_out,
          "port device output differs from mtr_tpu host output")
    for name in ("counts", "consensus", "di"):
        check(launches[name] > 0, f"the device path ran no {name} launch")
    check(launches["dbg_walk"] == 0, "use_device_walks=False walked on the "
          "device")


def reset_counts():
    from mtr_tpu_torch.ops import dbg_device as dw
    from mtr_tpu_torch.ops import directional_index as di
    from mtr_tpu_torch.ops import wrap_dp_consensus as cons_op
    from mtr_tpu_torch.ops import wrap_dp_counts as counts_op

    counts_op.LAUNCHES = cons_op.LAUNCHES = dw.LAUNCHES = 0
    dw.STAGE_A_CALLS = di.CALLS = 0


def read_counts():
    from mtr_tpu_torch.ops import dbg_device as dw
    from mtr_tpu_torch.ops import directional_index as di
    from mtr_tpu_torch.ops import wrap_dp_consensus as cons_op
    from mtr_tpu_torch.ops import wrap_dp_counts as counts_op

    return {"counts": counts_op.LAUNCHES, "consensus": cons_op.LAUNCHES,
            "dbg_walk": dw.LAUNCHES, "stage_a": dw.STAGE_A_CALLS,
            "di": di.CALLS}


def device_walk_path(fasta, host_out):
    """Phase 3c: run_file under backend "device" with the DBG walks on the
    card, on the bench set and the 100x10 golden, then the CLI; returns
    the launch counts of the bench run."""
    import io

    from mtr_tpu.config import MTRConfig
    from mtr_tpu.utils.timers import TIMERS
    from mtr_tpu_torch.pipeline import make_batcher, run_file

    cfg = MTRConfig(backend="device")
    batcher = make_batcher(cfg)
    before_t, before_c = timer_snapshot(), dict(TIMERS.counters)
    reset_counts()
    t0 = time.perf_counter()
    out = io.StringIO()
    run_file(fasta, cfg, out, batcher=batcher)
    dt = time.perf_counter() - t0
    launches = read_counts()
    spent, counted = timer_delta(before_t), counter_delta(before_c)
    n_q = counted.get("speculative_queries", 0)
    n_host = counted.get("walk_fallback_queries", 0)
    info(f"bench set, port device with device walks: {dt:.3f} s, "
         f"{BENCH_READS / dt:.3f} reads/s, "
         f"{out.getvalue().count(chr(10))} records")
    info(f"bench set, device walks: walk seconds {spent.get('walks', 0.0):.3f}"
         f" (stage A + job building {spent.get('count_table', 0.0):.3f}), "
         f"{launches['stage_a']} stage-A passes, {launches['dbg_walk']} "
         f"walk-kernel launches, {counted.get('walk_jobs', 0)} speculative "
         f"jobs, {n_q} walk queries")
    info(f"bench set, device walks: walk_fallback_queries {n_host} "
         f"(share {n_host / max(n_q, 1):.6f})")
    info(f"bench set, port device with device walks: {launches['counts']} "
         f"counts launches, {launches['consensus']} consensus launches, "
         f"{launches['di']} device-DI passes")
    info("bench set, device walks, stage seconds (threads overlap): "
         + ", ".join(f"{k} {v:.3f}" for k, v in sorted(spent.items())))
    check(out.getvalue() == host_out,
          "port device output (device walks) differs from mtr_tpu host")
    for name in ("counts", "consensus", "dbg_walk", "stage_a", "di"):
        check(launches[name] > 0, f"the device path ran no {name} launch")

    golden = os.path.join(HERE, "tests", "golden", "multi20_100x10")
    t0 = time.perf_counter()
    out = io.StringIO()
    run_file(golden + ".fasta", cfg, out, batcher=make_batcher(cfg))
    dt = time.perf_counter() - t0
    with open(golden + ".out") as f:
        check(out.getvalue() == f.read(),
              "port device output (device walks) differs from the 100x10 "
              "golden")
    info(f"100x10 golden, port device with device walks: identical, "
         f"{dt:.3f} s")

    t0 = time.perf_counter()
    r = subprocess.run(
        [sys.executable, "-m", "mtr_tpu_torch.cli", "--backend", "device",
         fasta], cwd=HERE, capture_output=True, text=True, timeout=600)
    dt = time.perf_counter() - t0
    info(f"CLI --backend device on the bench set: exit {r.returncode}, "
         f"{dt:.3f} s in a new process")
    check(r.returncode == 0, f"the CLI failed: {r.stderr[-2000:]}")
    check(r.stdout == host_out, "the CLI's stdout differs from mtr_tpu host")
    return launches


def prefilter_path(fasta, host_out):
    """Phase 3d: the port's hybrid with MTR_TPU_MF_FILTER=1."""
    import io

    from mtr_tpu.config import MTRConfig
    from mtr_tpu.utils.timers import TIMERS
    from mtr_tpu_torch.pipeline import make_batcher, run_file

    cfg = MTRConfig(backend="hybrid")
    before = dict(TIMERS.counters)
    os.environ["MTR_TPU_MF_FILTER"] = "1"
    try:
        t0 = time.perf_counter()
        out = io.StringIO()
        run_file(fasta, cfg, out, batcher=make_batcher(cfg))
        dt = time.perf_counter() - t0
    finally:
        del os.environ["MTR_TPU_MF_FILTER"]
    counted = counter_delta(before)
    n_q = counted.get("speculative_queries", 0)
    n_out = counted.get("mf_filtered_queries", 0)
    info(f"bench set, port hybrid with MTR_TPU_MF_FILTER=1: {dt:.3f} s, "
         f"{BENCH_READS / dt:.3f} reads/s; {n_out} of {n_q} walk queries "
         f"filtered out on the card ({n_out / max(n_q, 1):.4f})")
    check(out.getvalue() == host_out,
          "port hybrid with the walk pre-filter differs from mtr_tpu host")
    check(n_out > 0, "the pre-filter filtered no query")


def elapsed_ms(fn, n):
    """CUDA-event time of one call of fn, over n calls after a warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def time_kernel():
    """CUDA-event times at the bench's GCUPS shapes (bench.py:395-397)."""
    import numpy as np
    import torch

    from mtr_tpu_torch.ops.wrap_dp_counts import (
        wrap_dp_counts,
        wrap_dp_counts_plain,
    )
    from mtr_tpu_torch.ops.wrap_dp_resident import gather_segments

    rng = np.random.default_rng(395)

    def inputs(b, ul, rl, u_span):
        unit = rng.integers(0, 4, ul).astype(np.int8)
        rep = periodic_rep(rng, unit, rl + b)
        flat = np.lib.stride_tricks.sliding_window_view(rep, rl)[:b]
        jobs = [(flat[q], unit, (1, 1, 3)) for q in range(b)]
        return [torch.from_numpy(a).cuda() for a in make_batch(jobs, u_span)]

    res = {}
    for b, ul, rl, u_span, n in ((2048, 100, 4096, 128, 5),
                                 (1024, 200, 32768, 256, 2)):
        args = inputs(b, ul, rl, u_span)
        ms = elapsed_ms(lambda: wrap_dp_counts(*args, u_span), n)
        gcups = b * ul * rl / (ms * 1e-3) / 1e9
        info(f"kernel, unit {ul} x rep_len {rl} x {b} jobs (u_span "
             f"{u_span}): {ms:.3f} ms/launch, {gcups:.2f} GCUPS")
        res[ul] = (ms, args)
    ms, args = res[100]
    flat, starts, scal, units = args

    def plain():
        rep = gather_segments(flat, starts, 4096)
        return wrap_dp_counts_plain(scal, rep, units)

    plain_ms = elapsed_ms(plain, 1)
    info(f"plain version on the card, unit 100 x rep_len 4096 x 2048 jobs: "
         f"{plain_ms:.1f} ms/call, kernel {ms:.3f} ms "
         f"({plain_ms / ms:.0f}x)")
    return ms, plain_ms


def time_consensus():
    """CUDA-event times of the consensus kernels at unit 200 (the bench
    set's polish units) and of one device-DI pass."""
    import numpy as np
    import torch

    from mtr_tpu import native
    from mtr_tpu_torch.ops import wrap_dp_consensus as cop
    from mtr_tpu_torch.ops.directional_index import make_di_compute
    from mtr_tpu_torch.ops.wrap_dp_resident import consensus_resident_plain

    rng = np.random.default_rng(931)

    def inputs(b, rl):
        unit = rng.integers(0, 4, 200).astype(np.int8)
        rep = periodic_rep(rng, unit, rl + b)
        flat = np.lib.stride_tricks.sliding_window_view(rep, rl)[:b]
        jobs = [(flat[q], unit, (5, 1, 1)) for q in range(b)]
        return [torch.from_numpy(a).cuda() for a in make_batch(jobs, 256)]

    def full(args):
        return lambda: cop.wrap_dp_consensus(*args, 256, 6)

    b, rl = 512, 4096
    args = inputs(b, rl)
    ms = elapsed_ms(full(args), 3)
    fill_ms = elapsed_ms(lambda: cop.fill(*args, 256), 3)
    gcups = b * 200 * rl / (ms * 1e-3) / 1e9
    info(f"consensus kernel, unit 200 x rep_len {rl} x {b} jobs (u_span "
         f"256, scheme 5,1,1): {ms:.3f} ms/launch (fill {fill_ms:.3f} ms, "
         f"traceback share {1 - fill_ms / ms:.3f}), {gcups:.2f} GCUPS")

    rl = 1024
    args = inputs(b, rl)
    small_ms = elapsed_ms(full(args), 3)
    plain_ms = elapsed_ms(lambda: consensus_resident_plain(*args, 6), 1)
    info(f"consensus plain version on the card, unit 200 x rep_len {rl} x "
         f"{b} jobs: {plain_ms:.1f} ms/call, kernel {small_ms:.3f} ms "
         f"({plain_ms / small_ms:.0f}x)")

    # one Manhattan DI pass at the 131,072 position bucket, k = 5, w = 640
    from mtr_tpu.utils.encoding import rolling_kmer_codes

    L, rsl, w, k = 100000, 10000, 640, 5
    di_len = L + 2 * rsl
    buf = np.zeros(di_len + 16, np.int32)
    buf[: di_len - k + 1] = rolling_kmer_codes(
        rng.integers(0, 4, di_len).astype(np.int32), k)
    di_compute = make_di_compute("cuda", True)
    di_compute(buf, di_len, w, k, rsl)
    n = 5
    t0 = time.perf_counter()
    for _ in range(n):
        dev_di = di_compute(buf, di_len, w, k, rsl)
    di_ms = (time.perf_counter() - t0) / n * 1e3
    n_i = di_len - w - rsl - k + 1
    t0 = time.perf_counter()
    host_d = native.sliding_l1(buf, w, n_i + w)
    host_ms = (time.perf_counter() - t0) * 1e3
    want = (host_d[:n_i] - host_d[w : w + n_i]) / float(2 * w)
    check(np.array_equal(dev_di[w : w + n_i], want),
          "device DI disagrees with the native sliding L1")
    info(f"device DI pass (Manhattan, 131,072 bucket, k {k}, w {w}): "
         f"{di_ms:.3f} ms/call incl. copies (host clock); native host "
         f"sliding L1 {host_ms:.3f} ms")
    return small_ms, plain_ms


def time_walk(bench):
    """Phase 4c: CUDA-event times of the walk kernel on the speculative
    jobs of the bench batch's chunk with the most jobs, and the kernel
    against stage_b_plain on the card on the first 512 of them."""
    import numpy as np

    from mtr_tpu_torch.ops import dbg_device as dw

    orgs, lens, (ridx, qs, qe, k) = bench
    v_pad, (sv, adj), job = max(
        walk_chunks(orgs, lens, np.stack([ridx, qs, qe, k], 1)),
        key=lambda chunk: chunk[2][0].shape[0])
    ms = elapsed_ms(lambda: dw.dbg_walk(sv, adj, *job), 3)
    info(f"walk kernel, bench batch 1's largest job set (V bucket {v_pad}, "
         f"{job[0].shape[0]} jobs): {ms:.3f} ms/launch")
    sub = [a[:512] for a in job]
    sub_ms = elapsed_ms(lambda: dw.dbg_walk(sv, adj, *sub), 3)
    plain_ms = elapsed_ms(lambda: dw.stage_b_plain(sv, adj, *sub), 1)
    info(f"walk plain version on the card, first {sub[0].shape[0]} of those "
         f"jobs: {plain_ms:.1f} ms/call, kernel {sub_ms:.3f} ms "
         f"({plain_ms / sub_ms:.0f}x)")
    return sub_ms, plain_ms


def main() -> int:
    sys.meta_path.insert(0, _NoJax())
    sys.path.insert(0, HERE)
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "false)", file=sys.stderr)
        return 1
    t_all = time.perf_counter()
    try:
        preflight()
        worst = kernel_vs_references()
        cons_worst = consensus_vs_references()
        build_dir = os.path.join(HERE, "build")
        os.makedirs(build_dir, exist_ok=True)
        with tempfile.TemporaryDirectory(dir=build_dir) as tmp:
            fasta, host_out, hybrid_rate, host_rate = main_path(tmp)
            walk_worst, walk_bad, bench = walk_vs_references(fasta)
            device_path(fasta, host_out, hybrid_rate, host_rate)
            launches = device_walk_path(fasta, host_out)
            prefilter_path(fasta, host_out)
        ms, plain_ms = time_kernel()
        cons_ms, cons_plain_ms = time_consensus()
        walk_ms, walk_plain_ms = time_walk(bench)
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    info(f"chip_smoke: all phases passed in "
         f"{time.perf_counter() - t_all:.1f} s")
    print(json.dumps({"kernels": [{
        "name": "wrap_dp_counts",
        "route": "cuda",
        "source": "mtr_tpu_torch/csrc/wrap_dp_counts.cu",
        "replaces": REPLACES,
        "launches": launches["counts"],
        "max_abs_err": worst,
        "ms": ms,
        "plain_ms": plain_ms,
    }, {
        "name": "wrap_dp_consensus",
        "route": "cuda",
        "source": "mtr_tpu_torch/csrc/wrap_dp_consensus.cu",
        "replaces": CONS_REPLACES,
        "launches": launches["consensus"],
        "max_abs_err": cons_worst,
        "ms": cons_ms,
        "plain_ms": cons_plain_ms,
    }, {
        "name": "dbg_walk",
        "route": "cuda",
        "source": "mtr_tpu_torch/csrc/dbg_walk.cu",
        "replaces": WALK_REPLACES,
        "launches": launches["dbg_walk"],
        "max_abs_err": walk_worst,
        "mismatches": walk_bad,
        "ms": walk_ms,
        "plain_ms": walk_plain_ms,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
