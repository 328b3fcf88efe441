#!/usr/bin/env python3
"""Smoke run of mtr_tpu_torch on one CUDA card (sm_90a: H100 / H200).

    python3 chip_smoke.py        # from the repository root

Phases, in order; any failure exits non-zero before the result line:
  1. preflight: a CUDA card, the port's native host engine (built for
     this machine's CPU at first use), the card's name and power limit,
     the kernels' build, and one wrap_dp_counts launch held to the plain
     version (the compiler and the card are alive before anything is
     timed);
  2. the counts kernel against its plain PyTorch version on the card
     (rep_len <= 2048; units at 32C and 32C + 1 for every C = 1..16 and
     at the old span edges; degenerate jobs; one launch per C, then all
     in one mixed launch) and against the native host engine at main-path
     sizes and past rep_len 32,768, with zero tolerance: the results are
     integers;
  2b. the consensus kernel (fill + traceback in one launch) against its
     plain versions on the card (units 2-500, three schemes, rep_len <=
     2048, degenerate jobs; a launch per C, then all in one launch: best,
     the (B, 500, 9) polish tensor and the packed move scratch against
     pack_moves of the plain fill's moves) and against the native host
     engine at polish sizes, with zero tolerance;
  3. the hybrid path: the port's hybrid engine on the bench's 200 bp x
     200 copy set (20 reads of ~120 kb) and the port's host backend on
     this machine's CPU, each byte-identical to
     tests/golden/bench_200x200.out (mtr_tpu's host backend on that set),
     with kernel launches and device-leg cells counted; then the in-repo
     100x10 golden;
  2d. the directional-index kernels (csrc/directional_index.cu: the
     Manhattan sliding L1 and the Pearson moments, one launch a group of
     passes) against their plain versions on the card, with zero
     tolerance: group launches of every w of each k of the DI sweep, n_out
     below, at and past a tile, w above a tile, the group's fill term at a
     multiple of 32, alphabets 4, 64 and 1,024 with runs of equal codes,
     stale tails that some passes of a group reach (Pearson skips codes >=
     4^k), windows past 32,767 (int32 Manhattan bins), lengths just past
     the old position buckets 16,384 / 131,072 / 1,114,112, and the 40
     passes of one 800 kbp read (bench_800k), a launch a k as the device
     backend runs them; it runs after phase 3,
     which makes the temporary directory;
  2c. the DBG row walk kernel against its plain twin (walk_rows_plain,
     on the CPU) with zero tolerance, on the stage-A chunks of fuzzed
     queries (periodic reads with units 2-120, k 2-15 with ranges at the
     read's end, homopolymer / 2-mer tie storms, walks that overflow the
     32-tie list, whale ranges of 2,048 to 38,371 bases) and on
     testutil/walk_cases.edge_chunk's rows (overflows before, at and after
     the winner, winners in later rank groups, period-500 walks); then
     dbg_walk_device_batch against native.dbg_walk_batch2 on the first
     batch of the bench set (~570k queries), every query's result equal,
     with at most two waits (walk_waits) and two synchronizing calls
     (torch.cuda.set_sync_debug_mode("warn")) in the call (it runs after
     phase 3, which writes the set);
  3b. the device path with the walks on the host: run_file with
     MTRConfig(backend="device", use_device_walks=False) on the same set,
     byte-identical to the golden, with counts and consensus launches and
     device-DI passes counted;
  3c. the device path whole: run_file with MTRConfig(backend="device")
     (mtr_tpu's default: DBG walks on the card) on the bench set and the
     100x10 golden, byte-identical, with the launches of all three
     kernels, stage-A passes, the walk route's calls and waits and
     host-route queries counted, the 400 Manhattan DI passes in 60 launches of the DI kernel
     (one a read and k) and no plain DI call on the card, and the walk
     thread's seconds split into
     stage A launches, walk kernel launches, the pull, host route and
     the rest; then `python -m mtr_tpu_torch.cli --backend device` in a
     subprocess, same stdout;
  3e. the device path whole with -p's Pearson DI
     (MTRConfig(backend="device", manhattan_distance=False)) on the bench
     set, byte-identical to tests/golden/bench_200x200_pcc.out, the 400
     Pearson passes in 60 launches of the DI kernel;
  3f. the device DI of the bench set's reads alone on one thread, as
     run_file calls it (a make_di_compute_k plug-in a kind, a call a read
     and k), Manhattan and Pearson: seconds in all, split into the
     groups' round trips (pinned upload, launch, copy back, int64
     widening), the host float64 finish and the rest, beside the DI
     seconds that 3c and 3e spent on the reader thread;
  3d. the hybrid with MTR_TPU_MF_FILTER=1 (the walk pre-filter on the
     card), byte-identical, with the queries it filtered out;
  4. counts kernel times with CUDA events at the bench's GCUPS shapes
     and at unit 400, with GCUPS, bound and share of bound; the plain
     version's time at the first shape;
  4b. every consensus launch of phase 3c's bench run (its inputs recorded
     by Spies) replayed with CUDA events: ms a launch, the run's sum, the
     three heaviest launches, bound and share; the kernel against the
     plain version on the heaviest launch (zero tolerance) and the plain
     version's time there;
  4c. every row-kernel launch of that run (a chunk's stage-A outputs)
     replayed the same way, with rows, gated rows, V bucket and
     winning-row entries a launch; then, heaviest first within
     WALK_PLAIN_BUDGET_S, the kernel against walk_rows_plain on the
     launch (zero tolerance) and the lookups and steps it counts there,
     for the bound;
  4e. every DI launch of phases 3c (Manhattan) and 3e (Pearson), recorded
     by Spies, replayed: the kernel against its plain version (zero
     tolerance), and timed with CUDA events, summed over the run; at the
     heaviest launch of each, the kernel, the group with its copies, the
     plain version, the host passes and the bound;
  5a. the CLI's other modes, each `python -m mtr_tpu_torch.cli` in a new
     process against a golden that mtr_tpu's host backend wrote
     (scripts/write_port_goldens.py): -p under --backend hybrid and under
     --backend device (the -c summary must count Pearson DI passes on the
     card), -a under device, --cluster under hybrid (the near matrix on
     the card), --checkpoint resumed at 10 of 20 reads, and --no-strict
     with a fresh checkpoint on the clean set (the file must end at 20);
  5b. the hybrid on the equality sets: the structured-error set, the
     100-read 100x10 set and one read of 800 kbp;
  5c. the mesh on two slots that are both this one card (it shows that the
     split is exact, not that it scales): entry()'s step,
     sharded_wrap_dp_step against one launch, the bench set under backend
     device with host walks and ShardedTorchDPBatcher (the counts and
     consensus launches of the one-device path doubled, the Manhattan DI
     cut by position, one DI kernel launch a slot and pass), make_mesh
     refusing one card more than there are;
  5d. two processes on the one card: two run_file_sharded workers (gloo,
     hybrid), merged output and gathered record columns against the
     one-process run, both walls printed;
  5e. accuracy: the pinned exact-match and ratio counts of
     tests/test_accuracy.py through the hybrid.

The replayed launches' rows are written to build/chip_smoke/*_launches.json
(consensus, walk, di_l1, di_pcc).
Each path of phase 3 sets the kernels' launch counts to 0 before it runs
and fails if a kernel of that path was not launched.  A path whose output
differs from its golden prints the first differing line.

The next-to-last line is the kernels' JSON record, the last line
{"ok": true, "device": {...}}.  Neither JAX nor mtr_tpu is ever
imported: a meta-path hook refuses both.
"""

from __future__ import annotations

import importlib.abc
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

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
BENCH_ARGS = (200, 200, 9.7, 2.9, 7.5, 40000, 40000, BENCH_READS)
# the mesh phases' slots: both are the one card
MESH_SLOTS = ("cuda:0", "cuda:0")
# tests/test_accuracy.py:32-40: unit 100 x 10 copies, 50 reads, seed 777 ->
# exact matches, ratios >= 0.99, ratios >= 0.98
ACCURACY_PINS = (35, 48, 49)
WALK_REPLACES = "mtr_tpu/ops/dbg_device.py:132 (_stage_b)"
WALK_UNITS = (2, 3, 7, 15, 33, 60, 95, 120)
# seconds of walk_rows_plain on the replayed walk launches (heaviest first)
# for the bound's lookups and steps and the check against the kernel; the
# bench run's 60 launches took ~200 s in all on an H100, so this budget
# checks the heaviest of them
WALK_PLAIN_BUDGET_S = 60.0
WHALE_WIDTHS = (2048, 5000, 12000, 38371)
DI_SOURCE = "mtr_tpu_torch/csrc/directional_index.cu"
DI_REPLACES = {
    "l1": "mtr_tpu/ops/directional_index.py:30 (_sliding_l1_device)",
    "pcc": "mtr_tpu/ops/directional_index.py:106 (_pearson_moments_device)"}
# the (k, largest w) of fill_directional_index_with_end's sweep (w = 5, 10,
# 20, ... while w < L / 2)
DI_SWEEP = ((1, 20), (3, 80), (5, 10240))
# a bench read (~120 kb) runs every w of the sweep: 20 passes, one launch
# a k on one device
BENCH_DI_GROUPS = BENCH_READS * len(DI_SWEEP)
BENCH_DI_PASSES = BENCH_READS * 20
# int32 operations a position the sliding update needs, for the bound:
# Manhattan four bin updates of four operations (read, add, and |.| before
# and after into D), Pearson six count updates of six (the count, the
# square's change, one or two inner products)
DI_OPS = {"l1": 16, "pcc": 36}


class _NoJax(importlib.abc.MetaPathFinder):
    """Refuses jax and the JAX package mtr_tpu: the port stands alone."""

    def find_spec(self, name, path=None, target=None):
        if name in ("jax", "mtr_tpu") or name.startswith(
                ("jax.", "jaxlib", "mtr_tpu.")):
            raise ImportError(f"chip_smoke imports neither JAX nor mtr_tpu "
                              f"(asked: {name})")
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


def card_line():
    """nvidia-smi's name and power limit of the card."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return smi.stdout.strip().splitlines()[0]


def preflight():
    import torch

    check(torch.cuda.is_available(), "torch.cuda.is_available() is false")
    from mtr_tpu_torch import native

    t0 = time.perf_counter()
    native.available()  # builds the engine for this CPU, or raises
    info(f"native host engine ready in {time.perf_counter() - t0:.1f} s "
         f"({os.path.relpath(native.library_path(), HERE)})")
    info(card_line())
    info(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
         f"cuda {torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    from mtr_tpu_torch.ops import _build

    t0 = time.perf_counter()
    _build.library()
    info(f"kernel build (nvcc, fresh checkout) and load: "
         f"{time.perf_counter() - t0:.2f} s")
    # one launch against the plain version: the liveness probe
    from mtr_tpu_torch.ops import wrap_dp_counts as counts_op
    from mtr_tpu_torch.ops.wrap_dp_resident import gather_segments

    from mtr_tpu_torch.utils.timers import TIMERS

    before = TIMERS.counters["launch.wrap_dp_counts"]

    rng = np.random.default_rng(229)
    unit = rng.integers(0, 4, 100).astype(np.int8)
    jobs = [(periodic_rep(rng, unit, rl), unit, (1, 1, 3))
            for rl in (512, 300, 64)]
    batch = make_batch(jobs, 128)
    got = run_kernel(batch, 128)
    flat, starts, scal, units = (torch.from_numpy(a).cuda() for a in batch)
    want = counts_op.wrap_dp_counts_plain(
        scal, gather_segments(flat, starts, 512), units).cpu().numpy()
    check(TIMERS.counters["launch.wrap_dp_counts"] == before + 1,
          "preflight launched no kernel")
    check(np.array_equal(got[:, :11], want[:, :11]),
          "preflight: the counts kernel disagrees with the plain version")
    info(f"preflight launch: wrap_dp_counts on {len(jobs)} jobs (unit 100, "
         f"rep_len <= 512) equals the plain version")


def kernel_vs_references():
    """Phase 2.  Returns the largest absolute difference seen (must be
    0)."""
    import numpy as np
    import torch

    from mtr_tpu_torch import native
    from mtr_tpu_torch.ops.wrap_dp_counts import (
        U_SPANS,
        u_span_for,
        wrap_dp_counts_plain,
    )
    from mtr_tpu_torch.ops.wrap_dp_resident import gather_segments

    rng = np.random.default_rng(20240)
    worst = 0
    # (a) against the plain version on the card, rep_len <= 2048: units at
    # 32C and 32C + 1 for every C the kernel is instantiated for, and the
    # old span edges
    unit_lens = sorted({u for span in U_SPANS for u in (span, span + 1)
                        if u <= 500} | set(UNIT_LENS))
    by_span: dict = {}
    for ul in unit_lens:
        for scheme in SCHEMES:
            unit = rng.integers(0, 4, ul).astype(np.int8)
            rl = int(rng.integers(ul, 2049))
            by_span.setdefault(u_span_for(ul), []).extend([
                (periodic_rep(rng, unit, rl), unit, scheme),
                # deletion-heavy, non-periodic
                (rng.integers(0, 4, int(rng.integers(1, 2049))).astype(
                    np.int8), unit, scheme),
            ])
    for scheme in SCHEMES:  # degenerate: rep_len 1 and 0, unit_len 1 and 2
        by_span[32] += [
            (np.array([1], np.int8), np.array([1, 2], np.int8), scheme),
            (np.array([3], np.int8), np.array([3, 3], np.int8), scheme),
            (np.zeros(0, np.int8), np.array([0, 0], np.int8), scheme),
            (np.array([2, 2, 1], np.int8), np.array([2], np.int8), scheme),
        ]
    n_jobs = bad_total = 0
    for u_span, jobs in sorted(by_span.items()):
        batch = make_batch(jobs, u_span)
        got = run_kernel(batch, u_span)
        flat, starts, scal, units = (torch.from_numpy(a).cuda()
                                     for a in batch)
        r_pad = max(1, int(batch[2][:, 0].max()))
        want = wrap_dp_counts_plain(
            scal, gather_segments(flat, starts, r_pad),
            torch.nn.functional.pad(units, (0, 512 - u_span), value=-2),
        ).cpu().numpy()
        diff = np.abs(got[:, :11].astype(np.int64) - want[:, :11])
        bad = int((diff.max(axis=1) > 0).sum())
        worst = max(worst, int(diff.max()))
        n_jobs += len(jobs)
        bad_total += bad
        check(bad == 0, f"kernel disagrees with the plain version "
              f"(C {u_span // 32}, {bad} of {len(jobs)} jobs)")
    # every job of (a) again in one launch, as the batcher launches them:
    # rows 512 wide, each job at its own C
    jobs = sorted((j for js in by_span.values() for j in js),
                  key=lambda j: -len(j[0]))
    batch = make_batch(jobs, 512)
    got = run_kernel(batch, 512)
    flat, starts, scal, units = (torch.from_numpy(a).cuda() for a in batch)
    want = wrap_dp_counts_plain(
        scal, gather_segments(flat, starts, max(1, int(batch[2][:, 0].max()))),
        units).cpu().numpy()
    diff = np.abs(got[:, :11].astype(np.int64) - want[:, :11])
    bad = int((diff.max(axis=1) > 0).sum())
    worst = max(worst, int(diff.max()))
    check(bad == 0, f"kernel disagrees with the plain version in one mixed "
          f"launch ({bad} of {len(jobs)} jobs)")
    info(f"kernel vs plain on the card: {n_jobs} jobs over C 1-16 (units "
         f"{unit_lens[0]}-{unit_lens[-1]}), rep_len <= 2048, one launch "
         f"per C and all in one launch, {bad_total + bad} mismatching")

    # (b) against the native host engine at main-path sizes and past
    # rep_len 32,768
    sizes = ((1, 33000), (2, 40000), (100, 4096), (129, 32769),
             (200, 32767), (200, 32768), (257, 33000), (400, 32768),
             (480, 20000), (500, 9000), (100, 262000))
    jobs = []
    for ul, rl in sizes:
        unit = rng.integers(0, 4, ul).astype(np.int8)
        for scheme in SCHEMES:
            jobs.append((periodic_rep(rng, unit, rl), unit, scheme))
    by_span = {}
    for q, job in enumerate(jobs):
        by_span.setdefault(u_span_for(len(job[1])), []).append(q)
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
    """Phase 2b.  Returns the largest absolute difference seen (must be
    0)."""
    import numpy as np
    import torch

    from mtr_tpu_torch import native
    from mtr_tpu_torch.ops import wrap_dp_consensus as cop
    from mtr_tpu_torch.ops.wrap_dp_counts import u_span_for
    from mtr_tpu_torch.ops.wrap_dp_resident import (
        _pow2_units,
        consensus_resident_plain,
        gather_segments,
    )
    from mtr_tpu_torch.pipeline import _factor

    rng = np.random.default_rng(20241)
    worst = 0

    def run(jobs, u_span, plain=False):
        t = [torch.from_numpy(a).cuda() for a in make_batch(jobs, u_span)]
        factor = _factor(s for _, _, s in jobs)
        fn = consensus_resident_plain if plain else (
            lambda *a: cop.wrap_dp_consensus(*a[:4], u_span, a[4]))
        fused, best = fn(*t, factor)
        torch.cuda.synchronize()
        return fused.cpu().numpy(), best.cpu().numpy()

    def packed_moves_differ(jobs, u_span):
        """The kernel's packed move scratch against pack_moves of the
        plain fill's moves: the number of differing bytes."""
        flat, starts, scal, unit = (torch.from_numpy(a).cuda() for a in
                                    make_batch(jobs, u_span))
        launch, (_, _, done, moves, mv_off) = cop.prepare(
            flat, starts, scal, unit, u_span, _factor(s for _, _, s in jobs))
        launch()
        r_pad = max(1, int(scal[:, 0].max()))
        want_mv, _ = cop.wrap_dp_fill_plain(
            scal, gather_segments(flat, starts, r_pad).to(torch.int32),
            _pow2_units(unit).to(torch.int32))
        want, want_off = cop.pack_moves(want_mv, scal.cpu())
        got = moves[: want.numel()].cpu()
        check(bool(done.all()), "consensus kernel left a walk unfinished")
        check(torch.equal(mv_off.cpu(), want_off), "move offsets differ")
        return int((got != want).sum())

    # (a) against the plain version on the card, rep_len <= 2048: a launch
    # per C, then every job in one launch
    by_span: dict = {}
    for ul in CONS_UNIT_LENS:
        for scheme in SCHEMES:
            unit = rng.integers(0, 4, ul).astype(np.int8)
            rl = int(rng.integers(ul, 2049))
            by_span.setdefault(u_span_for(ul), []).extend([
                (periodic_rep(rng, unit, rl), unit, scheme),
                (rng.integers(0, 4, int(rng.integers(1, 2049))).astype(
                    np.int8), unit, scheme),
            ])
    for scheme in SCHEMES:  # degenerate: rep_len 1 and 0, unit_len 2
        by_span[32] += [
            (np.array([1], np.int8), np.array([1, 2], np.int8), scheme),
            (np.array([3], np.int8), np.array([3, 3], np.int8), scheme),
            (np.zeros(0, np.int8), np.array([0, 0], np.int8), scheme),
        ]
    every = sorted((j for js in by_span.values() for j in js),
                   key=lambda j: -len(j[0]))
    for u_span, jobs in sorted(by_span.items()) + [(512, every)]:
        got, got_best = run(jobs, u_span)
        want, want_best = run(jobs, u_span, plain=True)
        diff = np.abs(got.astype(np.int64) - want).reshape(len(jobs), -1)
        diff_best = np.abs(got_best.astype(np.int64) - want_best)
        bad = int(((diff.max(axis=1) > 0) | (diff_best.max(axis=1) > 0))
                  .sum())
        worst = max(worst, int(diff.max()), int(diff_best.max()))
        n_mv = packed_moves_differ(jobs, u_span)
        info(f"consensus kernel vs plain on the card, u_span {u_span}: "
             f"{len(jobs)} jobs, rep_len <= "
             f"{max(len(r) for r, _, _ in jobs)}, {bad} mismatching, "
             f"{n_mv} packed move bytes differing")
        check(bad == 0 and n_mv == 0, f"consensus kernel disagrees with the "
              f"plain version (u_span {u_span})")

    # (b) against the native host engine at polish sizes
    jobs = []
    for ul, rl in POLISH_SIZES:
        unit = rng.integers(0, 4, ul).astype(np.int8)
        for scheme in SCHEMES:
            jobs.append((periodic_rep(rng, unit, rl), unit, scheme))
    got = run(jobs, u_span_for(max(len(u) for _, u, _ in jobs)))[0]
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


def rows_differ(got, want):
    """Rows of two walk_cases per-row results (CPU) that differ."""
    bad = np.zeros(len(want["bad"]), bool)
    for key in want:
        d = np.asarray(got[key]) != np.asarray(want[key])
        bad |= d.reshape(len(bad), -1).any(1)
    return bad


def walk_vs_references(fasta):
    """Phase 2c.  Returns the number of mismatching rows and queries
    (must be 0)."""
    import warnings

    import numpy as np
    import torch

    from mtr_tpu_torch import native
    from mtr_tpu_torch.ops import _build
    from mtr_tpu_torch.ops import dbg_device as dw
    from mtr_tpu_torch.testutil import walk_cases as wc
    from mtr_tpu_torch.utils.timers import TIMERS

    groups = {v: _build.library().mtr_dbg_walk_group(v) for v in dw.V_BUCKETS}
    check(all(g == dw.walk_group(v) for v, g in groups.items()),
          f"the row kernel walks {groups} nodes a direction at once by "
          f"table width, walk_rows_plain {dw.walk_group(64)} / "
          f"{dw.walk_group(dw.V_MAX)}")
    rng = np.random.default_rng(20242)
    orgs, lens, queries = walk_fuzz_set(rng)
    tot = {"rows": 0, "won": 0, "bad_rows": 0, "mismatching": 0}
    t0 = time.perf_counter()

    def compare(label, chunk):
        got = wc.run_rows(*chunk)
        want = wc.run_rows(*(t.cpu() for t in chunk))
        diff = rows_differ(got, want)
        tot["rows"] += len(diff)
        tot["won"] += int((want["fwd_period"] > 0).sum()
                          + (want["bwd_period"] > 0).sum())
        tot["bad_rows"] += int(want["bad"].sum())
        tot["mismatching"] += int(diff.sum())
        info(f"walk row kernel vs plain twin on the card, {label}: "
             f"{len(diff)} rows, {int(diff.sum())} mismatching")

    for v_pad, chunk in wc.chunks_of(orgs, lens, queries, "cuda"):
        compare(f"V bucket {v_pad}", chunk)
    for v_pad in (4096, dw.WIDE_V, dw.V_MAX):  # 2, 8 and 8 walks a group
        chunk, kinds, _ = wc.edge_chunk(v_pad)
        compare(f"edge rows at V {v_pad} ({', '.join(sorted(set(kinds)))})",
                tuple(t.cuda() for t in chunk))
    info(f"walk row kernel vs plain twin: {tot['rows']} rows of "
         f"{len(queries)} fuzz queries and the edge rows, {tot['won']} "
         f"winning walks, {tot['bad_rows']} bad rows, {tot['mismatching']} "
         f"mismatching ({time.perf_counter() - t0:.1f} s)")
    check(tot["mismatching"] == 0, "walk row kernel disagrees with its "
          "plain twin")
    check(tot["bad_rows"] > 0, "the fuzz set made no bad row")
    check(tot["won"] > 0, "the fuzz set found no unit")

    b_orgs, b_lens, (ridx, qs, qe, _, k) = wc.batch_queries(fasta)
    n = len(ridx)
    dw.dbg_walk_device_batch(b_orgs, b_lens, ridx, qs, qe, k, "cuda")
    before = TIMERS.snapshot()[1]
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            t0 = time.perf_counter()
            got = dw.dbg_walk_device_batch(b_orgs, b_lens, ridx, qs, qe, k,
                                           "cuda")
            dt_dev = time.perf_counter() - t0
    finally:
        torch.cuda.set_sync_debug_mode("default")
    after = TIMERS.snapshot()[1]
    waits = after.get("walk_waits", 0) - before.get("walk_waits", 0)
    syncs = [str(w.message).splitlines()[0] for w in caught
             if "synchroniz" in str(w.message)]
    t0 = time.perf_counter()
    want = native.dbg_walk_batch2(b_orgs, b_lens, ridx, qs, qe, k)
    dt_nat = time.perf_counter() - t0
    g, w = wc.canonical(got, n), wc.canonical(want, n)
    diff = [key for key in w if not np.array_equal(g[key], w[key])]
    rows = int((got["fwd_off"] >= 0).sum() + (got["bwd_off"] >= 0).sum())
    info(f"dbg_walk_device_batch vs native on bench batch 1: {n} queries, "
         f"{rows} unit rows, fields differing: {diff or 'none'} (device "
         f"{dt_dev:.3f} s after a first call, native {dt_nat:.3f} s); "
         f"walk_waits {waits}, synchronizing calls the sync debug mode saw "
         f"{len(syncs)}{': ' + '; '.join(sorted(set(syncs))) if syncs else ''}")
    check(not diff, "dbg_walk_device_batch disagrees with the native engine")
    check(waits <= 2 and len(syncs) <= 2, f"the device walk route waited "
          f"{waits} times (counted) and synchronized {len(syncs)} times in "
          f"one call")
    return tot["mismatching"]


def di_group_out(kind, codes, n_outs, ws, n_sym):
    """One counted launch of a DI kernel ("l1" Manhattan, "pcc" Pearson)
    on a group of passes over codes (a CUDA tensor): each pass's int32
    output."""
    from mtr_tpu_torch.ops import directional_index as di

    if kind == "l1":
        return di.split_group(di.sliding_l1_kernel(codes, n_outs, ws, n_sym),
                              n_outs, 1)
    return di.split_group(di.pearson_moments_kernel(codes, n_outs, ws, n_sym),
                          n_outs, 5)


def di_diff(codes, n_outs, ws, n_sym, kind):
    """A DI kernel's group launch against its plain version on each pass:
    the largest absolute difference."""
    from mtr_tpu_torch.ops import directional_index as di

    got = di_group_out(kind, codes, n_outs, ws, n_sym)
    want = di.plain_group(codes, n_outs, ws, n_sym, kind == "pcc")
    worst = 0
    for g, x in zip(got, want):
        check(tuple(g.shape) == tuple(x.shape), f"DI kernel {kind}: shape "
              f"{tuple(g.shape)} against the plain {tuple(x.shape)}")
        worst = max(worst, int((g.long() - x).abs().max()))
    return worst


def di_vs_plain(tmp, edges=(16384, 131072, 1048576 + 65536),
                long_set="bench_800k"):
    """Phase 2d: group launches of mixed w against the plain versions, and
    every pass of the first read of `long_set` (a group launch a k, as the
    device backend runs them).  Returns the largest absolute difference
    (must be 0) and the passes checked by kind."""
    import torch

    from mtr_tpu_torch.config import MTRConfig
    from mtr_tpu_torch.io.fasta import iter_fasta
    from mtr_tpu_torch.ops import directional_index as di
    from mtr_tpu_torch.oracle.arena import Arena
    from mtr_tpu_torch.oracle.directional_index import (
        fill_directional_index_with_end,
    )
    from mtr_tpu_torch.testutil.golden_sets import write_set

    rng = np.random.default_rng(20243)
    worst, n, launches, tiles = 0, {"l1": 0, "pcc": 0}, 0, set()
    t0 = time.perf_counter()

    def run(codes, n_outs, ws, n_sym, kind, what):
        nonlocal worst, launches
        n_win = 2 if kind == "l1" else 3
        size = max(m + n_win * w - 1 for m, w in zip(n_outs, ws))
        t = torch.from_numpy(np.ascontiguousarray(codes[:size],
                                                  np.int32)).cuda()
        err = di_diff(t, n_outs, ws, n_sym, kind)
        worst = max(worst, err)
        n[kind] += len(ws)
        launches += 1
        table = di.plan_group(t.device, n_outs, ws, n_sym, kind == "pcc")
        tiles.update((int(r[3]), int(r[4])) for r in table)
        check(err == 0, f"DI kernel {kind} disagrees with its plain version "
              f"({what}: n_out {n_outs}, w {ws}, n_sym {n_sym}; max abs err "
              f"{err})")

    def group(n_outs, ws, k, alphabet, what, runs=False):
        """A Manhattan and a Pearson group over the same codes: below 4^k,
        then a stale tail of codes below `alphabet` that the longer passes
        reach and the shorter ones may not (Manhattan sizes n_sym over the
        whole group; Pearson skips codes >= 4^k); or runs of equal codes."""
        for kind, n_win in (("l1", 2), ("pcc", 3)):
            size = max(m + n_win * w - 1 for m, w in zip(n_outs, ws))
            if runs:  # runs of equal codes: steps that move equal codes
                codes = np.repeat(rng.integers(0, alphabet, size),
                                  rng.integers(1, 40, size))[:size]
            else:
                codes = rng.integers(0, 4**k, size)
                cut = int(rng.integers(size // 2, size))
                codes[cut:] = rng.integers(0, alphabet, size - cut)
            n_sym = (4 ** di._k_for(codes, size) if kind == "l1" else 4**k)
            run(codes, n_outs, ws, n_sym, kind, what)

    for k, max_w in DI_SWEEP:  # every w of each k in one launch
        ws = [5 * 2**i for i in range(20) if 5 * 2**i <= max_w]
        group([int(x) for x in rng.integers(1, 30000, len(ws))], ws, k, 1024,
              "sweep")
    dev = torch.device("cuda")
    for w in (5, 200, 2000, 10240):  # n_out around a tile and a warp
        for pearson in (False, True):
            _, _, _, tile, sl = di.plan_group(dev, [1], [w], 64,
                                              pearson)[0].tolist()
            group([1, tile - 1 or 1, tile, tile + 1, sl * tile,
                   sl * tile + 1, 4 * sl * tile + 1], [w] * 7, 3, 64,
                  f"tile {tile}, {sl} sliders")
    ws = [5, 640, 10240]
    sl = di.di_sliders([2 * w for w in ws], 1024, 2)
    resident = di.resident_warps(dev, False, 1024, ws, max(sl))
    for extra in (-1, 0, 1):  # the group's fill term at a multiple of 32
        per = (32 * resident + extra) // 3
        group([s * per for s in sl[:2]] + [sl[2] * (32 * resident + extra
                                                   - 2 * per)],
              ws, 5, 1024, "fill edge")
    for alphabet, k in ((4, 1), (64, 3), (1024, 5)):
        group([int(x) for x in rng.integers(1000, 20000, 3)], [5, 80, 2560],
              k, alphabet, f"alphabet {alphabet}, runs", runs=True)
    # windows past 32,767: int32 Manhattan bins (Pearson's 16-bit counts
    # hold w up to the bound's 46,340)
    group([100, 33], [32768, 40000], 1, 4, "wide bins")
    for n_pos in (e + 1 for e in edges):
        for kind, n_win in (("l1", 2), ("pcc", 3)):
            ws = [5, 640, 5000]
            run(rng.integers(0, 1024, n_pos),
                [n_pos - n_win * w + 1 for w in ws], ws, 1024, kind,
                f"n_pos {n_pos}")
    n_fuzz, l_fuzz = dict(n), launches

    # every pass of one 800 kbp read, from the arena as the pipeline fills
    # it: a group launch a k and kind
    cfg = MTRConfig()
    read = next(iter_fasta(write_set(long_set, tmp), cfg.max_input_length))
    arena = Arena(cfg.max_input_length)
    arena.load_read(read.codes)

    def compare(buf, di_len, ws, k, rsl):
        passes = [(w, di_len - w - rsl - k + 1) for w in ws]
        passes = [(w, n_i) for w, n_i in passes if n_i > 0]
        pws = [w for w, _ in passes]
        n_pos = max(n_i + 3 * w - 1 for w, n_i in passes)
        run(buf, [n_i + w for w, n_i in passes], pws,
            4 ** di._k_for(buf, n_pos), "l1", "800k")
        run(buf, [n_i for _, n_i in passes], pws, 4**k, "pcc", "800k")
        return [np.full(di_len, -1.0) for _ in ws]

    fill_directional_index_with_end(
        arena, read.length, 100 if read.length < 1000 else read.length // 10,
        di_compute_k=compare)
    torch.cuda.synchronize()
    info(f"DI kernels vs plain on the card: {l_fuzz} fuzz group launches of "
         f"{n_fuzz['l1']} Manhattan and {n_fuzz['pcc']} Pearson passes "
         f"(every w of each k of the sweep in one launch, n_out around "
         f"(tile, sliders) {sorted(tiles)}, the fill term at a multiple of "
         f"32, alphabets "
         f"4 / 64 / 1,024 with runs, stale tails that some passes of a group "
         f"reach, w past 32,767, n_pos past {edges}), {launches - l_fuzz} "
         f"launches of "
         f"{n['l1'] - n_fuzz['l1']} + {n['pcc'] - n_fuzz['pcc']} passes of "
         f"the {read.length} bp read; max abs err {worst} "
         f"({time.perf_counter() - t0:.1f} s)")
    return worst, n


def timer_snapshot():
    from mtr_tpu_torch.utils.timers import TIMERS

    return dict(TIMERS.t)


def timer_delta(before):
    from mtr_tpu_torch.utils.timers import TIMERS

    return {k: v - before.get(k, 0.0) for k, v in TIMERS.t.items()
            if v - before.get(k, 0.0) > 0}


def counter_delta(before):
    from mtr_tpu_torch.utils.timers import TIMERS

    return {k: v - before.get(k, 0) for k, v in TIMERS.counters.items()}


def first_difference(got: str, want: str) -> str:
    """The first line where got and want differ, for the failure text."""
    g, w = got.splitlines(), want.splitlines()
    for n, (x, y) in enumerate(zip(g, w)):
        if x != y:
            return f"line {n + 1}: got {x!r}, want {y!r}"
    return (f"line {min(len(g), len(w)) + 1}: got {len(g)} lines, want "
            f"{len(w)}")


def same_as_golden(got: str, golden: str, what: str) -> None:
    if got != golden:
        diff = first_difference(got, golden)
        info(f"{what}: differs from the golden at {diff}")
        raise SmokeFailure(f"{what} differs from the golden ({diff})")


def main_path(tmp):
    """Phase 3: the port's hybrid on the bench set and the 100x10 set, and
    the port's host backend on the bench set, each against its golden
    (tests/golden/bench_200x200.out: mtr_tpu's host backend on this set)."""
    import io

    from mtr_tpu_torch.config import MTRConfig
    from mtr_tpu_torch.pipeline import make_batcher, run_file
    from mtr_tpu_torch.testutil.golden_sets import read_golden
    from mtr_tpu_torch.testutil.rand_seq import write_fasta

    fasta = os.path.join(tmp, "bench_200x200.fasta")
    n_reads = BENCH_READS
    t0 = time.perf_counter()
    write_fasta(fasta, fasta[:-6] + ".units", *BENCH_ARGS, seed=20200)
    info(f"bench set: {n_reads} reads, {os.path.getsize(fasta)} bytes, "
         f"generated in {time.perf_counter() - t0:.1f} s")
    golden = read_golden("bench_200x200")

    cfg = MTRConfig(backend="hybrid")
    batcher = make_batcher(cfg)
    reset_counts()
    t0 = time.perf_counter()
    port_out = io.StringIO()
    run_file(fasta, cfg, port_out, batcher=batcher)
    dt_port = time.perf_counter() - t0
    launches = read_counts()["counts"]

    t0 = time.perf_counter()
    host_out = io.StringIO()
    records, per_read = [], {}  # the one-process run, for phase 5d
    run_file(fasta, MTRConfig(backend="host"), host_out,
             record_sink=records.append, read_meta=per_read.__setitem__)
    dt_host = time.perf_counter() - t0

    dev, host = batcher.device.cells, batcher.host_cells
    n_lines = port_out.getvalue().count("\n")
    info(f"bench set, port hybrid: {dt_port:.3f} s, "
         f"{n_reads / dt_port:.3f} reads/s, {n_lines} records, "
         f"{launches} counts-kernel launches")
    info(f"bench set, port host backend (this machine's CPU): "
         f"{dt_host:.3f} s, {n_reads / dt_host:.3f} reads/s")
    info(f"bench set, counts DP cells: device {dev}, host {host}, "
         f"device share {dev / max(dev + host, 1):.4f}")
    same_as_golden(host_out.getvalue(), golden, "port host backend")
    same_as_golden(port_out.getvalue(), golden, "port hybrid")
    check(n_lines > 0, "no records on the bench set")
    check(launches > 0, "the main path launched no counts kernel")
    check(dev > 0, "the device leg computed no DP cell")

    golden_100 = os.path.join(HERE, "tests", "golden", "multi20_100x10")
    cfg = MTRConfig(backend="hybrid")
    batcher = make_batcher(cfg)
    t0 = time.perf_counter()
    out = io.StringIO()
    run_file(golden_100 + ".fasta", cfg, out, batcher=batcher)
    dt = time.perf_counter() - t0
    same_as_golden(out.getvalue(), read_golden("multi20_100x10"),
                   "port hybrid, 100x10 set")
    with open(golden_100 + ".fasta") as f:
        n_golden = sum(line.startswith(">") for line in f)
    info(f"100x10 golden, port hybrid: identical, {dt:.3f} s, "
         f"{n_golden / dt:.1f} reads/s ({n_golden} reads), device cells "
         f"{batcher.device.cells}")
    single = {"records": records, "per_read": per_read,
              "hybrid_s": dt_port}
    return fasta, golden, n_reads / dt_port, n_reads / dt_host, launches, single


def device_path(fasta, golden, hybrid_rate, host_rate):
    """Phase 3b: run_file under backend "device" with the walks on the host
    on the bench set vs mtr_tpu's host output."""
    import io

    from mtr_tpu_torch.config import MTRConfig
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
         f"(port hybrid {hybrid_rate:.3f}, port host {host_rate:.3f} "
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
    same_as_golden(out.getvalue(), golden, "port device (host walks)")
    for name in ("counts", "consensus", "di"):
        check(launches[name] > 0, f"the device path ran no {name} launch")
    check(launches["dbg_walk"] == 0, "use_device_walks=False walked on the "
          "device")
    check((launches["di_l1_kernel"], launches["di"]) == (
        BENCH_DI_GROUPS, BENCH_DI_PASSES), f"{launches['di']} DI passes in "
          f"{launches['di_l1_kernel']} DI kernel launches, not "
          f"{BENCH_DI_PASSES} in {BENCH_DI_GROUPS} (one a read and k)")
    return launches, dt


_COUNTS_BASE: dict = {}


def reset_counts():
    """Launch counts from now (read_counts reads the port's counters'
    growth since)."""
    from mtr_tpu_torch.utils.timers import TIMERS

    _COUNTS_BASE.clear()
    _COUNTS_BASE.update(TIMERS.snapshot()[1])


def read_counts():
    from mtr_tpu_torch.ops import directional_index as di
    from mtr_tpu_torch.utils.timers import TIMERS

    counters = TIMERS.snapshot()[1]

    def grew(*keys):
        return sum(counters.get(k, 0) - _COUNTS_BASE.get(k, 0) for k in keys)

    return {"counts": grew("launch.wrap_dp_counts"),
            "consensus": grew("launch.wrap_dp_consensus"),
            "dbg_walk": grew("launch.dbg_walk"),
            "stage_a": grew("stage_a_calls"),
            "di": grew(*di.PASS_COUNTERS),
            "di_sharded": grew("di_sharded_passes"),
            "di_l1_kernel": grew("launch.di_sliding_l1"),
            "di_pcc_kernel": grew("launch.di_pearson_moments")}


def device_walk_path(fasta, golden):
    """Phase 3c: run_file under backend "device" with the DBG walks on the
    card, on the bench set and the 100x10 golden, then the CLI; returns
    the launch counts of the bench run and its Spies (every walk and
    consensus launch's inputs)."""
    import io

    from mtr_tpu_torch.config import MTRConfig
    from mtr_tpu_torch.utils.timers import TIMERS
    from mtr_tpu_torch.pipeline import make_batcher, run_file
    from mtr_tpu_torch.testutil.golden_sets import read_golden

    cfg = MTRConfig(backend="device")
    batcher = make_batcher(cfg)
    before_t, before_c = timer_snapshot(), dict(TIMERS.counters)
    reset_counts()
    with Spies() as spies:
        t0 = time.perf_counter()
        out = io.StringIO()
        run_file(fasta, cfg, out, batcher=batcher)
        dt = time.perf_counter() - t0
    launches = read_counts()
    spent, counted = timer_delta(before_t), counter_delta(before_c)
    launches["di_seconds"] = spent.get("di_device", 0.0)
    n_q = counted.get("speculative_queries", 0)
    n_host = counted.get("walk_fallback_queries", 0)
    info(f"bench set, port device with device walks: {dt:.3f} s, "
         f"{BENCH_READS / dt:.3f} reads/s, "
         f"{out.getvalue().count(chr(10))} records")
    calls = counted.get("walk_device_calls", 0)
    info(f"bench set, device walks: walk seconds {spent.get('walks', 0.0):.3f}"
         f" (stage A launches {spent.get('count_table', 0.0):.3f}), "
         f"{launches['stage_a']} stage-A passes, {launches['dbg_walk']} "
         f"walk-kernel launches, {calls} route calls, "
         f"{counted.get('walk_waits', 0)} waits, "
         f"{counted.get('walk_rows_bytes', 0)} bytes of rows pulled, {n_q} "
         f"walk queries")
    info(f"bench set, device walks: walk_fallback_queries {n_host} "
         f"(share {n_host / max(n_q, 1):.6f})")
    info(f"bench set, port device with device walks: {launches['counts']} "
         f"counts launches, {launches['consensus']} consensus launches, "
         f"{launches['di']} device-DI passes")
    info("bench set, device walks, stage seconds (threads overlap): "
         + ", ".join(f"{k} {v:.3f}" for k, v in sorted(spent.items())))
    split = {name: spent.get(key, 0.0) for name, key in (
        ("stage A launches", "count_table"),
        ("kernel launches", "walk_kernel"),
        ("the pull", "mtr.walk.rows"),
        ("host route", "walk_host_route"))}
    walk_s = spent.get("walks", 0.0)
    info(f"bench set, device walks, the walk thread: walks {walk_s:.3f} s = "
         + " + ".join(f"{k} {v:.3f}" for k, v in split.items())
         + f" + the rest {walk_s - sum(split.values()):.3f}; wall {dt:.3f} s,"
         f" DI seconds {spent.get('di_device', 0.0):.3f} on the reader "
         f"thread, {launches['di_l1_kernel']} DI kernel launches for "
         f"{launches['di']} passes, {spies.di_plain_on_card} plain DI calls "
         f"on the card ({card_line()})")
    same_as_golden(out.getvalue(), golden, "port device (device walks)")
    for name in ("counts", "consensus", "dbg_walk", "stage_a", "di"):
        check(launches[name] > 0, f"the device path ran no {name} launch")
    check(launches["di_l1_kernel"] == len(spies.di_l1) == BENCH_DI_GROUPS
          and launches["di"] == BENCH_DI_PASSES == sum(
              len(ws) for _, _, ws, _ in spies.di_l1)
          and launches["di_pcc_kernel"] == 0 and spies.di_plain_on_card == 0,
          "the device path's DI did not run every pass through the kernel, "
          "one launch a read and k")

    golden_100 = os.path.join(HERE, "tests", "golden", "multi20_100x10")
    t0 = time.perf_counter()
    out = io.StringIO()
    run_file(golden_100 + ".fasta", cfg, out, batcher=make_batcher(cfg))
    dt = time.perf_counter() - t0
    same_as_golden(out.getvalue(), read_golden("multi20_100x10"),
                   "port device (device walks), 100x10 set")
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
    same_as_golden(r.stdout, golden, "CLI --backend device")
    return launches, spies


def pearson_device_path(fasta):
    """Phase 3e: run_file under backend "device" with -p's Pearson DI on
    the bench set against bench_200x200_pcc.out.  Returns the launch
    counts and the recorded Pearson group launches."""
    import io

    from mtr_tpu_torch.config import MTRConfig
    from mtr_tpu_torch.pipeline import make_batcher, run_file
    from mtr_tpu_torch.testutil.golden_sets import read_golden

    cfg = MTRConfig(backend="device", manhattan_distance=False)
    batcher = make_batcher(cfg)
    before = timer_snapshot()
    reset_counts()
    with Spies() as spies:
        t0 = time.perf_counter()
        out = io.StringIO()
        run_file(fasta, cfg, out, batcher=batcher)
        dt = time.perf_counter() - t0
    launches = read_counts()
    spent = timer_delta(before)
    launches["di_seconds"] = spent.get("di_device", 0.0)
    same_as_golden(out.getvalue(), read_golden("bench_200x200_pcc"),
                   "port device -p")
    info(f"bench set, port device -p (Pearson DI, device walks): identical "
         f"to its golden, {dt:.3f} s, DI seconds "
         f"{spent.get('di_device', 0.0):.3f}, {launches['di_pcc_kernel']} DI "
         f"kernel launches for {launches['di']} passes, "
         f"{spies.di_plain_on_card} plain DI calls on the card "
         f"({card_line()})")
    check(launches["di_pcc_kernel"] == len(spies.di_pcc) == BENCH_DI_GROUPS
          and launches["di"] == BENCH_DI_PASSES == sum(
              len(ws) for _, _, ws, _ in spies.di_pcc)
          and launches["di_l1_kernel"] == 0
          and spies.di_plain_on_card == 0,
          "the -p device path's DI did not run every pass through the "
          "kernel, one launch a read and k")
    return launches, spies.di_pcc


# ------------------------------------------- phases 5a-5e: the other paths


def run_cli(flags, fasta, what, want=None):
    """`python -m mtr_tpu_torch.cli <flags> <fasta>` in a new process ->
    (stdout, stderr, wall seconds); exit 0 or the phase fails.  With
    `want`, the stdout must equal it."""
    t0 = time.perf_counter()
    r = subprocess.run(
        [sys.executable, "-m", "mtr_tpu_torch.cli", *flags, fasta], cwd=HERE,
        capture_output=True, text=True, timeout=600)
    dt = time.perf_counter() - t0
    check(r.returncode == 0,
          f"CLI {' '.join(flags)} failed ({what}): {r.stderr[-2000:]}")
    if want is not None:
        same_as_golden(r.stdout, want, f"CLI {' '.join(flags)} ({what})")
        info(f"CLI {' '.join(flags)} on {what}: identical to its golden, "
             f"{r.stdout.count(chr(10))} lines, {dt:.3f} s in a new process "
             f"({card_line()})")
    return r.stdout, r.stderr, dt


def summary_count(stderr: str, name: str) -> int:
    """A counter of the CLI's -c summary (a line of tab, count, tab,
    name)."""
    for line in stderr.splitlines():
        parts = line.split("\t")
        if len(parts) == 3 and parts[2] == name:
            return int(parts[1])
    return 0


def cli_modes(fasta, tmp, hybrid="hybrid", device="device"):
    """Phase 5a: the CLI's -p, -a, --cluster, --checkpoint and --no-strict
    on the card, each against a golden written by mtr_tpu's host backend."""
    from mtr_tpu_torch.testutil.golden_sets import MULTI20, read_golden

    pcc = read_golden("bench_200x200_pcc")
    run_cli(["--backend", hybrid, "-p"], fasta, "the bench set", pcc)
    _, err, _ = run_cli(["--backend", device, "-p", "-c"], fasta,
                        "the bench set", pcc)
    n_pearson = summary_count(err, "di_pearson_passes")
    info(f"CLI --backend {device} -p: {n_pearson} Pearson DI passes on the "
         f"card, {summary_count(err, 'di_manhattan_passes')} Manhattan")
    check(n_pearson > 0 or device != "device",
          "-p under --backend device ran no Pearson DI pass on the card")
    run_cli(["--backend", device, "-a"], MULTI20, "the 100x10 set",
            read_golden("multi20_100x10_alignment"))
    run_cli(["--backend", hybrid, "--cluster"], fasta, "the bench set",
            read_golden("bench_200x200_cluster"))

    golden = read_golden("bench_200x200")
    ckpt = os.path.join(tmp, "resume.ckpt")
    with open(ckpt, "w") as f:
        f.write("10")
    # read ids of the set are 0..19: reads 11-20 are ids 10-19
    want = "".join(ln for ln in golden.splitlines(True)
                   if int(ln.split("\t")[0]) >= 10)
    check(0 < want.count("\n") < golden.count("\n"), "empty resume golden")
    run_cli(["--backend", hybrid, "--checkpoint", ckpt], fasta,
            "the bench set resumed at read 11 of 20", want)
    with open(ckpt) as f:
        check(f.read() == "20", "the resumed run left no 20 in its checkpoint")
    fresh = os.path.join(tmp, "fresh.ckpt")
    run_cli(["--backend", hybrid, "--no-strict", "--checkpoint", fresh],
            fasta, "the clean bench set, fresh checkpoint", golden)
    with open(fresh) as f:
        check(f.read() == "20", "the whole run left no 20 in its checkpoint")


def equality_sets(tmp, backend="hybrid"):
    """Phase 5b: the hybrid on the bench's other equality sets."""
    import io

    from mtr_tpu_torch.config import MTRConfig
    from mtr_tpu_torch.pipeline import make_batcher, run_file
    from mtr_tpu_torch.testutil.golden_sets import read_golden, write_set

    for name in ("bench_structured", "bench_100x10_100", "bench_800k"):
        fasta = write_set(name, tmp)
        cfg = MTRConfig(backend=backend)
        batcher = make_batcher(cfg)
        reset_counts()
        t0 = time.perf_counter()
        out = io.StringIO()
        run_file(fasta, cfg, out, batcher=batcher)
        dt = time.perf_counter() - t0
        same_as_golden(out.getvalue(), read_golden(name),
                       f"port {backend}, {name}")
        cells = getattr(getattr(batcher, "device", None), "cells", 0)
        info(f"{name}, port {backend}: identical to its golden, "
             f"{out.getvalue().count(chr(10))} records, {dt:.3f} s, "
             f"{read_counts()['counts']} counts launches, device cells "
             f"{cells} ({card_line()})")


def mesh_path(fasta, golden, one_device, slots=MESH_SLOTS):
    """Phase 5c: the mesh, with every slot on this one card.  `one_device`
    is phase 3b's (launch counts, seconds).  Returns the launch counts of
    the sharded bench run."""
    import io

    import torch

    from mtr_tpu_torch.config import MTRConfig
    from mtr_tpu_torch.entry import entry
    from mtr_tpu_torch.ops.wrap_dp_counts import wrap_dp_counts_plain
    from mtr_tpu_torch.parallel.mesh import make_mesh, sharded_wrap_dp_step
    from mtr_tpu_torch.pipeline import ShardedTorchDPBatcher, run_file

    dev = slots[0]
    on_card = torch.device(dev).type == "cuda"
    note = (f"{len(slots)} slots, all of them {dev}: this shows that the "
            f"split is exact, not that it scales")

    reset_counts()
    step, args = entry(dev)
    counts, best = step(*args)
    scal, reps, units = (torch.from_numpy(a).to(dev) for a in args)
    want = wrap_dp_counts_plain(scal, reps.to(torch.int8),
                                units.to(torch.int8))
    check(read_counts()["counts"] == int(on_card),
          "entry()'s step launched no counts kernel")
    check(torch.equal(counts[:, :11], want[:, :11]) and bool(
        (best[:, 1] > 0).all()), "entry()'s step disagrees with the plain "
          "version")
    info(f"entry(): one wrap_dp_counts step at (8, 128, 256) equals the "
         f"plain version, scores {best[:, 1].tolist()}")

    mesh = make_mesh(devices=list(slots))
    rng = np.random.default_rng(540)
    b, u_span, r_pad = 16, 128, 256
    scal = np.zeros((b, 8), np.int32)
    reps = np.full((b, r_pad), -1, np.int8)
    units = np.full((b, u_span), -2, np.int8)
    for q in range(b):
        ul, rl = int(rng.integers(2, 129)), int(rng.integers(10, r_pad + 1))
        unit = rng.integers(0, 4, ul).astype(np.int8)
        reps[q, :rl] = periodic_rep(rng, unit, rl)
        units[q, :ul] = unit
        scal[q, :5] = (rl, ul, *SCHEMES[q % 3])
    reset_counts()
    one, _ = sharded_wrap_dp_step(make_mesh(devices=[dev]), b, u_span,
                                  r_pad)(scal, reps, units)
    n_one = read_counts()["counts"]
    cut, _ = sharded_wrap_dp_step(mesh, b, u_span, r_pad)(scal, reps, units)
    n_cut = read_counts()["counts"] - n_one
    cols = [c for c in range(15) if c != 7]  # 7: the launch's final wrap row
    check(torch.equal(one[:, cols], cut[:, cols]),
          "sharded_wrap_dp_step differs from the one launch")
    check(not on_card or (n_one, n_cut) == (1, len(slots)),
          f"sharded_wrap_dp_step launched {n_cut} kernels, one launch {n_one}")
    info(f"sharded_wrap_dp_step, {b} jobs over {note}: equal to the one "
         f"launch in every column but 7, {n_cut} launches against {n_one}")

    cfg = MTRConfig(backend="device", use_device_walks=False)
    before = timer_snapshot()
    reset_counts()
    t0 = time.perf_counter()
    out = io.StringIO()
    run_file(fasta, cfg, out, batcher=ShardedTorchDPBatcher(mesh))
    dt = time.perf_counter() - t0
    launches = read_counts()
    di_s = timer_delta(before).get("di_device", 0.0)
    same_as_golden(out.getvalue(), golden, "port device under the sharded "
                   "batcher")
    base, base_dt = one_device
    info(f"bench set, port device (host walks) under ShardedTorchDPBatcher, "
         f"{note}: identical to the golden, {dt:.3f} s, DI seconds "
         f"{di_s:.3f} (one device {base_dt:.3f} s); counts launches {launches['counts']} (one "
         f"device {base['counts']}), consensus launches "
         f"{launches['consensus']} ({base['consensus']}), device-DI passes "
         f"{launches['di']}, {launches['di_sharded']} of them cut over the "
         f"mesh ({card_line()})")
    check(launches["di_sharded"] > 0 and
          launches["di_sharded"] == launches["di"],
          "the sharded batcher's run did not cut its DI over the mesh")
    if on_card:
        n = len(slots)
        for name in ("counts", "consensus"):
            # a part of fewer jobs than slots launches fewer kernels
            check(base[name] < launches[name] <= n * base[name],
                  f"sharded {name} launches {launches[name]}, one device "
                  f"{base[name]}")
        check(launches["di_l1_kernel"] == n * launches["di_sharded"],
              f"{launches['di_sharded']} sharded DI passes on {n} slots but "
              f"{launches['di_l1_kernel']} DI kernel launches")
        have = torch.cuda.device_count()
        try:
            make_mesh(have + 1)
        except RuntimeError as e:
            info(f"make_mesh({have + 1}) on {have} card(s) raises: {e}")
        else:
            raise SmokeFailure(f"make_mesh({have + 1}) did not raise on "
                               f"{have} card(s)")
    return launches


def two_process_path(fasta, golden, single, tmp, backend="hybrid"):
    """Phase 5d: two run_file_sharded workers (gloo) that share the one
    card, against the one-process run."""
    import io
    import socket

    from mtr_tpu_torch.clustering import pack_records
    from mtr_tpu_torch.parallel.distributed import merge_outputs

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    prefix = os.path.join(tmp, "two_proc")
    worker = os.path.join(HERE, "tests", "_torch_dist_worker.py")
    env = {k: v for k, v in os.environ.items() if k != "LOCAL_RANK"}
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, worker, prefix, fasta, backend], cwd=HERE,
        env={**env, "RANK": str(rank), "WORLD_SIZE": "2",
             "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port)},
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for rank in range(2)]
    try:
        for p in procs:
            out, err = p.communicate(timeout=600)
            check(p.returncode == 0, f"a worker failed: {err[-2000:]}")
            info("  " + out.strip())
    finally:
        for p in procs:
            p.kill()
    dt = time.perf_counter() - t0
    merged = io.StringIO()
    merge_outputs(prefix, 2, merged)
    same_as_golden(merged.getvalue(), golden, "two processes, merged")
    records, per_read = single["records"], single["per_read"]
    firsts = np.cumsum([0] + [per_read[r] for r in range(BENCH_READS)])
    want = pack_records([rec for rank in range(2)
                         for r in range(rank, BENCH_READS, 2)
                         for rec in records[firsts[r] : firsts[r + 1]]])
    g0, g1 = (np.load(f"{prefix}.gather{rank}.npy") for rank in range(2))
    check(g0.shape == (len(records), 20) and np.array_equal(g0, g1)
          and np.array_equal(g0, want),
          "gather_records_multihost differs between the ranks or from the "
          "one-process run")
    info(f"two processes on the one card ({backend}, gloo): merged output "
         f"identical to the golden, {len(g0)} records' columns gathered on "
         f"both ranks; {dt:.3f} s from start to both exits, processes' "
         f"start-up included (one process, {backend} in this process: "
         f"{single['hybrid_s']:.3f} s; {card_line()})")
    return dt


def accuracy_path(tmp, backend="hybrid"):
    """Phase 5e: tests/test_accuracy.py's pinned counts (unit 100 x 10, 50
    reads, seed 777) through the port; byte parity makes them exact."""
    sys.path.insert(0, os.path.join(HERE, "scripts"))
    from accuracy_sweep_torch import sweep

    exact, ratios, dt = sweep(100, 10, 50, 777, backend, tmp)
    got = (exact, sum(r >= 0.99 for r in ratios),
           sum(r >= 0.98 for r in ratios))
    info(f"accuracy, unit 100 x 10, 50 reads, port {backend}: exact "
         f"{got[0]}/50, ratio >= 0.99: {got[1]}, >= 0.98: {got[2]} (pinned "
         f"{ACCURACY_PINS}), {dt:.3f} s")
    check(got == ACCURACY_PINS, f"accuracy counts {got} differ from the "
          f"pinned {ACCURACY_PINS}")


class Spies:
    """Records the inputs of every walk-, consensus- and DI-kernel call of
    a run (a DI call is a group launch: codes, n_outs, ws, n_sym), and
    counts the plain DI versions' calls on the card.  Their callers
    (ops/dbg_device._device_rows, TorchDPBatcher._dispatch,
    ops/directional_index._group / plain_group) look the ops up at call
    time, so
    a stand-in that records its arguments and calls the real op sees every
    launch.  Holding the arguments keeps each launch's tables and codes
    alive on the card (a few GB a bench run)."""

    def __enter__(self):
        from mtr_tpu_torch import pipeline as tp
        from mtr_tpu_torch.ops import dbg_device as dw
        from mtr_tpu_torch.ops import directional_index as di

        self.walks, self.cons, self.di_l1, self.di_pcc = [], [], [], []
        self.di_plain_on_card = 0
        self._real = (dw.walk_rows, tp.wrap_dp_consensus,
                      di.sliding_l1_kernel, di.pearson_moments_kernel,
                      di._sliding_l1_device, di._pearson_moments_device)

        def recorder(into, real):
            def call(*args):
                into.append(args)
                return real(*args)
            return call

        def plain_counter(real):
            def call(codes, *args):
                self.di_plain_on_card += int(codes.is_cuda)
                return real(codes, *args)
            return call

        real = self._real
        dw.walk_rows = recorder(self.walks, real[0])
        tp.wrap_dp_consensus = recorder(self.cons, real[1])
        di.sliding_l1_kernel = recorder(self.di_l1, real[2])
        di.pearson_moments_kernel = recorder(self.di_pcc, real[3])
        di._sliding_l1_device = plain_counter(real[4])
        di._pearson_moments_device = plain_counter(real[5])
        return self

    def __exit__(self, *exc):
        from mtr_tpu_torch import pipeline as tp
        from mtr_tpu_torch.ops import dbg_device as dw
        from mtr_tpu_torch.ops import directional_index as di

        (dw.walk_rows, tp.wrap_dp_consensus, di.sliding_l1_kernel,
         di.pearson_moments_kernel, di._sliding_l1_device,
         di._pearson_moments_device) = self._real
        return False


def event_ms(fn, n):
    """CUDA-event ms of one fn() (kernel launches with no host sync
    inside), over n back-to-back calls after one warm-up."""
    import torch

    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def kernel_ms(fn, n):
    """The least of two event_ms readings of fn, n calls each."""
    return min(event_ms(fn, n), event_ms(fn, n))


def in_turns(variants, n):
    """{name: ms} of each bare launcher, timed in turns (a, b, b, a), the
    least of each name's two turns."""
    names = list(variants)
    ms = {name: [] for name in names}
    for name in names + names[::-1]:
        ms[name].append(event_ms(variants[name], n))
    return {name: min(v) for name, v in ms.items()}


def walk_bound(args, lookups, steps, row_entries):
    """The row walk's bound on one launch: (lookups x (log2 of the staged
    level's length + 1) x 2 + steps x 20) int32 operations, counting the
    lookups and steps of the walks up to each direction's winner
    (walk_rows_plain's PLAIN_WORK); bytes as the kernel moves them: an
    ungated row's maxfreq read (4) and results written (32), a gated
    row's staged level (v_pad / S values; S = 2 above 32,768), inputs
    (maxfreq, n_nodes, k, lmax, 100 nodes) and results, and each winning
    row's unit (1 byte) and score (4) written.  The lookups' own loads
    are left out, so the bound is a floor."""
    sv, maxfreq = args[0], args[2]
    v_pad, rows = sv.shape[1], sv.shape[0]
    gated = int((maxfreq > 5).sum())
    level = v_pad // (1 if v_pad <= 1 << 15 else 2)
    ops = lookups * ((level - 1).bit_length() + 1) * 2 + steps * 20
    n_bytes = ((rows - gated) * (4 + 32)
               + gated * (level * 4 + 4 * 4 + 400 + 32) + row_entries * 5)
    return bound_ms(ops, n_bytes)


def cons_bound(scal):
    """The consensus bound on one launch: 20 int32
    operations a fill cell and 10 a traceback step (rep_len + unit_len
    steps a job); bytes: the rep codes read and the (B, 500, 9) blocks
    written."""
    rep_len, unit_len = scal[:, 0].astype(np.int64), scal[:, 1]
    ops = int((rep_len * unit_len * 20 + (rep_len + unit_len) * 10).sum())
    return bound_ms(ops, int(rep_len.sum()) + len(scal) * 500 * 9 * 4)


def row_walk(args):
    """A bare launcher of the row kernel on one recorded launch's inputs,
    with outputs of its own (the slot counter zeroed before each launch,
    so a replay reuses its row buffers), and those outputs."""
    import torch

    from mtr_tpu_torch.ops import dbg_device as dw

    sv, lmax = args[0], args[6]
    q, dev = sv.shape[0], sv.device
    cap = max(1, 2 * int(lmax.clamp(min=0).sum()))
    outs = (torch.zeros((q, 4), dtype=torch.int32, device=dev),
            torch.zeros((q, 2), dtype=torch.int64, device=dev),
            torch.zeros(cap, dtype=torch.uint8, device=dev),
            torch.zeros(cap, dtype=torch.int32, device=dev),
            torch.zeros(1, dtype=torch.int64, device=dev))
    launch = dw.prepare(*args[:7], *outs)
    used = outs[4]

    def run():
        used.zero_()
        launch()

    return run, outs


def replay_walks(walks, budget_s):
    """Phase 4c: every row-kernel launch of the device-whole bench run
    replayed on its own inputs (stage A's outputs of a chunk), timed with
    CUDA events (a slot-counter reset included); launch statistics; then,
    heaviest launches first and within budget_s of plain time, the kernel
    against walk_rows_plain on the launch (zero tolerance) and the lookups
    and steps it counts there, for the bound.  Returns one dict a
    launch."""
    import torch

    from mtr_tpu_torch.ops import dbg_device as dw
    from mtr_tpu_torch.testutil import walk_cases as wc

    rows = []
    for n, args in enumerate(walks):
        run, outs = row_walk(args)
        ms = kernel_ms(run, 2)
        sv, maxfreq = args[0], args[2]
        rows.append({"launch": n, "rows": int(sv.shape[0]),
                     "gated": int((maxfreq > 5).sum()),
                     "v_pad": int(sv.shape[1]),
                     "row_entries": int(outs[4].item()),
                     "table_mb": sv.numel() * 8 / 1e6, "ms": ms})
        del run, outs
    spent = 0.0
    for row in sorted(rows, key=lambda r: -r["ms"]):
        if spent > budget_s:
            break
        args = walks[row["launch"]][:7]
        got = wc.run_rows(*args)
        dw.PLAIN_WORK.update(lookups=0, steps=0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        want = wc.run_rows(*(t.cpu() for t in args))
        dt = time.perf_counter() - t0
        spent += dt
        row.update(plain_ms=dt * 1e3,
                   mismatches=int(rows_differ(got, want).sum()),
                   lookups=dw.PLAIN_WORK["lookups"],
                   plain_steps=dw.PLAIN_WORK["steps"])
        row["bound_ms"], row["bound_by"] = walk_bound(
            args, row["lookups"], row["plain_steps"], row["row_entries"])
    return rows


def replay_cons(cons):
    """Phase 4b: every consensus launch of the device-whole bench run
    replayed on its own inputs, timed with CUDA events; then the kernel
    against the plain version on the heaviest launch (zero tolerance) and
    the plain version's time there.  Returns one dict a launch."""
    import torch

    from mtr_tpu_torch.ops import wrap_dp_consensus as cop
    from mtr_tpu_torch.ops.wrap_dp_resident import consensus_resident_plain

    rows = []
    for n, args in enumerate(cons):
        scal = args[2].cpu().numpy()
        ms = kernel_ms(cop.prepare(*args)[0], 3)
        bms, by = cons_bound(scal)
        rows.append({"launch": n, "jobs": len(scal), "u_span": args[4],
                     "max_rep_len": int(scal[:, 0].max()),
                     "max_unit": int(scal[:, 1].max()),
                     "cells": int((scal[:, 0].astype(np.int64)
                                   * scal[:, 1]).sum()),
                     "ms": ms, "bound_ms": bms, "bound_by": by})
    row = max(rows, key=lambda r: r["ms"])
    flat, starts, scal, unit, u_span, factor = cons[row["launch"]]
    launch, (fused, best, done, _, _) = cop.prepare(*cons[row["launch"]])
    launch()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want, want_best = consensus_resident_plain(flat, starts, scal, unit,
                                               factor)
    torch.cuda.synchronize()
    row["plain_ms"] = (time.perf_counter() - t0) * 1e3
    diff = torch.maximum(
        (fused.long() - want.long()).abs().reshape(len(scal), -1).amax(1),
        (best.long() - want_best.long()).abs().amax(1))
    row["mismatches"] = int((diff > 0).sum()) + int((done == 0).sum())
    row["max_abs_err"] = int(diff.max())
    return rows


def run_summary(rows):
    """The kernel's sum over the run's launches, and its three heaviest
    launches."""
    return (sum(r["ms"] for r in rows),
            sorted(rows, key=lambda r: -r["ms"])[:3])


def prefilter_path(fasta, golden):
    """Phase 3d: the port's hybrid with MTR_TPU_MF_FILTER=1."""
    import io

    from mtr_tpu_torch.config import MTRConfig
    from mtr_tpu_torch.utils.timers import TIMERS
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
    same_as_golden(out.getvalue(), golden, "port hybrid with the pre-filter")
    check(n_out > 0, "the pre-filter filtered no query")


# bounds: an H100 SXM at its 700 W limit does 132 SMs x 64 int32 lanes x
# 1.98 GHz int32 operations a second (half its 128 fp32 lanes an SM), and
# moves 3.35 TB/s of device memory (NVIDIA's data sheet)
INT32_OPS_PER_S = 132 * 64 * 1.98e9
HBM_BYTES_PER_S = 3.35e12
# int32 operations a cell of the counts DP needs: the recurrence, the
# traceback precedence and the three payloads carried through the fill
COUNTS_OPS_PER_CELL = 30


def bound_ms(ops, n_bytes):
    """(least time in ms, "operations" or "bytes") for ops int32
    operations and n_bytes of device memory traffic."""
    t_ops, t_bytes = ops / INT32_OPS_PER_S, n_bytes / HBM_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def counts_bound(scal):
    """The counts kernel's bound on these jobs: cells x ops a cell, and
    the rep codes, units, scal and output rows moved once."""
    rep_len, unit_len = scal[:, 0].astype(np.int64), scal[:, 1]
    cells = int((rep_len * unit_len).sum())
    n_bytes = int(rep_len.sum() + unit_len.sum()) + len(scal) * (8 + 15) * 4
    return (*bound_ms(cells * COUNTS_OPS_PER_CELL, n_bytes), cells)


def time_kernel():
    """Phase 4: CUDA-event times of the counts kernel at the bench's
    GCUPS shapes (bench.py:395-397) and at unit 400; the plain version at
    the first."""
    import torch

    from mtr_tpu_torch.ops.wrap_dp_counts import (
        u_span_for,
        wrap_dp_counts,
        wrap_dp_counts_plain,
    )
    from mtr_tpu_torch.ops.wrap_dp_resident import gather_segments

    rng = np.random.default_rng(395)
    info(f"timing on: {card_line()}")

    def inputs(b, ul, rl, u_span):
        unit = rng.integers(0, 4, ul).astype(np.int8)
        rep = periodic_rep(rng, unit, rl + b)
        flat = np.lib.stride_tricks.sliding_window_view(rep, rl)[:b]
        jobs = [(flat[q], unit, (1, 1, 3)) for q in range(b)]
        return make_batch(jobs, u_span)

    res = {}
    for b, ul, rl, n in ((2048, 100, 4096, 5), (1024, 200, 32768, 2),
                         (256, 400, 32768, 2)):
        u_span = u_span_for(ul)
        batch = inputs(b, ul, rl, u_span)
        args = [torch.from_numpy(a).cuda() for a in batch]
        t = [event_ms(lambda: wrap_dp_counts(*args, u_span), n)
             for _ in range(2)]
        ms = min(t)
        bms, by, cells = counts_bound(batch[2])
        info(f"counts kernel, unit {ul} x rep_len {rl} x {b} jobs (C "
             f"{u_span // 32}): {ms:.3f} ms/launch ({t[0]:.3f}, "
             f"{t[1]:.3f}), {cells / ms / 1e6:.2f} GCUPS; bound {bms:.3f} ms "
             f"({by}), share of bound {bms / ms:.3f}")
        res[ul] = dict(ms=ms, bound_ms=bms, bound_by=by, args=args,
                       u_span=u_span)
    r = res[100]
    flat, starts, scal, units = r["args"]

    def plain():
        rep = gather_segments(flat, starts, 4096)
        unit = torch.nn.functional.pad(units, (0, 128 - r["u_span"]),
                                       value=-2)
        return wrap_dp_counts_plain(scal, rep, unit)

    plain_ms = event_ms(plain, 1)
    info(f"plain version on the card, unit 100 x rep_len 4096 x 2048 jobs: "
         f"{plain_ms:.1f} ms/call, kernel {r['ms']:.3f} ms "
         f"({plain_ms / r['ms']:.0f}x)")
    return res, plain_ms


def di_bound(kind, n_outs, ws):
    """A DI group launch's bound: DI_OPS int32 operations a position;
    bytes: the group's codes read once, D (Pearson: five moments) written
    once as int32."""
    n_win, n_res = (2, 1) if kind == "l1" else (3, 5)
    n_codes = max(n + n_win * w - 1 for n, w in zip(n_outs, ws))
    return bound_ms(sum(n_outs) * DI_OPS[kind],
                    n_codes * 4 + n_res * sum(n_outs) * 4)


def bare_di_group(kind, codes, n_outs, ws, n_sym):
    """A bare launcher of a DI kernel on a group of passes (the wrapper's
    tiles and table, its output allocated once; no launch counted), for
    CUDA-event timing.  Returns (run, flat output)."""
    import ctypes

    import torch

    from mtr_tpu_torch.ops import _build
    from mtr_tpu_torch.ops import directional_index as di

    pearson = kind == "pcc"
    rows = 5 if pearson else 1
    table = di.plan_group(codes.device, n_outs, ws, n_sym, pearson)
    out = torch.empty(rows * sum(n_outs), dtype=torch.int32,
                      device=codes.device)
    lib = _build.library()
    fn = lib.mtr_di_pearson_moments if pearson else lib.mtr_di_sliding_l1
    args = (codes.data_ptr(), codes.numel(), table.ctypes.data, len(ws),
            n_sym, out.data_ptr(), out.numel(),
            ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))

    def run(_keep=(out, table)):
        err = fn(*args)
        check(err == 0, f"DI kernel {kind} launch failed: CUDA error {err}")

    return run, out


def replay_di(launches, kind):
    """Phase 4e: every recorded DI group launch of a device run, the
    kernel against its plain version (zero tolerance) and timed with CUDA
    events.  Returns one dict a launch."""
    rows = []
    for n, (codes, n_outs, ws, n_sym) in enumerate(launches):
        err = di_diff(codes, n_outs, ws, n_sym, kind)
        ms = kernel_ms(bare_di_group(kind, codes, n_outs, ws, n_sym)[0], 3)
        bms, by = di_bound(kind, n_outs, ws)
        rows.append({"launch": n, "passes": len(ws), "positions": sum(n_outs),
                     "w_max": max(ws), "n_sym": n_sym, "max_abs_err": err,
                     "ms": ms, "bound_ms": bms, "bound_by": by})
    return rows


def di_host_split(fasta, in_run):
    """Phase 3f: the device DI of the bench set's reads alone on this
    thread, with nothing else on the card or the host: each read's arena
    filled as run_file fills it, its passes through a make_di_compute_k
    plug-in.  Seconds in all a kind, split by timing stand-ins of
    _Staging.run (the groups' round trips: pinned upload, launch, copy
    back, int64 widening) and of the float64 finish (looked up at call
    time by di_group_device), the rest being the checks, the alphabet and
    the placement.  in_run: the DI seconds of 3c and 3e by kind."""
    import torch

    from mtr_tpu_torch.config import MTRConfig
    from mtr_tpu_torch.io.fasta import iter_fasta
    from mtr_tpu_torch.ops import directional_index as di
    from mtr_tpu_torch.oracle.arena import Arena
    from mtr_tpu_torch.oracle.directional_index import (
        fill_directional_index_with_end,
    )

    cfg = MTRConfig(backend="device")
    reads = [r for r in iter_fasta(fasta, cfg.max_input_length)
             if r.length >= cfg.device_di_threshold]
    real = (di._Staging.run, di._manhattan_finish, di._pearson_finish)
    spent = {}

    def timed(name, fn):
        def call(*args):
            t0 = time.perf_counter()
            res = fn(*args)
            spent[name] = spent.get(name, 0.0) + time.perf_counter() - t0
            return res
        return call

    di._Staging.run = timed("round trips", real[0])
    di._manhattan_finish = timed("finish", real[1])
    di._pearson_finish = timed("finish", real[2])
    res = {}
    arena = Arena(cfg.max_input_length)
    for kind, manhattan in (("l1", True), ("pcc", False)):
        spent.clear()
        plug = timed("all", di.make_di_compute_k(torch.device("cuda"),
                                                 manhattan))
        for read in reads:
            arena.load_read(read.codes)
            L = read.length
            fill_directional_index_with_end(
                arena, L, 100 if L < 1000 else L // 10, manhattan=manhattan,
                di_compute_k=plug)
        split = {k: spent.get(k, 0.0) for k in ("all", "round trips",
                                                  "finish")}
        res[kind] = dict(split, rest=split["all"] - split["round trips"]
                         - split["finish"], in_run=in_run[kind])
    (di._Staging.run, di._manhattan_finish, di._pearson_finish) = real
    for kind, r in res.items():
        name = "Manhattan" if kind == "l1" else "Pearson"
        info(f"bench set, device DI alone ({name}, {len(reads)} reads, one "
             f"thread; {card_line()}): "
             f"{r['all']:.3f} s = round trips {r['round trips']:.3f} + "
             f"finish {r['finish']:.3f} + the rest {r['rest']:.3f}; in the "
             f"device run on the reader thread {r['in_run']:.3f} s")
    return res


def time_di(rows, launches, kind):
    """Phase 4e at the heaviest replayed launch: the kernel (CUDA events),
    the group with its copies (numpy codes
    through pinned memory to the card and the outputs back; host clock), the plain version on the card, the native host
    passes (Manhattan only: the native engine's Pearson pass runs inside
    its whole-read fill_di) and the bound; the run's sums."""
    import torch

    from mtr_tpu_torch import native
    from mtr_tpu_torch.ops import directional_index as di

    name = "Manhattan sliding L1" if kind == "l1" else "Pearson moments"
    sums, _ = report_replay(f"DI {name} kernel", rows,
                            f"di_{kind}_launches.json")
    heavy = max(rows, key=lambda r: r["ms"])
    codes, n_outs, ws, n_sym = launches[heavy["launch"]]
    ms = kernel_ms(bare_di_group(kind, codes, n_outs, ws, n_sym)[0], 20)
    vals = codes.cpu().numpy()
    staging = di._Staging()

    def with_copies():
        staging.run(vals, vals.size, n_outs, ws, n_sym, kind == "pcc",
                    codes.device)

    with_copies()
    t0 = time.perf_counter()
    for _ in range(10):
        with_copies()
    copies_ms = (time.perf_counter() - t0) / 10 * 1e3
    plain_ms = event_ms(lambda: di.plain_group(codes, n_outs, ws, n_sym,
                                               kind == "pcc"), 3)
    host_ms = None
    if kind == "l1":
        t0 = time.perf_counter()
        for n, w in zip(n_outs, ws):
            native.sliding_l1(vals, w, n)
        host_ms = (time.perf_counter() - t0) * 1e3
    bms, by = di_bound(kind, n_outs, ws)
    k = n_sym.bit_length() // 2
    res = {"ms": ms, "copies_ms": copies_ms, "plain_ms": plain_ms,
           "host_ms": host_ms, "bound_ms": bms, "bound_by": by,
           "run_ms": sums, "run_bound_ms": sum(r["bound_ms"] for r in rows),
           "launches": len(rows), "passes": sum(r["passes"] for r in rows),
           "max_abs_err": max(r["max_abs_err"] for r in rows),
           "shape": f"n_sym {n_sym} (k {k}), {len(ws)} passes, w "
                    f"{min(ws)}-{max(ws)}, {sum(n_outs)} positions"}
    host = "no native pass alone" if host_ms is None else \
        f"native sliding L1 {host_ms:.3f} ms over its passes"
    info(f"DI {name} kernel, the device run's {res['launches']} launches of "
         f"{res['passes']} passes ({card_line()}): run bound "
         f"{res['run_bound_ms']:.4f} ms, share "
         f"{res['run_bound_ms'] / res['run_ms']:.4f}; "
         f"max abs err against the plain version {res['max_abs_err']}")
    info(f"  heaviest launch ({res['shape']}): kernel {ms:.4f} ms; with its "
         f"copies {copies_ms:.3f} ms (host clock), plain version "
         f"{plain_ms:.3f} ms, {host}; bound {bms:.5f} ms ({by}), share "
         f"{bms / ms:.4f}")
    return res


def report_replay(name, rows, save):
    """Print a replayed kernel's run sums and heaviest launches; write
    every launch's row to build/chip_smoke/<save>."""
    total, heavy = run_summary(rows)
    out_dir = os.path.join(HERE, "build", "chip_smoke")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, save), "w") as f:
        json.dump(rows, f, indent=1)
    info(f"{name}, the device-whole bench run's {len(rows)} launches "
         f"replayed ({card_line()}): run sum {total:.3f} ms; rows in "
         f"build/chip_smoke/{save}")
    for r in heavy:
        info(f"  heavy launch {r['launch']}: "
             + ", ".join(f"{k} {v}" for k, v in r.items()
                         if k not in ("launch", "ms"))
             + f"; ms {r['ms']:.3f}")
    return total, heavy


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
            (fasta, golden, hybrid_rate, host_rate, counts_launches,
             single) = main_path(tmp)
            walk_bad = walk_vs_references(fasta)
            di_worst, _ = di_vs_plain(tmp)
            one_device = device_path(fasta, golden, hybrid_rate, host_rate)
            launches, spies = device_walk_path(fasta, golden)
            pcc_counts, pcc_launches = pearson_device_path(fasta)
            di_alone = di_host_split(fasta, {
                "l1": launches["di_seconds"],
                "pcc": pcc_counts["di_seconds"]})
            prefilter_path(fasta, golden)
            t_new = time.perf_counter()
            cli_modes(fasta, tmp)
            equality_sets(tmp)
            mesh_launches = mesh_path(fasta, golden, one_device)
            two_proc_s = two_process_path(fasta, golden, single, tmp)
            accuracy_path(tmp)
            info(f"phases 5a-5e: {time.perf_counter() - t_new:.1f} s")
            counts, plain_ms = time_kernel()
        cons_rows = replay_cons(spies.cons)
        walk_rows = replay_walks(spies.walks, WALK_PLAIN_BUDGET_S)
        l1_launches = spies.di_l1
        del spies
        cons_sums, (cons_heavy, *_) = report_replay(
            "consensus kernel", cons_rows, "consensus_launches.json")
        walk_sums, (walk_heavy, *_) = report_replay(
            "walk kernel", walk_rows, "walk_launches.json")
        check(cons_heavy["mismatches"] == 0, "consensus kernel disagrees "
              "with the plain version on the heaviest launch")
        counted = [r for r in walk_rows if "mismatches" in r]
        check("mismatches" in walk_heavy and not any(
            r["mismatches"] for r in counted), "walk kernel disagrees with "
              "walk_rows_plain on the run's launches")
        walk_bound_run = sum(r["bound_ms"] for r in counted)
        lookups = sum(r["lookups"] for r in counted)
        steps = sum(r["plain_steps"] for r in counted)
        info(f"walk kernel bound over the {len(counted)} of {len(walk_rows)} "
             f"launches walk_rows_plain counted ({lookups} lookups, {steps} "
             f"steps, 0 mismatching): {walk_bound_run:.4f} ms; consensus "
             f"bound over the run: "
             f"{sum(r['bound_ms'] for r in cons_rows):.4f} ms")
        l1 = time_di(replay_di(l1_launches, "l1"), l1_launches, "l1")
        pcc = time_di(replay_di(pcc_launches, "pcc"), pcc_launches, "pcc")
        check(max(di_worst, l1["max_abs_err"], pcc["max_abs_err"]) == 0,
              "a DI kernel disagrees with its plain version on the run's "
              "passes")
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    info(f"chip_smoke: all phases passed in "
         f"{time.perf_counter() - t_all:.1f} s")
    c200 = counts[200]

    def heaviest(r, keys):
        return {k: r[k] for k in keys if k in r}

    # no single PyTorch call computes any of these functions: library_ms
    # is null
    print(json.dumps({"kernels": [{
        "name": "wrap_dp_counts",
        "route": "cuda",
        "source": "mtr_tpu_torch/csrc/wrap_dp_counts.cu",
        "replaces": REPLACES,
        "launches": counts_launches,
        "mesh_launches": mesh_launches["counts"],
        "max_abs_err": worst,
        "ms": c200["ms"],
        "plain_ms": plain_ms,
        "bound_ms": c200["bound_ms"],
        "bound_by": c200["bound_by"],
        "library_ms": None,
        "shape": "unit 200 x rep_len 32768 x 1024 jobs",
        "ms_at_unit_100": counts[100]["ms"],
        "ms_at_unit_400": counts[400]["ms"],
    }, {
        "name": "wrap_dp_consensus",
        "route": "cuda",
        "source": "mtr_tpu_torch/csrc/wrap_dp_consensus.cu",
        "replaces": CONS_REPLACES,
        "launches": launches["consensus"],
        "mesh_launches": mesh_launches["consensus"],
        "max_abs_err": max(cons_worst, cons_heavy["max_abs_err"]),
        "ms": cons_heavy["ms"],
        "plain_ms": cons_heavy["plain_ms"],
        "bound_ms": cons_heavy["bound_ms"],
        "bound_by": cons_heavy["bound_by"],
        "library_ms": None,
        "run_ms": cons_sums,
        "run_bound_ms": sum(r["bound_ms"] for r in cons_rows),
        "heaviest_launch": heaviest(cons_heavy, (
            "launch", "jobs", "u_span", "max_rep_len", "max_unit",
            "cells")),
    }, {
        "name": "dbg_walk",
        "route": "cuda",
        "source": "mtr_tpu_torch/csrc/dbg_walk.cu",
        "replaces": WALK_REPLACES,
        "launches": launches["dbg_walk"],
        "max_abs_err": None,
        "mismatches": walk_bad + sum(r["mismatches"] for r in counted),
        "ms": walk_heavy["ms"],
        "plain_ms": walk_heavy["plain_ms"],
        "bound_ms": walk_heavy["bound_ms"],
        "bound_by": walk_heavy["bound_by"],
        "library_ms": None,
        "run_ms": walk_sums,
        "run_bound_ms": walk_bound_run,
        "run_bound_launches": len(counted),
        "heaviest_launch": heaviest(walk_heavy, (
            "launch", "rows", "gated", "v_pad", "row_entries",
            "plain_steps", "lookups")),
    }] + [{
        "name": name,
        "route": "cuda",
        "source": DI_SOURCE,
        "replaces": DI_REPLACES[kind],
        "launches": count,
        "max_abs_err": max(di_worst, r["max_abs_err"]),
        "ms": r["ms"],
        "plain_ms": r["plain_ms"],
        "bound_ms": r["bound_ms"],
        "bound_by": r["bound_by"],
        "library_ms": None,
        "run_ms": r["run_ms"],
        "run_bound_ms": r["run_bound_ms"],
        "passes": passes,
        "launches_replayed": r["launches"],
        "passes_replayed": r["passes"],
        "ms_with_copies": r["copies_ms"],
        "host_ms": r["host_ms"],
        "shape": r["shape"],
        "bench_di_alone_s": di_alone[kind],
    } for name, kind, count, passes, r in (
        ("di_sliding_l1", "l1", launches["di_l1_kernel"], launches["di"], l1),
        ("di_pearson_moments", "pcc", pcc_counts["di_pcc_kernel"],
         pcc_counts["di"], pcc))],
        "mesh": {"slots": list(MESH_SLOTS),
                 "di_sharded_passes": mesh_launches["di_sharded"]},
        "two_process_s": two_proc_s,
        "one_process_hybrid_s": single["hybrid_s"]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
