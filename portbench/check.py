"""What decides `correct`: the records the port wrote for a sample of the
window's reads, drawn from the seed with the longest read in it, against
the plain reference (portbench/reference, NumPy only) on the same reads.

The port keeps mTR's per-file buffers (the arena): a read's DI windows
can reach past its own random flanks into what earlier reads left there,
and the DP reads one base past a range.  So the reference replays the
arena writes of every read the port read before a sampled one (the read
codes, and the DI's last pass, k = 5, over the flanks), then runs the
sampled read.  Each sampled read is one task in a pool of worker
processes (spawned: they import NumPy and the reference, nothing else).

Two numbers are compared, each an exact comparison with the limit 0:
  * `mismatched_reads`: sampled reads whose record lines differ in any
    byte from the reference's, or that the port never emitted;
  * `mismatched_di_reads`: sampled reads whose candidate ranges out of
    the directional index (each position with a range, its end, its
    window and its float64 DI value, bit for bit) differ from the
    reference's.  The records alone cannot tell a float32 DI finish from
    mTR's float64 one under the Manhattan DI; the values can.
"""

from __future__ import annotations

import multiprocessing
import os

import numpy as np

LIMITS = {"mismatched_reads": 0, "mismatched_di_reads": 0}


def di_ranges(di, di_end, di_w, input_len: int):
    """The candidate ranges of a read's DI, as compared: (positions,
    ends, windows, values) of every position in the read with a range."""
    pos = np.nonzero(di[:input_len] != -1.0)[0]
    return (pos.astype(np.int64), np.asarray(di_end)[pos].astype(np.int64),
            np.asarray(di_w)[pos].astype(np.int64), np.asarray(di)[pos].astype(np.float64))


def same_ranges(a, b) -> bool:
    return a is not None and b is not None and all(
        x.shape == y.shape and np.array_equal(x, y) for x, y in zip(a, b))


def parse_record(rec: bytes) -> tuple[str, np.ndarray]:
    """(read id, base codes) of one FASTA record of the generator (a
    header line and one sequence line)."""
    from portbench.reference.encoding import encode_bases

    head, seq = rec.split(b"\n", 2)[:2]
    return head[1:].decode("ascii"), encode_bases(seq)


def reference_lines(records: list[bytes], manhattan: bool = True,
                    precision: str = "float64"):
    """The reference's record lines and DI ranges (di_ranges) for the last
    of `records`, after the arena writes of those before it, in the order
    the port read them."""
    from portbench.reference.arena import Arena
    from portbench.reference.directional_index import init_input_w_rand
    from portbench.reference.read import handle_one_read

    arena = Arena()
    for rec in records[:-1]:
        _rid, codes = parse_record(rec)
        arena.load_read(codes)
        L = len(codes)
        init_input_w_rand(arena, 5, L, 100 if L < 1000 else L // 10)
    rid, codes = parse_record(records[-1])
    arena.load_read(codes)
    ranges = []
    recs = handle_one_read(
        arena, rid, len(codes), manhattan=manhattan, dtype=np.dtype(precision).type,
        on_ranges=lambda d, e, w: ranges.append(di_ranges(d, e, w, len(codes))))
    return [r.format_record() for r in recs], ranges[0]


def _task(args):
    return reference_lines(*args)


def reference_pool(tasks, workers: int | None = None) -> list[list[str]]:
    """reference_lines over `tasks` in spawned worker processes, results
    in task order; every worker has ended when this returns."""
    if not tasks:
        return []
    n = max(1, min(len(tasks), workers or os.cpu_count() or 1))
    if n == 1:
        return [_task(t) for t in tasks]
    ctx = multiprocessing.get_context("spawn")
    with ctx.Pool(n) as pool:
        out = pool.map(_task, tasks, chunksize=1)
        pool.close()
        pool.join()
    return out


def sample_reads(n_done: int, lengths: list[int], n_sample: int, seed: int) -> list[int]:
    """`n_sample` of the first n_done reads, drawn from the seed, with
    the longest (the first of equals) in it."""
    if n_done <= 0:
        return []
    rng = np.random.default_rng([seed % (1 << 64), 1])
    longest = int(np.argmax(lengths[:n_done]))
    rest = [i for i in rng.permutation(n_done).tolist() if i != longest]
    return sorted([longest] + rest[: max(0, n_sample - 1)])


def replay_records(sequence, i: int) -> list[bytes]:
    """The records whose arena writes still show when the port reads its
    i-th record, then that record: read j's writes (a prefix of each
    buffer, longer for a longer read) show unless a later read before i
    is at least as long, so the writes of the rest change nothing."""
    keep = []
    longest = -1
    for j in range(i - 1, -1, -1):
        rec = sequence(j)
        n = len(rec) - rec.index(b"\n") - 2  # the read's bases
        if n > longest:
            keep.append(rec)
            longest = n
    return keep[::-1] + [sequence(i)]


def compare(program: dict[int, list[str]], program_ranges: dict, sequence, sample,
            manhattan: bool, precision: str = "float64", workers: int | None = None):
    """Check the sampled reads: `sequence(i)` is the i-th FASTA record the
    port read, `program[i]` its record lines and `program_ranges[i]` its
    di_ranges.  Returns (reads whose records differ, reads whose ranges
    differ)."""
    tasks = [(replay_records(sequence, i), manhattan, precision) for i in sample]
    ref = dict(zip(sample, reference_pool(tasks, workers)))
    bad = [i for i in sample if program.get(i) != ref[i][0]]
    bad_di = [i for i in sample if not same_ranges(program_ranges.get(i), ref[i][1])]
    return bad, bad_di
