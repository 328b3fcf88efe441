"""Cross-read repeat-unit clustering — the reference's legacy phase 2
(k_means_clustering.c, unlinked from the current binary; see SURVEY.md
2.12).  This is the only cross-read computation in the system and hence
the natural all-gather point in a multi-host run.

Algorithm (faithful to the reference's live code — despite the filename
there is no Lloyd k-means):
  1. qualify TRs (unit span > min_rep_len, match ratio, >1 unit copies);
  2. sort by (rep_period, freq_2mer[16], num_freq_unit);
  3. group identical (rep_period, freq_2mer) keys with group size >=
     min_num_rep_tr; the LAST member represents the group
     (k_means_clustering.c:136-167);
  4. merge groups whose unit lengths differ <= 10% and whose 2-mer
     histograms lie within Manhattan distance 0.3 * rep_period,
     pointing each group at its largest neighbor, then chase roots and
     accumulate frequencies (:169-233);
  5. emit records sorted by (-group_freq, group_root_id).

The pairwise Manhattan distances in step 4 are one batched |a-b|
reduction over the (G, 16) histogram matrix, in plain PyTorch on the
run's device (the CUDA card under backends auto / hybrid / device, the
CPU under host / oracle), in exact int32 arithmetic.  In a multi-process
run `gather_records_multihost` all-gathers every process's records over
torch.distributed first.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from mtr_tpu_torch.records import RepeatRecord

MH_DISTANCE_THRESHOLD = 0.3   # chaining.cpp:39 / k_means_clustering.c:176
MIN_NUM_REP_TR = 2            # minimum group size for a representative
MIN_REP_LEN = 10              # qualification span threshold


def _near_matrix(hists: np.ndarray, periods: np.ndarray,
                 device="cpu") -> np.ndarray:
    """Pairwise merge-eligibility matrix: (G, G) Manhattan distances over
    the 2-mer histograms plus the reference's <=10% unit-length gate
    (k_means_clustering.c:169-180), both in exact integer arithmetic
    (d <= 0.1p <=> 10d <= p), computed on `device`."""
    import torch

    h = torch.as_tensor(np.asarray(hists, np.int32), device=device)
    p = torch.as_tensor(np.asarray(periods, np.int32), device=device)
    dist = torch.zeros((len(h), len(h)), dtype=torch.int32, device=device)
    for col in range(h.shape[1]):  # (G, G) at a time, not a (G, G, 16) cube
        dist += (h[:, None, col] - h[None, :, col]).abs()
    len_ok = 10 * (p[:, None] - p[None, :]).abs() <= p[:, None]
    return ((10 * dist <= 3 * p[:, None]) & len_ok).cpu().numpy()


@dataclasses.dataclass
class ClusteredTR:
    record: RepeatRecord
    global_id: int
    rep_id: int      # root representative's global id
    group_freq: int  # size of the merged group


def _sort_key(rec: RepeatRecord):
    return (rec.rep_period, tuple(rec.freq_2mer), rec.num_freq_unit)


def cluster_repeats(
    records: list[RepeatRecord],
    min_match_ratio: float = 0.6,
    min_num_rep_tr: int = MIN_NUM_REP_TR,
    device="cpu",
) -> list[ClusteredTR]:
    """Cluster the records' units; the near matrix runs on `device`."""
    # 1. qualification (k_means_clustering.c:267-283)
    qualified: list[tuple[int, RepeatRecord]] = []
    for gid, rec in enumerate(records):
        if rec.repeat_len <= 0:
            continue
        ratio = rec.num_matches / rec.repeat_len
        if (
            rec.rep_period * rec.num_freq_unit > MIN_REP_LEN
            and ratio > min_match_ratio
            and rec.num_freq_unit > 1
        ):
            qualified.append((gid, rec))
    if not qualified:
        return []

    # 2. sort by (period, 2-mer histogram, unit count)
    qualified.sort(key=lambda t: _sort_key(t[1]))

    # 3. group identical (period, histogram) keys
    groups: list[dict] = []  # {"members": [...], "rep": gid, "freq": n}
    cur: list[tuple[int, RepeatRecord]] = []

    def flush_group():
        if len(cur) >= min_num_rep_tr:
            groups.append(
                {"members": list(cur), "rep_idx": len(groups), "freq": len(cur)}
            )

    for item in qualified:
        if cur and _sort_key(item[1])[:2] != _sort_key(cur[-1][1])[:2]:
            flush_group()
            cur = []
        cur.append(item)
    flush_group()
    if not groups:
        return []

    # 4. merge near-identical groups (vectorized pairwise Manhattan)
    periods = np.array([g["members"][-1][1].rep_period for g in groups])
    hists = np.array(
        [g["members"][-1][1].freq_2mer for g in groups], dtype=np.int64
    )
    freqs = np.array([g["freq"] for g in groups])
    n = len(groups)
    near = _near_matrix(hists, periods, device)

    parent = np.arange(n)
    for i in range(n):
        cand = np.nonzero(near[i])[0]
        best = i
        best_freq = freqs[i]
        for j in cand:
            if freqs[j] > best_freq:
                best_freq = freqs[j]
                best = int(j)
        parent[i] = best

    def root(i: int) -> int:
        while parent[i] != i:
            i = int(parent[i])
        return i

    group_freq = freqs.copy()
    for i in range(n):
        r = root(i)
        if r != i:
            group_freq[r] += freqs[i]

    # 5. emit, sorted by (-merged group freq, root id)
    out: list[ClusteredTR] = []
    for i, g in enumerate(groups):
        r = root(i)
        rep_gid = groups[r]["members"][-1][0]
        for gid, rec in g["members"]:
            out.append(
                ClusteredTR(
                    record=rec,
                    global_id=gid,
                    rep_id=rep_gid,
                    group_freq=int(group_freq[r]),
                )
            )
    out.sort(key=lambda c: (-c.group_freq, c.rep_id, c.global_id))
    return out


PACKED_COLUMNS = 20  # period, unit count, matches, repeat length, 16 2-mers


def pack_records(records: list[RepeatRecord]) -> np.ndarray:
    """(n, 20) int32: the fields cluster_repeats reads, one row a record."""
    if not records:
        return np.zeros((0, PACKED_COLUMNS), np.int32)
    return np.array(
        [[rec.rep_period, rec.num_freq_unit, rec.num_matches, rec.repeat_len]
         + list(rec.freq_2mer) for rec in records], dtype=np.int32)


def gather_records_multihost(local_records: list[RepeatRecord]):
    """All-gather fixed-width record arrays across a torch.distributed run
    so every process can run cluster_repeats on the full set, in rank
    order.  Processes hold different numbers of records: the counts are
    gathered first, the rows padded to the largest, gathered once, and
    stripped.  With one process, or no process group, this is the
    identity."""
    import torch
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()
            and dist.get_world_size() > 1):
        return local_records
    world = dist.get_world_size()
    packed = torch.from_numpy(pack_records(local_records))
    counts = [torch.zeros(1, dtype=torch.int64) for _ in range(world)]
    dist.all_gather(counts, torch.tensor([len(packed)], dtype=torch.int64))
    counts = [int(c) for c in counts]
    padded = torch.zeros((max(counts), PACKED_COLUMNS), dtype=torch.int32)
    padded[: len(packed)] = packed
    rows = [torch.empty_like(padded) for _ in range(world)]
    dist.all_gather(rows, padded)
    out = []
    for n, part in zip(counts, rows):
        for row in part[:n].tolist():
            rec = RepeatRecord()
            rec.rep_period, rec.num_freq_unit = row[0], row[1]
            rec.num_matches, rec.repeat_len = row[2], row[3]
            rec.freq_2mer = row[4:PACKED_COLUMNS]
            out.append(rec)
    return out
