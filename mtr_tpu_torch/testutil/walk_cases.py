"""Walk-stage references and cases for the row walk (ops/dbg_device
walk_rows), shared by tests/test_torch_dbg_device.py and chip_smoke.py.

speculative_rows restates the earlier device design on a chunk's stage-A
outputs: every listed max node of every gated row walked in both
directions (stage_b_plain), then on the host the first found rank of each
(row, direction) wins, a row is bad when a walk overflowed at or before
its winner (or anywhere without one), and each winning row is cut to its
period, reversed for backward walks.  rows_of reads the row walk's
outputs into the same per-row form, canonical reads a whole batch's
result dict (either form) per query.  edge_chunk builds a chunk of rows
with chosen max-node lists: overflows before, at and after the winner,
no winner with and without an overflow, winners in later rank groups and
walks of period 500.
"""

from __future__ import annotations

import numpy as np
import torch

from mtr_tpu_torch.ops import dbg_device as dw

P = dw.MAX_PERIOD


def _cut(rows: np.ndarray, p: np.ndarray, reverse: bool) -> np.ndarray:
    """rows (N, 500) cut to each row's first p entries (zero after), the
    first p reversed for backward walks."""
    col = np.arange(P)[None, :]
    if reverse:
        rows = np.take_along_axis(rows, np.clip(p[:, None] - 1 - col, 0, None),
                                  1)
    return np.where(col < p[:, None], rows, 0)


def _empty(q: int) -> dict:
    out = {key: np.zeros(q, np.int64) for key in
           ("fwd_period", "bwd_period", "found_last")}
    out["bad"] = np.zeros(q, bool)
    for d in ("fwd", "bwd"):
        for key in ("units", "scores"):
            out[f"{d}_{key}"] = np.zeros((q, P), np.int64)
    return out


def speculative_rows(sv, sc, maxfreq, nodes, n_nodes, k, lmax) -> dict:
    """The earlier design's result per row of one chunk (CPU tensors as
    walk_rows takes them): fwd_period, bwd_period, found_last, bad (Q,)
    and fwd/bwd units/scores (Q, 500), cut and oriented.  Rows that are
    bad keep only the flag."""
    q = sv.shape[0]
    out = _empty(q)
    gated = np.nonzero(maxfreq.numpy() > dw.MIN_NUM_FREQ_UNIT)[0]
    if not len(gated):
        return out
    nn = np.minimum(n_nodes.numpy()[gated].astype(np.int64),
                    dw.MAX_NUM_MAXNODES)
    nodes_g = nodes.numpy()[gated]
    per = 2 * nn
    grp = np.repeat(np.arange(len(gated)), per)
    within = np.arange(int(per.sum())) - np.repeat(np.cumsum(per) - per, per)
    is_fwd = within < nn[grp]
    rank = np.where(is_fwd, within, within - nn[grp])
    tq = gated[grp]
    job = [torch.from_numpy(a.astype(np.int32)) for a in
           (tq, nodes_g[grp, rank], is_fwd)]
    found, period, units, scores, ovf = (t.numpy() for t in dw.stage_b_plain(
        sv, sc, *job, k[tq], lmax[tq]))
    size = np.repeat(nn, 2)
    start = np.cumsum(size) - size
    big = np.int64(1) << 40
    win = np.minimum.reduceat(np.where(found, rank, big), start)
    bad = np.logical_or.reduceat(ovf & (rank <= np.repeat(win, size)), start)
    bad_q = bad[0::2] | bad[1::2]
    out["bad"][gated] = bad_q
    for d, name in ((0, "fwd"), (1, "bwd")):
        has = ~bad_q & (win[d::2] < big)
        wj = start[d::2][has] + win[d::2][has]
        p = period[wj].astype(np.int64)
        rows = gated[has]
        out[f"{name}_period"][rows] = p
        out[f"{name}_units"][rows] = _cut(units[wj], p, d == 1)
        out[f"{name}_scores"][rows] = _cut(scores[wj], p, d == 1)
        if d == 1:
            out["found_last"][rows] = 1
    return out


def _gather_rows(units, scores, off, period):
    """(N, 500) rows from flat units / scores at off, each period long."""
    n = len(off)
    col = np.arange(P)[None, :]
    has = off >= 0
    keep = has[:, None] & (col < period[:, None])
    idx = np.where(keep, off[:, None] + col, 0)
    u = np.where(keep, np.asarray(units, np.int64)[idx] if len(units) else 0,
                 0)
    s = np.where(keep, np.asarray(scores, np.int64)[idx] if len(scores)
                 else 0, 0)
    return u.reshape(n, P), s.reshape(n, P)


def rows_of(tab, off, units, scores) -> dict:
    """walk_rows' outputs (tab (Q, 4), off (Q, 2), the row buffers) in
    speculative_rows' form: rows that are bad keep only the flag."""
    tab, off = np.asarray(tab, np.int64), np.asarray(off, np.int64)
    q = len(tab)
    out = _empty(q)
    bad = tab[:, 3] != 0
    out["bad"] = bad
    good = ~bad
    for j, key in enumerate(("fwd_period", "bwd_period", "found_last")):
        out[key] = np.where(good, tab[:, j], 0)
    for j, d in enumerate(("fwd", "bwd")):
        o = np.where(good, off[:, j], -1)
        out[f"{d}_units"], out[f"{d}_scores"] = _gather_rows(
            units, scores, o, out[f"{d}_period"])
    return out


def run_rows(sv, sc, maxfreq, nodes, n_nodes, k, lmax) -> dict:
    """walk_rows on one chunk (all on the tables' device), its outputs
    read back in speculative_rows' form."""
    q, dev = sv.shape[0], sv.device
    cap = max(1, 2 * int(lmax.clamp(min=0).sum()))
    tab = torch.empty((q, 4), dtype=torch.int32, device=dev)
    off = torch.empty((q, 2), dtype=torch.int64, device=dev)
    units = torch.zeros(cap, dtype=torch.uint8, device=dev)
    scores = torch.zeros(cap, dtype=torch.int32, device=dev)
    used = torch.zeros(1, dtype=torch.int64, device=dev)
    dw.walk_rows(sv, sc, maxfreq, nodes, n_nodes, k, lmax, tab, off, units,
                 scores, used)
    m = int(used.cpu()[0])
    return rows_of(tab.cpu(), off.cpu(), units[:m].cpu().numpy(),
                   scores[:m].cpu().numpy())


def differing(got: dict, want: dict) -> list[str]:
    """The fields of two per-row results that differ."""
    return [key for key in want if not np.array_equal(got[key], want[key])]


def canonical(res, n: int) -> dict:
    """Per-query view of a batch's walk result in either form (row numbers
    and offsets differ between engines): found_last, periods, and each
    direction's unit / score row cut to its period (zeros without one)."""
    if "fwd_row" in res:
        res = dw.flat_rows(res)
    out = {key: np.asarray(res[key][:n]) for key in
           ("found_last", "fwd_period", "bwd_period")}
    for d in ("fwd", "bwd"):
        off = np.asarray(res[f"{d}_off"][:n], np.int64)
        out[f"{d}_has"] = off >= 0
        out[f"{d}_units"], out[f"{d}_scores"] = _gather_rows(
            res["units"], res["scores"], off, out[f"{d}_period"])
    return out


def chunks_of(orgs, lens, queries, device="cpu"):
    """(v_pad, chunk) per chunk of the queries (read, qs, qe, k), as
    dbg_walk_device_batch cuts them (bucket_chunks; ranges wider than V_MAX
    are left out): stage A's outputs and each row's k
    and lmax on `device`, the arguments walk_rows takes (without its
    outputs)."""
    q = np.asarray(queries, np.int64).reshape(-1, 4)
    ridx, qs, qe, k = q.T
    V = qe - qs + 1
    n_code = np.minimum(qe, np.asarray(lens, np.int64)[ridx] - k + 1) - qs
    lmax = np.minimum(P, (qe - qs) // dw.MIN_NUM_FREQ_UNIT)
    flat, offs = dw.upload_reads(orgs, device)
    reach = np.nonzero(V <= dw.V_MAX)[0]

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(device)

    for v_pad, c in dw.bucket_chunks(reach, V, dw.V_MAX):
        tabs = dw.stage_a(flat, torch.from_numpy(offs[ridx[c]] + qs[c]).to(
            device), put(n_code[c]), put(V[c]), put(k[c]), v_pad)
        yield v_pad, (*tabs, put(k[c]), put(lmax[c]))


def batch_queries(fasta, max_reads=None):
    """A batch of a FASTA as run_file cuts it (oracle DI) and its wave-1
    walk queries: (orgs, lens, (ridx, qs, qe, w, k))."""
    from mtr_tpu_torch.config import MTRConfig
    from mtr_tpu_torch.io.fasta import iter_fasta
    from mtr_tpu_torch.oracle.arena import Arena
    from mtr_tpu_torch.oracle.directional_index import (
        fill_directional_index_with_end,
    )
    from mtr_tpu_torch.pipeline import ReadState, _collect_queries

    cfg = MTRConfig(backend="device")
    cap = max_reads or cfg.reads_per_batch
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
        if len(states) >= cap or bases >= cfg.bases_per_batch:
            break
    orgs = [st.org for st in states]
    lens = [st.read.length for st in states]
    return orgs, lens, _collect_queries(states, cfg)


# ------------------------------------------------------------- edge chunk


def _read(rng, L, unit_len, noise):
    unit = rng.integers(0, 4, unit_len)
    seq = np.tile(unit, L // unit_len + 1)[:L].copy()
    n_err = int(L * noise)
    if n_err:
        idx = rng.integers(0, L, n_err)
        seq[idx] = rng.integers(0, 4, n_err)
    return np.concatenate([seq, [0]]).astype(np.int64)


def _tables(orgs, queries, v_pad):
    ridx, qs, qe, k = (np.array([q[i] for q in queries], np.int64)
                       for i in range(4))
    lens = np.array([len(o) - 1 for o in orgs], np.int64)
    flat, offs = dw.upload_reads(orgs, "cpu")
    n_code = np.minimum(qe, lens[ridx] - k + 1) - qs

    def put(a):
        return torch.from_numpy(a.astype(np.int32))

    tabs = dw.stage_a(flat, torch.from_numpy(offs[ridx] + qs), put(n_code),
                      put(qe - qs + 1), put(k), v_pad)
    lmax = np.minimum(P, (qe - qs) // dw.MIN_NUM_FREQ_UNIT)
    return tabs, put(k), put(lmax)


def _classes(sv, sc, row, codes, k, lmax):
    """Per start code and direction of one table row: found, ovf."""
    n = len(codes)
    tq = torch.full((2 * n,), row, dtype=torch.int32)
    node0 = torch.from_numpy(np.tile(codes, 2).astype(np.int32))
    fwd = torch.from_numpy(np.repeat([1, 0], n).astype(np.int32))
    kk = torch.full((2 * n,), int(k), dtype=torch.int32)
    ll = torch.full((2 * n,), int(lmax), dtype=torch.int32)
    f, _, _, _, o = dw.stage_b_plain(sv, sc, tq, node0, fwd, kk, ll)
    f, o = f.numpy().reshape(2, n), o.numpy().reshape(2, n)
    return f, o


def _pad(t, v_pad, fill):
    if t.shape[1] == v_pad:
        return t
    out = torch.full((t.shape[0], v_pad), fill, dtype=t.dtype)
    out[:, : t.shape[1]] = t
    return out


EDGE_KINDS = ("ovf_before_winner", "ovf_at_winner", "ovf_after_winner",
              "no_winner_ovf", "no_winner_clean", "winner_in_group_2",
              "winner_in_group_3", "winner_past_rank_8", "period_500")


# a k-3 table (counts of the 64 3-mers) on which the backward walk from
# node 10 overflows its tie list and still loops (period 14): found by a
# search over random 0/1 tables
TIE_TABLE = (
    0, 0, 1, 1, 0, 1, 1, 1, 0, 1, 1, 0, 0, 1, 1, 1, 1, 0, 1, 1, 0, 1, 0, 0,
    1, 1, 1, 0, 0, 1, 1, 0, 0, 0, 1, 1, 0, 1, 0, 1, 1, 0, 1, 1, 1, 0, 1, 1,
    1, 0, 1, 1, 0, 1, 1, 0, 0, 0, 1, 1, 1, 0, 1, 1)
TIE_NODE, TIE_K, TIE_LMAX = 10, 3, 60


def _tie_row(v_pad):
    """TIE_TABLE as one stage-A row: sorted values, counts, maxfreq 6."""
    codes = np.nonzero(TIE_TABLE)[0].astype(np.int32)
    sv = torch.full((1, v_pad), dw.INT_MAX, dtype=torch.int32)
    sc = torch.zeros((1, v_pad), dtype=torch.int32)
    sv[0, : len(codes)] = torch.from_numpy(codes)
    sc[0, : len(codes)] = 1
    return sv, sc


def edge_chunk(v_pad: int = 4096):
    """One chunk of rows (CPU tensors as walk_rows takes them, tables
    padded to v_pad) with chosen max-node lists, each row's kind
    (EDGE_KINDS) and expected (bad, fwd winner rank, bwd winner rank; -1
    without one) under the rank-group rule.

    Start codes come from a noisy unit-37 read at k 9 (its listed nodes,
    other k-mers of the range, codes absent from it) and are classed by
    their walks: L found without an overflow both ways, O overflowing
    forward without a loop, N neither found nor overflowing both ways.
    The overflow at the winner is TIE_TABLE's backward walk.  The
    period-500 rows walk a clean unit-500 read at k 13 (every walk loops
    at step 500: no unit)."""
    rng = np.random.default_rng(1601)
    orgs = [_read(rng, 1400, 37, 0.04), _read(rng, 3600, 500, 0.0)]
    queries = [(0, 20, 1300, 9), (1, 0, 3550, 13)]
    (sv, sc, maxfreq, nodes, n_nodes), k, lmax = _tables(orgs, queries,
                                                        v_pad)
    row_sv, row_nodes = sv[0].numpy(), nodes[0].numpy()
    present = np.unique(row_sv[row_sv != dw.INT_MAX])
    absent = np.setdiff1d(rng.integers(0, 4**9, 400), present)[:60]
    codes = np.concatenate([row_nodes[row_nodes >= 0],
                            rng.choice(present, 200, replace=False),
                            absent])
    f, o = _classes(sv, sc, 0, codes, k[0], lmax[0])
    cls = {
        "L": codes[f[0] & f[1] & ~o[0] & ~o[1]],
        "O": codes[o[0] & ~f[0]],
        "N": codes[~f[0] & ~f[1] & ~o[0] & ~o[1]],
    }
    for name, c in cls.items():
        if len(c) < 2:
            raise RuntimeError(f"edge_chunk: under two start codes of "
                               f"class {name}")
    L, O, N = (cls[c] for c in "LON")
    # the three source rows: the unit-37 read, the unit-500 read, TIE_TABLE
    tie_sv, tie_sc = _tie_row(v_pad)
    sv = torch.cat([sv, tie_sv])
    sc = torch.cat([sc, tie_sc])
    maxfreq = torch.cat([maxfreq, torch.tensor([6], dtype=torch.int32)])
    k = torch.cat([k, torch.tensor([TIE_K], dtype=torch.int32)])
    lmax = torch.cat([lmax, torch.tensor([TIE_LMAX], dtype=torch.int32)])
    # (kind, source row, node list, expected (bad, fwd rank, bwd rank))
    lists = [
        ("ovf_before_winner", 0, [O[0], L[0]], (True, -1, -1)),
        ("ovf_before_winner", 0, [N[0], O[1], L[1]], (True, -1, -1)),
        ("ovf_at_winner", 2, [TIE_NODE], (True, -1, -1)),
        ("ovf_after_winner", 0, [L[0], O[0]], (False, 0, 0)),
        ("ovf_after_winner", 0, [L[0], L[1], O[0], O[1]], (False, 0, 0)),
        # past the winner, walks that run to lmax (stopped early on the card)
        ("ovf_after_winner", 0, [N[0], L[0]] + [O[0], O[1], N[1]] * 2,
         (False, 1, 1)),
        ("no_winner_ovf", 0, [O[0]], (True, -1, -1)),
        ("no_winner_ovf", 0, [N[0], O[0], N[1]], (True, -1, -1)),
        ("no_winner_clean", 0, [N[0]], (False, -1, -1)),
        ("no_winner_clean", 0, list(N[:5]), (False, -1, -1)),
        ("winner_in_group_2", 0, [N[0], N[1], L[0]], (False, 2, 2)),
        ("winner_in_group_2", 0, [N[0], N[1], N[0], L[0], O[0]],
         (False, 3, 3)),
        ("winner_in_group_3", 0, [N[0]] * 4 + [L[1]], (False, 4, 4)),
        # the second group of eight (tables from WIDE_V up)
        ("winner_past_rank_8", 0, [N[0], N[1]] * 4 + [N[2], L[0], O[0]],
         (False, 9, 9)),
        # the unit-500 read: its first six listed nodes, and the first alone
        ("period_500", 1, list(nodes[1, :6].numpy()), (False, -1, -1)),
        ("period_500", 1, [int(nodes[1, 0])], (False, -1, -1)),
    ]
    idx = torch.tensor([src for _, src, _, _ in lists])
    out_nodes = torch.full((len(lists), dw.MAX_NUM_MAXNODES), -1,
                           dtype=torch.int32)
    out_nn = torch.zeros(len(lists), dtype=torch.int32)
    for r, (_, _, lst, _) in enumerate(lists):
        out_nodes[r, : len(lst)] = torch.tensor(lst, dtype=torch.int32)
        out_nn[r] = len(lst)
    chunk = (sv[idx].contiguous(), sc[idx].contiguous(), maxfreq[idx].clone(),
             out_nodes, out_nn, k[idx].clone(), lmax[idx].clone())
    return chunk, [kind for kind, *_ in lists], [e for *_, e in lists]
