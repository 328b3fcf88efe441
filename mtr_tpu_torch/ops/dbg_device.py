"""De Bruijn unit inference on a torch device: the counterpart of
mtr_tpu/ops/dbg_device.py (k-mer tables, max-node lists and the greedy
lookahead walks of consensus.c:37-582).

Stage A (tables), plain PyTorch on any device: for a chunk of (read,
range, k) queries, the k-mer multiset the reference counts (rolling codes
over [qs, min(qe, L-k+1)), RAW bases on the tail up to qe: the
consensus.c:42-57 quirk), padded with INT_MAX, sorted per row with a
stable sort; run counts from cummax / a flipped cummin; the max-node list
in first-occurrence order, capped at 100, and the listed nodes'
decremented counts in the live table (consensus.c:156-164, 199-222).

Stage B (walks), settled per row: for every gated query (maxfreq >
MIN_NUM_FREQ_UNIT) and direction, the listed max nodes are walked in rank
order, walk_group(v_pad) at a time, until a group in which some walk
loops; the lowest looping rank wins.  The reference walks the nodes in turn and stops
at the first loop (consensus.c:534-573), so this is its winner.  CUDA
tensors launch csrc/dbg_walk.cu (a block per row, reading stage A's
outputs where they lie; the winning rows cut to their periods on the
card); CPU tensors run walk_rows_plain, stage_b_plain's walks (the
vectorised port of JAX's two fori_loops) in the same rank groups.

dbg_walk_device_batch drives both: one upload a call, stage A and the
row kernel a chunk (bucket_chunks) without waiting, and one pull of the
per-query table and one of the rows at the end (walk_waits counts the
two waits).  The device keeps tie lists of T_DEV = 32 against the
reference's 1,024: a query whose tie list overflows at or before its
winning node, and a query outside the device envelope (range wider than
V_MAX), goes to the host engine, in one native.dbg_walk_batch2 call for
the whole batch, so the output stays exact.

V_BUCKETS are powers of two, sized for the card's memory rather than for
a compile cache: a chunk holds about CHUNK_ELEMS table elements, so the
widest bench range (38,371 bases, bucket 65,536) runs on the card.
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np
import torch

from mtr_tpu_torch.utils.timers import TIMERS

MAX_PERIOD = 500
MIN_NUM_FREQ_UNIT = 5
MAX_NUM_MAXNODES = 100
T_DEV = 32              # device tie-list cap: one tie per warp lane
KMAX = 15               # the Horner gather's depth (maxKmer, mTR.h)
INT_MAX = 2**31 - 1
V_BUCKETS = tuple(1 << s for s in range(6, 17))   # 64 .. 65,536
V_MAX = V_BUCKETS[-1]   # widest range walked on the device
CHUNK_ELEMS = 1 << 23   # stage-A table elements per chunk
WIDE_V = 1 << 13        # table width from which a direction walks 8 at once

# stage-A passes and walk-kernel launches are TIMERS.counters
# "stage_a_calls" and "launch.dbg_walk" (the main path shows it ran here);
# "walk_device_calls", "walk_waits" and "walk_rows_bytes" count the device
# route's calls, its waits for the card and the winning rows' bytes pulled.
# PLAIN_WORK: work of stage_b_plain's walks since the last reset, table
# lookups and walk steps; walk_rows_plain adds only the walks a row needs,
# those up to its winner in each direction (the walk kernel's bound in
# chip_smoke.py counts them)
PLAIN_WORK = {"lookups": 0, "steps": 0}


def walk_group(v_pad: int) -> int:
    """Max nodes a direction walks at once at table width v_pad (the row
    kernel's G: more warps a row where the staged level lets at most
    three rows onto an SM)."""
    return 8 if v_pad >= WIDE_V else 2

_POW4 = [4**i for i in range(16)]


def _flat_reads(orgs) -> tuple[np.ndarray, np.ndarray]:
    """The reads as one flat int8 array (never empty), and each read's
    int64 offset into it."""
    lens = np.fromiter((len(o) for o in orgs), np.int64, len(orgs))
    offs = np.zeros(len(orgs), np.int64)
    offs[1:] = np.cumsum(lens)[:-1]
    flat = np.zeros(int(lens.sum()) + 1, np.int8)
    for o, off in zip(orgs, offs):
        flat[off : off + len(o)] = o
    return flat, offs


def upload_reads(orgs, device) -> tuple[torch.Tensor, np.ndarray]:
    """The reads as one flat int8 tensor on `device`, and each read's
    int64 offset into it.  Uploaded on every call: nothing is cached, so a
    recycled array never meets a stale copy."""
    flat, offs = _flat_reads(orgs)
    return torch.from_numpy(flat).to(device), offs


def check_queries(orgs, read_idx, qss, qes) -> None:
    """Every query range must lie inside its read's array."""
    if not len(read_idx):
        return
    org_len = np.fromiter((len(o) for o in orgs), np.int64, len(orgs))
    if (qss < 0).any() or (qes >= org_len[read_idx]).any():
        raise ValueError("walk query range outside its read")


def bucket_chunks(idx: np.ndarray, V: np.ndarray, v_max: int):
    """Yield (v_pad, chunk) over the queries `idx` (V <= v_max), grouped by
    bucket in ascending V, each chunk holding about CHUNK_ELEMS table
    elements."""
    order = idx[np.argsort(V[idx], kind="stable")]
    lo = 0
    for v_pad in V_BUCKETS:
        if v_pad > v_max:
            break
        hi = int(np.searchsorted(V[order], v_pad, side="right"))
        cap = max(64, CHUNK_ELEMS // v_pad)
        for c0 in range(lo, hi, cap):
            yield v_pad, order[c0 : min(c0 + cap, hi)]
        lo = hi


def query_values(flat, base, n_code, v_len, k, v_pad: int) -> torch.Tensor:
    """(Q, v_pad) int32 value rows of the queries' k-mer multisets.

    flat (F,) int8 reads; base (Q,) int64 offset of qs in flat; n_code (Q,)
    int32 number of k-mer lanes (min(qe, L-k+1) - qs, may be <= 0); v_len
    (Q,) int32 range width qe - qs + 1; k (Q,) int32 <= KMAX.  Lanes below
    n_code hold rolling codes, the rest up to v_len RAW bases, padding
    INT_MAX.  Gathers past a read's end only feed lanes that are masked."""
    dev = flat.device
    j = torch.arange(v_pad + KMAX - 1, device=dev)
    seg = flat[(base[:, None] + j).clamp_(max=flat.numel() - 1)].to(torch.int32)
    kk = k[:, None]
    code = torch.zeros((base.shape[0], v_pad), dtype=torch.int32, device=dev)
    for t in range(KMAX):
        code = torch.where(t < kk, code * 4 + seg[:, t : t + v_pad], code)
    jj = j[:v_pad].to(torch.int32)
    vals = torch.where(jj < n_code[:, None], code, seg[:, :v_pad])
    return torch.where(jj < v_len[:, None], vals, INT_MAX)


def _run_counts(svals):
    """Per element of sorted rows: run-start flag, run start index, run
    length (0 on padding) and the valid mask."""
    q, v = svals.shape
    dev = svals.device
    j = torch.arange(v, dtype=torch.int32, device=dev).expand(q, v)
    ne = svals[:, 1:] != svals[:, :-1]
    ones = torch.ones((q, 1), dtype=torch.bool, device=dev)
    first = torch.cat([ones, ne], 1)
    last = torch.cat([ne, ones], 1)
    start = torch.cummax(torch.where(first, j, -1), 1).values
    end = torch.cummin(torch.where(last, j, v).flip(1), 1).values.flip(1)
    valids = svals != INT_MAX
    cnt = torch.where(valids, end - start + 1, 0)
    return first, start, cnt, valids


def max_freq(flat, base, n_code, v_len, k, v_pad: int) -> torch.Tensor:
    """(Q,) int32 max multiplicity of each query's multiset (stage A's
    maxfreq alone)."""
    svals = torch.sort(query_values(flat, base, n_code, v_len, k, v_pad),
                       dim=1, stable=True).values
    return _run_counts(svals)[2].amax(1)


def stage_a(flat, base, n_code, v_len, k, v_pad: int):
    """Tables of a chunk (inputs as query_values) -> svals (Q, v_pad)
    int32 sorted values, adj (Q, v_pad) int32 live counts (listed max
    nodes decremented), maxfreq (Q,) int32, nodes (Q, 100) int32 (-1
    padded), n_nodes (Q,) int32: the outputs of mtr_tpu's _stage_a."""
    TIMERS.count("stage_a_calls")
    i32 = torch.int32
    dev = flat.device
    svals, perm = torch.sort(query_values(flat, base, n_code, v_len, k, v_pad),
                             dim=1, stable=True)
    first, start, cnt, valids = _run_counts(svals)
    maxfreq = cnt.amax(1)
    q = svals.shape[0]

    # run leaders of max-frequency runs, back at their original positions:
    # the stable sort puts each run's first occurrence first
    is_max_first = first & valids & (cnt == maxfreq[:, None])
    node_at_orig = torch.full((q, v_pad), -1, dtype=i32, device=dev)
    node_at_orig.scatter_(1, perm, torch.where(is_max_first, svals, -1))
    mask_orig = node_at_orig >= 0
    rank = torch.cumsum(mask_orig, 1, dtype=i32) - 1
    listed = mask_orig & (rank < MAX_NUM_MAXNODES)
    n_nodes = mask_orig.sum(1, dtype=i32).clamp_(max=MAX_NUM_MAXNODES)
    # unlisted elements land in one spare column that is cut off
    tgt = torch.where(listed, rank, MAX_NUM_MAXNODES).long()
    nodes = torch.full((q, MAX_NUM_MAXNODES + 1), -1, dtype=i32, device=dev)
    nodes = nodes.scatter_(1, tgt, node_at_orig)[:, :MAX_NUM_MAXNODES]

    # an element belongs to a listed run iff its run leader's original
    # position is listed
    first_pos = torch.gather(perm, 1, start.long())
    listed_sorted = torch.gather(listed, 1, first_pos) & valids
    adj = cnt - listed_sorted.to(i32)
    return svals, adj, maxfreq, nodes.contiguous(), n_nodes


# ---------------------------------------------------------------------------
# stage B: the walks of each row's max nodes
# ---------------------------------------------------------------------------


class _Tables:
    """A chunk's sorted tables flattened for per-row searches: row r's
    values shifted by r * 2^32 make the whole (Q, V) table one ascending
    sequence, so one torch.searchsorted serves every job's row."""

    def __init__(self, sv, sc):
        self.v = sv.shape[1]
        self.svf = sv.reshape(-1)
        self.scf = sc.reshape(-1)
        rows = torch.arange(sv.shape[0], device=sv.device, dtype=torch.int64)
        self.seq = (sv.long() + (rows[:, None] << 32)).reshape(-1)

    def lookup(self, tq, keys):
        """Live counts of keys (J, C) in rows tq (J, 1) int64; 0 where
        absent.  The index is jnp.searchsorted's (side "left") in the
        row, clipped to it."""
        base = tq * self.v
        pos = torch.searchsorted(self.seq, keys.long() + (tq << 32))
        idx = torch.minimum(pos, base + self.v - 1)
        return torch.where(self.svf[idx] == keys, self.scf[idx], 0)


def _lookahead(tab, tq, node, fwd, k, max_la):
    """One walk step's tie-break lookahead for a set of jobs (all (n,)
    tensors; tq (n, 1)) -> (md, m_out), the overflow flag and each job's
    table lookups: the la_body loop of mtr_tpu's _stage_b, run on the jobs
    still looking ahead.  A tie list lives in T_DEV columns, candidate
    t*4 + j extending tie t by base j."""
    dev = node.device
    i32 = torch.int32
    n = node.shape[0]
    T = T_DEV
    tj = torch.arange(4, dtype=i32, device=dev)
    lane = torch.arange(T, device=dev)
    ties = torch.zeros((n, T), dtype=i32, device=dev)
    tcnt = torch.ones(n, dtype=i32, device=dev)
    md = torch.zeros(n, dtype=i32, device=dev)
    # a lookahead that never breaks leaves m = max_la + 1 (the post-loop
    # quirk of consensus.c:335)
    m_out = max_la + 1
    ovf = torch.zeros(n, dtype=torch.bool, device=dev)
    looks = torch.zeros(n, dtype=torch.int64, device=dev)
    live = torch.arange(n, device=dev)
    for m in range(1, int(max_la.max()) + 1 if n else 0):
        live = live[m <= max_la[live]]
        if not live.numel():
            break
        v_node, v_k, f3 = node[live], k[live], fwd[live][:, None, None]
        km = (4 ** (v_k - m).clamp(0, 15)).to(i32)
        pm1, pm = _POW4[min(m - 1, 15)], _POW4[min(m, 15)]
        lsd = 4 * ties[live][:, :, None] + tj
        msd = tj * pm1 + ties[live][:, :, None]
        tmp_f = (pm * (v_node % km))[:, None, None] + lsd
        tmp_b = msd * km[:, None, None] + (v_node // pm)[:, None, None]
        cand = torch.where(f3, lsd, msd).reshape(-1, 4 * T)
        looks[live] += 4 * tcnt[live]
        cnts = tab.lookup(tq[live],
                          torch.where(f3, tmp_f, tmp_b).reshape(-1, 4 * T))
        validc = (lane[None, :] < tcnt[live][:, None]).repeat_interleave(4, 1)
        cm = torch.where(validc, cnts, -1).amax(1)
        mask = validc & (cnts == cm[:, None])
        md[live] = cand.gather(1, mask.to(i32).argmax(1)[:, None])[:, 0]
        nt = mask.sum(1, dtype=i32)
        ovf[live] |= nt > T
        brk = torch.where(fwd[live], nt == 1, nt <= 1)
        m_out[live[brk]] = m
        # the r-th maximal candidate (r < T) becomes tie r
        rk = torch.cumsum(mask, 1, dtype=i32) - 1
        tgt = torch.where(mask & (rk < T), rk, T).long()
        new_ties = torch.zeros((live.numel(), T + 1), dtype=i32, device=dev)
        new_ties = new_ties.scatter_(1, tgt, cand)[:, :T]
        cont = ~brk
        live = live[cont]
        ties[live] = new_ties[cont]
        tcnt[live] = nt[cont].clamp(max=T)
    return md, m_out, ovf, looks


def stage_b_plain(sv, sc, tq, node0, is_fwd, k, lmax, work=None):
    """The walks of mtr_tpu's _stage_b as vectorised torch over jobs: sv/sc
    (Q, V) int32 tables of a chunk, per job tq (row), node0, is_fwd, k,
    lmax (J,) -> found (J,) bool, period (J,) int32, units, scores (J, 500)
    int32, ovf (J,) bool.  Each step runs on the jobs still walking, where
    JAX's masked fori_loops carry the finished ones along unchanged.  The
    walks' lookups and steps go to PLAIN_WORK, or per job into the dict
    `work` when one is given."""
    dev = sv.device
    i32 = torch.int32
    J = node0.shape[0]
    tab = _Tables(sv, sc)
    tq = tq.long()[:, None]
    fwd = is_fwd.bool()
    k = k.to(i32)
    lmax = lmax.to(i32)
    node0 = node0.to(i32)
    k1 = (4 ** (k - 1)).to(i32)

    node = node0.clone()
    done = lmax <= 0
    found = torch.zeros(J, dtype=torch.bool, device=dev)
    ovf = torch.zeros(J, dtype=torch.bool, device=dev)
    period = torch.zeros(J, dtype=i32, device=dev)
    units = torch.zeros((J, MAX_PERIOD), dtype=i32, device=dev)
    scores = torch.zeros((J, MAX_PERIOD), dtype=i32, device=dev)
    looks = torch.zeros(J, dtype=torch.int64, device=dev)
    steps = torch.zeros(J, dtype=torch.int64, device=dev)
    for l in range(int(lmax.max()) if J else 0):
        act = torch.nonzero(~done & (l < lmax))[:, 0]
        if not act.numel():
            break
        a_node, a_fwd, a_k, a_k1 = node[act], fwd[act], k[act], k1[act]
        a_tq = tq[act]
        max_la = torch.ones_like(a_k) if l < 10 else a_k
        md, m_out, a_ovf, a_looks = _lookahead(tab, a_tq, a_node, a_fwd, a_k,
                                               max_la)
        # a step looks up the recorded node's score besides its lookahead
        steps[act] += 1
        looks[act] += 1 + a_looks
        ovf[act] |= a_ovf
        nf = 4 * (a_node % a_k1) + md // (4 ** (m_out - 1).clamp(0, 15)).to(i32)
        nb = (md % 4) * a_k1 + a_node // 4
        new = torch.where(a_fwd, nf, nb)
        # forward records the CURRENT node's digit and score before
        # stepping, backward the NEW node's after
        rec = torch.where(a_fwd, a_node, new)
        units[act, l] = rec // a_k1
        scores[act, l] = tab.lookup(a_tq, rec[:, None])[:, 0]
        node[act] = new
        looped = new == node0[act]
        period[act[looped]] = l + 1
        found[act[looped]] = l + 1 < MAX_PERIOD
        done[act[looped]] = True
        done |= l + 1 >= lmax
    if work is None:
        PLAIN_WORK["lookups"] += int(looks.sum())
        PLAIN_WORK["steps"] += int(steps.sum())
    else:
        work.update(lookups=looks, steps=steps)
    return found, period, units, scores, ovf


def walk_rows_plain(sv, sc, maxfreq, nodes, n_nodes, k, lmax, tab, off,
                    units, scores, used):
    """The row kernel's function (csrc/dbg_walk.cu) as vectorised torch
    over rows, on CPU tensors: stage_b_plain walks each open direction's
    next walk_group(v_pad) listed max nodes of every gated row (maxfreq >
    MIN_NUM_FREQ_UNIT) a round, until a round in which some walk finds a
    unit (the lowest such rank wins) or the list ends.  A row is bad when a
    walk overflowed T_DEV at or before the winner's rank in either
    direction, or anywhere in a direction without a winner.

    Inputs as the kernel's: sv / sc (Q, V) tables, maxfreq / n_nodes /
    k / lmax (Q,), nodes (Q, 100).  Writes tab (Q, 4) int32 (fwd_period,
    bwd_period, found_last, bad), off (Q, 2) int64 (each winning row's
    offset, -1 without one), the winning rows cut to their periods (the
    backward one reversed) into units / scores from used[0] on, and
    advances used[0] past them (rows in round order; the kernel's order is
    the card's)."""
    i32 = torch.int32
    q = sv.shape[0]
    G = walk_group(sv.shape[1])
    g = torch.arange(G)
    col = torch.arange(MAX_PERIOD)
    gated = maxfreq > MIN_NUM_FREQ_UNIT
    nn = torch.where(gated, n_nodes.clamp(max=MAX_NUM_MAXNODES), 0).long()
    nxt = torch.zeros((q, 2), dtype=torch.int64)
    live = gated[:, None].repeat(1, 2)
    per = torch.zeros((q, 2), dtype=i32)
    offs = torch.full((q, 2), -1, dtype=torch.int64)
    bad = torch.zeros(q, dtype=torch.bool)
    while live.any():
        rq, rd = torch.nonzero(live, as_tuple=True)
        rank = nxt[rq, rd][:, None] + g
        valid = rank < nn[rq][:, None]
        jm, jg = torch.nonzero(valid, as_tuple=True)
        jq = rq[jm]
        work = {}
        f, p, u, s, o = stage_b_plain(
            sv, sc, jq.to(i32), nodes[jq, rank[jm, jg]].to(i32),
            (rd[jm] == 0).to(i32), k[jq].to(i32), lmax[jq].to(i32), work)
        found = torch.zeros_like(valid)
        found[jm, jg] = f
        ovf = torch.zeros_like(valid)
        ovf[jm, jg] = o
        job = torch.full(valid.shape, -1, dtype=torch.int64)
        job[jm, jg] = torch.arange(len(jm))
        has = found.any(1)
        win = found.to(torch.uint8).argmax(1)
        upto = torch.where(has, win, G - 1)
        bad[rq[(ovf & (g[None, :] <= upto[:, None])).any(1)]] = True
        need = jg <= upto[jm]  # the kernel stops the walks past a winner
        PLAIN_WORK["lookups"] += int(work["lookups"][need].sum())
        PLAIN_WORK["steps"] += int(work["steps"][need].sum())
        hr = torch.nonzero(has)[:, 0]
        if hr.numel():
            wj = job[hr, win[hr]]
            wp = p[wj].long()
            src = torch.where(rd[hr][:, None] == 1,
                              (wp[:, None] - 1 - col).clamp(min=0), col)
            keep = col[None, :] < wp[:, None]
            start = int(used[0])
            stop = start + int(wp.sum())
            units[start:stop] = torch.gather(u[wj], 1, src)[keep].to(
                units.dtype)
            scores[start:stop] = torch.gather(s[wj], 1, src)[keep].to(
                scores.dtype)
            used[0] = stop
            per[rq[hr], rd[hr]] = wp.to(i32)
            offs[rq[hr], rd[hr]] = start + torch.cumsum(wp, 0) - wp
        nxt[rq, rd] += G
        live[rq, rd] = ~has & (nxt[rq, rd] < nn[rq])
    tab[:, :2] = per
    tab[:, 2] = per[:, 1] > 0
    tab[:, 3] = bad
    off[:] = offs


def walk_rows(sv, sc, maxfreq, nodes, n_nodes, k, lmax, tab, off, units,
              scores, used):
    """Stage B on one chunk's stage-A outputs, settled per row (arguments
    as walk_rows_plain's; every input int32).  CUDA tensors launch the row
    kernel (csrc/dbg_walk.cu) on the current stream, counted as
    launch.dbg_walk, or the call raises; CPU tensors run walk_rows_plain.
    Nothing waits for the card."""
    tensors = (sv, sc, maxfreq, nodes, n_nodes, k, lmax, tab, off, units,
               scores, used)
    if all(t.device.type == "cpu" for t in tensors):
        walk_rows_plain(*tensors)
        return
    if not all(t.is_cuda and t.device == sv.device for t in tensors):
        raise ValueError("walk_rows: tensors must all be on one CUDA device "
                         "or all on the CPU")
    prepare(*tensors)()
    TIMERS.count("launch.dbg_walk")


def prepare(sv, sc, maxfreq, nodes, n_nodes, k, lmax, tab, off, units,
            scores, used):
    """Check a launch's shapes, dtypes and layout (CUDA tensors) -> a bare
    launcher that enqueues the row kernel on the current stream.  The
    values the kernel trusts (k in 1..KMAX, lmax <= MAX_PERIOD, row
    buffers of 2 x lmax a row) are checked on the host by
    dbg_walk_device_batch before its upload.  walk_rows counts the launch;
    chip_smoke.py times the launcher alone."""
    from mtr_tpu_torch.ops import _build

    q, v = sv.shape
    i32, i64 = torch.int32, torch.int64
    for name, t, dtype, shape in (
            ("sv", sv, i32, (q, v)), ("sc", sc, i32, (q, v)),
            ("maxfreq", maxfreq, i32, (q,)),
            ("nodes", nodes, i32, (q, MAX_NUM_MAXNODES)),
            ("n_nodes", n_nodes, i32, (q,)), ("k", k, i32, (q,)),
            ("lmax", lmax, i32, (q,)), ("tab", tab, i32, (q, 4)),
            ("off", off, i64, (q, 2)), ("used", used, i64, (1,))):
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"walk_rows: {name} must be {dtype} of shape "
                             f"{shape}, got {t.dtype} {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"walk_rows: {name} must be contiguous")
    if units.dtype != torch.uint8 or scores.dtype != i32 or \
            units.dim() != 1 or scores.shape != units.shape:
        raise ValueError("walk_rows: units / scores must be uint8 / int32 "
                         "row buffers of one length")
    if v not in V_BUCKETS:
        raise ValueError(f"walk_rows: table width {v} is not one of "
                         f"{V_BUCKETS}")
    if sv.data_ptr() % 16 or sc.data_ptr() % 16:
        raise ValueError("walk_rows: tables must be 16-byte aligned")
    lib = _build.library()
    stream = ctypes.c_void_p(torch.cuda.current_stream(sv.device).cuda_stream)
    ptrs = [t.data_ptr() for t in (maxfreq, n_nodes, nodes, k, lmax, tab,
                                   off, units, scores, used)]

    def launch():
        err = lib.mtr_dbg_walk_rows(sv.data_ptr(), sc.data_ptr(), v, q,
                                    *ptrs, stream)
        if err != 0:
            raise RuntimeError(f"dbg_walk kernel launch failed: CUDA error "
                               f"{err} (V={v}, rows={q})")

    return launch


# ---------------------------------------------------------------------------
# orchestration: one upload, chunks, one pull, the host route
# ---------------------------------------------------------------------------


def _upload_call(orgs, read_idx, qss, cols, device):
    """One upload a call: the reads (int8, laid out as upload_reads lays
    them), each query's int64 offset into them (its read's offset + qs)
    and its int32 columns `cols` (n_code, V, k, lmax) as the rows of a
    (4, n) block, in one buffer.  On a CUDA device the buffer is pinned and
    copied without a wait.  -> (flat, base, cols) on `device`."""
    flat_h, offs = _flat_reads(orgs)
    n = len(read_idx)
    o_cols = -(-8 * n // 16) * 16
    o_flat = o_cols + -(-16 * n // 16) * 16
    cuda = device.type == "cuda"
    buf = torch.empty(o_flat + len(flat_h), dtype=torch.uint8,
                      pin_memory=cuda)
    a = buf.numpy()
    a[: 8 * n].view(np.int64)[:] = offs[read_idx] + qss
    a[o_cols : o_cols + 16 * n].view(np.int32).reshape(4, n)[:] = cols
    a[o_flat:] = flat_h.view(np.uint8)
    if cuda:
        buf = buf.to(device, non_blocking=True)
    return (buf[o_flat:].view(torch.int8), buf[: 8 * n].view(torch.int64),
            buf[o_cols : o_cols + 16 * n].view(torch.int32).view(4, n))


def _pull(*tensors):
    """Host arrays of the tensors after ONE wait, counted as walk_waits:
    non-blocking copies into pinned memory, then the stream's synchronize
    (span mtr.walk.wait).  CPU tensors are read in place at that point."""
    TIMERS.count("walk_waits")
    if tensors[0].device.type != "cuda":
        return [t.numpy() for t in tensors]
    outs = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            for t in tensors]
    for o, t in zip(outs, tensors):
        o.copy_(t, non_blocking=True)
    with TIMERS.span("mtr.walk.wait"):
        torch.cuda.current_stream(tensors[0].device).synchronize()
    return [o.numpy() for o in outs]


def _device_rows(org_arrays, q, reach, device, res, host):
    """The reachable queries on the device: one upload, stage A and the
    row kernel a chunk (launches only), then one pull of the per-query
    table and one of the winning rows.  Fills res for the queries the
    device settles, appends the bad ones to host, and returns the rows
    (units uint8, scores int32, flat)."""
    read_idx, qss, ks, V, n_code, lmax = q
    chunks = list(bucket_chunks(np.nonzero(reach)[0], V, V_MAX))
    order = np.concatenate([c for _, c in chunks])
    n = len(order)
    # a winning row is at most lmax long, two a query
    cap = max(1, 2 * int(np.maximum(lmax[order], 0).sum()))
    with TIMERS.span("mtr.walk.upload"):
        flat, base, cols = _upload_call(
            org_arrays, read_idx[order], qss[order],
            np.stack([n_code[order], V[order], ks[order], lmax[order]]),
            device)
        tab = torch.empty((n, 4), dtype=torch.int32, device=device)
        off = torch.empty((n, 2), dtype=torch.int64, device=device)
        units = torch.empty(cap, dtype=torch.uint8, device=device)
        scores = torch.empty(cap, dtype=torch.int32, device=device)
        used = torch.zeros(1, dtype=torch.int64, device=device)
    lo = 0
    for v_pad, chunk in chunks:
        c = slice(lo, lo + len(chunk))
        lo = c.stop
        # the device analog of -c's "count table generation"
        # (consensus.c:73-127)
        with TIMERS.span("mtr.walk.stage_a", "count_table"):
            sv, adj, maxfreq, nodes, n_nodes = stage_a(
                flat, base[c], cols[0, c], cols[1, c], cols[2, c], v_pad)
        with TIMERS.span("mtr.walk.kernel", "walk_kernel"):
            walk_rows(sv, adj, maxfreq, nodes, n_nodes, cols[2, c],
                      cols[3, c], tab[c], off[c], units, scores, used)
    with TIMERS.span("mtr.walk.rows"):  # the results, pulled once
        tab_h, off_h, used_h = _pull(tab, off, used)
        m = int(used_h[0])
        units_h, scores_h = _pull(units[:m], scores[:m])
        TIMERS.count("walk_rows_bytes", units_h.nbytes + scores_h.nbytes)
        bad = tab_h[:, 3] != 0
        host.append(order[bad])
        good = ~bad
        qg = order[good]
        for j, key in enumerate(("fwd_period", "bwd_period", "found_last")):
            res[key][qg] = tab_h[good, j]
        res["fwd_off"][qg] = off_h[good, 0]
        res["bwd_off"][qg] = off_h[good, 1]
    return units_h, scores_h


_NATIVE_LOCK = threading.Lock()


def native_walks(orgs, lens, read_idx, qss, qes, ks):
    """native.dbg_walk_batch2, one call at a time, with its result copied
    out of the engine's process-wide result buffers (the walk thread and
    the wave loop of the DP thread both walk)."""
    from mtr_tpu_torch import native

    n = len(read_idx)
    with _NATIVE_LOCK:
        r = native.dbg_walk_batch2(orgs, lens, read_idx, qss, qes, ks)
        out = {key: r[key][:n].copy() for key in
               ("fwd_row", "bwd_row", "fwd_period", "bwd_period",
                "found_last")}
        used = 1 + max(int(out["fwd_row"].max(initial=-1)),
                       int(out["bwd_row"].max(initial=-1)))
        out["units"] = r["units"][:used].copy()
        out["scores"] = r["scores"][:used].copy()
    return out


def flat_rows(res):
    """A native.dbg_walk_batch2-form result (fwd_row / bwd_row into
    (N, 500) unit / score rows) in the device route's form: the rows
    flattened, and each direction's offset into them (fwd_off / bwd_off,
    -1 without a row).  A walk's unit is units[off : off + period]."""
    out = {key: res[key] for key in ("fwd_period", "bwd_period",
                                     "found_last")}
    for d in ("fwd", "bwd"):
        row = np.asarray(res[f"{d}_row"], np.int64)
        out[f"{d}_off"] = np.where(row >= 0, row * MAX_PERIOD, -1)
    out["units"] = np.asarray(res["units"]).reshape(-1)
    out["scores"] = np.asarray(res["scores"]).reshape(-1)
    return out


def _host_route(org_arrays, lens, read_idx, qss, qes, ks, h, res, units,
                scores):
    """The queries h in one native.dbg_walk_batch2 call; their rows follow
    the device's.  Returns the rows extended."""
    orgs = [np.ascontiguousarray(o, np.int32) for o in org_arrays]
    r = flat_rows(native_walks(orgs, lens, read_idx[h], qss[h], qes[h],
                               ks[h]))
    for d in ("fwd", "bwd"):
        o = r[f"{d}_off"]
        res[f"{d}_off"][h] = np.where(o >= 0, o + len(units), -1)
    for key in ("fwd_period", "bwd_period", "found_last"):
        res[key][h] = r[key]
    return (np.concatenate([units, r["units"].astype(np.uint8)]),
            np.concatenate([scores, r["scores"].astype(np.int32)]))


def dbg_walk_device_batch(org_arrays, len_table, read_idx, qss, qes, ks,
                          device):
    """Device equivalent of native.dbg_walk_batch2, on `device`, in
    flat_rows' form: fwd_off / bwd_off (int64) into the flat units (uint8
    digits) / scores (int32), fwd_period / bwd_period, found_last.  The
    card settles each query's walks (walk_rows) and the host waits for it
    twice a call, however many chunks (the table, then the rows; each
    counted as walk_waits).  Queries outside the device's reach (range
    wider than V_MAX), or bad on the card (a tie list over T_DEV at or
    before the winner), go to the host engine in one call, counted as
    walk_fallback_queries.  A kernel or launch error raises."""
    TIMERS.count("walk_device_calls")
    n = len(read_idx)
    read_idx = np.asarray(read_idx, np.int64)
    qss = np.asarray(qss, np.int64)
    qes = np.asarray(qes, np.int64)
    ks = np.asarray(ks, np.int64)
    lens = np.asarray(len_table, np.int64)
    check_queries(org_arrays, read_idx, qss, qes)
    res = {
        "fwd_off": np.full(n, -1, np.int64),
        "bwd_off": np.full(n, -1, np.int64),
        "fwd_period": np.zeros(n, np.int32),
        "bwd_period": np.zeros(n, np.int32),
        "found_last": np.zeros(n, np.int32),
    }
    V = qes - qss + 1
    n_code = np.minimum(qes, lens[read_idx] - ks + 1) - qss
    # the row kernel trusts 1 <= k <= KMAX and lmax <= MAX_PERIOD
    lmax = np.minimum(MAX_PERIOD, (qes - qss) // MIN_NUM_FREQ_UNIT)
    reach = (V <= V_MAX) & (ks >= 1) & (ks <= KMAX)
    host = [np.nonzero(~reach)[0]]
    units = np.zeros(0, np.uint8)
    scores = np.zeros(0, np.int32)
    if reach.any():
        units, scores = _device_rows(
            org_arrays, (read_idx, qss, ks, V, n_code, lmax), reach,
            torch.device(device), res, host)
    h = np.sort(np.concatenate(host))  # batch order keeps the k runs
    if len(h):
        TIMERS.count("walk_fallback_queries", len(h))
        with TIMERS.span("mtr.walk.host_route", "walk_host_route"):
            units, scores = _host_route(org_arrays, lens, read_idx, qss, qes,
                                        ks, h, res, units, scores)
    res["units"], res["scores"] = units, scores
    return res
