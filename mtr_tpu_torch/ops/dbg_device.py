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

Stage B (walks): one speculative job per (gated query, direction, start
node); the reference walks the nodes in order and stops at the first loop
(consensus.c:534-573), so walking all of them and taking the first found
one is equivalent.  CUDA tensors launch csrc/dbg_walk.cu (one block per
table row and up to two of its jobs, a warp per job, the row's search
level staged in shared memory; walk_blocks builds its launch table); CPU
tensors run stage_b_plain, the vectorised port of JAX's two fori_loops.
A job reads its query's row of the chunk's tables through its row index;
nothing is copied per job.

dbg_walk_device_batch drives both and returns native.dbg_walk_batch2's
result dict.  The device keeps tie lists of T_DEV = 32 against the
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
JOBS_PER_LAUNCH = 1 << 16  # stage-B jobs per launch (units + scores: 256 MB)

# stage-A passes and walk-kernel launches are TIMERS.counters
# "stage_a_calls" and "launch.dbg_walk" (the main path shows it ran here)
# work of stage_b_plain's walks since the last reset: table lookups and
# walk steps (the walk kernel's bound in chip_smoke.py counts them)
PLAIN_WORK = {"lookups": 0, "steps": 0}

_POW4 = [4**i for i in range(16)]


def upload_reads(orgs, device) -> tuple[torch.Tensor, np.ndarray]:
    """The reads as one flat int8 tensor on `device`, and each read's
    int64 offset into it.  Uploaded on every call: nothing is cached, so a
    recycled array never meets a stale copy."""
    lens = np.fromiter((len(o) for o in orgs), np.int64, len(orgs))
    offs = np.zeros(len(orgs), np.int64)
    offs[1:] = np.cumsum(lens)[:-1]
    flat = np.zeros(int(lens.sum()) + 1, np.int8)  # never empty
    for o, off in zip(orgs, offs):
        flat[off : off + len(o)] = o
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
# stage B: speculative walks
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
    tensors; tq (n, 1)) -> (md, m_out) and the overflow flag: the
    la_body loop of mtr_tpu's _stage_b, run on the jobs still looking
    ahead.  A tie list lives in T_DEV columns, candidate t*4 + j extending
    tie t by base j."""
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
        PLAIN_WORK["lookups"] += 4 * int(tcnt[live].sum())
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
    return md, m_out, ovf


def stage_b_plain(sv, sc, tq, node0, is_fwd, k, lmax):
    """The walks of mtr_tpu's _stage_b as vectorised torch over jobs: sv/sc
    (Q, V) int32 tables of a chunk, per job tq (row), node0, is_fwd, k,
    lmax (J,) -> found (J,) bool, period (J,) int32, units, scores (J, 500)
    int32, ovf (J,) bool.  Each step runs on the jobs still walking, where
    JAX's masked fori_loops carry the finished ones along unchanged."""
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
    for l in range(int(lmax.max()) if J else 0):
        act = torch.nonzero(~done & (l < lmax))[:, 0]
        if not act.numel():
            break
        a_node, a_fwd, a_k, a_k1 = node[act], fwd[act], k[act], k1[act]
        a_tq = tq[act]
        # a step looks up the recorded node's score besides its lookahead
        PLAIN_WORK["steps"] += act.numel()
        PLAIN_WORK["lookups"] += act.numel()
        max_la = torch.ones_like(a_k) if l < 10 else a_k
        md, m_out, a_ovf = _lookahead(tab, a_tq, a_node, a_fwd, a_k, max_la)
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
    return found, period, units, scores, ovf


def dbg_walk(sv, sc, tq, node0, is_fwd, k, lmax):
    """Stage B on one chunk's tables (shapes as stage_b_plain; every input
    int32).  CUDA tensors launch the kernel (csrc/dbg_walk.cu) or the call
    raises; CPU tensors run stage_b_plain."""
    tensors = (sv, sc, tq, node0, is_fwd, k, lmax)
    if all(t.device.type == "cpu" for t in tensors):
        return stage_b_plain(*tensors)
    if not all(t.is_cuda and t.device == sv.device for t in tensors):
        raise ValueError("dbg_walk: tensors must all be on one CUDA device "
                         "or all on the CPU")
    launch, outs = prepare(*tensors)
    if launch is not None:
        launch()
        TIMERS.count("launch.dbg_walk")
    return outs


def walk_blocks(tq: np.ndarray, per_block: int):
    """The walk kernel's launch table for jobs reading table rows tq (J,):
    perm (J,) int32, the job indices grouped by row (stable), and blocks
    (n_blocks, 3) int32, per block its row, its first index into perm and
    its job count (1 .. per_block, all of one row)."""
    perm = np.argsort(tq, kind="stable")
    st = tq[perm]
    n = len(st)
    run_start = np.flatnonzero(np.r_[True, st[1:] != st[:-1]]) if n else \
        np.zeros(0, np.int64)
    run_len = np.diff(np.r_[run_start, n])
    nb = -(-run_len // per_block)
    run = np.repeat(np.arange(len(run_start)), nb)
    within = np.arange(int(nb.sum())) - np.repeat(np.cumsum(nb) - nb, nb)
    first = run_start[run] + within * per_block
    count = np.minimum(per_block, run_start[run] + run_len[run] - first)
    blocks = np.stack([st[first], first, count], 1).astype(np.int32)
    return perm.astype(np.int32), blocks.reshape(-1, 3)


def prepare(sv, sc, tq, node0, is_fwd, k, lmax):
    """Check a launch's inputs (CUDA tensors), allocate its outputs and
    build its launch table -> (launch, outputs): launch() enqueues the
    kernel on the current stream (None when there is no job).  dbg_walk
    counts the launch; chip_smoke.py times launch() alone."""
    from mtr_tpu_torch.ops import _build

    q, v = sv.shape
    J = node0.shape[0]
    for name, t, shape in (("sv", sv, (q, v)), ("sc", sc, (q, v)),
                           ("tq", tq, (J,)), ("node0", node0, (J,)),
                           ("is_fwd", is_fwd, (J,)), ("k", k, (J,)),
                           ("lmax", lmax, (J,))):
        if t.dtype != torch.int32 or tuple(t.shape) != shape:
            raise ValueError(f"dbg_walk: {name} must be int32 of shape "
                             f"{shape}, got {t.dtype} {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"dbg_walk: {name} must be contiguous")
    if v not in V_BUCKETS:
        raise ValueError(f"dbg_walk: table width {v} is not one of "
                         f"{V_BUCKETS}")
    if sv.data_ptr() % 16 or sc.data_ptr() % 16:
        raise ValueError("dbg_walk: tables must be 16-byte aligned")
    dev = sv.device
    found = torch.empty(J, dtype=torch.bool, device=dev)
    ovf = torch.empty(J, dtype=torch.bool, device=dev)
    period = torch.empty(J, dtype=torch.int32, device=dev)
    units = torch.zeros((J, MAX_PERIOD), dtype=torch.int32, device=dev)
    scores = torch.zeros((J, MAX_PERIOD), dtype=torch.int32, device=dev)
    outs = (found, period, units, scores, ovf)
    if J == 0:
        return None, outs
    # the kernel reads row tq of the tables, codes below 4^k and up to
    # lmax entries of a job's units / scores
    tq_h, k_h, lmax_h = torch.stack([tq, k, lmax]).cpu().numpy()
    if not (0 <= tq_h.min() and tq_h.max() < q):
        raise ValueError("dbg_walk: tq outside the tables' rows")
    if not (1 <= k_h.min() and k_h.max() <= KMAX):
        raise ValueError(f"dbg_walk: k outside 1..{KMAX}")
    if lmax_h.max() > MAX_PERIOD:
        raise ValueError(f"dbg_walk: lmax above {MAX_PERIOD}")
    lib = _build.library()
    perm, blocks = walk_blocks(tq_h, lib.mtr_dbg_walk_jobs_per_block())
    perm, blocks = (torch.from_numpy(a).to(dev) for a in (perm, blocks))
    stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)
    n_blocks = blocks.shape[0]

    def launch():
        err = lib.mtr_dbg_walk(
            sv.data_ptr(), sc.data_ptr(), v, blocks.data_ptr(), n_blocks,
            perm.data_ptr(), node0.data_ptr(), is_fwd.data_ptr(),
            k.data_ptr(), lmax.data_ptr(), found.data_ptr(),
            period.data_ptr(), units.data_ptr(), scores.data_ptr(),
            ovf.data_ptr(), stream)
        if err != 0:
            raise RuntimeError(f"dbg_walk kernel launch failed: CUDA error "
                               f"{err} (V={v}, J={J})")

    return launch, outs


# ---------------------------------------------------------------------------
# orchestration: chunks, jobs, winners, the host route
# ---------------------------------------------------------------------------


def chunk_jobs(maxfreq, n_nodes, nodes):
    """Speculative jobs of one chunk, from its stage-A outputs: for every
    gated query (maxfreq > MIN_NUM_FREQ_UNIT), forward over its max nodes
    in list order, then backward.  Returns numpy (gated rows, nodes per
    gated row, tq, node0, is_fwd, rank) with jobs grouped by (row,
    direction), rank ascending inside a group."""
    gated = np.nonzero(maxfreq.cpu().numpy() > MIN_NUM_FREQ_UNIT)[0]
    if not len(gated):
        z = np.zeros(0, np.int64)
        return gated, z, z, z, z, z
    g = torch.from_numpy(gated).to(nodes.device)
    nn = n_nodes[g].cpu().numpy().astype(np.int64)  # >= 1 where gated
    nodes_g = nodes[g].cpu().numpy()
    per = 2 * nn
    grp = np.repeat(np.arange(len(gated)), per)
    within = np.arange(int(per.sum())) - np.repeat(np.cumsum(per) - per, per)
    is_fwd = within < nn[grp]
    rank = np.where(is_fwd, within, within - nn[grp])
    return gated, nn, gated[grp], nodes_g[grp, rank], is_fwd, rank


class _Rows:
    """Unit/score rows of a batch's result, appended in blocks."""

    def __init__(self):
        self.units: list[np.ndarray] = []
        self.scores: list[np.ndarray] = []
        self.n = 0

    def add(self, units: np.ndarray, scores: np.ndarray) -> np.ndarray:
        self.units.append(units.astype(np.int32, copy=False))
        self.scores.append(scores.astype(np.int32, copy=False))
        rows = np.arange(self.n, self.n + len(units), dtype=np.int32)
        self.n += len(units)
        return rows

    def stacked(self) -> tuple[np.ndarray, np.ndarray]:
        if not self.n:
            return (np.zeros((0, MAX_PERIOD), np.int32),
                    np.zeros((0, MAX_PERIOD), np.int32))
        return np.concatenate(self.units), np.concatenate(self.scores)


def _keep_period(rows: np.ndarray, p: np.ndarray, reverse: bool):
    """rows (N, 500) cut to each row's first p entries (zero after), the
    first p reversed for backward walks."""
    col = np.arange(MAX_PERIOD)[None, :]
    if reverse:
        rows = np.take_along_axis(rows, np.clip(p[:, None] - 1 - col, 0, None),
                                  1)
    return np.where(col < p[:, None], rows, 0)


def _run_chunk(flat, offs, chunk, v_pad, q, res, rows, host):
    """Stage A and B for one chunk of queries (indices into the batch);
    fills res/rows for the queries the device settles and appends the rest
    to host."""
    read_idx, qss, qes, ks, V, n_code, lmax = q
    dev = flat.device

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(dev)

    base = torch.from_numpy(offs[read_idx[chunk]] + qss[chunk]).to(dev)
    # the device analog of -c's "count table generation"
    # (consensus.c:73-127), materialization included
    with TIMERS.span("mtr.walk.stage_a", "count_table"):
        sv, adj, maxfreq, nodes, n_nodes = stage_a(
            flat, base, put(n_code[chunk]), put(V[chunk]), put(ks[chunk]),
            v_pad)
        gated, nn, tq, node0, is_fwd, rank = chunk_jobs(maxfreq, n_nodes,
                                                        nodes)
    if not len(gated):
        return
    n_jobs = len(tq)
    TIMERS.count("walk_jobs", n_jobs)
    qi = chunk[tq]
    args = [put(a) for a in (tq, node0, is_fwd, ks[qi], lmax[qi])]
    found = np.zeros(n_jobs, bool)
    period = np.zeros(n_jobs, np.int32)
    ovf = np.zeros(n_jobs, bool)
    dev_rows = []  # per launch: (first job, units, scores) on the device
    # launches and their pulls
    with TIMERS.span("mtr.walk.kernel", "walk_kernel"):
        for lo in range(0, n_jobs, JOBS_PER_LAUNCH):
            hi = min(lo + JOBS_PER_LAUNCH, n_jobs)
            f, p, u, s, o = dbg_walk(sv, adj, *(a[lo:hi] for a in args))
            found[lo:hi] = f.cpu().numpy()
            period[lo:hi] = p.cpu().numpy()
            ovf[lo:hi] = o.cpu().numpy()
            dev_rows.append((lo, u, s))

    with TIMERS.span("mtr.walk.rows"):  # winners, their rows pulled
        # per (row, direction) group: the first found node wins; an overflow
        # at or before the winner (or anywhere, without one) could have
        # changed the outcome, so the query goes to the host
        size = np.repeat(nn, 2)
        start = np.cumsum(size) - size
        big = np.int64(1) << 40
        win = np.minimum.reduceat(np.where(found, rank, big), start)
        bad = np.logical_or.reduceat(ovf & (rank <= np.repeat(win, size)),
                                     start)
        bad_q = bad[0::2] | bad[1::2]
        host.append(chunk[gated[bad_q]])
        good = ~bad_q
        qg = chunk[gated]
        for d, key_row, key_per in ((0, "fwd_row", "fwd_period"),
                                    (1, "bwd_row", "bwd_period")):
            has = good & (win[d::2] < big)
            if d == 1:
                res["found_last"][qg[good]] = has[good]
            if not has.any():
                continue
            wj = start[d::2][has] + win[d::2][has]
            u = np.zeros((len(wj), MAX_PERIOD), np.int32)
            s = np.zeros_like(u)
            for lo, du, ds in dev_rows:
                sel = np.nonzero((wj >= lo) & (wj < lo + du.shape[0]))[0]
                if len(sel):
                    idx = torch.from_numpy(wj[sel] - lo).to(dev)
                    u[sel] = du[idx].cpu().numpy()
                    s[sel] = ds[idx].cpu().numpy()
            p = period[wj]
            back = d == 1
            res[key_row][qg[has]] = rows.add(_keep_period(u, p, back),
                                             _keep_period(s, p, back))
            res[key_per][qg[has]] = p


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


def _host_route(org_arrays, lens, read_idx, qss, qes, ks, h, res, rows):
    """The queries h in one native.dbg_walk_batch2 call."""
    orgs = [np.ascontiguousarray(o, np.int32) for o in org_arrays]
    r = native_walks(orgs, lens, read_idx[h], qss[h], qes[h], ks[h])
    # the native rows follow this batch's rows
    off = rows.n
    rows.add(r["units"], r["scores"])
    for key in ("fwd_row", "bwd_row"):
        res[key][h] = np.where(r[key] >= 0, r[key] + off, -1)
    for key in ("fwd_period", "bwd_period", "found_last"):
        res[key][h] = r[key]


def dbg_walk_device_batch(org_arrays, len_table, read_idx, qss, qes, ks,
                          device):
    """Device equivalent of native.dbg_walk_batch2, on `device`: the same
    result dict (fwd_row / bwd_row into units / scores rows, fwd_period /
    bwd_period, found_last).  Queries outside the device's reach (range
    wider than V_MAX, or a tie list over T_DEV at or before the winner) go
    to the host engine in one call, counted as walk_fallback_queries.  A
    kernel or launch error raises."""
    n = len(read_idx)
    read_idx = np.asarray(read_idx, np.int64)
    qss = np.asarray(qss, np.int64)
    qes = np.asarray(qes, np.int64)
    ks = np.asarray(ks, np.int64)
    lens = np.asarray(len_table, np.int64)
    check_queries(org_arrays, read_idx, qss, qes)
    res = {
        "fwd_row": np.full(n, -1, np.int32),
        "bwd_row": np.full(n, -1, np.int32),
        "fwd_period": np.zeros(n, np.int32),
        "bwd_period": np.zeros(n, np.int32),
        "found_last": np.zeros(n, np.int32),
    }
    rows = _Rows()
    V = qes - qss + 1
    n_code = np.minimum(qes, lens[read_idx] - ks + 1) - qss
    lmax = np.minimum(MAX_PERIOD, (qes - qss) // MIN_NUM_FREQ_UNIT)
    reach = (V <= V_MAX) & (ks >= 1) & (ks <= KMAX)
    host = [np.nonzero(~reach)[0]]
    if reach.any():
        with TIMERS.span("mtr.walk.upload"):
            flat, offs = upload_reads(org_arrays, device)
        q = (read_idx, qss, qes, ks, V, n_code, lmax)
        for v_pad, chunk in bucket_chunks(np.nonzero(reach)[0], V, V_MAX):
            _run_chunk(flat, offs, chunk, v_pad, q, res, rows, host)
    h = np.sort(np.concatenate(host))  # batch order keeps the k runs
    if len(h):
        TIMERS.count("walk_fallback_queries", len(h))
        with TIMERS.span("mtr.walk.host_route", "walk_host_route"):
            _host_route(org_arrays, lens, read_idx, qss, qes, ks, h, res,
                        rows)
    res["units"], res["scores"] = rows.stacked()
    return res
