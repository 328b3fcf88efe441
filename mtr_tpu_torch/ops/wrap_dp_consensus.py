"""Consensus-mode wrap-around DP: the plain PyTorch versions and the
public op.

Consensus (polish) jobs align a repeat against its unit and count, for
every unit column, the read bases aligned to it and the bases inserted
before it (consensus.c:931-962); the polish step rebuilds the unit from
those columns.  The result is one (500, 9) int32 block per job,
[consensus A C G T gap | missing A C G T], indexed by the 1-origin unit
column j.

`wrap_dp_fill_plain` is a line-for-line port of the Pallas fill
(`mtr_tpu/ops/wrap_dp_pallas.py::_fill_kernel` / `make_wrap_dp_pallas`):
it returns the move tensor in the JAX layout, (r_pad, B, u_pad) uint8
with 0 stop / 1 diag / 2 del / 3 ins, and best (B, 8) int32 [wrap,
best_val, best_i, best_j, 0, 0, 0, 0].  `traceback_consensus_plain` ports
`traceback_consensus_batch_n` (:252-311): every job walks its moves from
(best_i, best_j or unit_len) and adds into its (500, 9) block.

`wrap_dp_consensus` is the resident form used by the device batcher (the
counterpart of `get_wrap_dp_consensus_resident`, wrap_dp_resident.py:
67-90): rep codes come from the batch's flat int8 reads at `starts`, unit
rows are u_span codes wide (a multiple of 32, as for the counts op: the
kernel gives each job C = ceil(unit_len / 32) columns a lane, so one
launch takes every unit width).  CUDA tensors launch the hand-written
kernel (csrc/wrap_dp_consensus.cu: fill and traceback in one launch, the
moves packed 2 bits a cell as `pack_moves` states them) or the call
raises; CPU tensors run gather -> plain fill -> plain traceback.
"""

from __future__ import annotations

import ctypes

import torch

from mtr_tpu_torch.native import MAX_PERIOD
from mtr_tpu_torch.ops.wrap_dp_counts import NEG, U_SPANS

# move codes
STOP, DIAG, DEL, INS = 0, 1, 2, 3

# kernel launches since the last reset
LAUNCHES = 0


def wrap_dp_fill_plain(scal: torch.Tensor, rep: torch.Tensor,
                       unit: torch.Tensor):
    """scal (B, 8) int32 [rep_len, unit_len, mg, mp, ip, 0, 0, 0], rep
    (B, r_pad) padded with -1, unit (B, u_pad) padded with -2 -> moves
    (r_pad, B, u_pad) uint8 (row r = DP row r + 1), best (B, 8) int32.

    best[:, 0] is the wrap column of DP row r_pad: 0 for every job
    shorter than r_pad (the Pallas kernel's value whenever its last row
    tile ends at r_pad)."""
    b, u_pad = unit.shape
    r_pad = rep.shape[1]
    log2u = (u_pad - 1).bit_length()
    if 1 << log2u != u_pad:
        raise ValueError(f"u_pad must be a power of two, got {u_pad}")
    i32 = torch.int32
    dev = unit.device
    scal = scal.to(i32)
    rep_len = scal[:, 0:1]
    unit_len = scal[:, 1:2]
    mg = scal[:, 2:3]
    mp = scal[:, 3:4]
    ip = scal[:, 4:5]

    jidx = torch.arange(u_pad, dtype=i32, device=dev).expand(b, u_pad)
    lane_ok = jidx < unit_len
    ulm1 = torch.clamp(unit_len - 1, min=0).long()  # wrap column
    j0 = jidx == 0
    shmasks = [jidx >= (1 << s) for s in range(log2u)]
    unit32 = unit.to(i32)
    rep32 = rep.to(i32)
    zero = torch.zeros((b, u_pad), dtype=i32, device=dev)
    col0 = torch.zeros((b, 1), dtype=i32, device=dev)

    moves = torch.zeros((r_pad, b, u_pad), dtype=torch.uint8, device=dev)
    prev = zero
    wrap_prev = bv = bi = bj = col0
    max_rep_len = int(rep_len.max()) if b else 0
    for r in range(max_rep_len):
        i = r + 1  # 1-origin DP row
        diag = torch.where(j0, wrap_prev, torch.roll(prev, 1, 1))
        mi = unit32 == rep32[:, r:r + 1]
        m_nomatch = torch.clamp(torch.maximum(diag - mp, prev - ip), min=0)
        m = torch.where(mi, diag + mg, m_nomatch)
        # deletion chain: Hillis-Steele scan of f_j(x) = max(a_j, x + c_j)
        a = m
        c = torch.where(mi | j0, NEG, -ip)
        for s in range(log2u):
            sh = 1 << s
            a_sh = torch.roll(a, sh, 1)
            c_sh = torch.roll(c, sh, 1)
            a = torch.where(shmasks[s], torch.maximum(a, a_sh + c), a)
            c = torch.where(shmasks[s], torch.clamp(c + c_sh, min=NEG), c)
        row = torch.where(mi, m, a)
        ok = lane_ok & (i <= rep_len)
        row = torch.where(ok, row, zero)
        wrap_val = row.gather(1, ulm1)

        left = torch.where(j0, wrap_val, torch.roll(row, 1, 1))
        e2 = row == diag - mp
        e3 = row == left - ip
        e4 = row == prev - ip
        mv = torch.where(
            mi | e2, DIAG,
            torch.where(e3, DEL, torch.where(e4, INS, STOP)))
        pos = (row > 0) & ok
        moves[r] = torch.where(pos, mv, STOP).to(torch.uint8)

        masked = torch.where(ok, row, -1)
        row_max = masked.amax(1, keepdim=True)
        row_arg = torch.where(masked == row_max, jidx,
                              u_pad + 1).amin(1, keepdim=True)
        better = row_max > bv  # strict: the first row wins
        bv = torch.where(better, row_max, bv)
        bi = torch.where(better, i, bi)
        bj = torch.where(better, row_arg + 1, bj)
        wrap_prev = wrap_val
        prev = row
    if max_rep_len < r_pad:
        wrap_prev = col0  # rows past every job are all zero
    best = torch.cat([wrap_prev, bv, bi, bj, col0, col0, col0, col0], dim=1)
    return moves, best


def traceback_consensus_plain(moves: torch.Tensor, rep: torch.Tensor,
                              unit_lens: torch.Tensor, best: torch.Tensor,
                              steps: int) -> torch.Tensor:
    """moves (r_pad, B, u_pad) uint8, rep (B, r_pad), unit_lens (B,), best
    (B, 8) -> (B, 500, 9) int32 [consensus(5) | missing(4)].

    Stops once every walk has stopped (later steps are no-ops); raises if
    a walk is still going after `steps` steps, where the JAX loop would
    truncate it silently.  Updates at a column index j >= 500 are
    dropped, as JAX's scatter drops them."""
    r_pad, b, u_pad = moves.shape
    dev = moves.device
    unit_len = unit_lens.to(dev).long()
    bidx = torch.arange(b, device=dev)
    rep64 = rep.long()
    i = best[:, 2].long()
    bj = best[:, 3].long()
    j = torch.where(bj == 0, unit_len, bj)
    done = i <= 0
    out = torch.zeros((b, MAX_PERIOD, 9), dtype=torch.int32, device=dev)
    flat_out = out.view(-1)
    for _ in range(steps):
        if bool(done.all()):
            break
        ii = torch.clamp(i - 1, 0, r_pad - 1)
        mv = moves[ii, bidx, torch.clamp(j - 1, 0, u_pad - 1)].long()
        mv = torch.where(done, STOP, mv)
        stop = mv == STOP
        is_diag = mv == DIAG
        is_del = mv == DEL
        is_ins = mv == INS
        base = rep64[bidx, ii]
        col = torch.where(is_diag, base, torch.where(is_del, 4, 5 + base))
        add = ~stop & (j < MAX_PERIOD)
        cell = (bidx * MAX_PERIOD + j) * 9 + col
        flat_out[cell[add]] += 1  # one cell per job: no repeated index
        ni = torch.where(is_diag | is_ins, i - 1, i)
        nj = torch.where(is_diag | is_del, j - 1, j)
        nj = torch.where(nj == 0, unit_len, nj)
        i = torch.where(stop, i, ni)
        j = torch.where(stop, j, nj)
        done = done | stop | (i <= 0)
    if not bool(done.all()):
        raise RuntimeError(
            f"consensus traceback: a walk is still going after {steps} steps")
    return out


def consensus_steps(r_pad: int, factor: int) -> int:
    """The traceback's step bound: a path has at most rep_len * (1 +
    ceil(mg/ip)) steps (wrap_dp_pallas.py:207-216); factor >= 1 +
    ceil(mg/ip) for every job, 2 * 500 of slack as in JAX."""
    return r_pad * factor + 2 * MAX_PERIOD


def wrap_dp_consensus(flat: torch.Tensor, starts: torch.Tensor,
                      scal: torch.Tensor, unit: torch.Tensor, u_span: int,
                      factor: int):
    """Resident consensus op: job b's rep codes are flat[starts[b] :
    starts[b] + scal[b, 0]].  flat (N,) int8, starts (B,) int32, scal
    (B, 8) int32, unit (B, u_span) int8 -> (fused (B, 500, 9) int32,
    best (B, 8) int32).

    CUDA tensors launch the kernels (the caller has checked the bounds
    named in wrap_dp_counts); CPU tensors run the plain versions.  Either
    raises if a traceback walk reaches its step bound."""
    tensors = (flat, starts, scal, unit)
    if all(t.device.type == "cpu" for t in tensors):
        from mtr_tpu_torch.ops.wrap_dp_resident import (
            consensus_resident_plain,
        )

        return consensus_resident_plain(flat, starts, scal, unit, factor)
    if not all(t.is_cuda and t.device == flat.device for t in tensors):
        raise ValueError("wrap_dp_consensus: tensors must all be on one "
                         "CUDA device or all on the CPU")
    return _launch(flat, starts, scal, unit, u_span, factor)


def _check_inputs(flat, starts, scal, unit, u_span, factor):
    if u_span not in U_SPANS:
        raise ValueError(f"u_span must be one of {U_SPANS}, got {u_span}")
    if factor < 1:
        raise ValueError(f"factor must be >= 1, got {factor}")
    b = scal.shape[0]
    for name, t, dtype, shape in (
        ("flat", flat, torch.int8, (flat.shape[0],)),
        ("starts", starts, torch.int32, (b,)),
        ("scal", scal, torch.int32, (b, 8)),
        ("unit", unit, torch.int8, (b, u_span)),
    ):
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"wrap_dp_consensus: {name} must be {dtype} of "
                             f"shape {shape}, got {t.dtype} {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"wrap_dp_consensus: {name} must be contiguous")


def move_row_bytes(unit_len):
    """Bytes of one packed move row for units of unit_len (int, numpy or
    torch): 32 lanes x WB, a lane's C = ceil(unit_len / 32) codes at 2 bits
    each in a word of WB = 1, 2 or 4 bytes (C <= 4, 8, 16)."""
    c = (unit_len + 31) // 32
    return 32 * (1 + (c > 4) * 1 + (c > 8) * 2)


def pack_moves(moves: torch.Tensor, scal: torch.Tensor):
    """The kernel's move layout, stated in plain PyTorch: moves (r_pad, B,
    u_pad) uint8 codes (as wrap_dp_fill_plain returns them) -> (packed
    uint8 bytes, mv_off (B,) int64).  Job b's rows r < rep_len lie at
    mv_off[b] + r * row_bytes; cell (r, j) is bits 2c..2c+1 of lane j // C's
    little-endian word of WB bytes, c = j % C (move_row_bytes)."""
    rep_len, unit_len = scal[:, 0].long(), scal[:, 1].long()
    rb = move_row_bytes(unit_len)
    sizes = rep_len * rb
    mv_off = torch.cumsum(sizes, 0) - sizes
    packed = torch.zeros(int(sizes.sum()), dtype=torch.uint8)
    mv = moves.cpu().long()
    for b in range(scal.shape[0]):
        n_r, wb = int(rep_len[b]), int(rb[b]) // 32
        c = max(1, -(-int(unit_len[b]) // 32))
        if not n_r:
            continue
        cells = torch.zeros((n_r, 32 * c), dtype=torch.long)
        w = min(32 * c, mv.shape[2])
        cells[:, :w] = mv[:n_r, b, :w]
        words = (cells.view(n_r, 32, c)
                 << (2 * torch.arange(c))).sum(2)           # (n_r, 32)
        byte = (words[:, :, None] >> (8 * torch.arange(wb))) & 255
        o = int(mv_off[b])
        packed[o : o + n_r * 32 * wb] = byte.reshape(-1).to(torch.uint8)
    return packed, mv_off


def prepare(flat, starts, scal, unit, u_span, factor):
    """Check a launch's inputs (CUDA tensors) and allocate its outputs and
    move scratch -> (launch, (fused, best, done, moves, mv_off)): launch()
    enqueues the kernel on the current stream (None when there is no job).
    _launch counts the launch; chip_smoke.py times launch() alone and
    reads the packed moves."""
    from mtr_tpu_torch.ops import _build

    _check_inputs(flat, starts, scal, unit, u_span, factor)
    b = scal.shape[0]
    dev = flat.device
    sizes = scal[:, 0].long() * move_row_bytes(scal[:, 1].long())
    mv_off = torch.cumsum(sizes, 0) - sizes
    moves = torch.empty(max(int(sizes.sum()) if b else 0, 1),
                        dtype=torch.uint8, device=dev)
    fused = torch.empty((b, MAX_PERIOD, 9), dtype=torch.int32, device=dev)
    best = torch.empty((b, 8), dtype=torch.int32, device=dev)
    done = torch.empty(b, dtype=torch.int32, device=dev)
    outs = (fused, best, done, moves, mv_off)
    if b == 0:
        return None, outs
    # the wrap column is the batch's final row, as in wrap_dp_counts
    max_rep = scal[:, 0].amax().reshape(1)
    lib = _build.library()
    stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)

    def launch():
        err = lib.mtr_wrap_dp_consensus(
            u_span, flat.data_ptr(), starts.data_ptr(), scal.data_ptr(),
            unit.data_ptr(), mv_off.data_ptr(), max_rep.data_ptr(),
            moves.data_ptr(), factor, best.data_ptr(), fused.data_ptr(),
            done.data_ptr(), b, stream)
        if err != 0:
            raise RuntimeError(f"wrap_dp_consensus kernel launch failed: "
                               f"CUDA error {err} (u_span={u_span}, B={b})")

    return launch, outs


def _launch(flat, starts, scal, unit, u_span, factor):
    global LAUNCHES
    launch, (fused, best, done, _, _) = prepare(flat, starts, scal, unit,
                                                u_span, factor)
    if launch is None:
        return fused, best
    launch()
    LAUNCHES += 1
    if not bool(done.all()):
        raise RuntimeError(
            "wrap_dp_consensus: a traceback walk reached its step bound "
            f"(rep_len * {factor} + {2 * MAX_PERIOD}) without stopping")
    return fused, best
