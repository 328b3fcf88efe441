"""Counts-mode wrap-around DP: the plain PyTorch version and the public op.

The function is the fill plus traceback counts of wrap_around_DP.c:222-354,
one (B, 15) int32 row per job:

    [m, x, ins, del, scanned, i_final, done | wrap, best, max_i, max_j,
     m, ins, si, 0]

`wrap_dp_counts_plain` is a line-for-line port of
`mtr_tpu/ops/wrap_dp_xla.py::make_wrap_dp_counts_xla`, the simplest
statement of the function (no TPU packing, units up to 512).  Jobs ride
the batch dim and the unit the minor dim; the in-row deletion chain is a
flag-carrying segmented Kogge-Stone max scan, the aux (m, ins, si) copy an
origin-index scan plus gathers, and the argmax is tracked per (job, lane)
and resolved row-major-first at the end.  Column 7 (wrap) is the last
column of the batch's final row, so it is 0 for every job shorter than
the batch's longest, exactly as in the JAX kernels.

`wrap_dp_counts` is the resident form used by the device batcher: rep
codes are read from the batch's flat int8 reads at `starts`, and unit
rows are u_span codes wide, a multiple of 32 (the kernel gives each job
C = ceil(unit_len / 32) columns a lane, so jobs of every unit width share
one launch).  CUDA tensors launch the hand-written
kernel (csrc/wrap_dp_counts.cu), or the call raises; CPU tensors run the
plain version.
"""

from __future__ import annotations

import ctypes

import torch

NEG = -(1 << 30)
# unit row widths the kernel takes: 32 * C, C = 1..16 columns a lane
# (units 1-512)
U_SPANS = tuple(32 * c for c in range(1, 17))
# kernel bounds, asserted by the dispatcher (pipeline.TorchDPBatcher):
# rep_len <= R_MAX (the JAX package's largest rep bucket) and, per job,
# the scan value rep_len*mg + ip*u_span_for(unit_len) (D[j] + ip*j) must
# fit int32
R_MAX = 1 << 20
VALUE_LIMIT = 1 << 31

# kernel launches since the last reset (the main path shows it ran here)
LAUNCHES = 0


def u_span_for(unit_len: int) -> int:
    """32 * C for a unit, C = ceil(unit_len / 32) the columns a lane holds
    in the counts kernel."""
    span = 32 * max(1, -(-unit_len // 32))
    if span > U_SPANS[-1]:
        raise ValueError(f"unit_len {unit_len} exceeds the largest span "
                         f"{U_SPANS[-1]}")
    return span


def wrap_dp_counts_plain(scal: torch.Tensor, rep: torch.Tensor,
                         unit: torch.Tensor) -> torch.Tensor:
    """scal (B, 8) int32 [rep_len, unit_len, mg, mp, ip, 0, 0, 0],
    rep (B, r_pad) int8 padded with -1, unit (B, u_pad) int8 left-aligned
    and padded with -2 -> (B, 15) int32 (layout in the module docstring)."""
    b, u_pad = unit.shape
    n_lev = (u_pad - 1).bit_length()
    if 1 << n_lev != u_pad:
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
    zero = torch.zeros((b, u_pad), dtype=i32, device=dev)
    ulm1 = torch.clamp(unit_len - 1, min=0).long()  # (B, 1) gather index
    ipj = ip * jidx
    sub_ok = jidx < unit_len
    j0 = jidx == 0
    edges = [jidx < (1 << s) for s in range(n_lev)]
    unit32 = unit.to(i32)
    rep32 = rep.to(i32)
    max_rep_len = int(rep_len.max()) if b else 0

    prev = auxm = auxi = auxs = bv = bi = bm = bins = bsi = zero
    for r in range(max_rep_len):
        i = r + 1
        rep_c = rep32[:, r:r + 1]
        mi = unit32 == rep_c
        wrapv = prev.gather(1, ulm1)
        diag = torch.where(j0, wrapv, torch.roll(prev, 1, 1))
        m_nm = torch.clamp(torch.maximum(diag - mp, prev - ip), min=0)
        m = torch.where(mi, diag + mg, m_nm)

        t = m + ipj
        fi = (mi | j0).to(i32)
        for s in range(n_lev):
            sh = 1 << s
            t_r = torch.where(edges[s], NEG, torch.roll(t, sh, 1))
            f_r = torch.where(edges[s], 1, torch.roll(fi, sh, 1))
            t = torch.where(fi > 0, t, torch.maximum(t, t_r))
            fi = fi | f_r
        chain = t - ipj
        row = torch.where(mi, m, chain)
        ok = sub_ok & (i <= rep_len)
        row = torch.where(ok, row, zero)

        pos = (row > 0) & ok
        is_m = mi & pos
        e2v = row == diag - mp
        not_mi = ~mi
        sel_x = not_mi & e2v & pos
        rem = pos & not_mi & ~e2v
        left = torch.where(j0, row.gather(1, ulm1), torch.roll(row, 1, 1))
        e3v = row == left - ip
        sel_d = rem & e3v
        sel_diag = is_m | sel_x

        daux_m = torch.where(j0, auxm.gather(1, ulm1), torch.roll(auxm, 1, 1))
        daux_i = torch.where(j0, auxi.gather(1, ulm1), torch.roll(auxi, 1, 1))
        daux_s = torch.where(j0, auxs.gather(1, ulm1), torch.roll(auxs, 1, 1))
        mi_i = mi.to(i32)
        base_m = torch.where(sel_diag, daux_m + mi_i,
                             torch.where(pos, auxm, zero))
        base_i = torch.where(sel_diag, daux_i,
                             torch.where(pos, auxi + 1, zero))
        base_s = torch.where(sel_diag, daux_s,
                             torch.where(pos, auxs, zero + i))

        org = torch.where(sel_d, -1, jidx)
        for s in range(n_lev):
            sh = 1 << s
            org = torch.maximum(
                org, torch.where(edges[s], -1, torch.roll(org, sh, 1)))
        open_ = org < 0
        orgc = torch.clamp(org, min=0).long()
        org_last = orgc.gather(1, ulm1)
        fin_m = torch.where(open_, base_m.gather(1, org_last),
                            base_m.gather(1, orgc))
        fin_i = torch.where(open_, base_i.gather(1, org_last),
                            base_i.gather(1, orgc))
        fin_s = torch.where(open_, base_s.gather(1, org_last),
                            base_s.gather(1, orgc))

        better = row > bv
        bv = torch.where(better, row, bv)
        bi = torch.where(better, zero + i, bi)
        bm = torch.where(better, fin_m, bm)
        bins = torch.where(better, fin_i, bins)
        bsi = torch.where(better, fin_s, bsi)
        prev, auxm, auxi, auxs = row, fin_m, fin_i, fin_s

    # row-major-first global argmax resolution (wrap_around_DP.c:276-281):
    # max value, then smallest row, then smallest lane
    big = 1 << 30
    gmax = bv.amax(1, keepdim=True)
    cand = bv == gmax
    min_bi = torch.where(cand, bi, big).amin(1, keepdim=True)
    cand2 = cand & (bi == min_bi)
    jstar = torch.where(cand2, jidx, big).amin(1, keepdim=True)
    found = gmax > 0
    js = jstar.long()
    arg_m = bm.gather(1, js)
    arg_i = bins.gather(1, js)
    arg_s = bsi.gather(1, js)
    max_i = torch.where(found, min_bi, 0)
    max_j = torch.where(found, jstar + 1, 0)
    wrap_val = prev.gather(1, ulm1)
    zcol = torch.zeros((b, 1), dtype=i32, device=dev)
    out = torch.cat(
        [wrap_val, gmax, max_i, max_j,
         torch.where(found, arg_m, 0),
         torch.where(found, arg_i, 0),
         torch.where(found, arg_s, 0),
         zcol],
        dim=1,
    )

    bvv, bii = out[:, 1], out[:, 2]
    mm, ins, si = out[:, 4], out[:, 5], out[:, 6]
    mgv, mpv, ipv = scal[:, 2], scal[:, 3], scal[:, 4]
    x = bii - si - mm - ins                      # read-consumption identity
    dl = torch.div(mm * mgv - x * mpv - bvv - ins * ipv, ipv,
                   rounding_mode="floor")        # score identity, jnp's //
    scanned = mm + x + dl
    done = torch.ones_like(mm)
    tb = torch.stack([mm, x, ins, dl, scanned, si, done], dim=1)
    return torch.cat([tb, out], dim=1)


def wrap_dp_counts(flat: torch.Tensor, starts: torch.Tensor,
                   scal: torch.Tensor, unit: torch.Tensor,
                   u_span: int) -> torch.Tensor:
    """Resident counts op: job b's rep codes are flat[starts[b] :
    starts[b] + scal[b, 0]].  flat (N,) int8, starts (B,) int32, scal
    (B, 8) int32, unit (B, u_span) int8 -> (B, 15) int32.

    CUDA tensors launch the kernel (the caller has checked the bounds
    named at R_MAX / VALUE_LIMIT); CPU tensors run the plain version."""
    tensors = (flat, starts, scal, unit)
    if all(t.device.type == "cpu" for t in tensors):
        # imported here: wrap_dp_resident imports this module
        from mtr_tpu_torch.ops.wrap_dp_resident import counts_resident_plain

        return counts_resident_plain(flat, starts, scal, unit)
    if not all(t.is_cuda and t.device == flat.device for t in tensors):
        raise ValueError("wrap_dp_counts: tensors must all be on one CUDA "
                         "device or all on the CPU")
    return _launch(flat, starts, scal, unit, u_span)


def _launch(flat, starts, scal, unit, u_span):
    global LAUNCHES
    from mtr_tpu_torch.ops import _build

    if u_span not in U_SPANS:
        raise ValueError(f"u_span must be one of {U_SPANS}, got {u_span}")
    b = scal.shape[0]
    for name, t, dtype, shape in (
        ("flat", flat, torch.int8, (flat.shape[0],)),
        ("starts", starts, torch.int32, (b,)),
        ("scal", scal, torch.int32, (b, 8)),
        ("unit", unit, torch.int8, (b, u_span)),
    ):
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"wrap_dp_counts: {name} must be {dtype} of "
                             f"shape {shape}, got {t.dtype} {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"wrap_dp_counts: {name} must be contiguous")
    out = torch.empty((b, 15), dtype=torch.int32, device=flat.device)
    if b == 0:
        return out
    # the wrap column is the batch's final row (see module docstring)
    max_rep = scal[:, 0].amax().reshape(1)
    lib = _build.library()
    stream = torch.cuda.current_stream(flat.device).cuda_stream
    err = lib.mtr_wrap_dp_counts(
        u_span, flat.data_ptr(), starts.data_ptr(), scal.data_ptr(),
        unit.data_ptr(), max_rep.data_ptr(), out.data_ptr(), b,
        ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(
            f"wrap_dp_counts kernel launch failed: CUDA error {err} "
            f"(u_span={u_span}, B={b})")
    LAUNCHES += 1
    return out
