"""Device-resident read feeding for the counts and consensus ops
(counterpart of mtr_tpu/ops/wrap_dp_resident.py).

A batch's reads are uploaded once as one flat int8 array; every job's rep
stream is a segment of it starting at `starts[b]` (wrap_around_DP.c:237-244
fills from `orgInputString + query_start`).  The CUDA kernels read
`flat[start + i]` themselves, so no (B, r_pad) tensor is built on the
card; the plain paths gather the segments here.

A segment may run past its own read into the next read's bases: harmless,
rows beyond scal[:, 0] (= rep_len) are masked before any value is used.
Past the END of flat the gather masks with -1 and never clamps: a clamp
would shift the segment silently.  Padded rows use start = 0 with
rep_len = 0, unit_len = 2 and scheme (1, 1, 1).
"""

from __future__ import annotations

import torch

from mtr_tpu_torch.ops.wrap_dp_consensus import (
    consensus_steps,
    traceback_consensus_plain,
    wrap_dp_fill_plain,
)
from mtr_tpu_torch.ops.wrap_dp_counts import wrap_dp_counts_plain


def gather_segments(flat: torch.Tensor, starts: torch.Tensor,
                    r_pad: int) -> torch.Tensor:
    """(B,) starts -> (B, r_pad) int8 segments of the 1-D flat array,
    -1 past its end."""
    idx = starts.long()[:, None] + torch.arange(r_pad, device=flat.device)
    inside = idx < flat.shape[0]
    seg = flat[torch.where(inside, idx, 0)]
    return torch.where(inside, seg, torch.full_like(seg, -1))


def _r_pad(scal: torch.Tensor) -> int:
    return max(1, int(scal[:, 0].max())) if scal.shape[0] else 1


def _pow2_units(unit: torch.Tensor) -> torch.Tensor:
    """Unit rows padded with -2 to the power of two the plain scans
    need."""
    u_pad = 1 << (unit.shape[1] - 1).bit_length()
    if u_pad == unit.shape[1]:
        return unit
    return torch.nn.functional.pad(unit, (0, u_pad - unit.shape[1]),
                                   value=-2)


def counts_resident_plain(flat: torch.Tensor, starts: torch.Tensor,
                          scal: torch.Tensor,
                          unit: torch.Tensor) -> torch.Tensor:
    """Plain counterpart of the resident counts kernel: gather, then
    fill."""
    return wrap_dp_counts_plain(
        scal, gather_segments(flat, starts, _r_pad(scal)), _pow2_units(unit))


def consensus_resident_plain(flat: torch.Tensor, starts: torch.Tensor,
                             scal: torch.Tensor, unit: torch.Tensor,
                             factor: int):
    """Plain counterpart of the resident consensus kernel: gather, fill,
    then the bounded traceback -> ((B, 500, 9) int32, best (B, 8))."""
    r_pad = _r_pad(scal)
    rep = gather_segments(flat, starts, r_pad).to(torch.int32)
    moves, best = wrap_dp_fill_plain(scal, rep, _pow2_units(unit).to(
        torch.int32))
    fused = traceback_consensus_plain(moves, rep, scal[:, 1], best,
                                      consensus_steps(r_pad, factor))
    return fused, best
