"""Device-resident read feeding for the counts op (counterpart of
mtr_tpu/ops/wrap_dp_resident.py).

A batch's reads are uploaded once as one flat int8 array; every job's rep
stream is a segment of it starting at `starts[b]` (wrap_around_DP.c:237-244
fills from `orgInputString + query_start`).  The CUDA kernel reads
`flat[start + i]` itself, so no (B, r_pad) tensor is built on the card;
the plain path gathers the segments here.

A segment may run past its own read into the next read's bases: harmless,
rows beyond scal[:, 0] (= rep_len) are masked before any value is used.
Past the END of flat the gather masks with -1 and never clamps: a clamp
would shift the segment silently.  Padded rows use start = 0 with
rep_len = 0, unit_len = 2 and scheme (1, 1, 1).
"""

from __future__ import annotations

import torch

from mtr_tpu_torch.ops.wrap_dp_counts import wrap_dp_counts_plain


def gather_segments(flat: torch.Tensor, starts: torch.Tensor,
                    r_pad: int) -> torch.Tensor:
    """(B,) starts -> (B, r_pad) int8 segments of the 1-D flat array,
    -1 past its end."""
    idx = starts.long()[:, None] + torch.arange(r_pad, device=flat.device)
    inside = idx < flat.shape[0]
    seg = flat[torch.where(inside, idx, 0)]
    return torch.where(inside, seg, torch.full_like(seg, -1))


def counts_resident_plain(flat: torch.Tensor, starts: torch.Tensor,
                          scal: torch.Tensor,
                          unit: torch.Tensor) -> torch.Tensor:
    """Plain counterpart of the resident kernel: gather, then fill."""
    r_pad = max(1, int(scal[:, 0].max())) if scal.shape[0] else 1
    return wrap_dp_counts_plain(scal, gather_segments(flat, starts, r_pad),
                                unit)
