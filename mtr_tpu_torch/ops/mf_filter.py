"""The DBG walk pre-filter on a torch device: the counterpart of
mtr_tpu/ops/mf_filter.py.

A (range, k) walk query does table and walk work only when the max
multiplicity of its value multiset exceeds MIN_NUM_FREQ_UNIT
(consensus.c:532); otherwise its outputs are constants (found 0, no
rows).  walked_mask computes every query's max multiplicity on the
device, so the native engine walks only the queries that will.

The multiset and its max multiplicity are stage A's (ops/dbg_device.py:
max_freq: rolling codes, the raw-base tail, a stable row sort and run
lengths), not JAX's pairwise-equality cube, which XLA fused but which in
torch would materialise Q x V x V elements per chunk.  Queries wider than
FILTER_V_MAX go to the host unfiltered, as in JAX.  The reads are
uploaded on every call with int64 offsets: no cache keyed by array
identity, and no int32 truncation of positions.
"""

from __future__ import annotations

import numpy as np
import torch

from mtr_tpu_torch.ops.dbg_device import (
    MIN_NUM_FREQ_UNIT,
    bucket_chunks,
    check_queries,
    max_freq,
    upload_reads,
)

FILTER_V_MAX = 1024  # mtr_tpu/ops/mf_filter.py:33


def walked_mask(orgs, lens, ridx, qs, qe, k, device) -> np.ndarray:
    """Bool per query: True iff the native walk engine must process it
    (max multiplicity > MIN_NUM_FREQ_UNIT, or the range is wider than
    FILTER_V_MAX)."""
    n = len(ridx)
    out = np.ones(n, bool)
    ridx = np.asarray(ridx, np.int64)
    qs = np.asarray(qs, np.int64)
    qe = np.asarray(qe, np.int64)
    k = np.asarray(k, np.int64)
    V = qe - qs + 1
    near = np.nonzero(V <= FILTER_V_MAX)[0]
    if not len(near):
        return out
    check_queries(orgs, ridx, qs, qe)
    n_code = np.minimum(qe, np.asarray(lens, np.int64)[ridx] - k + 1) - qs

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(device)

    flat, offs = upload_reads(orgs, device)
    for v_pad, idx in bucket_chunks(near, V, FILTER_V_MAX):
        base = torch.from_numpy(offs[ridx[idx]] + qs[idx]).to(device)
        mf = max_freq(flat, base, put(n_code[idx]), put(V[idx]), put(k[idx]),
                      v_pad)
        out[idx] = mf.cpu().numpy() > MIN_NUM_FREQ_UNIT
    return out
