"""The least time an NVIDIA H100 SXM needs for a kernel's work, counted
from the inputs handed to the op (never from what a kernel does).

Peaks, at the card's 700 W power limit:
  * HBM3 bandwidth 3.35 TB/s: NVIDIA's H100 SXM data sheet;
  * int32 operations 16.73 T/s: derived, not published: 132 SMs x 64
    int32 lanes an SM (half its 128 fp32 lanes) x 1.98 GHz boost clock,
    all from the data sheet.
A card set below 700 W runs slower under load: report its power.limit
(nvidia-smi) beside every share of these peaks.

Each function returns (ops, bytes); `least_s` turns that into seconds and
names the bound.  Bytes count each input read once and each output
written once.
"""

from __future__ import annotations

import numpy as np

SMS = 132
INT32_LANES_PER_SM = 64
BOOST_HZ = 1.98e9
INT32_OPS_PER_S = SMS * INT32_LANES_PER_SM * BOOST_HZ
HBM_BYTES_PER_S = 3.35e12
PEAK_SOURCE = ("H100 SXM data sheet: HBM3 3.35 TB/s; int32 derived as "
               "132 SMs x 64 lanes x 1.98 GHz = 16.73 T/s")

# int32 operations a cell of the counts-mode wrap-around DP needs: the
# recurrence, the traceback precedence and the three payloads carried
# through the fill
COUNTS_OPS_PER_CELL = 30
# a position of a DI pass: Manhattan (two windows' bins updated, |diff|
# kept incrementally) and Pearson (three windows, five moments)
DI_OPS_PER_POSITION = {"l1": 16, "pcc": 36}
# consensus-mode DP: a fill cell, and a traceback step (one a row)
CONSENSUS_OPS_PER_CELL = 20
CONSENSUS_OPS_PER_TRACEBACK_ROW = 10


def least_s(ops: float, n_bytes: float) -> tuple[float, str]:
    """(least seconds, "operations" or "bytes"): the larger of the two
    times, and which one it is."""
    t_ops, t_bytes = ops / INT32_OPS_PER_S, n_bytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def counts_work(scal: np.ndarray) -> tuple[int, int]:
    """A counts launch's jobs, from its (B, 8) int32 scal rows
    [rep_len, unit_len, mg, mp, ip, ...]: rep_len x unit_len cells at
    COUNTS_OPS_PER_CELL each; bytes: the rep codes (int8) and unit codes
    (int8) read once, scal (8 int32) read and the (15 int32) result row
    written once a job."""
    rep_len = scal[:, 0].astype(np.int64)
    unit_len = scal[:, 1].astype(np.int64)
    cells = int((rep_len * unit_len).sum())
    n_bytes = int(rep_len.sum() + unit_len.sum()) + len(scal) * (8 + 15) * 4
    return cells * COUNTS_OPS_PER_CELL, n_bytes


def di_passes(di_len: int, ws, k: int, rsl: int, manhattan: bool):
    """The passes a group launch of one k computes, as the port's DI
    plug-in receives them (fill_directional_index_with_end's
    di_compute_k(buf, di_len, ws, k, rsl)): (n_out, w) for every w whose
    pass has positions; Manhattan computes D on n_i + w positions,
    Pearson the moments on n_i."""
    out = []
    for w in ws:
        n_i = di_len - w - rsl - k + 1
        if n_i > 0:
            out.append((n_i + w if manhattan else n_i, w))
    return out


def di_work(passes, manhattan: bool) -> tuple[int, int]:
    """A DI group's work: DI_OPS_PER_POSITION a position of every pass;
    bytes: the group's codes read once (int32, over the longest pass:
    n_out + windows x w - 1) and D (Pearson: five moments) written once
    as int32."""
    kind, n_win, n_res = ("l1", 2, 1) if manhattan else ("pcc", 3, 5)
    if not passes:
        return 0, 0
    n_codes = max(n + n_win * w - 1 for n, w in passes)
    positions = sum(n for n, _ in passes)
    return positions * DI_OPS_PER_POSITION[kind], n_codes * 4 + n_res * positions * 4


def consensus_work(scal: np.ndarray) -> tuple[int, int]:
    """A consensus launch (for a later metric): CONSENSUS_OPS_PER_CELL a
    fill cell, CONSENSUS_OPS_PER_TRACEBACK_ROW a row of traceback; bytes:
    codes and units read once, a 5 + 4 int32 count row written a unit
    column and job."""
    rep_len = scal[:, 0].astype(np.int64)
    unit_len = scal[:, 1].astype(np.int64)
    ops = int((rep_len * unit_len).sum()) * CONSENSUS_OPS_PER_CELL \
        + int(rep_len.sum()) * CONSENSUS_OPS_PER_TRACEBACK_ROW
    n_bytes = int(rep_len.sum() + unit_len.sum()) + int(unit_len.sum()) * 9 * 4
    return ops, n_bytes
