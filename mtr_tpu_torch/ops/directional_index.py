"""Directional-index sliding windows on a torch device (plain PyTorch; the
JAX originals, mtr_tpu/ops/directional_index.py:29-169, are jnp programs
with no Pallas kernel).

Manhattan: D(i) = sum_v |count_v(codes[i:i+w]) - count_v(codes[i+w:i+2w])|
for every position i (fill_directional_index.c:171-295), exact in
integers through per-symbol prefix sums over 256-symbol one-hot chunks.
Pearson: the per-position squared sums and inner products of three
adjacent windows' k-mer count vectors on the device, then the
sqrt/divide finish in host float64, so DI matches the C double math bit
for bit (fill_directional_index.c:298-450).

Codes are padded to a POS_BUCKETS length with -1, as in JAX; entries
whose windows reach past the codes are garbage and never read.  Every
device-to-host copy is an explicit .cpu() of the positions the caller
uses.  `make_di_compute` returns the `di_compute` plug-in of
mtr_tpu_torch.oracle.directional_index.fill_directional_index_with_end.

Over a mesh of several slots (parallel/mesh.py) the Manhattan pass is cut
by position (`sliding_l1_sharded`, `make_di_manhattan_sharded`; the JAX
original, :173-285, is a shard_map with a ring halo exchange): one
contiguous block of positions a slot, each computed from its own codes plus
the 2w codes to its right.  The sums are integers, so the blocks put
together equal the one-device pass bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

from mtr_tpu_torch.utils.timers import TIMERS

POS_BUCKETS = (16384, 131072, 1048576 + 65536)
_CHUNK = 256

# device DI passes since the last reset (the main path shows it ran here),
# and those of them cut over a mesh; the -c summary counts them by kind
# (di_manhattan_passes, di_pearson_passes, di_sharded_passes)
CALLS = 0
SHARDED_CALLS = 0


def _bucket(n: int) -> int:
    for b in POS_BUCKETS:
        if n <= b:
            return b
    return POS_BUCKETS[-1]


def _padded_codes(vals: np.ndarray, n_pos: int, device) -> torch.Tensor:
    codes = np.full(_bucket(n_pos), -1, np.int32)
    codes[:n_pos] = vals[:n_pos]
    return torch.from_numpy(codes).to(device)


def _prefix_counts(codes: torch.Tensor, lo: int, width: int,
                   tail: int) -> torch.Tensor:
    """(width, n_pad + 1 + tail) int32: column p counts symbol lo + v in
    codes[:p]; `tail` zero columns after the last so that slices up to
    `tail` further stay in range.  Symbol-major (the transpose of JAX's
    (n, width) layout): the scan runs along contiguous memory."""
    n_pad = codes.shape[0]
    onehot = torch.arange(lo, lo + width,
                          device=codes.device)[:, None] == codes[None, :]
    P = torch.zeros((width, n_pad + 1 + tail), dtype=torch.int32,
                    device=codes.device)
    # dtype: an int32 prefix sum (the default would be int64, twice the
    # bytes at every bucket)
    torch.cumsum(onehot, 1, dtype=torch.int32, out=P[:, 1 : n_pad + 1])
    return P


def _sliding_l1_device(codes: torch.Tensor, k: int, w: int) -> torch.Tensor:
    """codes (n_pad,) int32 padded with -1 -> D (n_pad,) int64 over the
    padded range."""
    n_pad = codes.shape[0]
    D = torch.zeros(n_pad, dtype=torch.int64, device=codes.device)
    for lo in range(0, 4**k, _CHUNK):
        width = min(_CHUNK, 4**k - lo)
        P = _prefix_counts(codes, lo, width, 2 * w)
        # diff(i) = 2*P[i+w] - P[i] - P[i+2w], in place
        diff = P[:, w : w + n_pad] * 2
        diff -= P[:, :n_pad]
        diff -= P[:, 2 * w : 2 * w + n_pad]
        D += diff.abs_().sum(0)
    return D


def sliding_l1_device(vals: np.ndarray, w: int, n_out: int,
                      device) -> np.ndarray:
    """Drop-in for oracle.directional_index.sliding_l1 on `device`."""
    global CALLS
    n_pos = n_out + 2 * w - 1
    k = 1
    vmax = int(vals[:n_pos].max()) if n_pos else 0
    while 4**k <= vmax:
        k += 1
    CALLS += 1
    TIMERS.count("di_manhattan_passes")
    D = _sliding_l1_device(_padded_codes(vals, n_pos, device), k, w)
    return D[:n_out].cpu().numpy()


def di_manhattan_device(buf: np.ndarray, di_len: int, w: int, k: int,
                        rsl: int, device) -> np.ndarray:
    """Manhattan DI pass with the oracle's bounds and placement."""
    di_tmp = np.full(di_len, -1.0)
    n_i = di_len - w - rsl - k + 1
    if n_i <= 0:
        return di_tmp
    D = sliding_l1_device(buf, w, n_i + w, device)
    d01 = D[:n_i]
    d12 = D[w : w + n_i]
    di_tmp[w : w + n_i] = (d01 - d12) / float(2 * w)
    return di_tmp


def _pearson_moments_device(codes: torch.Tensor, k: int, w: int):
    """-> (q0, q1, q2, ip01, ip12) int64 over the padded range: squared
    sums and inner products of the three adjacent w-windows' k-mer count
    vectors."""
    n_pad = codes.shape[0]
    dev = codes.device
    acc = [torch.zeros(n_pad, dtype=torch.int64, device=dev)
           for _ in range(5)]
    for lo in range(0, 4**k, _CHUNK):
        width = min(_CHUNK, 4**k - lo)
        P = _prefix_counts(codes, lo, width, 3 * w)
        W0 = P[:, w : w + n_pad] - P[:, :n_pad]
        W1 = P[:, 2 * w : 2 * w + n_pad] - P[:, w : w + n_pad]
        W2 = P[:, 3 * w : 3 * w + n_pad] - P[:, 2 * w : 2 * w + n_pad]
        for a, (x, y) in zip(acc, ((W0, W0), (W1, W1), (W2, W2), (W0, W1),
                                   (W1, W2))):
            a += (x * y).sum(0)
    return acc


def di_pearson_device(buf: np.ndarray, di_len: int, w: int, k: int, rsl: int,
                      device) -> np.ndarray:
    """Pearson DI pass: moments on `device`, host float64 finish."""
    global CALLS
    di_tmp = np.full(di_len, -1.0)
    n_i = di_len - w - rsl - k + 1
    if n_i <= 0:
        return di_tmp
    n_pos = n_i + 3 * w - 1
    CALLS += 1
    TIMERS.count("di_pearson_passes")
    moments = _pearson_moments_device(_padded_codes(buf, n_pos, device), k, w)
    q0, q1, q2, ip01, ip12 = (
        a[:n_i].cpu().numpy().astype(np.int64) for a in moments)
    n4k = float(4**k)
    s = float(w)
    sd0 = np.sqrt(q0 * n4k - s * s)
    sd1 = np.sqrt(q1 * n4k - s * s)
    sd2 = np.sqrt(q2 * n4k - s * s)
    with np.errstate(divide="ignore", invalid="ignore"):
        p01 = np.where(sd0 * sd1 > 0, (ip01 * n4k - s * s) / (sd0 * sd1), 0.0)
        p12 = np.where(sd1 * sd2 > 0, (ip12 * n4k - s * s) / (sd1 * sd2), 0.0)
    di_tmp[w : w + n_i] = p12 - p01
    return di_tmp


def sliding_l1_sharded(vals: np.ndarray, w: int, n_out: int, mesh, k: int,
                       halo: int = 20480) -> np.ndarray:
    """Drop-in for sliding_l1 with the positions cut over `mesh`: slot s
    computes D for positions [s * local_n, (s + 1) * local_n) from its own
    block of codes plus the 2w codes to its right, which reach into as many
    later blocks as they need (the JAX original's ring hops) and read -1
    past the last code.  `halo` is the longest halo the caller's sweep may
    ask for (2 * w <= halo, as in JAX, where it sizes the program)."""
    global CALLS, SHARDED_CALLS
    if 2 * w > halo:
        raise ValueError(f"window {w} needs a halo of {2 * w} > {halo}")
    n_pos = n_out + 2 * w - 1
    local_n = -(-max(n_pos, 1) // mesh.size)
    codes = np.full(local_n * mesh.size + 2 * w, -1, np.int32)
    codes[:n_pos] = vals[:n_pos]
    CALLS += 1
    SHARDED_CALLS += 1
    TIMERS.count("di_sharded_passes")
    blocks = []
    for s, dev in enumerate(mesh.devices):
        ext = torch.from_numpy(
            codes[s * local_n : (s + 1) * local_n + 2 * w]).to(dev)
        blocks.append(_sliding_l1_device(ext, k, w)[:local_n])
    # every slot's pass is queued before the first copy back waits
    return np.concatenate([b.cpu().numpy() for b in blocks])[:n_out]


def make_di_manhattan_sharded(mesh):
    """The di_compute plug-in of fill_directional_index_with_end that runs
    each Manhattan pass cut by position over `mesh` (counterpart of
    mtr_tpu/ops/directional_index.py:248-271)."""

    def di_compute(buf, di_len: int, w: int, k: int, rsl: int):
        di_tmp = np.full(di_len, -1.0)
        n_i = di_len - w - rsl - k + 1
        if n_i <= 0:
            return di_tmp
        n_pos = n_i + 3 * w - 1
        kk = 1
        vmax = int(buf[:n_pos].max()) if n_pos > 0 else 0
        while 4**kk <= vmax:
            kk += 1
        with TIMERS.section("di_device"):
            D = sliding_l1_sharded(buf, w, n_i + w, mesh, kk)
        d01 = D[:n_i]
        d12 = D[w : w + n_i]
        di_tmp[w : w + n_i] = (d01 - d12) / float(2 * w)
        return di_tmp

    return di_compute


def make_di_compute(device, manhattan: bool):
    """The di_compute plug-in of
    mtr_tpu_torch.oracle.directional_index.fill_directional_index_with_end,
    running each (k, w) pass on `device`."""
    device = torch.device(device)
    fn = di_manhattan_device if manhattan else di_pearson_device

    def di_compute(buf, di_len: int, w: int, k: int, rsl: int):
        with TIMERS.section("di_device"):
            return fn(buf, di_len, w, k, rsl, device)

    return di_compute
