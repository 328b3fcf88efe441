"""The port's device DI (plain PyTorch, here on the CPU) against
mtr_tpu's device DI (jnp on the CPU), the oracle and the native host
pass.  Manhattan values are integers and compared exactly; Pearson values
come from the same integer moments and the same float64 finish, so they
are compared exactly too, as are the final DI ranges."""

import itertools
import os

import numpy as np
import pytest
import torch

from mtr_tpu.io.fasta import iter_fasta
from mtr_tpu.ops import directional_index as jax_di
from mtr_tpu.oracle.arena import Arena
from mtr_tpu.oracle.directional_index import (
    di_pearson,
    fill_directional_index_with_end,
    init_input_w_rand,
    sliding_l1,
)
from mtr_tpu_torch.ops import directional_index as di
from mtr_tpu_torch.utils.timers import TIMERS

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")
CPU = torch.device("cpu")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _reads(name, picks=None):
    reads = list(iter_fasta(os.path.join(GOLDEN, f"{name}.fasta")))
    return reads if picks is None else [reads[i] for i in picks]


def _rsl(read):
    return 100 if read.length < 1000 else read.length // 10


@pytest.mark.parametrize("w", [5, 20, 80])
@pytest.mark.parametrize("vmax", [4, 64, 1024])
def test_sliding_l1_matches_jax_and_oracle(w, vmax):
    rng = np.random.default_rng(w * vmax)
    vals = rng.integers(0, vmax, 5000).astype(np.int32)
    got = di.sliding_l1_device(vals, w, 1000, CPU)
    np.testing.assert_array_equal(got, jax_di.sliding_l1_device(vals, w, 1000))
    np.testing.assert_array_equal(got, sliding_l1(vals, w, 1000,
                                                  use_native=False))
    np.testing.assert_array_equal(got, sliding_l1(vals, w, 1000))


@pytest.mark.parametrize("k,w", [(1, 5), (3, 20), (5, 40)])
def test_pearson_matches_jax_and_oracle(k, w):
    read = _reads("multitr_gen_2_5_10_20")[0]
    arena = Arena()
    arena.load_read(read.codes)
    rsl = _rsl(read)
    di_len = read.length + 2 * rsl
    init_input_w_rand(arena, k, read.length, rsl)
    buf = arena.input_w_rand
    got = di.di_pearson_device(buf, di_len, w, k, rsl, CPU)
    np.testing.assert_array_equal(
        got, jax_di.di_pearson_device(buf, di_len, w, k, rsl))
    np.testing.assert_array_equal(got, di_pearson(buf, di_len, w, k, rsl))


def _ranges(read, manhattan, di_compute=None):
    arena = Arena()
    arena.load_read(read.codes)
    return fill_directional_index_with_end(
        arena, read.length, _rsl(read), manhattan=manhattan,
        di_compute=di_compute)


def _port_ranges(read, manhattan, **plug):
    from mtr_tpu_torch.oracle.arena import Arena as PortArena
    from mtr_tpu_torch.oracle.directional_index import (
        fill_directional_index_with_end as port_fill,
    )

    arena = PortArena()
    arena.load_read(read.codes)
    return port_fill(arena, read.length, _rsl(read), manhattan=manhattan,
                     **plug)


def _one_pass(plug_k):
    """The one-pass form of a grouped plug-in: the di_compute of mtr_tpu's
    sweep, a (k, w) pass a call."""
    return lambda buf, di_len, w, k, rsl: plug_k(buf, di_len, [w], k,
                                                 rsl)[0]


def di_passes():
    return sum(TIMERS.counters[c] for c in di.PASS_COUNTERS)


@pytest.mark.parametrize("name,picks,manhattan", [
    ("multi20_100x10", [0, 7, 19], True),
    ("multitr_gen_2_5_10_20", None, True),
    ("multitr_gen_2_5_10_20", None, False),
])
def test_full_di_ranges_match_host(name, picks, manhattan):
    """fill_directional_index_with_end with the port's grouped plug-in
    (every w of a k at once, in the port's sweep) and with its one-pass
    form (in mtr_tpu's sweep) against the native host pass
    (di_compute=None)."""
    plug_k = di.make_di_compute_k(CPU, manhattan)
    before = di_passes()
    for read in _reads(name, picks):
        want = _ranges(read, manhattan)
        for got in (_ranges(read, manhattan, _one_pass(plug_k)),
                    _port_ranges(read, manhattan, di_compute_k=plug_k)):
            for a, b in zip(got, want):
                np.testing.assert_array_equal(a, b)
    assert di_passes() > before


@pytest.mark.parametrize("manhattan", [True, False])
def test_grouped_plugin_matches_per_pass_native_and_jax(manhattan):
    """One read's ranges through the port's sweep with the grouped plug-in,
    with the grouped plug-in called a pass at a time and with the native
    fill_di, and through mtr_tpu's sweep with its jnp device passes: all
    equal, and the grouped plug-in takes each k's passes in one call."""
    read = _reads("multitr_gen_2_5_10_20")[0]
    jax_plug = (jax_di.di_manhattan_device if manhattan
                else jax_di.di_pearson_device)
    calls = []
    plug_k = di.make_di_compute_k(CPU, manhattan)

    def spy(buf, di_len, ws, k, rsl):
        calls.append((k, list(ws)))
        return plug_k(buf, di_len, ws, k, rsl)

    def per_pass(buf, di_len, ws, k, rsl):
        return [plug_k(buf, di_len, [w], k, rsl)[0] for w in ws]

    want = _ranges(read, manhattan, jax_plug)
    for got in (_port_ranges(read, manhattan, di_compute_k=spy),
                _port_ranges(read, manhattan, di_compute_k=per_pass),
                _port_ranges(read, manhattan)):
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
    sweep = {1: 20, 3: 80, 5: 10240}
    assert [k for k, _ in calls] == [1, 3, 5]
    for k, ws in calls:
        assert ws == [w for w in (5 * 2**i for i in range(12))
                      if w <= sweep[k] and w < read.length // 2]


# ------------------------------------------------- the unpadded plain versions

# n_pos just past the old position buckets 16,384 and 131,072, where the
# padded length changed (mtr_tpu pads to the bucket, the port not at all)
PAST_BUCKETS = (16384 + 1, 131072 + 1)


@pytest.mark.parametrize("n_pos,vmax,w", [
    (PAST_BUCKETS[0], 4, 640), (PAST_BUCKETS[0], 64, 10), (PAST_BUCKETS[0],
                                                           1024, 2560),
    (PAST_BUCKETS[1], 4, 80)])
def test_unpadded_sliding_l1_past_the_old_buckets(n_pos, vmax, w):
    """The unpadded plain version against mtr_tpu's padded jnp program and
    the oracle, vmax up to 1,023; codes past n_pos are never read."""
    rng = np.random.default_rng(n_pos + vmax)
    vals = rng.integers(0, vmax, n_pos + 100).astype(np.int32)
    vals[n_pos:] = 5000  # past the pass: outside the kernels' range
    n_out = n_pos - 2 * w + 1
    got = di.sliding_l1_device(vals, w, n_out, CPU)
    assert got.dtype == np.int64 and got.shape == (n_out,)
    np.testing.assert_array_equal(got, jax_di.sliding_l1_device(vals, w, n_out))
    np.testing.assert_array_equal(got, sliding_l1(vals[:n_pos], w, n_out,
                                                  use_native=False))


def _pearson_buf(rng, n_pos, w, k, rsl, tail_max):
    """(buf, di_len) of a Pearson pass over exactly n_pos codes: k-mer
    codes, then from the last 2w on a stale tail of codes below
    tail_max (>= 4^k: symbols the pass skips)."""
    di_len = n_pos - 2 * w + rsl + k
    buf = rng.integers(0, 4**k, n_pos + 64).astype(np.int32)
    buf[n_pos - 2 * w :] = rng.integers(0, tail_max, 2 * w + 64)
    return buf, di_len


@pytest.mark.parametrize("n_pos,k,w,tail_max", [
    (PAST_BUCKETS[0], 3, 320, 1024), (PAST_BUCKETS[1], 1, 20, 64),
    (PAST_BUCKETS[0], 1, 5, 16)])
def test_unpadded_pearson_past_the_old_buckets(n_pos, k, w, tail_max):
    """di_pearson_device on the unpadded plain moments against mtr_tpu's
    padded jnp program, with a stale tail of codes >= 4^k that both skip;
    and against the oracle on the same pass with the tail's codes folded
    below 4^k (the oracle sums every symbol present, so it parts from JAX
    on codes >= 4^k; the pipeline's tail holds raw bases, below 4^k)."""
    rng = np.random.default_rng(n_pos + k)
    rsl = 1000
    buf, di_len = _pearson_buf(rng, n_pos, w, k, rsl, tail_max)
    n_i = di_len - w - rsl - k + 1
    assert n_i + 3 * w - 1 == n_pos
    assert (buf[:n_pos] >= 4**k).any()
    got = di.di_pearson_device(buf, di_len, w, k, rsl, CPU)
    np.testing.assert_array_equal(
        got, jax_di.di_pearson_device(buf, di_len, w, k, rsl))
    folded = buf % 4**k
    np.testing.assert_array_equal(
        di.di_pearson_device(folded, di_len, w, k, rsl, CPU),
        di_pearson(folded, di_len, w, k, rsl))


# ----------------------------------- the kernels' group schedule, in numpy

def _live(v, n_sym):
    return 0 <= v < n_sym


def _schedule(n_outs, ws, n_win, rows, n_sym, resident):
    """csrc/directional_index.cu's launch restated: each pass's sliders a
    warp and tile (di_sliders, di_tiles), the table, and every slider of
    every warp: (pass, w, n_out, output offset, t0, t_end, lanes), t0 past
    n_out for the idle sliders of a pass's last warp."""
    spans = [n_win * w for w in ws]
    sliders = di.di_sliders(spans, n_sym, di.bin_bytes(ws, n_win == 3))
    tiles = di.di_tiles(n_outs, spans, sliders, resident)
    table = di.group_table(n_outs, ws, rows, tiles, sliders)
    out = []
    for i, (w, n_out, off, tile, sl) in enumerate(table.tolist()):
        for first in range(0, n_out, sl * tile):  # a warp
            for j in range(sl):
                t0 = first + j * tile
                out.append((i, w, n_out, off, t0, min(t0 + tile, n_out),
                            32 // sl))
    return table, out


def _steps(codes, t0, t_end, offs):
    """The codes each step of a slider moves, step into position q from
    q - 1, as step_code."""
    for q in range(t0 + 1, t_end):
        yield q, [int(codes[q - 1 + o]) for o in offs]


def group_l1(codes, n_outs, ws, n_sym, resident):
    """sliding_l1_kernel restated on a group: per slider, diff = c(W1) -
    c(W2) of its first position over its 2w codes (codes outside [0,
    n_sym) skipped), D = sum |diff|; then a step at a time (the lanes of a
    slider run it a chunk of 32 / sliders steps together): the three moved
    codes' bins loaded, merged where equal, D moved by |new| - |old| at
    each distinct bin, and stored.  Bins stay in uint16's biased range
    where the group is narrow.  Each (pass, position) is written once."""
    _, sliders = _schedule(n_outs, ws, 2, 1, n_sym, resident)
    limit = (1 << 31) if di.wide_bins(ws, False) else di.NARROW_MAX_W + 1
    out = np.full(sum(n_outs), -1, np.int64)
    for _, w, n_out, off, t0, t_end, _ in sliders:
        if t0 >= n_out:
            continue
        bins = np.zeros(n_sym, np.int64)
        win = codes[t0 : t0 + 2 * w]
        ok = (win >= 0) & (win < n_sym)
        np.add.at(bins, win[ok], np.where(np.arange(2 * w) < w, 1, -1)[ok])
        assert np.abs(bins).max() < limit
        d = int(np.abs(bins).sum())
        assert out[off + t0] == -1
        out[off + t0] = d
        for q, (a, b, c) in _steps(codes, t0, t_end, (0, w, 2 * w)):
            la, lb, lc = (_live(v, n_sym) for v in (a, b, c))
            xa, xb, xc = (int(bins[v]) if lv else 0
                          for v, lv in ((a, la), (b, lb), (c, lc)))
            na = xa - 1 + 2 * (b == a) - (c == a)
            nb = xb + 2 - (a == b) - (c == b)
            nc = xc - 1 - (a == c) + 2 * (b == c)
            d += (abs(na) - abs(xa)) * la
            d += (abs(nb) - abs(xb)) * (lb and b != a)
            d += (abs(nc) - abs(xc)) * (lc and c != a and c != b)
            for v, lv, nv in ((a, la, na), (b, lb, nb), (c, lc, nc)):
                if lv:
                    assert abs(nv) < limit
                    bins[v] = nv
            assert out[off + q] == -1
            out[off + q] = d
    assert (out >= 0).all()
    return di.split_group(out, n_outs, 1)


# (window, symbol, delta) of a Pearson step's six count updates
PEARSON_UPDATES = ((0, 0, -1), (0, 1, 1), (1, 1, -1), (1, 2, 1), (2, 2, -1),
                   (2, 3, 1))


def group_moments(codes, n_outs, ws, n_sym, resident):
    """pearson_moments_kernel restated on a group: per slider, the three
    windows' counts of its first position (each < 2^16: the packed word)
    and their moments; then a step at a time: the four moved codes' counts
    loaded, the six updates on the loaded copies (q += 2 c delta + 1, ip
    += delta c_other, every copy of the same symbol kept in step), stored,
    and the five moments written to the pass's (5, n_out) block."""
    _, sliders = _schedule(n_outs, ws, 3, 5, n_sym, resident)
    out = np.full(5 * sum(n_outs), -1, np.int64)

    def put(off, n_out, q, m):
        for t in range(5):
            assert out[off + t * n_out + q] == -1
            out[off + t * n_out + q] = m[t]

    for _, w, n_out, off, t0, t_end, _ in sliders:
        if t0 >= n_out:
            continue
        h = np.zeros((n_sym, 3), np.int64)
        win = codes[t0 : t0 + 3 * w]
        ok = (win >= 0) & (win < n_sym)
        np.add.at(h, (win[ok], (np.arange(3 * w) // w)[ok]), 1)
        assert h.max() < 1 << 16
        m = [int((h[:, 0] ** 2).sum()), int((h[:, 1] ** 2).sum()),
             int((h[:, 2] ** 2).sum()), int((h[:, 0] * h[:, 1]).sum()),
             int((h[:, 1] * h[:, 2]).sum())]
        put(off, n_out, t0, m)
        for q, s in _steps(codes, t0, t_end, [j * w for j in range(4)]):
            live = [_live(v, n_sym) for v in s]
            x = [list(h[v]) if lv else [0, 0, 0] for v, lv in zip(s, live)]
            for X, j, dl in PEARSON_UPDATES:
                if not live[j]:
                    continue
                xj = list(x[j])
                m[X] += 2 * xj[X] * dl + 1
                if X in (0, 1):
                    m[3] += dl * xj[1 - X]
                if X in (1, 2):
                    m[4] += dl * xj[3 - X]
                xj[X] += dl
                for r in range(4):
                    if s[r] == s[j]:
                        x[r] = list(xj)
            for j in range(4):
                if live[j]:
                    h[s[j]] = x[j]
            put(off, n_out, q, m)
    assert (out >= 0).all()
    return di.split_group(out, n_outs, 5)


def brute_moments(codes, n_out, w, n_sym):
    """The five moments of every position from the windows' bincounts."""
    out = np.zeros((5, n_out), np.int64)
    for i in range(n_out):
        c = [np.bincount(codes[i + j * w : i + (j + 1) * w],
                         minlength=max(n_sym, int(codes.max()) + 1))[:n_sym]
             for j in range(3)]
        out[:, i] = [c[0] @ c[0], c[1] @ c[1], c[2] @ c[2], c[0] @ c[1],
                     c[1] @ c[2]]
    return out


# an H100's resident warps for a k-5 Manhattan launch (132 SMs x 14 warps
# of 16 KB of bins), and a small card, so that the fill term and the start
# floor both set tiles
RESIDENT = (1848, 3)

# (w, n_out, alphabet): n_out below, at and past a tile of 32; w whose
# start floor sets the tile; alphabets 4,
# 64, 1,024, and for Pearson codes past 4^k (k = 1, 3) that it skips
SCHEDULE_CASES = [(5, 50, 4), (5, 128, 64), (5, 129, 64), (200, 401, 1024),
                  (1500, 300, 16), (5000, 700, 64), (7, 1000, 1024),
                  (5, 33, 64), (10240, 641, 1024)]


@pytest.mark.parametrize("w,n_out,alphabet", SCHEDULE_CASES)
def test_kernel_schedule_l1_matches_oracle(w, n_out, alphabet):
    rng = np.random.default_rng(w * n_out)
    codes = rng.integers(0, alphabet, n_out + 2 * w - 1).astype(np.int32)
    if alphabet > 4:
        codes[: w // 2] = alphabet - 1  # a run: steps with equal codes
    k = di._k_for(codes, len(codes))
    want = sliding_l1(codes, w, n_out, use_native=False)
    for resident in RESIDENT:
        np.testing.assert_array_equal(
            group_l1(codes, [n_out], [w], 4**k, resident)[0], want)
    np.testing.assert_array_equal(
        di._sliding_l1_device(torch.from_numpy(codes), k, w).numpy(), want)


@pytest.mark.parametrize("w,n_out,alphabet", SCHEDULE_CASES)
def test_kernel_schedule_moments_match_plain(w, n_out, alphabet):
    rng = np.random.default_rng(w + n_out)
    k = {4: 1, 16: 1, 64: 3, 1024: 5}[alphabet]  # 16 and 64 reach past 4^k
    codes = rng.integers(0, alphabet, n_out + 3 * w - 1).astype(np.int32)
    codes[w : w + w // 2] = 2  # a run: steps with equal codes
    plain = torch.stack(di._pearson_moments_device(torch.from_numpy(codes),
                                                   k, w)).numpy()
    for resident in RESIDENT:
        got = group_moments(codes, [n_out], [w], 4**k, resident)[0]
        np.testing.assert_array_equal(got, plain)
    if n_out <= 300:
        np.testing.assert_array_equal(got, brute_moments(codes, n_out, w,
                                                         4**k))
    assert got.max() < di.VALUE_LIMIT


# groups that mix the w of one k (the sweep's 5 ... 10,240), n_out at and
# around the tiles and warps the group gets (w 10,240: a tile of 640 on two
# sliders Manhattan, 960 on two Pearson; the rest the fill term on a 3-warp
# card), and a stale tail that the longer passes reach
GROUP_CASES = [
    ((5, 10, 20), (31, 32, 33), 1, 16),
    ((5, 40, 80), (95, 96, 97), 3, 64),
    ((5, 640, 10240), (63, 64, 641), 5, 1024),
    ((2560, 10240), (959, 1281), 5, 1024),
]


@pytest.mark.parametrize("ws,n_outs,k,tail_max", GROUP_CASES)
def test_group_schedule_l1_matches_oracle_and_plain(ws, n_outs, k, tail_max):
    rng = np.random.default_rng(sum(ws) + sum(n_outs))
    sizes = [n + 2 * w - 1 for n, w in zip(n_outs, ws)]
    codes = rng.integers(0, 4**k, max(sizes)).astype(np.int32)
    codes[min(sizes) :] = rng.integers(0, tail_max, max(sizes) - min(sizes))
    codes[: ws[0]] = 3  # a run: steps with equal codes
    n_sym = 4 ** di._k_for(codes, max(sizes))
    plain = di.plain_group(torch.from_numpy(codes), n_outs, ws, n_sym, False)
    for resident in RESIDENT:
        got = group_l1(codes, list(n_outs), list(ws), n_sym, resident)
        for g, p, n, w in zip(got, plain, n_outs, ws):
            want = sliding_l1(codes, w, n, use_native=False)
            np.testing.assert_array_equal(g, want)
            np.testing.assert_array_equal(p.numpy(), want)


@pytest.mark.parametrize("ws,n_outs,k,tail_max", GROUP_CASES)
def test_group_schedule_moments_match_plain(ws, n_outs, k, tail_max):
    rng = np.random.default_rng(sum(ws) * 3 + sum(n_outs))
    sizes = [n + 3 * w - 1 for n, w in zip(n_outs, ws)]
    codes = rng.integers(0, 4**k, max(sizes)).astype(np.int32)
    codes[min(sizes) :] = rng.integers(0, max(tail_max, 4**k + 1),
                                       max(sizes) - min(sizes))
    codes[ws[0] : 2 * ws[0]] = 1  # a run
    plain = di.plain_group(torch.from_numpy(codes), n_outs, ws, 4**k, True)
    for resident in RESIDENT:
        got = group_moments(codes, list(n_outs), list(ws), 4**k, resident)
        for g, p in zip(got, plain):
            np.testing.assert_array_equal(g, p.numpy())


@pytest.mark.parametrize("w", [32767, 32768])
def test_manhattan_bins_narrow_up_to_32767(w):
    """uint16 bins hold |diff| <= w up to w 32,767; past it the group takes
    int32 bins (and the restatement's range check passes either way): a
    window of one symbol in W1 and another in W2 reaches |diff| = w."""
    assert di.wide_bins([5, w], False) == (w > di.NARROW_MAX_W)
    assert not di.wide_bins([46340], True)
    codes = np.concatenate([np.zeros(w, np.int32), np.ones(w + 40, np.int32)])
    got = group_l1(codes, [41], [w], 4, 1)[0]
    np.testing.assert_array_equal(got, sliding_l1(codes, w, 41,
                                                  use_native=False))
    assert got[0] == 2 * w


def test_tiles_cover_every_position_once():
    """Every (pass, position) of a group lies in exactly one slider's
    tile; tiles are multiples of 32 at least the start floor, sliders a
    power of two within the span and bin budgets, and a group's warps are
    at most the resident ones plus one a pass."""
    sweep = [5 * 2**i for i in range(12)]
    for resident, (ws, n_outs, n_win, n_sym) in itertools.product(
            (1, 3, 100, 1848, 10**6), (
            (sweep, [130000 + 7 * i for i in range(12)], 2, 1024),
            (sweep, [120000 - 5 * i for i in range(12)], 3, 1024),
            ([5, 10, 20], [1, 31, 33], 2, 4), ([5, 40, 80], [9, 99, 999], 3,
                                               64), ([10240], [1], 3, 1024))):
        table, sliders = _schedule(n_outs, ws, n_win, 1, n_sym, resident)
        nbytes = di.bin_bytes(ws, n_win == 3)
        for w, _, _, tile, sl in table.tolist():
            assert tile % 32 == 0 and tile >= sl * n_win * w / di.START_DIV
            assert sl & (sl - 1) == 0 and 1 <= sl <= di.MAX_SLIDERS
            assert sl == 1 or sl * n_win * w <= di.SLIDER_SPAN
            assert sl * n_sym * nbytes <= di.WARP_BINS
        seen = [np.zeros(n, np.int64) for n in n_outs]
        for i, _, n_out, _, t0, t_end, _ in sliders:
            assert t0 < t_end <= n_out or t0 >= n_out
            seen[i][t0:t_end] += 1
        assert all((x == 1).all() for x in seen)
        warps = sum(-(-n // (sl * tile)) for _, n, _, tile, sl in
                    table.tolist())
        assert warps <= resident + len(ws)
        assert (table[:, 2] == np.cumsum([0] + n_outs[:-1])).all()


def test_sliders_a_warp_follow_the_span_and_the_bins():
    """The bench sweep's sliders a warp: at most 8, k 5 Manhattan 8 up to
    w 2,560, then fewer as the span grows; Pearson at k 5 four (8-byte
    bins, 32 KB a warp), two at w 10,240."""
    k5 = [5 * 2**i for i in range(12)]
    assert di.di_sliders([2 * w for w in (5, 10, 20)], 4, 2) == [8] * 3
    assert di.di_sliders([2 * w for w in (5, 80)], 64, 2) == [8, 8]
    assert di.di_sliders([2 * w for w in k5], 1024, 2) == [8] * 10 + [4, 2]
    assert di.di_sliders([3 * w for w in k5], 1024, 8) == [4] * 11 + [2]
    assert di.di_sliders([3 * w for w in (5, 80)], 64, 8) == [8, 8]


CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "mtr_tpu_torch", "csrc")
CU = os.path.join(CSRC, "directional_index.cu")


def _binding_table(tree, fn_name):
    import ast

    fn = next(n for n in ast.walk(tree)
              if isinstance(n, ast.FunctionDef) and n.name == fn_name)
    return {k.value: v.value for d in ast.walk(fn) if isinstance(d, ast.Dict)
            for k, v in zip(d.keys, d.values) if isinstance(v, ast.Constant)}


def _c_entries(path):
    import re

    with open(path) as f:
        src = f.read()
    return src, dict(re.findall(r'extern "C" int (mtr_di_\w+)\(([^)]*)\)',
                                src))


def test_the_build_binds_the_di_kernels():
    """_build.SOURCES names the kernel's source, library()'s table binds
    each entry point with as many arguments as the C function takes, the
    source's bounds equal the module's, and no try/except in the module
    could give way to the plain version on the card."""
    import ast
    import re

    from mtr_tpu_torch.ops import _build

    assert CU in _build.SOURCES
    with open(_build.__file__) as f:
        tree = ast.parse(f.read())
    table = _binding_table(tree, "library")
    src, entries = _c_entries(CU)
    assert set(entries) == {"mtr_di_sliding_l1", "mtr_di_pearson_moments",
                            "mtr_di_resident_warps"}
    for name, params in entries.items():
        assert len(table[name]) == len(params.split(",")), name
    for const, value in (("kMaxSym", di.MAX_SYMBOLS),
                         ("kMaxPasses", di.MAX_PASSES),
                         ("kStartDiv", di.START_DIV),
                         ("kSliderSpan", di.SLIDER_SPAN),
                         ("kWarpBins", di.WARP_BINS),
                         ("kMaxSliders", di.MAX_SLIDERS),
                         ("kNarrowMaxW", di.NARROW_MAX_W)):
        assert re.search(rf"constexpr int {const} = (\d+);", src).group(1) \
            == str(value), const
    with open(di.__file__) as f:
        mod = ast.parse(f.read())
    assert not [n for n in ast.walk(mod) if isinstance(n, ast.Try)]


@pytest.mark.parametrize("bad", ["code_1024", "code_negative", "w_0",
                                 "w_overflow", "short_buffer"])
def test_dispatchers_raise_outside_the_kernel_bounds(bad):
    rng = np.random.default_rng(3)
    w, n_out, k = 20, 500, 3
    vals = rng.integers(0, 64, n_out + 3 * w + 10).astype(np.int32)
    if bad == "code_1024":
        vals[n_out + 2 * w - 2] = 1024  # the last code of a Manhattan pass
    elif bad == "code_negative":
        vals[7] = -1
    elif bad == "w_0":
        w = 0
    elif bad == "w_overflow":
        w = 46341  # w^2 >= 2^31
    else:
        vals = vals[: n_out + w]
    di_len = n_out + w + 100 + k - 1  # Pearson: n_i = n_out, rsl 100
    for call in (lambda: di.sliding_l1_device(vals, w, n_out, CPU),
                 lambda: di.di_pearson_device(vals, di_len, w, k, 100, CPU),
                 lambda: di.sliding_l1_sharded(vals, w, n_out, _mesh(2), k,
                                               halo=1 << 20)):
        with pytest.raises(ValueError):
            call()


def _mesh(n):
    from mtr_tpu_torch.parallel.mesh import make_mesh

    return make_mesh(devices=["cpu"] * n)


def test_codes_past_the_pass_are_never_read():
    """Codes outside the kernels' range right after the pass's last code
    pass the bound check and leave the result unchanged."""
    rng = np.random.default_rng(4)
    w, n_out = 40, 3000
    n_pos = n_out + 2 * w - 1
    vals = rng.integers(0, 1024, n_pos + 20).astype(np.int32)
    want = sliding_l1(vals[:n_pos], w, n_out, use_native=False)
    vals[n_pos:] = -7
    np.testing.assert_array_equal(di.sliding_l1_device(vals, w, n_out, CPU),
                                  want)
    np.testing.assert_array_equal(
        di.sliding_l1_sharded(vals, w, n_out, _mesh(3), 5), want)
