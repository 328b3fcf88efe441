"""The port's device DI (plain PyTorch, here on the CPU) against
mtr_tpu's device DI (jnp on the CPU), the oracle and the native host
pass.  Manhattan values are integers and compared exactly; Pearson values
come from the same integer moments and the same float64 finish, so they
are compared exactly too, as are the final DI ranges."""

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


@pytest.mark.parametrize("name,picks,manhattan", [
    ("multi20_100x10", [0, 7, 19], True),
    ("multitr_gen_2_5_10_20", None, True),
    ("multitr_gen_2_5_10_20", None, False),
])
def test_full_di_ranges_match_host(name, picks, manhattan):
    """fill_directional_index_with_end with the port's plug-in against
    the native host pass (di_compute=None)."""
    plug = di.make_di_compute(CPU, manhattan)
    before = di.CALLS
    for read in _reads(name, picks):
        want = _ranges(read, manhattan)
        got = _ranges(read, manhattan, plug)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
    assert di.CALLS > before


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


# ----------------------------------- the kernels' tile schedule, in numpy

def _live(v, n_sym):
    return 0 <= v < n_sym


def kernel_l1(codes, n_out, w, n_sym):
    """csrc/directional_index.cu's sliding_l1_kernel restated: per tile of
    di_tile(2w) positions, diff = c(W1) - c(W2) over the first position's
    2w codes (codes outside [0, n_sym) skipped) and D = sum |diff|; then a
    step at a time, the three moved codes' bins loaded, merged where equal,
    D moved by |new| - |old| at each distinct bin, and stored."""
    D = np.zeros(n_out, np.int64)
    tile = di.di_tile(2 * w)
    for t0 in range(0, n_out, tile):
        diff = np.zeros(n_sym, np.int64)
        win = codes[t0 : t0 + 2 * w]
        ok = (win >= 0) & (win < n_sym)
        np.add.at(diff, win[ok], np.where(np.arange(2 * w) < w, 1, -1)[ok])
        d = int(np.abs(diff).sum())
        D[t0] = d
        for p in range(t0 + 1, min(t0 + tile, n_out)):
            a, b, c = (int(codes[p - 1 + j * w]) for j in range(3))
            la, lb, lc = (_live(v, n_sym) for v in (a, b, c))
            xa, xb, xc = (int(diff[v]) if lv else 0
                          for v, lv in ((a, la), (b, lb), (c, lc)))
            na = xa - 1 + 2 * (b == a) - (c == a)
            nb = xb + 2 - (a == b) - (c == b)
            nc = xc - 1 - (a == c) + 2 * (b == c)
            d += (abs(na) - abs(xa)) * la
            d += (abs(nb) - abs(xb)) * (lb and b != a)
            d += (abs(nc) - abs(xc)) * (lc and c != a and c != b)
            for v, lv, nv in ((a, la, na), (b, lb, nb), (c, lc, nc)):
                if lv:
                    diff[v] = nv
            D[p] = d
    return D


# (window, symbol, delta) of a Pearson step's six count updates
PEARSON_UPDATES = ((0, 0, -1), (0, 1, 1), (1, 1, -1), (1, 2, 1), (2, 2, -1),
                   (2, 3, 1))


def kernel_moments(codes, n_out, w, n_sym):
    """pearson_moments_kernel restated: per tile of di_tile(3w) positions,
    the three windows' counts of the first position and their moments;
    then a step at a time, the four moved codes' bins loaded, the six
    updates applied to the loaded copies (q += 2 c delta + 1, ip += delta
    c_other, every copy of the same symbol kept in step), and stored."""
    out = np.zeros((5, n_out), np.int64)
    tile = di.di_tile(3 * w)
    for t0 in range(0, n_out, tile):
        h = np.zeros((3, n_sym), np.int64)
        win = codes[t0 : t0 + 3 * w]
        ok = (win >= 0) & (win < n_sym)
        np.add.at(h, ((np.arange(3 * w) // w)[ok], win[ok]), 1)
        m = [int((h[0] ** 2).sum()), int((h[1] ** 2).sum()),
             int((h[2] ** 2).sum()), int((h[0] * h[1]).sum()),
             int((h[1] * h[2]).sum())]
        out[:, t0] = m
        for p in range(t0 + 1, min(t0 + tile, n_out)):
            s = [int(codes[p - 1 + j * w]) for j in range(4)]
            live = [_live(v, n_sym) for v in s]
            x = [[int(h[t, v]) if lv else 0 for t in range(3)]
                 for v, lv in zip(s, live)]
            for X, j, dl in PEARSON_UPDATES:
                if not live[j]:
                    continue
                c = x[j][X]
                m[X] += 2 * c * dl + 1
                if X in (0, 1):
                    m[3] += dl * x[j][1 - X]
                if X in (1, 2):
                    m[4] += dl * x[j][3 - X]
                for r in range(4):
                    if s[r] == s[j]:
                        x[r][X] = c + dl
            for j in range(4):
                if live[j]:
                    h[:, s[j]] = x[j]
            out[:, p] = m
    return out


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


# (w, n_out, alphabet): n_out below, at and past a tile of 128; w above a
# tile; tiles that grow with w (di_tile(10000) = 320); alphabets 4, 64,
# 1,024, and for Pearson codes past 4^k (k = 1, 3) that it skips
SCHEDULE_CASES = [(5, 50, 4), (5, 128, 64), (5, 129, 64), (200, 401, 1024),
                  (1500, 300, 16), (5000, 700, 64), (7, 1000, 1024)]


@pytest.mark.parametrize("w,n_out,alphabet", SCHEDULE_CASES)
def test_kernel_schedule_l1_matches_oracle(w, n_out, alphabet):
    rng = np.random.default_rng(w * n_out)
    codes = rng.integers(0, alphabet, n_out + 2 * w - 1).astype(np.int32)
    if alphabet > 4:
        codes[: w // 2] = alphabet - 1  # a run: steps with equal codes
    k = di._k_for(codes, len(codes))
    want = sliding_l1(codes, w, n_out, use_native=False)
    np.testing.assert_array_equal(kernel_l1(codes, n_out, w, 4**k), want)
    np.testing.assert_array_equal(
        di._sliding_l1_device(torch.from_numpy(codes), k, w).numpy(), want)


@pytest.mark.parametrize("w,n_out,alphabet", SCHEDULE_CASES)
def test_kernel_schedule_moments_match_plain(w, n_out, alphabet):
    rng = np.random.default_rng(w + n_out)
    k = {4: 1, 16: 1, 64: 3, 1024: 5}[alphabet]  # 16 and 64 reach past 4^k
    codes = rng.integers(0, alphabet, n_out + 3 * w - 1).astype(np.int32)
    codes[w : w + w // 2] = 2  # a run: steps with equal codes
    got = kernel_moments(codes, n_out, w, 4**k)
    plain = torch.stack(di._pearson_moments_device(torch.from_numpy(codes),
                                                   k, w)).numpy()
    np.testing.assert_array_equal(got, plain)
    if n_out <= 300:
        np.testing.assert_array_equal(got, brute_moments(codes, n_out, w,
                                                         4**k))
    assert got.max() < di.VALUE_LIMIT


def test_tiles_cover_every_position_once():
    for span in (10, 400, 3000, 10000, 20480, 30720, 1 << 20):
        tile = di.di_tile(span)
        assert di.TILE_MIN <= tile <= di.TILE_MAX and tile % 32 == 0
        assert tile >= min(span // 32, di.TILE_MAX)
    assert (di.di_tile(20480), di.di_tile(30720)) == (640, 960)


# ------------------------------------------------------- static and bounds

CU = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "mtr_tpu_torch", "csrc", "directional_index.cu")


def test_the_build_binds_the_di_kernels():
    """_build.SOURCES names the source, library()'s table binds each entry
    point with as many arguments as the C function takes, the source's
    bounds equal the module's, and no try/except in the module could give
    way to the plain version on the card."""
    import ast
    import re

    from mtr_tpu_torch.ops import _build

    assert CU in _build.SOURCES
    with open(_build.__file__) as f:
        tree = ast.parse(f.read())
    lib_fn = next(n for n in ast.walk(tree)
                  if isinstance(n, ast.FunctionDef) and n.name == "library")
    table = {k.value: v.value for d in ast.walk(lib_fn)
             if isinstance(d, ast.Dict)
             for k, v in zip(d.keys, d.values) if isinstance(v, ast.Constant)}
    with open(CU) as f:
        src = f.read()
    entries = dict(re.findall(r'extern "C" int (mtr_di_\w+)\(([^)]*)\)', src))
    assert set(entries) == {"mtr_di_sliding_l1", "mtr_di_pearson_moments",
                            "mtr_di_tile"}
    for name, params in entries.items():
        assert len(table[name]) == len(params.split(",")), name
    for const, value in (("kTileMin", di.TILE_MIN), ("kTileMax", di.TILE_MAX),
                         ("kMaxSym", di.MAX_SYMBOLS)):
        assert re.search(rf"constexpr int {const} = (\d+);", src).group(1) \
            == str(value)
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
