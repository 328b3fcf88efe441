"""The port's DBG walks against mtr_tpu's: stage A tables against JAX's
_stage_a at each of its buckets, stage_b_plain against _stage_b, and
dbg_walk_device_batch against JAX's on the four fuzz sets of
tests/test_dbg_device.py and against native.dbg_walk_batch2 on a larger
set with whale ranges and tie storms.  Every output is an integer:
compared exactly.  Result rows are compared per query (unit and score
rows up to each period), since row numbers depend on the engine."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mtr_tpu import native
from mtr_tpu.ops import dbg_device as jd
from mtr_tpu_torch.utils.timers import TIMERS
from mtr_tpu_torch.ops import dbg_device as td
from tests.test_dbg_device import make_read

CPU = torch.device("cpu")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def canon(res, n):
    """Per-query view of a walk result: found_last, periods, and each
    direction's unit / score row cut to its period (zeros without one)."""
    out = {key: np.asarray(res[key][:n]) for key in
           ("found_last", "fwd_period", "bwd_period")}
    col = np.arange(td.MAX_PERIOD)[None, :]
    for d in ("fwd", "bwd"):
        row = np.asarray(res[f"{d}_row"][:n])
        has = row >= 0
        out[f"{d}_has"] = has
        keep = has[:, None] & (col < out[f"{d}_period"][:, None])
        for key in ("units", "scores"):
            full = np.zeros((n, td.MAX_PERIOD), np.int64)
            full[has] = res[key][row[has]]
            out[f"{d}_{key}"] = np.where(keep, full, 0)
    return out


def assert_same(got, want, n):
    g, w = canon(got, n), canon(want, n)
    for key in w:
        np.testing.assert_array_equal(g[key], w[key], err_msg=key)


def as_arrays(queries):
    return tuple(np.array([q[i] for q in queries], np.int64) for i in range(4))


def port_batch(orgs, lens, queries):
    return td.dbg_walk_device_batch(orgs, lens, *as_arrays(queries), CPU)


# ---------------------------------------------------------------- stage A


def _tables(rng, n_reads, v_max):
    """Periodic reads and (read, qs, qe, k) queries up to width v_max,
    including ranges at the read's end (the raw-tail quirk)."""
    orgs, lens, queries = [], [], []
    for r in range(n_reads):
        L = v_max + 200
        orgs.append(make_read(rng, L, int(rng.integers(2, 60)), noise=0.08))
        lens.append(L)
        for v in (v_max, int(rng.integers(20, v_max)), 33):
            k = int(rng.integers(2, 16))
            qe = L - 1 - int(rng.integers(0, 3)) if v == 33 else \
                int(rng.integers(v - 1, L - 1))
            queries.append((r, qe - v + 1, qe, k))
    return orgs, lens, queries


def _port_stage_a(orgs, lens, queries, v_pad):
    ridx, qs, qe, k = as_arrays(queries)
    flat, offs = td.upload_reads(orgs, CPU)
    n_code = np.minimum(qe, np.asarray(lens)[ridx] - k + 1) - qs

    def put(a):
        return torch.from_numpy(a.astype(np.int32))

    return td.stage_a(flat, torch.from_numpy(offs[ridx] + qs), put(n_code),
                      put(qe - qs + 1), put(k), v_pad)


def _jax_stage_a(orgs, lens, queries, v_pad):
    ridx, qs, qe, k = as_arrays(queries)
    L_pad = -(-max(len(o) for o in orgs) // 128) * 128
    mat = np.zeros((len(orgs), L_pad), np.int32)
    for i, o in enumerate(orgs):
        mat[i, : len(o)] = o
    km_end = np.minimum(qe, np.asarray(lens)[ridx] - k + 1)
    return jd._stage_a(v_pad, jnp.asarray(mat),
                       *(jnp.asarray(a, jnp.int32)
                         for a in (ridx, qs, km_end, qe - qs + 1, k)))


@pytest.mark.parametrize("v_pad", jd.V_BUCKETS)
def test_stage_a_matches_jax(v_pad):
    rng = np.random.default_rng(v_pad)
    orgs, lens, queries = _tables(rng, 3 if v_pad < 32768 else 1,
                                  min(v_pad, 2500))
    # homopolymer read: one huge run, many tied max nodes elsewhere
    orgs.append(np.zeros(801, np.int64))
    lens.append(800)
    queries += [(len(orgs) - 1, 0, 799, 3), (len(orgs) - 1, 700, 799, 15)]
    got = _port_stage_a(orgs, lens, queries, v_pad)
    want = _jax_stage_a(orgs, lens, queries, v_pad)
    names = ("svals", "adj", "maxfreq", "nodes", "n_nodes")
    for name, g, w in zip(names, got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    assert int(got[4].max()) > 1  # some query lists several max nodes


def test_max_freq_is_stage_a_maxfreq():
    rng = np.random.default_rng(5)
    orgs, lens, queries = _tables(rng, 3, 700)
    ridx, qs, qe, k = as_arrays(queries)
    flat, offs = td.upload_reads(orgs, CPU)
    args = (flat, torch.from_numpy(offs[ridx] + qs),
            torch.from_numpy((np.minimum(qe, np.asarray(lens)[ridx] - k + 1)
                              - qs).astype(np.int32)),
            torch.from_numpy((qe - qs + 1).astype(np.int32)),
            torch.from_numpy(k.astype(np.int32)), 1024)
    np.testing.assert_array_equal(td.max_freq(*args).numpy(),
                                  td.stage_a(*args)[2].numpy())


# ---------------------------------------------------------------- stage B


def _walk_set(seed):
    """Periodic reads (units 2-60) with k 2-15, a 2-mer tie storm, and a
    noisy unit-95 read whose long walks dead-end in all-zero tie lists
    that overflow T_DEV."""
    rng = np.random.default_rng(seed)
    orgs, lens, queries = [], [], []
    for r in range(4):
        L = int(rng.integers(400, 900))
        orgs.append(make_read(rng, L, int(rng.integers(2, 60)), noise=0.05))
        lens.append(L)
        for _ in range(4):
            qs = int(rng.integers(0, L // 3))
            qe = int(rng.integers(qs + 100, L - 1))
            queries.append((r, qs, qe, int(rng.integers(2, 16))))
    storm = np.tile([0, 1], 300)[:600].astype(np.int64)
    storm[rng.integers(0, 600, 10)] = rng.integers(0, 4, 10)
    orgs.append(np.concatenate([storm, [0]]))
    lens.append(600)
    queries += [(len(orgs) - 1, 5, 598, k) for k in (3, 7, 12)]
    orgs.append(make_read(np.random.default_rng(0), 1600, 95, noise=0.1))
    lens.append(1600)
    queries += [(len(orgs) - 1, s, s + 823, k) for s in (100, 700)
                for k in range(8, 15)]
    return orgs, lens, queries


def test_stage_b_plain_matches_jax():
    orgs, lens, queries = _walk_set(11)
    ridx, qs, qe, k = as_arrays(queries)
    sv, adj, maxfreq, nodes, n_nodes = _port_stage_a(orgs, lens, queries, 1024)
    gated, nn, tq, node0, is_fwd, rank = td.chunk_jobs(maxfreq, n_nodes, nodes)
    assert len(gated) > len(queries) // 2
    lmax = np.minimum(td.MAX_PERIOD, (qe - qs) // td.MIN_NUM_FREQ_UNIT)
    job = [a.astype(np.int32) for a in (node0, is_fwd, k[tq], lmax[tq])]
    got = td.stage_b_plain(sv, adj, torch.from_numpy(tq.astype(np.int32)),
                           *map(torch.from_numpy, job))
    want = jd._stage_b(jnp.take(jnp.asarray(sv.numpy()), tq, axis=0),
                       jnp.take(jnp.asarray(adj.numpy()), tq, axis=0),
                       *map(jnp.asarray, job))
    for name, g, w in zip(("found", "period", "units", "scores", "ovf"),
                          got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    found, ovf = got[0].numpy(), got[4].numpy()
    assert found.any() and ovf.any() and not found.all()


def test_dbg_walk_cpu_tensors_run_plain():
    orgs, lens, queries = _walk_set(12)
    sv, adj, maxfreq, nodes, n_nodes = _port_stage_a(orgs, lens, queries, 1024)
    _, _, tq, node0, is_fwd, _ = td.chunk_jobs(maxfreq, n_nodes, nodes)
    ridx, qs, qe, k = as_arrays(queries)
    job = [torch.from_numpy(a.astype(np.int32)) for a in
           (tq, node0, is_fwd, k[tq], np.minimum(500, (qe - qs)[tq] // 5))]
    launches = TIMERS.counters["launch.dbg_walk"]
    for g, w in zip(td.dbg_walk(sv, adj, *job),
                    td.stage_b_plain(sv, adj, *job)):
        assert torch.equal(g, w)
    assert TIMERS.counters["launch.dbg_walk"] == launches
    with pytest.raises((RuntimeError, AssertionError, ValueError)):
        td.dbg_walk(sv.to("meta"), adj, *job)


# ------------------------------------------------ whole batch vs JAX


def _fuzz_periodic():
    rng = np.random.default_rng(0)
    orgs, lens, queries = [], [], []
    for r in range(6):
        unit_len = int(rng.integers(2, 40))
        L = int(rng.integers(200, 1200))
        orgs.append(make_read(rng, L, unit_len, noise=0.08))
        lens.append(L)
        for _ in range(8):
            qs = int(rng.integers(0, L // 2))
            qe = int(rng.integers(qs + 20, L - 1))
            queries.append((r, qs, qe, int(rng.integers(2, 11))))
    return orgs, lens, queries


def _fuzz_high_k():
    rng = np.random.default_rng(1)
    orgs, lens, queries = [], [], []
    for r in range(4):
        unit_len = int(rng.integers(20, 120))
        L = int(rng.integers(600, 2000))
        orgs.append(make_read(rng, L, unit_len, noise=0.05))
        lens.append(L)
        for _ in range(5):
            k = int(rng.integers(11, 16))
            qe = L - 1 - int(rng.integers(0, 5))
            qs = int(rng.integers(0, max(1, qe - 800)))
            queries.append((r, qs, qe, k))
    return orgs, lens, queries


def _fuzz_noise():
    rng = np.random.default_rng(2)
    orgs, lens, queries = [], [], []
    for r in range(4):
        org = np.zeros(501, np.int64)
        org[:500] = rng.integers(0, 4, 500)
        orgs.append(org)
        lens.append(500)
        for _ in range(6):
            qs = int(rng.integers(0, 200))
            qe = int(rng.integers(qs + 30, 499))
            queries.append((r, qs, qe, int(rng.integers(2, 9))))
    return orgs, lens, queries


def _fuzz_tie_storms():
    rng = np.random.default_rng(3)
    orgs, lens, queries = [], [], []
    for r, unit in enumerate(([0], [0, 1], [2, 2, 3])):
        seq = np.tile(unit, 400 // len(unit) + 1)[:400].copy()
        idx = rng.integers(0, 400, 12)
        seq[idx] = rng.integers(0, 4, 12)
        org = np.zeros(401, np.int64)
        org[:400] = seq
        orgs.append(org)
        lens.append(400)
        for k in (2, 3, 5, 7):
            queries.append((r, 5, 398, k))
    return orgs, lens, queries


FUZZ = {"periodic": _fuzz_periodic, "high_k_tail": _fuzz_high_k,
        "noise": _fuzz_noise, "tie_storms": _fuzz_tie_storms}


@pytest.mark.parametrize("name", sorted(FUZZ))
def test_batch_matches_jax(name):
    orgs, lens, queries = FUZZ[name]()
    arrays = as_arrays(queries)
    want = jd.dbg_walk_device_batch(orgs, lens, *arrays)
    got = td.dbg_walk_device_batch(orgs, lens, *arrays, CPU)
    assert_same(got, want, len(queries))


# ---------------------------------------- whole batch vs native engine


def test_batch_matches_native_with_whales_and_storms():
    """~500 queries: the k sweeps of periodic reads, two whale ranges (V
    2,400 and 3,000) walked on the device, and a homopolymer tie storm
    whose queries take the host route."""
    rng = np.random.default_rng(21)
    orgs, lens, queries = [], [], []
    for r in range(6):
        L = int(rng.integers(1500, 3500))
        orgs.append(make_read(rng, L, int(rng.integers(2, 120)), noise=0.1))
        lens.append(L)
        for _ in range(5):
            qs = int(rng.integers(0, L // 2))
            qe = int(rng.integers(qs + 40, min(L - 1, qs + 1500)))
            queries += [(r, qs, qe, k) for k in range(2, 16)]
    whale = make_read(rng, 3200, 97, noise=0.1)
    orgs.append(whale)
    lens.append(3200)
    queries += [(len(orgs) - 1, 100, 2499, 9), (len(orgs) - 1, 150, 3149, 13)]
    storm = np.zeros(801, np.int64)
    storm[rng.integers(0, 800, 8)] = rng.integers(0, 4, 8)
    orgs.append(storm)
    lens.append(800)
    queries += [(len(orgs) - 1, 3, 795, k) for k in (2, 4, 6)]
    arrays = as_arrays(queries)
    before = TIMERS.counters["walk_fallback_queries"]
    got = td.dbg_walk_device_batch(orgs, lens, *arrays, CPU)
    n_host = TIMERS.counters["walk_fallback_queries"] - before
    want = native.dbg_walk_batch2(
        [np.ascontiguousarray(o, np.int32) for o in orgs], lens, *arrays)
    assert_same(got, want, len(queries))
    assert 0 < n_host < len(queries) // 10
    assert got["found_last"][-5] or got["fwd_row"][-5] >= 0  # a whale walked


def test_batch_sends_wide_ranges_to_host(monkeypatch):
    """Ranges wider than V_MAX never reach stage A: with V_MAX cut to 128
    the wide queries take the host route, and the result is unchanged."""
    orgs, lens, queries = FUZZ["periodic"]()
    arrays = as_arrays(queries)
    want = td.dbg_walk_device_batch(orgs, lens, *arrays, CPU)
    wide = int(((arrays[2] - arrays[1] + 1) > 128).sum())
    assert 0 < wide < len(queries)
    monkeypatch.setattr(td, "V_MAX", 128)
    before = TIMERS.counters["walk_fallback_queries"]
    got = td.dbg_walk_device_batch(orgs, lens, *arrays, CPU)
    assert TIMERS.counters["walk_fallback_queries"] - before >= wide
    assert_same(got, want, len(queries))


def test_batch_rejects_ranges_outside_the_read():
    orgs, lens, queries = FUZZ["noise"]()
    queries[0] = (0, 10, len(orgs[0]), 5)
    with pytest.raises(ValueError, match="outside"):
        port_batch(orgs, lens, queries)


def test_native_walks_from_many_threads():
    """native.dbg_walk_batch2 returns views of process-wide buffers; the
    walk thread and the wave loop both walk, so native_walks serialises
    the call and copies the result out.  Twelve threads (more than the
    cores here) walking different sets at once must each get the serial
    result."""
    import sys
    import threading

    sets = []
    for seed in range(12):
        rng = np.random.default_rng(100 + seed)
        L = 2000
        org = np.zeros(L + 1, np.int32)
        org[:L] = make_read(rng, L, int(rng.integers(3, 90)), 0.08)[:L]
        q = [(0, s, s + 600, k) for s in range(0, 1200, 150)
             for k in range(2, 16)]
        sets.append(([org], [L], as_arrays(q)))
    want = [td.native_walks(o, ln, *a) for o, ln, a in sets]
    got = [None] * len(sets)

    def work(i):
        for _ in range(3):
            got[i] = td.native_walks(*sets[i][:2], *sets[i][2])

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=work, args=(i,))
                   for i in range(len(sets))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(old)
    for i, (_, _, a) in enumerate(sets):
        assert_same(got[i], want[i], len(a[0]))
        assert (want[i]["fwd_row"] >= 0).any()


# ------------------------------------------ the walk kernel's launch table


@pytest.mark.parametrize("per_block", [1, 2, 3])
def test_walk_blocks_group_jobs_by_row(per_block):
    """walk_blocks' table for the kernel's blocks (one table row and up
    to per_block of its jobs a block): every job in exactly one block, a
    block's jobs all of its row, row order stable; and the walks in the
    table's job order, put back in place, are JAX's _stage_b results, for
    jobs handed over in a shuffled order."""
    orgs, lens, queries = _walk_set(13)
    ridx, qs, qe, k = as_arrays(queries)
    sv, adj, maxfreq, nodes, n_nodes = _port_stage_a(orgs, lens, queries, 1024)
    _, _, tq, node0, is_fwd, _ = td.chunk_jobs(maxfreq, n_nodes, nodes)
    lmax = np.minimum(td.MAX_PERIOD, (qe - qs) // td.MIN_NUM_FREQ_UNIT)
    jobs = np.stack([tq, node0, is_fwd, k[tq], lmax[tq]], 1).astype(np.int32)
    jobs = jobs[np.random.default_rng(per_block).permutation(len(jobs))]
    perm, blocks = td.walk_blocks(jobs[:, 0], per_block)

    assert perm.dtype == blocks.dtype == np.int32
    np.testing.assert_array_equal(np.sort(perm), np.arange(len(jobs)))
    assert ((blocks[:, 2] >= 1) & (blocks[:, 2] <= per_block)).all()
    spans = [np.arange(f, f + n) for _, f, n in blocks]
    np.testing.assert_array_equal(np.concatenate(spans), np.arange(len(jobs)))
    for (row, f, n), span in zip(blocks, spans):
        assert (jobs[perm[span], 0] == row).all()
    for row in np.unique(jobs[:, 0]):  # stable inside a row
        mine = perm[jobs[perm, 0] == row]
        assert (np.diff(mine) > 0).all()

    got = td.stage_b_plain(sv, adj, *map(torch.from_numpy,
                                         jobs[perm].T.copy()))
    want = jd._stage_b(jnp.take(jnp.asarray(sv.numpy()), jobs[:, 0], axis=0),
                       jnp.take(jnp.asarray(adj.numpy()), jobs[:, 0], axis=0),
                       *map(jnp.asarray, jobs[:, 1:].T))
    inv = np.argsort(perm)
    for name, g, w in zip(("found", "period", "units", "scores", "ovf"),
                          got, want):
        np.testing.assert_array_equal(g.numpy()[inv], np.asarray(w),
                                      err_msg=name)


def kernel_lookup(sv, sc, tq, keys, stride):
    """The walk kernel's lookup restated in plain numpy: a row's search
    level holds the last value of every stride-element segment (the row
    itself at stride 1); its lower bound names the segment that holds the
    key's first position, and the segment's first match gives the live
    count, 0 without one."""
    out = np.zeros(keys.shape, np.int64)
    for q, (row, ks) in enumerate(zip(tq, keys)):
        level = sv[row, stride - 1 :: stride]
        for n, key in enumerate(ks):
            c = int(np.searchsorted(level, key, side="left"))
            if c == len(level):
                continue
            seg = sv[row, c * stride : (c + 1) * stride]
            hit = np.nonzero(seg == key)[0]
            if len(hit):
                out[q, n] = sc[row, c * stride + hit[0]]
    return out


@pytest.mark.parametrize("stride", [1, 2, 4])
def test_sampled_search_level_is_searchsorted(stride):
    """The kernel stages every stride-th value of a row (stride 2 and 4
    for the 32,768 and 65,536 buckets) and reads one segment: on stage-A
    tables that gives JAX's lookup (searchsorted left, clipped to the row,
    the count where the value is the key), for keys present (including
    first and last of a run and of a row), absent, and past every value."""
    orgs, lens, queries = _walk_set(14)
    sv, adj, *_ = _port_stage_a(orgs, lens, queries, 256)
    sv_n, adj_n = sv.numpy(), adj.numpy()
    rng = np.random.default_rng(stride)
    n_q = sv_n.shape[0]
    tq = rng.integers(0, n_q, 64)
    present = sv_n[tq[:, None], rng.integers(0, 256, (64, 6))]
    present = np.where(present == td.INT_MAX, 5, present)
    edges = np.stack([sv_n[tq, 0], np.where(sv_n[tq, -1] == td.INT_MAX,
                                            sv_n[tq, 0], sv_n[tq, -1])], 1)
    keys = np.concatenate([present, edges, present + 1,
                           rng.integers(0, 4**15, (64, 4)),
                           np.full((64, 1), 4**15 - 1)], 1).astype(np.int32)
    got = kernel_lookup(sv_n, adj_n, tq, keys, stride)
    tab = td._Tables(sv, adj)
    want = tab.lookup(torch.from_numpy(tq)[:, None], torch.from_numpy(keys))
    np.testing.assert_array_equal(got, want.numpy())
    assert (got > 0).any() and (got == 0).any()
