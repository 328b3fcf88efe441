"""The port's DBG walks against mtr_tpu's: stage A tables against JAX's
_stage_a at each of its buckets, stage_b_plain against _stage_b, the row
walk (walk_rows' plain twin) against the earlier speculative design with
host winner selection (testutil/walk_cases.speculative_rows) on golden
batches, fuzz sets and chosen edges, and dbg_walk_device_batch against
JAX's on the four fuzz sets of tests/test_dbg_device.py and against
native.dbg_walk_batch2 on a larger set with whale ranges and tie storms,
with at most two waits a call however many chunks.  Every output is an
integer: compared exactly.  Result rows are compared per query (unit and
score rows up to each period), since row offsets depend on the engine."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mtr_tpu import native
from mtr_tpu.ops import dbg_device as jd
from mtr_tpu_torch.testutil import walk_cases as wc
from mtr_tpu_torch.utils.timers import TIMERS
from mtr_tpu_torch.ops import dbg_device as td
from tests.test_dbg_device import make_read

CPU = torch.device("cpu")
GOLDEN = "tests/golden"


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def assert_same(got, want, n):
    g, w = wc.canonical(got, n), wc.canonical(want, n)
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


def _jobs(maxfreq, n_nodes, nodes):
    """The speculative jobs of a chunk: for every gated row, forward over
    its max nodes in list order, then backward -> numpy (tq, node0,
    is_fwd)."""
    gated = np.nonzero(maxfreq.numpy() > td.MIN_NUM_FREQ_UNIT)[0]
    nn = n_nodes.numpy()[gated].astype(np.int64)
    per = 2 * nn
    grp = np.repeat(np.arange(len(gated)), per)
    within = np.arange(int(per.sum())) - np.repeat(np.cumsum(per) - per, per)
    is_fwd = within < nn[grp]
    rank = np.where(is_fwd, within, within - nn[grp])
    return gated[grp], nodes.numpy()[gated][grp, rank], is_fwd


def test_stage_b_plain_matches_jax():
    orgs, lens, queries = _walk_set(11)
    ridx, qs, qe, k = as_arrays(queries)
    sv, adj, maxfreq, nodes, n_nodes = _port_stage_a(orgs, lens, queries, 1024)
    tq, node0, is_fwd = _jobs(maxfreq, n_nodes, nodes)
    assert len(np.unique(tq)) > len(queries) // 2
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


def test_walk_rows_cpu_tensors_run_plain():
    """walk_rows on CPU tensors runs the plain twin (no launch counted),
    writing exactly what walk_rows_plain writes; a tensor on another
    device raises."""
    orgs, lens, queries = _walk_set(12)
    ridx, qs, qe, k = as_arrays(queries)
    tabs = _port_stage_a(orgs, lens, queries, 1024)
    rows = (torch.from_numpy(k.astype(np.int32)),
            torch.from_numpy(np.minimum(500, (qe - qs) // 5).astype(np.int32)))
    q, cap = len(queries), 2 * 500 * len(queries)

    def outs():
        return (torch.zeros((q, 4), dtype=torch.int32),
                torch.zeros((q, 2), dtype=torch.int64),
                torch.zeros(cap, dtype=torch.uint8),
                torch.zeros(cap, dtype=torch.int32),
                torch.zeros(1, dtype=torch.int64))

    launches = TIMERS.counters["launch.dbg_walk"]
    got, want = outs(), outs()
    td.walk_rows(*tabs, *rows, *got)
    td.walk_rows_plain(*tabs, *rows, *want)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert TIMERS.counters["launch.dbg_walk"] == launches
    assert int(got[4][0]) > 0 and got[0][:, 3].any()  # rows; a bad query
    with pytest.raises((RuntimeError, AssertionError, ValueError)):
        td.walk_rows(tabs[0].to("meta"), *tabs[1:], *rows, *outs())


# ------------------------------------ the row walk vs the speculative design


def _golden_batch(name, n_reads):
    orgs, lens, (ridx, qs, qe, _, k) = wc.batch_queries(
        f"{GOLDEN}/{name}.fasta", n_reads)
    return orgs, lens, np.stack([ridx, qs, qe, k], 1)


def _whales_and_storms():
    orgs, lens, queries = _whale_set()
    return orgs, lens, np.asarray(queries)


ROW_SETS = {
    "golden_multi20_100x10": lambda: _golden_batch("multi20_100x10", 4),
    "golden_multitr_gen_2_5_10_20":
        lambda: _golden_batch("multitr_gen_2_5_10_20", 2),
    "whales_and_storms": _whales_and_storms,
    "walk_set": lambda: _walk_set(15),
    "tie_storms": lambda: _fuzz_tie_storms(),
}


@pytest.mark.parametrize("name", sorted(ROW_SETS))
def test_row_walk_matches_speculative(name):
    """The row walk (rank groups, stop at the first group that loops)
    equals every max node walked both ways with the host's winner rule:
    periods, found_last, the bad flag, and the winning rows cut to their
    periods, reversed for backward walks, chunk by chunk."""
    orgs, lens, queries = ROW_SETS[name]()
    n_rows = n_won = 0
    for v_pad, chunk in wc.chunks_of(orgs, lens, queries):
        want = wc.speculative_rows(*chunk)
        got = wc.run_rows(*chunk)
        assert not wc.differing(got, want), (v_pad, wc.differing(got, want))
        n_rows += len(want["bad"])
        n_won += int((want["fwd_period"] > 0).sum())
    assert n_rows == len(queries) and n_won > 0


@pytest.fixture(scope="module")
def edges():
    return wc.edge_chunk()


@pytest.fixture(scope="module")
def wide_edges():
    return wc.edge_chunk(td.WIDE_V)


@pytest.mark.parametrize("kind", wc.EDGE_KINDS)
def test_row_walk_edges(kind, edges):
    """Rows with chosen max-node lists (testutil/walk_cases.edge_chunk):
    the row walk equals the speculative design on each, with the bad flag
    and the winners the rank-group rule expects."""
    _check_edges(kind, edges)


@pytest.mark.parametrize("kind", wc.EDGE_KINDS)
def test_row_walk_edges_wide_group(kind, wide_edges):
    """The same rows in tables WIDE_V wide, where a direction walks eight
    max nodes at once: the same bad flags and winners."""
    assert td.walk_group(td.WIDE_V) > td.walk_group(td.WIDE_V // 2)
    _check_edges(kind, wide_edges)


def _check_edges(kind, edges):
    chunk, kinds, expect = edges
    rows = [r for r, kd in enumerate(kinds) if kd == kind]
    assert rows
    sel = torch.tensor(rows)
    part = tuple(t[sel].contiguous() for t in chunk)
    got = wc.run_rows(*part)
    assert not wc.differing(got, wc.speculative_rows(*part))
    sv, sc, maxfreq, nodes, n_nodes, k, lmax = part
    for i, r in enumerate(rows):
        bad, fwd_rank, bwd_rank = expect[r]
        assert bool(got["bad"][i]) == bad
        for name, d, rank in (("fwd", 1, fwd_rank), ("bwd", 0, bwd_rank)):
            if bad:
                continue
            if rank < 0:
                assert got[f"{name}_period"][i] == 0
                continue
            # the winner is the walk from the list's rank-th node
            one = td.stage_b_plain(
                sv, sc, torch.tensor([i], dtype=torch.int32),
                nodes[i, rank : rank + 1], torch.tensor([d], dtype=torch.int32),
                k[i : i + 1], lmax[i : i + 1])
            assert bool(one[0][0]) and got[f"{name}_period"][i] == int(one[1][0])
    if kind == "ovf_at_winner":  # the winner itself overflowed
        one = td.stage_b_plain(sv, sc, torch.tensor([0], dtype=torch.int32),
                               nodes[0, :1], torch.tensor([0], dtype=torch.int32),
                               k[:1], lmax[:1])
        assert bool(one[0][0]) and bool(one[4][0])
    if kind == "period_500":  # every walk loops at step 500: no unit
        one = td.stage_b_plain(sv, sc, torch.tensor([0], dtype=torch.int32),
                               nodes[0, :1], torch.tensor([1], dtype=torch.int32),
                               k[:1], lmax[:1])
        assert int(one[1][0]) == td.MAX_PERIOD and not bool(one[0][0])


def test_plain_work_counts_walks_up_to_the_winner(wide_edges):
    """walk_rows_plain adds to PLAIN_WORK only the walks up to each
    direction's winner (the kernel stops the rest of the group): on a row
    whose rank 1 wins among eight, the lookups and steps of ranks 0 and 1
    both ways."""
    chunk, kinds, expect = wide_edges
    r = next(i for i, (kd, e) in enumerate(zip(kinds, expect))
             if kd == "ovf_after_winner" and e == (False, 1, 1))
    part = tuple(t[r : r + 1].contiguous() for t in chunk)
    sv, sc, maxfreq, nodes, n_nodes, k, lmax = part
    assert int(n_nodes[0]) > 2 and td.walk_group(sv.shape[1]) >= n_nodes[0]
    work = {}
    i32 = torch.int32
    td.stage_b_plain(sv, sc, torch.zeros(4, dtype=i32),
                     nodes[0, [0, 1, 0, 1]],
                     torch.tensor([1, 1, 0, 0], dtype=i32),
                     k.repeat(4), lmax.repeat(4), work)
    td.PLAIN_WORK.update(lookups=0, steps=0)
    wc.run_rows(*part)
    assert td.PLAIN_WORK == {"lookups": int(work["lookups"].sum()),
                             "steps": int(work["steps"].sum())}


def test_walk_waits_at_most_two_per_call(monkeypatch):
    """With CHUNK_ELEMS cut so that a call runs ten chunks or more, the
    device route still waits at most twice a call (walk_waits), calls no
    .cpu() / .item() / .tolist() on the way, and its result is the
    native engine's."""
    orgs, lens, queries = _golden_batch("multi20_100x10", 2)
    arrays = tuple(queries.T)
    monkeypatch.setattr(td, "CHUNK_ELEMS", 1 << 12)
    syncs = []
    for name in ("cpu", "item", "tolist"):
        real = getattr(torch.Tensor, name)
        monkeypatch.setattr(torch.Tensor, name,
                            lambda self, *a, _r=real, _n=name, **kw:
                            syncs.append(_n) or _r(self, *a, **kw))
    before = TIMERS.snapshot()[1]
    got = td.dbg_walk_device_batch(orgs, lens, *arrays, CPU)
    after = TIMERS.snapshot()[1]
    monkeypatch.undo()

    def grew(key):
        return after.get(key, 0) - before.get(key, 0)

    assert grew("walk_device_calls") == 1
    assert grew("stage_a_calls") >= 10
    assert grew("walk_waits") <= 2
    assert grew("walk_rows_bytes") > 0
    assert not syncs
    want = native.dbg_walk_batch2(
        [np.ascontiguousarray(o, np.int32) for o in orgs], lens, *arrays)
    assert_same(got, want, len(queries))


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


def _whale_set():
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
    return orgs, lens, queries


def test_batch_matches_native_with_whales_and_storms():
    """_whale_set through the whole route against the native engine."""
    orgs, lens, queries = _whale_set()
    arrays = as_arrays(queries)
    before = TIMERS.counters["walk_fallback_queries"]
    got = td.dbg_walk_device_batch(orgs, lens, *arrays, CPU)
    n_host = TIMERS.counters["walk_fallback_queries"] - before
    want = native.dbg_walk_batch2(
        [np.ascontiguousarray(o, np.int32) for o in orgs], lens, *arrays)
    assert_same(got, want, len(queries))
    assert 0 < n_host < len(queries) // 10
    assert got["found_last"][-5] or got["fwd_off"][-5] >= 0  # a whale walked


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


# ------------------------------------------ the walk kernel's lookup


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

