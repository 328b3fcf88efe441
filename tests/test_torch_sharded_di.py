"""The position-sharded Manhattan DI stencil on CPU slots against the port's
one-device pass, the oracle's sliding_l1 and mtr_tpu's shard_map stencil on
JAX's 8-device CPU mesh, and wired into the pipeline.  The sums are
integers: every comparison is exact."""

import dataclasses
import io

import numpy as np
import pytest

from mtr_tpu_torch import pipeline as tp
from mtr_tpu_torch.config import MTRConfig
from mtr_tpu_torch.ops import directional_index as di_ops
from mtr_tpu_torch.oracle.directional_index import sliding_l1
from mtr_tpu_torch.parallel.mesh import make_mesh
from mtr_tpu_torch.testutil.rand_seq import write_fasta

K = 3
N_VALS, N_OUT = 20000, 17000


def cpu_mesh(n):
    return make_mesh(devices=["cpu"] * n)


@pytest.fixture(scope="module")
def vals():
    return np.random.default_rng(7).integers(0, 4**K, N_VALS).astype(np.int32)


# with 8 slots a block is 2,125 + w / 4 positions: w = 1400 needs 2,800
# codes to its right, which reach past the next block into the one after
# (the JAX original's second ring hop)
@pytest.mark.parametrize("w", [5, 40, 640, 1400])
def test_sliding_l1_sharded_equals_one_device_oracle_and_jax(vals, w):
    from mtr_tpu.ops.directional_index import sliding_l1_sharded as ref
    from mtr_tpu.parallel.mesh import make_mesh as ref_mesh

    want = sliding_l1(vals, w, N_OUT)
    np.testing.assert_array_equal(
        di_ops.sliding_l1_device(vals, w, N_OUT, "cpu"), want)
    np.testing.assert_array_equal(
        ref(vals, w, N_OUT, ref_mesh(8), K, halo=4096), want)
    for n in (2, 4, 8):
        got = di_ops.sliding_l1_sharded(vals, w, N_OUT, cpu_mesh(n), K,
                                        halo=4096)
        assert got.dtype == np.int64 and got.shape == (N_OUT,)
        np.testing.assert_array_equal(got, want)
    local_n = -(-(N_OUT + 2 * w - 1) // 8)
    assert (2 * w > local_n) == (w == 1400)


def test_sliding_l1_sharded_keeps_the_halo_bound(vals):
    with pytest.raises(ValueError, match="halo"):
        di_ops.sliding_l1_sharded(vals, 1025, 100, cpu_mesh(2), K, halo=2048)
    # more slots than positions: the tail blocks are all padding
    got = di_ops.sliding_l1_sharded(vals, 2, 3, cpu_mesh(8), K)
    np.testing.assert_array_equal(got, sliding_l1(vals, 2, 3))


def test_di_compute_sharded_equals_one_device(vals):
    """The plug-in's placement and bounds, against make_di_compute_k's, a
    pass and a group of passes."""
    di_len, k, rsl = 12000, K, 1200
    buf = np.zeros(di_len + 16, np.int32)
    buf[: di_len - k + 1] = vals[: di_len - k + 1]
    one = di_ops.make_di_compute_k("cpu", True)
    sharded = di_ops.make_di_manhattan_sharded(cpu_mesh(4))
    for ws in ([320], [5, 10, 20, 40, 80, 160, 320]):
        got = sharded(buf, di_len, ws, k, rsl)
        assert len(got) == len(ws)
        for g, want, w in zip(got, one(buf, di_len, ws, k, rsl), ws):
            np.testing.assert_array_equal(g, want)
            assert (g[w : w + 100] != -1.0).any()
    short = sharded(buf, 100, [90], k, 40)
    assert len(short) == 1 and (short[0] == -1.0).all()


def test_pipeline_uses_sharded_di_and_matches_host(monkeypatch, tmp_path):
    """A ~12 kb read (unit 10 x 400 and flanks) past a small DI threshold,
    under a sharded batcher: run_file cuts its Manhattan DI over the
    batcher's mesh, and the output equals the host backend's."""
    calls = []
    real = di_ops.sliding_l1_sharded

    def spy(vals, w, n_out, mesh, *rest, **kw):
        calls.append((w, mesh.size))
        return real(vals, w, n_out, mesh, *rest, **kw)

    monkeypatch.setattr(di_ops, "sliding_l1_sharded", spy)
    fa = str(tmp_path / "long.fasta")
    write_fasta(fa, fa[:-6] + ".units", 10, 400, 2.0, 2.0, 2.0, 4000, 4000,
                1, seed=11)
    host_out = io.StringIO()
    tp.run_file(fa, MTRConfig(backend="host"), host_out)

    cfg = dataclasses.replace(
        MTRConfig(backend="device", use_device_walks=False),
        device_di_threshold=8192)
    di_ops.CALLS = di_ops.SHARDED_CALLS = 0
    dev_out = io.StringIO()
    tp.run_file(fa, cfg, dev_out,
                batcher=tp.ShardedTorchDPBatcher(cpu_mesh(4)))
    assert host_out.getvalue() == dev_out.getvalue()
    assert host_out.getvalue().strip(), "no records produced"
    assert calls, "the sharded DI stencil never engaged"
    assert all(size == 4 for _, size in calls)
    assert di_ops.SHARDED_CALLS == di_ops.CALLS == len(calls)

    # Pearson stays on one device, and so does a mesh of one slot (a
    # short read past a threshold of 100 bases shows the routing)
    small = str(tmp_path / "small.fasta")
    write_fasta(small, small[:-6] + ".units", 10, 20, 2.0, 2.0, 2.0, 100,
                100, 1, seed=11)
    host_small = io.StringIO()
    tp.run_file(small, MTRConfig(backend="host"), host_small)
    cfg = dataclasses.replace(cfg, device_di_threshold=100)
    calls.clear()
    for cfg_i, n in ((dataclasses.replace(cfg, manhattan_distance=False), 2),
                     (cfg, 1), (cfg, 2)):
        before = di_ops.CALLS
        out = io.StringIO()
        tp.run_file(small, cfg_i, out,
                    batcher=tp.ShardedTorchDPBatcher(cpu_mesh(n)))
        assert di_ops.CALLS > before
        assert bool(calls) == (cfg_i is cfg and n == 2)
        if cfg_i is cfg:
            assert out.getvalue() == host_small.getvalue()


@pytest.mark.parametrize("n_slots,w,n_out", [(3, 700, 9001), (5, 17, 4099),
                                             (8, 2, 7)])
def test_sliding_l1_sharded_reads_exactly_the_pass(n_slots, w, n_out):
    """Blocks of n_out / slots positions (parts differ by at most one),
    each from its codes plus the 2w - 1 to its right, over a buffer that
    ends at the pass's last code (alphabet 1,024, k 5): equal to the
    oracle, and no kernel launched on CPU slots."""
    vals = np.random.default_rng(w).integers(0, 1024, n_out + 2 * w - 1)
    vals = vals.astype(np.int32)
    before = dict(di_ops.KERNEL_LAUNCHES)
    got = di_ops.sliding_l1_sharded(vals, w, n_out, cpu_mesh(n_slots), 5)
    assert got.dtype == np.int64 and got.shape == (n_out,)
    np.testing.assert_array_equal(got, sliding_l1(vals, w, n_out,
                                                  use_native=False))
    assert di_ops.KERNEL_LAUNCHES == before


@pytest.mark.parametrize("cut,reach", [(2925, [False, False, True]),
                                       (2905, [True, True, True]),
                                       (2950, [False, False, False])])
def test_group_stale_tail_some_passes_reach(cut, reach):
    """A stale tail of codes up to 63 from `cut` on, behind k-1 codes: the
    Manhattan plug-in called a pass at a time sizes each pass's alphabet
    over its own codes (4 symbols for the passes that end before the
    tail, 64 for those that reach it), called on the group it takes the
    group's largest; every pass's DI is the same both ways, through the
    sharded plug-in and the oracle."""
    rng = np.random.default_rng(cut)
    di_len, k, rsl, ws = 3000, 1, 100, [5, 10, 20]
    buf = rng.integers(0, 4, di_len + 64).astype(np.int32)
    buf[cut:] = rng.integers(0, 64, len(buf) - cut)
    n_pos = [di_len - rsl - k + 2 * w for w in ws]
    assert [cut < n for n in n_pos] == reach
    plug = di_ops.make_di_compute_k("cpu", True)
    sharded = di_ops.make_di_manhattan_sharded(cpu_mesh(3))(buf, di_len, ws,
                                                            k, rsl)
    for w, got, got_sharded in zip(ws, plug(buf, di_len, ws, k, rsl),
                                   sharded):
        n_i = di_len - w - rsl - k + 1
        D = sliding_l1(buf, w, n_i + w, use_native=False)
        want = np.full(di_len, -1.0)
        want[w : w + n_i] = (D[:n_i] - D[w : w + n_i]) / float(2 * w)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(plug(buf, di_len, [w], k, rsl)[0],
                                      want)
        np.testing.assert_array_equal(got_sharded, want)
