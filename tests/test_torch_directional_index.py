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
