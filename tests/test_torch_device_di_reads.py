"""The device-DI read cases of test_torch_pcc_device.py on its other two
seeds, Pearson and Manhattan (a file of their own, so that the test
workers share the cases: each takes 30-160 s on one thread, most of it
the plain DP)."""

import pytest
import torch

from _device_di_reads import SEEDS, check_one_read


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("manhattan", [False, True], ids=["pearson", "manhattan"])
@pytest.mark.parametrize("seed", SEEDS[1:])
def test_device_di_records_and_ranges_match_the_reference(tmp_path, seed, manhattan):
    check_one_read(tmp_path, seed, manhattan)
