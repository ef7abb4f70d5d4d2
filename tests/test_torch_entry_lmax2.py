"""PyTorch port, ``run_pointcloud`` at config ``cloud1m`` (lmax=2) against
the JAX runner at 2,000 points, in fp32 and bf16, and the GPU's kernel
dispatch forced on the CPU: ``test_torch_entry.py``'s checks and limits."""

import pytest
import torch

from tests.test_torch_entry import check_kernel_dispatch, check_run_pointcloud


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The port's side on one thread: the suite runs several workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("bf16", [False, True], ids=["fp32", "bf16"])
def test_run_pointcloud_matches_jax(bf16, tmp_path, monkeypatch):
    check_run_pointcloud("cloud1m", bf16, tmp_path, monkeypatch)


def test_kernel_dispatch_on_the_cpu_matches_jax(tmp_path, monkeypatch):
    check_kernel_dispatch("cloud1m", tmp_path, monkeypatch)

