"""PyTorch port, the reason for the one wider limit of
``test_torch_entry.py``: ``run_pointcloud`` at config ``cloud1m`` (lmax=2,
bf16, 2,000 points, 3 steps) against itself with the fp32 sums of every
update and message product in reverse order.  The curve after the first
Adam step and the held-out MSE move by more than the 3.3e-5 of the bf16
curves, and by less than the 3e-3 that they are held to against JAX: at
lmax=2 the bf16 curve follows the order of the fp32 sums, which no two
implementations share.
"""

import numpy as np
import pytest
import torch

from scalable_e3_gnn_torch.ops import linear, tensor_product
from scalable_e3_gnn_torch.train import runners as trunners
from scalable_e3_gnn_torch.utils import config as tconfig
from tests.test_torch_entry import TOL_BF16, TOL_BF16_LMAX2_STEPPED, _losses


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The port's side on one thread: the suite runs several workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _reversed_sum(f, w):
    """``f @ w`` in fp32 with the contraction summed in reverse order."""
    return torch.matmul(f.float().flip(-1), w.float().flip(0))


def test_bf16_curve_moves_with_the_sum_order(tmp_path, monkeypatch):
    cfg = tconfig.cloud1m_config()
    cfg.train.bf16 = True

    def run(tag):
        got = trunners.run_pointcloud(cfg, points=2000, steps=3, log=str(tmp_path / tag),
                                      device="cpu")
        return np.append(_losses(str(tmp_path / tag)), got["eval_mse"])

    base = run("base")
    for mod in (tensor_product, linear):
        monkeypatch.setattr(mod, "_matmul_f32", _reversed_sum)
    moved = run("reversed")
    rel = np.abs(moved - base) / np.abs(base)
    assert np.all(np.isfinite(rel))
    # after the first update (losses 2-3, eval_mse): beyond 3.3e-5, within 3e-3
    assert rel[1:].max() > TOL_BF16
    assert rel[1:].max() < TOL_BF16_LMAX2_STEPPED
