"""PyTorch port on a CUDA card: the hand-written CSM coarse kernel against
its plain PyTorch version.

The file imports no jax, so it also runs where jax is not installed (the
repository's conftest imports jax, hence ``--noconftest``):

    python -m pytest --noconftest -m cuda -q tests/test_torch_cuda.py

Without a card every test skips.
"""

import numpy as np
import pytest
import torch

from nautilus_tpu_torch.kernels import csm_coarse

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    return torch.device("cuda")


# (C, P, R, cells, noff, halfwidth, res, integer_tables)
CASES = {
    # The shapes of test_torch_csm.py (and of the JAX package's fused-kernel
    # test): random normal tables, summed in another order than plain.
    "small": (2, 48, 8, 16, 5, 4.0, 0.5, False),
    # T = 240: the 225 KB table and the points exceed the 227 KB of shared
    # memory a block may use, so the kernel reads the table from global
    # memory.  Integer-valued tables make every sum exact in float32, so
    # the two versions agree bit for bit whatever their order.
    "table_in_global": (2, 768, 16, 226, 15, 33.9, 0.3, True),
}


def _inputs(dev, C, P, R, cells, noff, halfwidth, integer_tables, seed=5):
    rng = np.random.default_rng(seed)
    T = cells + noff - 1
    pts = rng.uniform(-halfwidth, halfwidth, (C, P, 2))
    mask = rng.random((C, P)) > 0.2
    parked = np.where(mask[..., None], pts, 1e6).astype(np.float32)
    thetas = rng.uniform(-1.5, 1.5, (C, R)).astype(np.float32)
    tables = (rng.integers(-8, 8, (C, T, T)) if integer_tables
              else rng.normal(size=(C, T, T))).astype(np.float32)
    return [torch.as_tensor(a, device=dev) for a in (parked, thetas, tables)]


@pytest.mark.parametrize("case", list(CASES))
def test_kernel_matches_plain_on_card(dev, case):
    C, P, R, cells, noff, hw, res, integer_tables = CASES[case]
    parked, thetas, tables = _inputs(dev, C, P, R, cells, noff, hw,
                                     integer_tables)
    kw = dict(cells=cells, noff=noff, halfwidth=hw, res=res)
    T = cells + noff - 1
    assert csm_coarse.table_in_shared_memory(T, P) == (case == "small")
    before = csm_coarse.fused_coarse.launches
    out = csm_coarse.fused_coarse(parked, thetas, tables, **kw)
    ref = csm_coarse.fused_coarse_reference(parked, thetas, tables, **kw)
    torch.cuda.synchronize()
    assert csm_coarse.fused_coarse.launches == before + 1
    assert out.shape == (C, R, noff, noff)
    if integer_tables:
        assert bool(torch.any(out != 0))
        torch.testing.assert_close(out, ref, rtol=0, atol=0)
    else:
        # Same float32 table values summed in another order.
        torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-4)


def test_masked_out_of_raster_and_empty_score_zero_on_card(dev):
    C, P, R, cells, noff, hw, res, _ = CASES["small"]
    parked, thetas, tables = _inputs(dev, C, P, R, cells, noff, hw, False)
    parked[0] = 1e6                     # every point masked (parked)
    parked[1] = 50.0                    # every point outside the raster
    kw = dict(cells=cells, noff=noff, halfwidth=hw, res=res)
    out = csm_coarse.fused_coarse(parked, thetas, tables, **kw)
    empty = csm_coarse.fused_coarse(parked[:, :0].contiguous(), thetas,
                                    tables, **kw)
    torch.cuda.synchronize()
    assert torch.all(out == 0)
    assert empty.shape == out.shape and torch.all(empty == 0)
