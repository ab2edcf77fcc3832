"""PyTorch port: the band assembly's correspondence moments on the CPU.

On a CUDA card the moment form runs the hand-written kernel
(kernels/band_moments.py, checked against the plain version in
tests/test_torch_cuda.py).  CPU tensors and the Jacobian form stay on the
plain slice adds and never reach it."""

import numpy as np
import pytest
import torch

from nautilus_tpu_torch.core.luaconf import load_config_text
from nautilus_tpu_torch.ingest.synthetic import reverse_traversal_problem
from nautilus_tpu_torch.kernels import band_moments as bm
from nautilus_tpu_torch.solve import factors
from nautilus_tpu_torch.solve.solver import Solver


@pytest.fixture(scope="module")
def window_graph():
    """(x, graph, layout) of the 32-pose reverse traversal's third window."""
    state, _ = reverse_traversal_problem(3, device="cpu")
    cfg = load_config_text("translation_weight=1\nrotation_weight=1\n"
                           "lidar_constraint_amount_min=1\n"
                           "lidar_constraint_amount_max=3\n"
                           "outlier_threshold=0.25\n")
    solver = Solver(state, cfg)
    x = solver._current_x()
    return x, solver.build_graph(x, 3), solver._layout


@pytest.mark.parametrize("analytic", ["moments", True])
def test_cpu_assembly_stays_on_the_plain_version(monkeypatch, window_graph,
                                                 analytic):
    x, graph, layout = window_graph

    def refused(*args):
        raise AssertionError("a CPU assembly reached the CUDA kernel")
    before = bm.band_moments.launches
    monkeypatch.setattr(bm, "band_moments", refused)
    got = factors._accumulate_banded(x, graph, layout, analytic)
    want = factors._accumulate_banded_reference(x, graph, layout, analytic)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    sys_, cost = factors.assemble_banded_system(x, graph, layout, analytic)
    assert torch.isfinite(sys_.diag).all() and float(cost) > 0
    monkeypatch.undo()
    assert bm.band_moments.launches == before == 0


def test_band_moments_refuse_cpu_tensors(window_graph):
    x, graph, layout = window_graph
    with pytest.raises(ValueError, match="CUDA"):
        bm.band_moments(x, graph.planar, graph.edge, layout)
    assert np.isfinite(float(factors._accumulate_banded(
        x, graph, layout)[3]))
