"""PyTorch port: the band scan's CUDA graph cache (solve/band.py) on the
CPU.  CPU tensors and cyclic reduction never reach it; its bookkeeping
(one capture per key, replays after, least recently used dropped, a
failed capture run eagerly for good) is checked with a graph that runs
the function on its static inputs.  The captured graphs themselves are
checked on a card (tests/test_torch_cuda.py)."""

import pytest
import torch

from nautilus_tpu_torch.solve import band
from nautilus_tpu_torch.solve.factors import BandedSystem
from nautilus_tpu_torch.solve.lm import LMParams
from nautilus_tpu_torch.utils import timer


def random_system(n=40, w=3, R=4, L=1, seed=0):
    """A diagonally dominant band system with Woodbury columns and a HITL
    border of L line poses."""
    g = torch.Generator().manual_seed(seed)
    rnd = lambda *shape: torch.randn(*shape, generator=g)
    diag = rnd(n, 3, 3)
    diag = diag @ diag.mT + 8 * w * torch.eye(3)
    return BandedSystem(diag=diag, band=0.5 * rnd(w, n, 3, 3), g=rnd(n, 3),
                        U=0.3 * rnd(3 * n, R), C=0.2 * rnd(n, L, 3, 3),
                        E=10 * torch.eye(3).repeat(L, 1, 1),
                        gl=rnd(L, 3))


def _fixed(sys):
    fixed = torch.zeros(3 * (sys.n + sys.num_lines), dtype=torch.bool)
    fixed[:3] = True
    return fixed


def _solve(sys, method):
    return band.solve_damped_banded(sys, _fixed(sys), torch.tensor(1e2),
                                    LMParams(), superblock=4,
                                    method=method)[0]


def _columns(sys, method):
    return band.band_inverse_node_columns(sys, _fixed(sys),
                                          torch.tensor([4, 17, 30]),
                                          superblock=4, method=method)


class _Refused:
    def __call__(self, fn, *inputs):
        raise AssertionError(f"{fn.__name__} reached the graph cache")


def _span_names():
    return [sp.name for sp in timer.take()]


@pytest.fixture
def traced():
    timer.take()
    timer.tracing(True)
    try:
        yield
    finally:
        timer.tracing(False)
        timer.take()


@pytest.mark.parametrize("method", ["scan", "cr"])
@pytest.mark.parametrize("call", [_solve, _columns])
def test_cpu_and_cr_never_reach_the_graphs(monkeypatch, traced, method,
                                           call):
    monkeypatch.setattr(band, "_GRAPHS", _Refused())
    out = call(random_system(), method)
    assert torch.isfinite(out).all()
    assert not [n for n in _span_names() if n.startswith("band.graph")]


@pytest.mark.parametrize("call", [_solve, _columns])
def test_cpu_results_are_the_eager_scans(monkeypatch, call):
    """On the CPU the dispatch is the eager scan, bit for bit."""
    sys = random_system(seed=3)
    routed = call(sys, "scan")
    monkeypatch.setattr(band, "_scan", lambda fn, *inputs: fn(*inputs))
    assert torch.equal(routed, call(sys, "scan"))


class _RunGraph:
    """Stands in for a CUDA graph: replay() runs fn on the static inputs
    and writes the static outputs."""

    def __init__(self, fn, inputs, outputs):
        self.fn, self.inputs, self.outputs = fn, inputs, outputs

    def replay(self):
        out = self.fn(*self.inputs)
        out = (out,) if isinstance(out, torch.Tensor) else out
        for static, o in zip(self.outputs, out):
            static.copy_(o)


class _CpuCache(band._GraphCache):
    def __init__(self, fail=()):
        super().__init__()
        self.fail = fail

    def _capture(self, fn, inputs):
        if fn in self.fail:
            raise RuntimeError("operation not permitted when stream is "
                               "capturing")
        statics = tuple(t.clone() for t in inputs)
        out = fn(*statics)
        outputs = (out,) if isinstance(out, torch.Tensor) else tuple(out)
        return band._Graph(_RunGraph(fn, statics, outputs), statics, outputs)


def _tridiag(K=6, S=12, seed=0):
    """A block-tridiagonal SPD system (A [K, S, S], B [K, S, S], B_0 = 0)."""
    g = torch.Generator().manual_seed(seed)
    A = torch.randn(K, S, S, generator=g)
    A = A @ A.mT / S + 8 * torch.eye(S)
    B = torch.randn(K, S, S, generator=g) / S ** 0.5
    B[0] = 0
    return A, B


def test_one_capture_per_key_then_replays(traced):
    cache = _CpuCache()
    (A1, B1), (A2, B2) = _tridiag(seed=1), _tridiag(seed=2)
    first = cache(band._tridiag_cholesky, A1, B1)
    second = cache(band._tridiag_cholesky, A2, B2)
    held = [t.clone() for t in first]
    for m in (1, 3, 1):
        r = torch.randn(6, 12, m)
        x = cache(band._tridiag_solve, second[0], second[1], r)
        assert torch.equal(x, band._tridiag_solve(second[0], second[1], r))
    names = _span_names()
    assert names.count("band.graph.capture") == 3       # factor, m=1, m=3
    assert names.count("band.graph.replay") == 5
    assert len(cache.graphs) == 3
    # Each system gets its own answer, and a factorization handed out
    # earlier keeps its values across later replays.
    for got, want in zip(second, band._tridiag_cholesky(A2, B2)):
        assert torch.equal(got, want)
    for got, want in zip(first, held):
        assert torch.equal(got, want)


def test_least_recently_used_graph_is_dropped(monkeypatch, traced):
    monkeypatch.setattr(band, "GRAPH_CACHE_SIZE", 2)
    cache = _CpuCache()
    Ls, Cs, _ = band._tridiag_cholesky(*_tridiag())
    for m in (1, 2, 1, 3):
        cache(band._tridiag_solve, Ls, Cs, torch.randn(6, 12, m))
    assert [k[1][2][2] for k in cache.graphs] == [1, 3]
    cache(band._tridiag_solve, Ls, Cs, torch.randn(6, 12, 2))   # dropped
    assert _span_names().count("band.graph.capture") == 4


def test_failed_capture_runs_eagerly_for_good(traced):
    cache = _CpuCache(fail=(band._tridiag_cholesky,))
    A, B = _tridiag()
    with pytest.warns(UserWarning, match="runs eagerly"):
        got = cache(band._tridiag_cholesky, A, B)
    again = cache(band._tridiag_cholesky, A, B)
    for g1, g2, want in zip(got, again, band._tridiag_cholesky(A, B)):
        assert torch.equal(g1, want) and torch.equal(g2, want)
    names = _span_names()
    assert names.count("band.graph.capture") == 1
    assert "band.graph.replay" not in names
    assert not cache.graphs and len(cache.failed) == 1
