"""Matrix-free LM: preconditioned CG on the normal equations (port of
nautilus_tpu/solve/cg.py).

The dense path (solve/lm.py ``lm_solve``) holds H [3M, 3M]; this path never
forms it.  Per accepted LM step the factors are linearized once to
(r, J, dof) batches (factors._graph_factor_terms), and CG iterates with

    H v  =  sum over batches of  scatter( J^T (J gather(v)) ),

two small batched products and one scatter-add per factor type.  Gauge
fixing projects the fixed dofs out of every product.

Two preconditioners:
- block Jacobi: the inverse of the damped 3x3 block diagonal of H;
- the damped block-band Cholesky of the band-eligible subset of the graph
  (everything but the long-range loop closures): H = H_band + low rank, so
  the preconditioned spectrum clusters at 1 and CG needs a fraction of the
  iterations.  HITL line poses, which the band does not hold, keep block
  Jacobi.  One band factorization per inner solve.

The inner tolerance follows Eisenstat and Walker's choice 2,
eta_k = gamma (|g_k| / |g_{k-1}|)^alpha clamped to [tolerance, eta_max], and
each solve starts from the previous accepted step.  The trust-region
schedule is solve/lm.py's.

The loops run in Python: one host read of the residual test per CG
iteration, and one of the accept/stop flags per LM step.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from nautilus_tpu_torch.solve.band import (_apply_gauge_band,
                                           band_apply_inverse, band_factor,
                                           resolve_band_plan)
from nautilus_tpu_torch.solve.factors import (FactorGraph,
                                              _graph_factor_terms, _jtj,
                                              assemble_banded_system,
                                              total_cost)
from nautilus_tpu_torch.solve.lm import (LMParams, LMResult, _read_flags,
                                         _trust_region_update,
                                         mean_step_metric)
from nautilus_tpu_torch.utils.timer import span


class CGParams(NamedTuple):
    max_iterations: int = 100
    tolerance: float = 1e-6     # relative-residual floor
    # Eisenstat-Walker forcing (choice 2): early LM steps stop CG after a
    # few iterations instead of solving a linearization that is about to be
    # replaced down to the floor.
    ew_gamma: float = 0.9
    ew_alpha: float = 1.6
    ew_eta_max: float = 0.1
    ew_enabled: bool = True


def _linearize(x, graph: FactorGraph):
    """(terms, g [3M], diag [M, 3, 3], cost): the factor terms, the gradient,
    the 3x3 diagonal blocks of H and the cost at x [M, 3]."""
    terms = _graph_factor_terms(x, graph)
    m = x.shape[0]
    g = torch.zeros((3 * m,), dtype=x.dtype, device=x.device)
    diag = torch.zeros((m, 3, 3), dtype=x.dtype, device=x.device)
    cost = torch.zeros((), dtype=x.dtype, device=x.device)
    for r, J, dof in terms:
        Hq, gq = _jtj(r, J)
        g.index_put_((dof,), gq, accumulate=True)
        diag.index_put_((dof[:, 0] // 3,), Hq[:, :3, :3], accumulate=True)
        diag.index_put_((dof[:, 3] // 3,), Hq[:, 3:, 3:], accumulate=True)
        cost = cost + 0.5 * torch.sum(r * r)
    return terms, g, diag, cost


def _hvp(terms, v, n_dof: int):
    """H v without forming H."""
    out = torch.zeros((n_dof,), dtype=v.dtype, device=v.device)
    for _, J, dof in terms:
        w = torch.einsum("qmi,qi->qm", J, v[dof])
        out.index_put_((dof,), torch.einsum("qmi,qm->qi", J, w),
                       accumulate=True)
    return out


def _inv3x3(blocks):
    """Batched closed-form inverse of [M, 3, 3] blocks, with a small
    Tikhonov term and a floor on the determinant."""
    blocks = blocks + 1e-10 * torch.eye(3, dtype=blocks.dtype,
                                        device=blocks.device)
    a, b, c = blocks[:, 0, 0], blocks[:, 0, 1], blocks[:, 0, 2]
    d, e, f = blocks[:, 1, 0], blocks[:, 1, 1], blocks[:, 1, 2]
    g, h, i = blocks[:, 2, 0], blocks[:, 2, 1], blocks[:, 2, 2]
    A = e * i - f * h
    B = -(d * i - f * g)
    C = d * h - e * g
    det = a * A + b * B + c * C
    det = torch.where(torch.abs(det) < 1e-30, torch.full_like(det, 1e-30),
                      det)
    inv = torch.stack([
        torch.stack([A, -(b * i - c * h), b * f - c * e], dim=-1),
        torch.stack([B, a * i - c * g, -(a * f - c * d)], dim=-1),
        torch.stack([C, -(a * h - b * g), a * e - b * d], dim=-1),
    ], dim=-2)
    return inv / det[:, None, None]


def _safe(denom):
    return torch.where(torch.abs(denom) < 1e-30,
                       torch.full_like(denom, 1e-30), denom)


def _cg(matvec, precond, b, n_iters: int, tol, x0=None):
    """Preconditioned CG on matvec(x) = b until the residual norm falls to
    ``tol`` (a float or a 0-dim tensor) times |b|, or ``n_iters``.  x0
    warm-starts it.  Returns (x, iterations run)."""
    if x0 is None:
        x, r = torch.zeros_like(b), b
    else:
        x, r = x0, b - matvec(x0)
    z = precond(r)
    p = z
    rz = torch.dot(r, z)
    stop = tol * torch.clamp(torch.sqrt(torch.dot(b, b)), min=1e-30)
    k = 0
    while k < n_iters and bool(torch.sqrt(torch.dot(r, r)) > stop):
        Ap = matvec(p)
        alpha = rz / _safe(torch.dot(p, Ap))
        x = x + alpha * p
        r = r - alpha * Ap
        z = precond(r)
        rz_new = torch.dot(r, z)
        p = z + (rz_new / _safe(rz)) * p
        rz = rz_new
        k += 1
    return x, k


def lm_solve_cg(x0, graph: FactorGraph, fixed_dof,
                params: LMParams = LMParams(),
                cg_params: CGParams = CGParams(),
                band_graph: FactorGraph = None, layout=None) -> LMResult:
    """LM with matrix-free PCG inner solves; same contract as lm_solve.

    band_graph + layout (optional): the band-eligible subset of the factor
    graph (in-window correspondences, odometry and closures; everything but
    the long-range closures).  When given, the damped block-band Cholesky of
    that subset preconditions CG instead of block Jacobi."""
    m = x0.shape[0]
    n_dof = 3 * m
    dtype, dev = x0.dtype, x0.device
    free = (~fixed_dof).to(dtype)
    use_band = band_graph is not None and layout is not None

    def linearize(x):
        """The factor terms at x and, for the band preconditioner, the
        gauged band system of the subset."""
        terms, g, diag, cost = _linearize(x, graph)
        sysg = None
        if use_band:
            sysg = _apply_gauge_band(
                assemble_banded_system(x, band_graph, layout, True)[0],
                fixed_dof)
        return terms, g, diag, cost, sysg

    def solve_damped(terms, g, diag, sysg, radius, dx_prev, eta):
        d = torch.clamp(torch.diagonal(diag, dim1=1, dim2=2).reshape(-1),
                        params.min_diagonal, params.max_diagonal)
        d = torch.where(fixed_dof, torch.zeros_like(d), d) / radius

        def matvec(v):
            v = v * free
            return (_hvp(terms, v, n_dof) + d * v) * free

        # Damped block-Jacobi blocks: the fallback preconditioner, and the
        # line-pose tail under the band preconditioner.
        inv_blocks = _inv3x3(diag + torch.diag_embed(d.reshape(m, 3)))
        ok = torch.ones((), dtype=torch.bool, device=dev)

        def jacobi(v3, blocks):
            return torch.einsum("mij,mj->mi", blocks, v3).reshape(-1)

        if use_band:
            n = layout.n
            # The same damped diagonal as the matvec's: the preconditioner
            # then equals H exactly on the band.
            dsys = sysg._replace(
                diag=sysg.diag + torch.diag_embed(d[:3 * n].reshape(n, 3)))
            fac = band_factor(dsys, *resolve_band_plan(n, layout.w))
            ok = fac.ok

            def precond(v):
                v = v * free
                zn = band_apply_inverse(fac, v[:3 * n].reshape(n, 3))
                zl = jacobi(v[3 * n:].reshape(m - n, 3), inv_blocks[n:])
                return torch.cat([zn.reshape(-1), zl]) * free
        else:
            def precond(v):
                return jacobi((v * free).reshape(m, 3), inv_blocks) * free

        dx, k = _cg(matvec, precond, -g * free, cg_params.max_iterations,
                    eta, x0=dx_prev * free)
        return dx, d, ok, k

    def forcing(g, g_prev_norm):
        """This LM step's inner tolerance and |g|; the first step (no
        previous gradient) starts loose."""
        gn = torch.sqrt(torch.sum((g * free) ** 2))
        if not cg_params.ew_enabled:
            return cg_params.tolerance, gn
        if g_prev_norm is None:
            return cg_params.ew_eta_max, gn
        eta = cg_params.ew_gamma * (gn / torch.clamp(g_prev_norm, min=1e-30)
                                    ) ** cg_params.ew_alpha
        return torch.clamp(eta, cg_params.tolerance,
                           cg_params.ew_eta_max), gn

    terms, g, diag, cost, sysg = linearize(x0)
    cost0 = cost
    x = x0
    radius = torch.tensor(params.initial_radius, dtype=dtype, device=dev)
    divisor = torch.tensor(2.0, dtype=dtype, device=dev)
    dx_prev = torch.zeros((n_dof,), dtype=dtype, device=dev)
    g_prev_norm = None
    it = inner = 0
    converged = done = False
    while not done and it < params.max_iterations:
        with span("lm.step"):
            with span("lm.factor"):
                eta, g_norm = forcing(g, g_prev_norm)
                dx, d, ok, k = solve_damped(terms, g, diag, sysg, radius,
                                            dx_prev, eta)
            inner += k
            x_new = x + dx.reshape(m, 3)
            with span("lm.assemble"):
                new_cost = total_cost(x_new, graph)
            with span("lm.decide"):
                hdx = _hvp(terms, dx, n_dof)
                model_decrease = -(torch.dot(g * free, dx)
                                   + 0.5 * torch.dot(dx, hdx * free + d * dx))
                finite = ok & torch.all(torch.isfinite(dx)) \
                    & torch.isfinite(new_cost)
                accept, radius, divisor, converged = _trust_region_update(
                    cost, new_cost, model_decrease, finite, radius, divisor,
                    mean_step_metric(dx, params), params)
                accepted, converged, radius_ok = _read_flags(
                    accept, converged, radius, params)
            if accepted:
                # The next linearization is nearby: start its CG from this
                # step, and move the forcing ratio's gradient norm.
                x, dx_prev, g_prev_norm = x_new, dx, g_norm
                with span("lm.assemble"):
                    terms, g, diag, cost, sysg = linearize(x)
            else:
                # The next system is damped harder: start from zero.
                dx_prev = torch.zeros_like(dx)
        it += 1
        done = converged or not radius_ok
    return LMResult(x=x, cost=float(cost), initial_cost=float(cost0),
                    iterations=it, converged=converged,
                    inner_iterations=inner)
