"""Levenberg-Marquardt trust region on block-band or dense normal equations
(port of nautilus_tpu/solve/lm.py).

The update mirrors Ceres' LevenbergMarquardtStrategy with its default
options, exactly as the JAX package does:

- solve (H + diag(clip(diag(H))) / radius) dx = -g;
- rho = actual_decrease / model_decrease; accept when rho > 1e-3, then the
  radius grows by 1 / max(1/3, 1 - (2 rho - 1)^3) and the divisor resets
  to 2; on reject the radius shrinks by the divisor, which doubles;
- stop on max iterations, |dcost| <= 1e-6 * cost on an accepted step, an
  accepted mean |dx| below step_tolerance, or radius underflow.

The trust-region arithmetic runs on the device in the dtype of x (float32
by default, float64 for a float64 problem), as in the JAX package; each
iteration reads the accept/stop flags on the host once.  Each iteration is
an ``lm.step`` span (utils/timer) holding ``lm.factor`` (the damped solve),
``lm.assemble`` (the trial assembly or cost) and ``lm.decide`` (model
decrease, trust region, the flags read).  The band loop's step ends at the
read; the dense and CG loops re-linearize after an accepted step's read,
inside the step, so the device tail of that work falls in the next step.
A failed Cholesky or a non-finite trial counts as a rejected step.  One
copy of the schedule (``_trust_region_update``, ``mean_step_metric``)
serves the band loop, the dense loop below and the matrix-free loop of
solve/cg.py.

The dense loop holds H [3M, 3M]: gauge fixing zeroes the fixed rows and
columns and puts a unit diagonal there, which equals holding those
parameter blocks constant.  It evaluates the trial cost with a cost-only
pass and re-assembles H only after an accepted step.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from nautilus_tpu_torch.solve.band import band_matvec, solve_damped_banded
from nautilus_tpu_torch.solve.factors import (assemble_banded_system,
                                              assemble_normal_equations,
                                              total_cost)
from nautilus_tpu_torch.utils.timer import span


class LMParams(NamedTuple):
    """Defaults mirror ceres::Solver::Options (Ceres 1.14)."""

    max_iterations: int = 50
    function_tolerance: float = 1e-6
    # Mean |dx| per accepted step below this -> converged (config key
    # accuracy_change_stop_threshold); 0 disables.
    step_tolerance: float = 0.0
    # Leading dof entries the mean-step criterion averages over (0 = all).
    step_dof: int = 0
    min_relative_decrease: float = 1e-3
    initial_radius: float = 1e4
    max_radius: float = 1e16
    min_radius: float = 1e-32
    min_diagonal: float = 1e-6
    max_diagonal: float = 1e32


class LMResult(NamedTuple):
    x: torch.Tensor       # [N + L, 3] solved node and line poses
    cost: float           # final cost
    initial_cost: float
    iterations: int       # accepted + rejected LM steps taken
    converged: bool       # hit a convergence criterion
    inner_iterations: int = 0   # CG iterations over all LM steps (CG only)


def mean_step_metric(dx, params: LMParams):
    """Mean |dx| over the leading params.step_dof entries."""
    flat = dx.reshape(-1)
    k = params.step_dof if params.step_dof > 0 else flat.shape[0]
    return torch.sum(torch.abs(flat[:k])) / k


def _trust_region_update(cost, new_cost, model_decrease, step_finite,
                         radius, divisor, mean_step, params: LMParams):
    """Ceres' accept/radius schedule on 0-dim tensors.

    Returns (accept, radius_new, divisor_new, converged)."""
    actual_decrease = cost - new_cost
    floor = 1e-300 if cost.dtype == torch.float64 else 1e-30
    rho = actual_decrease / torch.clamp(model_decrease, min=floor)
    accept = step_finite & (model_decrease > 0) \
        & (rho > params.min_relative_decrease)
    grow = 1.0 / torch.clamp(1.0 - (2.0 * rho - 1.0) ** 3, min=1.0 / 3.0)
    radius_new = torch.where(
        accept, torch.clamp(radius * grow, max=params.max_radius),
        radius / divisor)
    divisor_new = torch.where(accept, torch.full_like(divisor, 2.0),
                              divisor * 2.0)
    converged = accept & (torch.abs(actual_decrease)
                          <= params.function_tolerance * cost)
    if params.step_tolerance > 0:
        converged = converged | (accept & (mean_step <= params.step_tolerance))
    return accept, radius_new, divisor_new, converged


def _read_flags(accept, converged, radius, params: LMParams):
    """(accepted, converged, radius above its floor) in one host read."""
    return torch.stack([accept, converged,
                        radius > params.min_radius]).tolist()


def _apply_gauge(H, g, fixed_dof):
    """Zero fixed rows/cols with a unit diagonal; clear the fixed gradient."""
    free = ~fixed_dof
    Hg = H * (free[:, None] & free[None, :]).to(H.dtype)
    Hg = Hg + torch.diag(fixed_dof.to(H.dtype))
    return Hg, g * free.to(g.dtype)


def _solve_damped(H, g, fixed_dof, radius, params: LMParams):
    """Solve (H + D / radius) dx = -g by dense Cholesky.  Returns (dx, gauged
    H, gauged g, ok): ok is False when the factorization failed, and the
    step must then be rejected."""
    Hg, gg = _apply_gauge(H, g, fixed_dof)
    d = torch.clamp(torch.diagonal(Hg), params.min_diagonal,
                    params.max_diagonal)
    # The unit diagonal of fixed dofs stays undamped, so dx is 0 there.
    d = torch.where(fixed_dof, torch.zeros_like(d), d)
    A = Hg + torch.diag(d / radius)
    chol, info = torch.linalg.cholesky_ex(A)
    dx = torch.cholesky_solve(-gg[:, None], chol)[:, 0]
    return dx, Hg, gg, info == 0


def lm_loop(x0, assemble_fn, cost_fn, fixed_dof,
            params: LMParams = LMParams(),
            iteration_callback=None) -> LMResult:
    """Dense LM loop: assemble_fn(x) -> (H, g, cost), cost_fn(x) -> cost.
    iteration_callback(x, cost, iteration), when given, runs after every
    step, accepted or not, with the current x and cost."""
    H, g, cost = assemble_fn(x0)
    cost0 = cost
    x = x0
    radius = torch.tensor(params.initial_radius, dtype=x0.dtype,
                          device=x0.device)
    divisor = torch.tensor(2.0, dtype=x0.dtype, device=x0.device)
    it = 0
    converged = done = False
    while not done and it < params.max_iterations:
        with span("lm.step"):
            with span("lm.factor"):
                dx, Hg, gg, ok = _solve_damped(H, g, fixed_dof, radius,
                                               params)
            x_new = x + dx.reshape(x.shape)
            with span("lm.assemble"):
                new_cost = cost_fn(x_new)
            with span("lm.decide"):
                # Model decrease of 0.5 |r + J dx|^2: -(g.dx + 0.5 dx.H.dx).
                model_decrease = -(torch.dot(gg, dx)
                                   + 0.5 * torch.dot(dx, Hg @ dx))
                finite = ok & torch.all(torch.isfinite(dx)) \
                    & torch.isfinite(new_cost)
                accept, radius, divisor, converged = _trust_region_update(
                    cost, new_cost, model_decrease, finite, radius, divisor,
                    mean_step_metric(dx, params), params)
                accepted, converged, radius_ok = _read_flags(
                    accept, converged, radius, params)
            if accepted:
                x = x_new
                with span("lm.assemble"):
                    H, g, cost = assemble_fn(x)
        it += 1
        done = converged or not radius_ok
        if iteration_callback is not None:
            iteration_callback(x, cost, it)
    return LMResult(x=x, cost=float(cost), initial_cost=float(cost0),
                    iterations=it, converged=converged)


def lm_solve(x0, graph, fixed_dof, params: LMParams = LMParams(),
             layout=None) -> LMResult:
    """Run LM to convergence from x0 [M, 3] with the dense Cholesky solver.

    fixed_dof: [3M] bool, the gauge-fixed dofs.  layout: optional
    factors.BandLayout for the scatter-free assembly of the correspondence
    blocks (needs the delta-major pair order)."""
    return lm_solve_stepped(x0, graph, fixed_dof, params, layout=layout)


def lm_solve_stepped(x0, graph, fixed_dof, params: LMParams = LMParams(),
                     iteration_callback=None, layout=None) -> LMResult:
    """lm_solve calling iteration_callback(x, cost, iteration) after every
    LM step: the reference's per-iteration redraw, the same steps as
    lm_solve.  A callback that reads x on the host makes it a debugging
    mode."""
    return lm_loop(
        x0,
        assemble_fn=lambda x: assemble_normal_equations(x, graph, layout),
        cost_fn=lambda x: total_cost(x, graph),
        fixed_dof=fixed_dof, params=params,
        iteration_callback=iteration_callback)


def fixed_pose_mask(num_dofs: int, fixed_pose: int = 0,
                    device=None) -> torch.Tensor:
    """[num_dofs] bool mask fixing one pose's 3 dofs (the gauge)."""
    mask = torch.zeros((num_dofs,), dtype=torch.bool, device=device)
    mask[3 * fixed_pose:3 * fixed_pose + 3] = True
    return mask


def lm_loop_banded(x0, assemble_fn, fixed_dof,
                   params: LMParams = LMParams(), superblock=None,
                   method: str = "auto") -> LMResult:
    """LM loop where assemble_fn(x) -> (BandedSystem, cost).

    The system is re-assembled at every trial point and its cost decides
    acceptance, so no separate cost evaluation runs; on rejection the trial
    system is dropped.  superblock and method pick the band backend
    (band.resolve_band_plan: 'auto' is cyclic reduction from CR_MIN_NODES
    nodes on, the scan below)."""
    sys, cost = assemble_fn(x0)
    cost0 = cost
    x = x0
    radius = torch.tensor(params.initial_radius, dtype=x0.dtype,
                          device=x0.device)
    divisor = torch.tensor(2.0, dtype=x0.dtype, device=x0.device)
    it = 0
    converged = done = False
    while not done and it < params.max_iterations:
        with span("lm.step"):
            with span("lm.factor"):
                dx, sysg, ok = solve_damped_banded(sys, fixed_dof, radius,
                                                   params, superblock, method)
            x_new = x + dx
            with span("lm.assemble"):
                sys_new, new_cost = assemble_fn(x_new)
            with span("lm.decide"):
                # Model decrease of 0.5 |r + J dx|^2: -(g.dx + 0.5 dx.H.dx),
                # with the line-pose rows (after the N nodes) summed apart,
                # as in JAX.
                n = sysg.n
                Hdx = band_matvec(sysg, dx)
                gdx = torch.sum(sysg.g * dx[:n])
                dHd = torch.sum(dx[:n] * Hdx[:n])
                if sysg.num_lines:
                    gdx = gdx + torch.sum(sysg.gl * dx[n:])
                    dHd = dHd + torch.sum(dx[n:] * Hdx[n:])
                model_decrease = -(gdx + 0.5 * dHd)
                finite = ok & torch.all(torch.isfinite(dx)) \
                    & torch.isfinite(new_cost)
                accept, radius, divisor, converged = _trust_region_update(
                    cost, new_cost, model_decrease, finite, radius, divisor,
                    mean_step_metric(dx, params), params)
                accepted, converged, radius_ok = _read_flags(
                    accept, converged, radius, params)
        if accepted:
            x, sys, cost = x_new, sys_new, new_cost
        it += 1
        done = converged or not radius_ok
    return LMResult(x=x, cost=float(cost), initial_cost=float(cost0),
                    iterations=it, converged=converged)


def lm_solve_banded(x0, graph, fixed_dof, params: LMParams = LMParams(),
                    layout=None, lr=None, superblock=None,
                    method: str = "auto", analytic="moments") -> LMResult:
    """Run LM to convergence with the block-band linear solver.

    Requires the delta-major correspondence layout and every in-graph
    odometry factor within the band (|i - j| <= layout.w); long-range
    loop closures go in via ``lr`` as a Woodbury term.  analytic:
    'moments' or True (factors.assemble_banded_system)."""
    return lm_loop_banded(
        x0,
        assemble_fn=lambda x: assemble_banded_system(x, graph, layout,
                                                     analytic, lr),
        fixed_dof=fixed_dof, params=params, superblock=superblock,
        method=method)
