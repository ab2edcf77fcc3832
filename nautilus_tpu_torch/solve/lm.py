"""Levenberg-Marquardt trust region on block-band normal equations (port
of nautilus_tpu/solve/lm.py, band path).

The update mirrors Ceres' LevenbergMarquardtStrategy with its default
options, exactly as the JAX package does:

- solve (H + diag(clip(diag(H))) / radius) dx = -g;
- rho = actual_decrease / model_decrease; accept when rho > 1e-3, then the
  radius grows by 1 / max(1/3, 1 - (2 rho - 1)^3) and the divisor resets
  to 2; on reject the radius shrinks by the divisor, which doubles;
- stop on max iterations, |dcost| <= 1e-6 * cost on an accepted step, an
  accepted mean |dx| below step_tolerance, or radius underflow.

The trust-region arithmetic runs in float32 on the device, as in the JAX
package; each iteration reads the accept/stop flags on the host once.  A
failed Cholesky or a non-finite trial counts as a rejected step.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from nautilus_tpu_torch.solve.band import band_matvec, solve_damped_banded
from nautilus_tpu_torch.solve.factors import assemble_banded_system


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
    rho = actual_decrease / torch.clamp(model_decrease, min=1e-30)
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


def lm_loop_banded(x0, assemble_fn, fixed_dof,
                   params: LMParams = LMParams()) -> LMResult:
    """LM loop where assemble_fn(x) -> (BandedSystem, cost).

    The system is re-assembled at every trial point and its cost decides
    acceptance, so no separate cost evaluation runs; on rejection the trial
    system is dropped."""
    sys, cost = assemble_fn(x0)
    cost0 = cost
    x = x0
    radius = torch.tensor(params.initial_radius, dtype=x0.dtype,
                          device=x0.device)
    divisor = torch.tensor(2.0, dtype=x0.dtype, device=x0.device)
    it = 0
    converged = done = False
    while not done and it < params.max_iterations:
        dx, sysg, ok = solve_damped_banded(sys, fixed_dof, radius, params)
        x_new = x + dx
        sys_new, new_cost = assemble_fn(x_new)
        # Model decrease of 0.5 |r + J dx|^2: -(g.dx + 0.5 dx.H.dx), with the
        # line-pose rows (after the N nodes) summed apart, as in JAX.
        n = sysg.n
        Hdx = band_matvec(sysg, dx)
        gdx = torch.sum(sysg.g * dx[:n])
        dHd = torch.sum(dx[:n] * Hdx[:n])
        if sysg.num_lines:
            gdx = gdx + torch.sum(sysg.gl * dx[n:])
            dHd = dHd + torch.sum(dx[n:] * Hdx[n:])
        model_decrease = -(gdx + 0.5 * dHd)
        finite = ok & torch.all(torch.isfinite(dx)) & torch.isfinite(new_cost)
        accept, radius, divisor, converged = _trust_region_update(
            cost, new_cost, model_decrease, finite, radius, divisor,
            mean_step_metric(dx, params), params)
        accepted, converged, radius_ok = torch.stack(
            [accept, converged, radius > params.min_radius]).tolist()
        if accepted:
            x, sys, cost = x_new, sys_new, new_cost
        it += 1
        done = converged or not radius_ok
    return LMResult(x=x, cost=float(cost), initial_cost=float(cost0),
                    iterations=it, converged=converged)


def lm_solve_banded(x0, graph, fixed_dof, params: LMParams = LMParams(),
                    layout=None, lr=None) -> LMResult:
    """Run LM to convergence with the block-band linear solver.

    Requires the delta-major correspondence layout and every in-graph
    odometry factor within the band (|i - j| <= layout.w); long-range
    loop closures go in via ``lr`` as a Woodbury term."""
    return lm_loop_banded(
        x0,
        assemble_fn=lambda x: assemble_banded_system(x, graph, layout,
                                                     "moments", lr),
        fixed_dof=fixed_dof, params=params)
