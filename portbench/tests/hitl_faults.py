"""Faults planted in the port's curation step, for the tests that must
catch them (tests/test_torch_hitl_reference.py and
portbench/tests/test_portbench_hitl_session.py).  Each takes a
pytest.MonkeyPatch and patches the port for as long as it is active."""

import dataclasses


def drop_line_b(mp):
    """Line B's poses never reach the solve."""
    from nautilus_tpu_torch.solve import hitl
    build = hitl.build_hitl_factors

    def without_b(state, dtype=None):
        saved = state.hitl_constraints
        state.hitl_constraints = [dataclasses.replace(c, line_b_poses=[])
                                  for c in saved]
        try:
            return build(state, dtype)
        finally:
            state.hitl_constraints = saved
    mp.setattr(hitl, "build_hitl_factors", without_b)


def fixed_line_pose(mp):
    """The line poses held at the identity, like the gauge pose."""
    from nautilus_tpu_torch.solve import solver
    plain = solver.Solver._fixed_mask

    def fixed(self):
        mask = plain(self)
        mask[3 * self.state.num_nodes:] = True
        return mask
    mp.setattr(solver.Solver, "_fixed_mask", fixed)


def wide_selection(mp):
    """Poses selected at twice the configured line width."""
    from nautilus_tpu_torch.solve import hitl
    tests = hitl._point_tests
    mp.setattr(hitl, "_point_tests",
               lambda p, m, x, msg, width: tests(p, m, x, msg, 2 * width))


def window_short(mp):
    """Every sweep stops one window short."""
    from nautilus_tpu_torch.solve import solver

    def short(self, optimization_type="feature"):
        cfg = self.config
        return self._solve_windows(
            cfg.get_int("lidar_constraint_amount_min"),
            cfg.get_int("lidar_constraint_amount_max") - 1, optimization_type)
    mp.setattr(solver.Solver, "solve_slam", short)
