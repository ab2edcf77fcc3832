"""Block-band Cholesky solver for the SLAM normal equations (port of
nautilus_tpu/solve/band.py, scan backend).

Lidar/odometry factors couple nodes within the window (|i - j| <= w), so H
is block-banded with 3x3 blocks.  Grouping s >= w block rows into
superblocks of S = 3s dofs makes it block tridiagonal (diagonal A_k,
sub-diagonal B_k), factored by a sequential scan:

  L_0 L_0^T = A_0;   C_k = B_k L_{k-1}^{-T};   L_k L_k^T = A_k - C_k C_k^T

followed by forward/backward substitution.  Long-range loop closures
(H_lr = U U^T) fold in by the Woodbury identity.  HITL line poses couple a
few extra dofs to arbitrary nodes; they form a dense border (C, E, gl)
that the Schur complement on the small line block eliminates.

Vectors over all dofs are [N + L, 3]: the N nodes, then the L line poses.

A failed Cholesky does not raise: ``cholesky_ex`` reports it, and the
caller treats the step as rejected (the JAX package sees NaNs there).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from nautilus_tpu_torch.solve.factors import BandedSystem


def band_matvec(sys: BandedSystem, v):
    """H @ v in band (+ low-rank, + border) form, v [N + L, 3] -> same."""
    n = sys.n
    v, vl = v[:n], v[n:]
    out = torch.einsum("nij,nj->ni", sys.diag, v)
    for d in range(1, sys.w + 1):
        b = sys.band[d - 1]                      # block (i, i-d) at row i
        out[d:] += torch.einsum("nij,nj->ni", b[d:], v[:-d])
        out[:-d] += torch.einsum("nji,nj->ni", b[d:], v[d:])
    if sys.rank_lr:
        uv = sys.U.T @ v.reshape(3 * n)
        out = out + (sys.U @ uv).reshape(n, 3)
    if not sys.num_lines:
        return out
    out = out + torch.einsum("nlij,lj->ni", sys.C, vl)
    outl = (torch.einsum("nlij,ni->lj", sys.C, v)
            + torch.einsum("lij,lj->li", sys.E, vl))
    return torch.cat([out, outl])


def _apply_gauge_band(sys: BandedSystem, fixed):
    """Zero fixed rows/cols with a unit diagonal; fixed: [3N + 3L] bool."""
    n = sys.n
    fr = fixed[:3 * n].reshape(n, 3)
    keep = (~fr).to(sys.diag.dtype)
    diag = sys.diag * keep[:, :, None] * keep[:, None, :]
    diag = diag + torch.diag_embed(fr.to(sys.diag.dtype))
    band = sys.band.clone()
    for d in range(1, sys.w + 1):
        kj = torch.zeros_like(keep)
        kj[d:] = keep[:-d]
        band[d - 1] = sys.band[d - 1] * keep[:, :, None] * kj[:, None, :]
    U = sys.U
    if sys.rank_lr:
        # Zeroing fixed ROWS of U zeroes both rows and columns of U U^T.
        U = U * keep.reshape(3 * n)[:, None]
    C, E, gl = sys.C, sys.E, sys.gl
    if sys.num_lines:
        L = sys.num_lines
        fl = fixed[3 * n:3 * (n + L)].reshape(L, 3)
        keepl = (~fl).to(diag.dtype)
        C = C * keep[:, None, :, None] * keepl[None, :, None, :]
        E = E * keepl[:, :, None] * keepl[:, None, :] \
            + torch.diag_embed(fl.to(diag.dtype))
        gl = gl * keepl
    return BandedSystem(diag=diag, band=band, g=sys.g * keep, U=U, C=C, E=E,
                        gl=gl)


def _superblock_tridiag(sys: BandedSystem, s: int):
    """Superblock tridiagonal (A [K, S, S], B [K, S, S]) from the band,
    S = 3 s, K = ceil(n / s); requires s >= w.  B_0 = 0."""
    n, w = sys.n, sys.w
    K = -(-n // s)
    pad_n = K * s - n
    dt, dev = sys.diag.dtype, sys.diag.device
    padn = lambda t: torch.nn.functional.pad(
        t, (0, 0) * (t.dim() - 1) + (0, pad_n))
    diag = padn(sys.diag)
    if pad_n:
        # Padded tail rows get a unit diagonal so the factor stays SPD.
        diag[n:] += torch.eye(3, dtype=dt, device=dev)
    eye_s = torch.eye(s, dtype=dt, device=dev)
    A = (0.5 * diag).reshape(K, s, 3, 3)[:, :, None] \
        * eye_s[None, :, :, None, None]                    # [K, s, s, 3, 3]
    B = torch.zeros_like(A)
    ar = torch.arange(s, device=dev)
    for d in range(1, w + 1):
        lvl = padn(sys.band[d - 1]).reshape(K, s, 3, 3)[:, :, None]
        in_a = (ar[:, None] - ar[None, :] == d).to(dt)      # a - b == d
        A = A + lvl * in_a[None, :, :, None, None]
        in_b = (s + ar[:, None] - ar[None, :] == d).to(dt)
        B = B + lvl * in_b[None, :, :, None, None]
    A = A + A.permute(0, 2, 1, 4, 3)
    S = 3 * s
    A = A.permute(0, 1, 3, 2, 4).reshape(K, S, S)
    B = B.permute(0, 1, 3, 2, 4).reshape(K, S, S)
    return A, B, K, pad_n


class BandFactorization(NamedTuple):
    Ls: torch.Tensor     # [K, S, S] diagonal Cholesky factors
    Cs: torch.Tensor     # [K, S, S] sub-diagonal factors (C_0 = 0)
    K: int
    pad_n: int
    s: int
    ok: torch.Tensor     # 0-dim bool: every Cholesky succeeded


def _tridiag_cholesky(A, B):
    """Factor the superblock tridiagonal by a sequential scan."""
    K, S = A.shape[0], A.shape[1]
    Ls = torch.empty_like(A)
    Cs = torch.zeros_like(B)
    info_sum = torch.zeros((), dtype=torch.int32, device=A.device)
    l_prev = None
    for k in range(K):
        a = A[k]
        if k:
            # C_k = B_k L_{k-1}^{-T} = (L_{k-1}^{-1} B_k^T)^T
            c = torch.linalg.solve_triangular(l_prev, B[k].T, upper=False).T
            Cs[k] = c
            a = a - c @ c.T
        l_prev, info = torch.linalg.cholesky_ex(a)
        Ls[k] = l_prev
        info_sum = info_sum + (info != 0).to(torch.int32)
    return Ls, Cs, info_sum == 0


def _tridiag_solve(Ls, Cs, r):
    """Solve (L L^T) x = r with the tridiagonal factors; r [K, S, m]."""
    K = Ls.shape[0]
    ys = torch.empty_like(r)
    y = None
    for k in range(K):
        rk = r[k] if k == 0 else r[k] - Cs[k] @ y
        y = torch.linalg.solve_triangular(Ls[k], rk, upper=False)
        ys[k] = y
    xs = torch.empty_like(r)
    x = None
    for k in reversed(range(K)):
        yk = ys[k] if k == K - 1 else ys[k] - Cs[k + 1].T @ x
        x = torch.linalg.solve_triangular(Ls[k].T, yk, upper=True)
        xs[k] = x
    return xs


def resolve_band_plan(w: int) -> int:
    """Superblock size of the sequential scan backend.

    The JAX package switches to block cyclic reduction at n >= 2000
    (CR_MIN_NODES); that backend is not ported yet (ROADMAP.md section 1,
    'CR backend'), so the port runs the scan at every n.  The scan is exact
    at any n: cyclic reduction only changes its speed on long chains.
    """
    return max(16, w)


def band_factor(sys: BandedSystem, s: int) -> BandFactorization:
    A, B, K, pad_n = _superblock_tridiag(sys, s)
    Ls, Cs, ok = _tridiag_cholesky(A, B)
    return BandFactorization(Ls, Cs, K, pad_n, s, ok)


def band_apply_inverse(fac: BandFactorization, r):
    """Hb^{-1} r for r [N, 3, m] (multi-RHS) or [N, 3] -> same shape."""
    squeeze = r.dim() == 2
    if squeeze:
        r = r[..., None]
    n, m = r.shape[0], r.shape[-1]
    rk = torch.nn.functional.pad(r, (0, 0, 0, 0, 0, fac.K * fac.s - n))
    x = _tridiag_solve(fac.Ls, fac.Cs, rk.reshape(fac.K, fac.s * 3, m))
    x = x.reshape(fac.K * fac.s, 3, m)[:n]
    return x[..., 0] if squeeze else x


def _make_node_inverse(sysg: BandedSystem, fac: BandFactorization):
    """(closure z -> (Hb + U U^T)^{-1} z, ok flag): the band factorization
    plus the Woodbury correction when the system carries U."""
    n, R = sysg.n, sysg.rank_lr
    if not R:
        return (lambda z: band_apply_inverse(fac, z)), fac.ok
    T = band_apply_inverse(fac, sysg.U.reshape(n, 3, R))      # Hb^-1 U
    Tf = T.reshape(3 * n, R)
    core = torch.eye(R, dtype=Tf.dtype, device=Tf.device) + sysg.U.T @ Tf
    MW, info = torch.linalg.cholesky_ex(core)

    def node_inverse(z):
        z1 = band_apply_inverse(fac, z)
        flat = z1.reshape(3 * n, -1)
        corr = Tf @ torch.cholesky_solve(sysg.U.T @ flat, MW)
        return z1 - corr.reshape(z1.shape)

    return node_inverse, fac.ok & (info == 0)


def _line_block(E):
    """Dense block diagonal [3L, 3L] of the line blocks E [L, 3, 3]."""
    return torch.block_diag(*E.unbind(0))


def _border_columns(sys: BandedSystem):
    """The border C [N, L, 3, 3] as N x 3 rows of 3L columns."""
    return sys.C.permute(0, 2, 1, 3).reshape(sys.n, 3, 3 * sys.num_lines)


def band_inverse_node_columns(sys: BandedSystem, fixed, cols,
                              reg: float = 1e-8):
    """Columns of H^{-1}: (H^{-1})[:3N, cols] as [3N, m], cols < 3N.

    The covariance engine of the loop-closure gate: gauge by ``fixed``,
    Tikhonov-regularize, factor once and solve all unit columns in one
    multi-RHS pass (+ Woodbury for long-range closures).  The HITL border
    enters by the block-inverse identity (H^-1)_nn = Hn^-1 + Y S^-1 Y^T,
    Y = Hn^-1 C, S = E - C^T Hn^-1 C.  A failed factorization yields NaN
    columns, as in the JAX package.
    """
    sysg = _apply_gauge_band(sys, fixed)
    n = sysg.n
    eye3 = torch.eye(3, dtype=sysg.diag.dtype, device=sysg.diag.device)
    sysg = sysg._replace(diag=sysg.diag + reg * eye3)
    node_inverse, ok = _make_node_inverse(
        sysg, band_factor(sysg, resolve_band_plan(sysg.w)))
    m = cols.shape[0]
    rhs = (torch.arange(3 * n, device=cols.device)[:, None]
           == cols[None, :]).to(sysg.diag.dtype).reshape(n, 3, m)
    X = node_inverse(rhs)                                     # [N, 3, m]
    if sysg.num_lines:
        eye3 = torch.eye(3, dtype=X.dtype, device=X.device)
        C2 = _border_columns(sysg)
        Y = node_inverse(C2)                                  # Hn^-1 C
        S = _line_block(sysg.E + reg * eye3) \
            - torch.einsum("nim,nik->mk", C2, Y)
        LS, info = torch.linalg.cholesky_ex(S)
        CtX = torch.einsum("nim,nik->mk", C2, X)
        X = X + torch.einsum("nim,mk->nik", Y, torch.cholesky_solve(CtX, LS))
        ok = ok & (info == 0)
    X = X.reshape(3 * n, m)
    return torch.where(ok, X, torch.full_like(X, float("nan")))


def solve_damped_banded(sys: BandedSystem, fixed, radius, params):
    """Solve (H + D/radius) dx = -g in band (+ low-rank, + border) form.

    LM-scaled damping on the clipped diagonal of the full H (band + U U^T,
    and the line blocks), gauge by fixed-dof masking.  With HITL line poses
    the node block is eliminated first: Y = Hn^-1 C, u = -Hn^-1 g, then the
    Schur complement S = E - C^T Y gives the line step
    dxl = S^-1 (-gl - C^T u) and dx = u - Y dxl.  Returns (step [N + L, 3],
    gauged system, ok): ok is False when a Cholesky failed (the step must be
    rejected).
    """
    sysg = _apply_gauge_band(sys, fixed)
    n = sysg.n
    diag_full = torch.diagonal(sysg.diag, dim1=-2, dim2=-1)
    if sysg.rank_lr:
        diag_full = diag_full + torch.sum(sysg.U * sysg.U, dim=1).reshape(n, 3)
    dvec = torch.clamp(diag_full, params.min_diagonal, params.max_diagonal)
    fr = fixed[:3 * n].reshape(n, 3)
    dvec = torch.where(fr, torch.zeros_like(dvec), dvec)
    dsys = sysg._replace(diag=sysg.diag + torch.diag_embed(dvec / radius))
    node_inverse, ok = _make_node_inverse(
        dsys, band_factor(dsys, resolve_band_plan(sysg.w)))
    L = sysg.num_lines
    if not L:
        return node_inverse(-sysg.g), sysg, ok
    El = sysg.E
    dl = torch.clamp(torch.diagonal(El, dim1=-2, dim2=-1),
                     params.min_diagonal, params.max_diagonal)
    fl = fixed[3 * n:3 * (n + L)].reshape(L, 3)
    dl = torch.where(fl, torch.zeros_like(dl), dl)
    C2 = _border_columns(sysg)                                # [N, 3, 3L]
    sol = node_inverse(torch.cat([C2, -sysg.g[..., None]], dim=-1))
    Y, u = sol[..., :3 * L], sol[..., 3 * L]                  # Hn^-1 C, -Hn^-1 g
    S = _line_block(El + torch.diag_embed(dl / radius)) \
        - torch.einsum("nim,nik->mk", C2, Y)
    rl = -sysg.gl.reshape(3 * L) - torch.einsum("nim,ni->m", C2, u)
    LS, info = torch.linalg.cholesky_ex(S)
    dxl = torch.cholesky_solve(rl[:, None], LS)[:, 0]
    dx = u - torch.einsum("nim,m->ni", Y, dxl)
    return torch.cat([dx, dxl.reshape(L, 3)]), sysg, ok & (info == 0)
