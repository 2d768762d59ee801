"""Complex arithmetic as (real, imag) f64 pairs for complex-free backends.

Some backends reject complex dtypes (see
parallel/batcheval.platform_supports_complex); the CPU and GPU backends
execute complex128 natively. Complex TCI (test/test_tensorci2.jl's ComplexF64
cases, BASELINE config 5) on a complex-free backend still needs device-side
panels, rrLU and CI factor algebra — so this module implements
the complete-pivot elimination and the triangular factor solves on explicit
(re, im) pairs of real arrays. Semantics mirror ops/lu_kernel._rrlu_state and
ops/fused.ci_factors exactly (|z|^2 pivot metric, same stop rule and
tie-breaking, identity-padded solves for dynamic rank).

Integrands must be *pair-valued* on such backends: fjax(idx) returns a
shape-(2,) real array (re, im).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def _cmul(ar, ai, br, bi):
    return ar * br - ai * bi, ar * bi + ai * br


def _cdiv(ar, ai, br, bi):
    d = br * br + bi * bi
    return (ar * br + ai * bi) / d, (ai * br - ar * bi) / d


def rrlu_state_pair(Ar, Ai, m_true, n_true, maxrank, reltol, abstol,
                    leftorthogonal: bool):
    """Complete-pivot rrLU on a complex panel stored as (Ar, Ai).

    Same contract as lu_kernel._rrlu_state, with (Ar, Ai) in place of the
    complex matrix."""
    mp, npd = Ar.shape
    rmax = min(mp, npd)
    rows = jnp.arange(mp, dtype=jnp.int32)
    cols = jnp.arange(npd, dtype=jnp.int32)

    def cond(state):
        Ar, Ai, rowperm, colperm, k, maxerror, err, done, mags = state
        return (k < maxrank) & (~done)

    def body(state):
        Ar, Ai, rowperm, colperm, k, maxerror, err, done, mags = state
        valid = (
            (rows[:, None] >= k) & (rows[:, None] < m_true)
            & (cols[None, :] >= k) & (cols[None, :] < n_true)
        )
        metric = jnp.where(valid, Ar * Ar + Ai * Ai, -1.0)
        # column-major first-occurrence argmax, transpose-free for large
        # panels only (see lu_kernel._rrlu_state for the size rationale)
        if mp * npd >= 1 << 16:
            colvals = jnp.max(metric, axis=0)
            colrows = jnp.argmax(metric, axis=0).astype(jnp.int32)
            pc = jnp.argmax(colvals).astype(jnp.int32)
            pr = colrows[pc]
        else:
            flat = metric.T.reshape(-1)
            p = jnp.argmax(flat)
            pc = (p // mp).astype(jnp.int32)
            pr = (p % mp).astype(jnp.int32)
        newerr = jnp.sqrt(jnp.maximum(metric[pr, pc], 0.0)).astype(jnp.float64)

        stop = ((newerr < reltol * maxerror) | (newerr < abstol)) & (k > 0)
        # Exactly-zero pivot => remaining submatrix is exactly zero; stop
        # instead of dividing by zero (reltol=abstol=0 "exact" passes).
        stop = stop | ((newerr == 0.0) & (k > 0))
        do = ~stop
        pr_eff = jnp.where(do, pr, k)
        pc_eff = jnp.where(do, pc, k)

        def swap_rows(M):
            rk, rp = M[k, :], M[pr_eff, :]
            return M.at[pr_eff, :].set(rk).at[k, :].set(rp)

        def swap_cols(M):
            ck, cp = M[:, k], M[:, pc_eff]
            return M.at[:, pc_eff].set(ck).at[:, k].set(cp)

        Ar, Ai = swap_rows(Ar), swap_rows(Ai)
        pk, pp = rowperm[k], rowperm[pr_eff]
        rowperm = rowperm.at[pr_eff].set(pk).at[k].set(pp)
        Ar, Ai = swap_cols(Ar), swap_cols(Ai)
        qk, qp = colperm[k], colperm[pc_eff]
        colperm = colperm.at[pc_eff].set(qk).at[k].set(qp)

        akr, aki = Ar[k, k], Ai[k, k]
        nz = do & ((akr != 0) | (aki != 0))
        safe_r = jnp.where(nz, akr, 1.0)
        safe_i = jnp.where(nz, aki, 0.0)
        if leftorthogonal:
            cr, ci = Ar[:, k], Ai[:, k]
            qr_, qi_ = _cdiv(cr, ci, safe_r, safe_i)
            m = (rows > k) & do
            cr = jnp.where(m, qr_, cr)
            ci = jnp.where(m, qi_, ci)
            Ar = Ar.at[:, k].set(cr)
            Ai = Ai.at[:, k].set(ci)
            xr = jnp.where(m, cr, 0.0)
            xi = jnp.where(m, ci, 0.0)
            yr = jnp.where(cols > k, Ar[k, :], 0.0)
            yi = jnp.where(cols > k, Ai[k, :], 0.0)
        else:
            rr, ri = Ar[k, :], Ai[k, :]
            qr_, qi_ = _cdiv(rr, ri, safe_r, safe_i)
            m = (cols > k) & do
            rr = jnp.where(m, qr_, rr)
            ri = jnp.where(m, qi_, ri)
            Ar = Ar.at[k, :].set(rr)
            Ai = Ai.at[k, :].set(ri)
            xr = jnp.where((rows > k) & do, Ar[:, k], 0.0)
            xi = jnp.where((rows > k) & do, Ai[:, k], 0.0)
            yr = jnp.where(m, rr, 0.0)
            yi = jnp.where(m, ri, 0.0)
        upr, upi = _cmul(xr[:, None], xi[:, None], yr[None, :], yi[None, :])
        Ar = Ar - upr
        Ai = Ai - upi

        mags = jnp.where(
            (jnp.arange(mags.shape[0]) == k) & do, newerr, mags
        )
        return (
            Ar, Ai, rowperm, colperm,
            k + do.astype(jnp.int32),
            jnp.where(do, jnp.maximum(maxerror, newerr), maxerror),
            newerr, stop, mags,
        )

    state0 = (
        Ar, Ai, rows, cols, jnp.int32(0), jnp.float64(0.0),
        jnp.full((), jnp.nan, jnp.float64), False,
        jnp.zeros((rmax,), dtype=jnp.float64),
    )
    Ar, Ai, rowperm, colperm, k, maxerror, err, done, mags = (
        jax.lax.while_loop(cond, body, state0)
    )
    return Ar, Ai, rowperm, colperm, k, mags, err


def right_solve_upper_pair(Ur, Ui, Br, Bi, k):
    """Solve X · U = B with U (n, n) upper-triangular on the k-block
    (identity outside); X, B are (m, n) pairs. Sequential over columns."""
    n = Ur.shape[1]
    lidx = jnp.arange(n)

    def body(j, X):
        Xr, Xi = X
        colUr = jnp.where(lidx < j, Ur[:, j], 0.0)
        colUi = jnp.where(lidx < j, Ui[:, j], 0.0)
        sr = Br[:, j] - (Xr @ colUr - Xi @ colUi)
        si = Bi[:, j] - (Xr @ colUi + Xi @ colUr)
        inb = j < k
        dr = jnp.where(inb, Ur[j, j], 1.0)
        di = jnp.where(inb, Ui[j, j], 0.0)
        qr_, qi_ = _cdiv(sr, si, dr, di)
        return Xr.at[:, j].set(qr_), Xi.at[:, j].set(qi_)

    Xr = jnp.zeros_like(Br)
    Xi = jnp.zeros_like(Bi)
    return jax.lax.fori_loop(0, n, body, (Xr, Xi))


def right_solve_unit_lower_pair(Lr, Li, Br, Bi, k):
    """Solve X · L = B with L (n, n) unit-lower-triangular on the k-block;
    columns resolve from the last to the first."""
    n = Lr.shape[1]
    lidx = jnp.arange(n)

    def body(i, X):
        j = n - 1 - i
        Xr, Xi = X
        colLr = jnp.where(lidx > j, Lr[:, j], 0.0)
        colLi = jnp.where(lidx > j, Li[:, j], 0.0)
        sr = Br[:, j] - (Xr @ colLr - Xi @ colLi)
        si = Bi[:, j] - (Xr @ colLi + Xi @ colLr)
        # unit diagonal
        return Xr.at[:, j].set(sr), Xi.at[:, j].set(si)

    Xr = jnp.zeros_like(Br)
    Xi = jnp.zeros_like(Bi)
    return jax.lax.fori_loop(0, n, body, (Xr, Xi))


def left_solve_unit_upper_pair(Ur, Ui, Br, Bi, k):
    """Solve U · X = B with U (n, n) unit-upper-triangular on the k-block;
    rows resolve from the last to the first."""
    n = Ur.shape[0]
    lidx = jnp.arange(n)

    def body(i, X):
        j = n - 1 - i
        Xr, Xi = X
        rowUr = jnp.where(lidx > j, Ur[j, :], 0.0)
        rowUi = jnp.where(lidx > j, Ui[j, :], 0.0)
        sr = Br[j, :] - (rowUr @ Xr - rowUi @ Xi)
        si = Bi[j, :] - (rowUr @ Xi + rowUi @ Xr)
        return Xr.at[j, :].set(sr), Xi.at[j, :].set(si)

    Xr = jnp.zeros_like(Br)
    Xi = jnp.zeros_like(Bi)
    return jax.lax.fori_loop(0, n, body, (Xr, Xi))


def ci_factors_pair(Ar, Ai, rowperm, colperm, k, leftorthogonal: bool):
    """CI factors from pair LU output; mirrors ops/fused.ci_factors."""
    mp, npd = Ar.shape
    rmax = min(mp, npd)
    ridx = jnp.arange(rmax)
    inblock = (ridx[:, None] < k) & (ridx[None, :] < k)

    def masked_unit_diag(Mr, Mi, tri):
        Mr = tri(Mr)
        Mi = tri(Mi)
        Mr = Mr.at[ridx, ridx].set(1.0)
        Mi = Mi.at[ridx, ridx].set(0.0)
        return Mr, Mi

    if leftorthogonal:
        Lr_all = jnp.tril(Ar[:, :rmax])
        Li_all = jnp.tril(Ai[:, :rmax])
        Lr_all = Lr_all.at[ridx, ridx].set(1.0)
        Li_all = Li_all.at[ridx, ridx].set(0.0)
        Ur_all = jnp.triu(Ar[:rmax, :])
        Ui_all = jnp.triu(Ai[:rmax, :])
        Lbr = jnp.where(inblock, Lr_all[:rmax, :rmax], jnp.eye(rmax))
        Lbi = jnp.where(inblock, Li_all[:rmax, :rmax], 0.0)
        Xr, Xi = right_solve_unit_lower_pair(Lbr, Lbi, Lr_all, Li_all, k)
        leftr = jnp.zeros_like(Xr).at[rowperm, :].set(Xr)
        lefti = jnp.zeros_like(Xi).at[rowperm, :].set(Xi)
        Rr, Ri = _matmul_pair(
            Lr_all[:rmax, :rmax], Li_all[:rmax, :rmax], Ur_all, Ui_all
        )
        rightr = jnp.zeros_like(Rr).at[:, colperm].set(Rr)
        righti = jnp.zeros_like(Ri).at[:, colperm].set(Ri)
    else:
        Ur_all = jnp.triu(Ar[:rmax, :])
        Ui_all = jnp.triu(Ai[:rmax, :])
        Ur_all = Ur_all.at[ridx, ridx].set(1.0)
        Ui_all = Ui_all.at[ridx, ridx].set(0.0)
        Lr_all = jnp.tril(Ar[:, :rmax])
        Li_all = jnp.tril(Ai[:, :rmax])
        Ubr = jnp.where(inblock, Ur_all[:rmax, :rmax], jnp.eye(rmax))
        Ubi = jnp.where(inblock, Ui_all[:rmax, :rmax], 0.0)
        Xr, Xi = left_solve_unit_upper_pair(Ubr, Ubi, Ur_all, Ui_all, k)
        rightr = jnp.zeros_like(Xr).at[:, colperm].set(Xr)
        righti = jnp.zeros_like(Xi).at[:, colperm].set(Xi)
        Cr, Ci = _matmul_pair(
            Lr_all, Li_all, Ur_all[:rmax, :rmax], Ui_all[:rmax, :rmax]
        )
        leftr = jnp.zeros_like(Cr).at[rowperm, :].set(Cr)
        lefti = jnp.zeros_like(Ci).at[rowperm, :].set(Ci)
    return leftr, lefti, rightr, righti


def _matmul_pair(Ar, Ai, Br, Bi):
    Rr = Ar @ Br - Ai @ Bi
    Ri = Ar @ Bi + Ai @ Br
    return Rr, Ri


def panel_solve_pinv_pair(P1r, P1i, Pr, Pi_, n_ip):
    """T = Π₁ · P^{-1} for complex pairs (mirrors ops/fused.panel_solve_pinv).
    P must be identity-padded outside the true n_ip block."""
    n = Pr.shape[0]
    Ar, Ai, rowperm, colperm, k, _, _ = rrlu_state_pair(
        Pr, Pi_, n_ip, n_ip, n_ip, jnp.float64(0.0), jnp.float64(0.0), True
    )
    ridx = jnp.arange(n)
    Lr = jnp.tril(Ar).at[ridx, ridx].set(1.0)
    Li = jnp.tril(Ai).at[ridx, ridx].set(0.0)
    Ur = jnp.triu(Ar)
    Ui = jnp.triu(Ai)
    pad = ridx >= n_ip
    eye = jnp.eye(n)
    Lr = jnp.where(pad[:, None] | pad[None, :], eye, Lr)
    Li = jnp.where(pad[:, None] | pad[None, :], 0.0, Li)
    Ur = jnp.where(pad[:, None] | pad[None, :], eye, Ur)
    Ui = jnp.where(pad[:, None] | pad[None, :], 0.0, Ui)
    Qr = P1r[:, colperm]
    Qi = P1i[:, colperm]
    # Y · U = Q (U upper, pivots on diag inside n_ip block)
    Yr, Yi = right_solve_upper_pair(Ur, Ui, Qr, Qi, n_ip)
    # Y' · L = Y (L unit lower)
    Yr, Yi = right_solve_unit_lower_pair(Lr, Li, Yr, Yi, n_ip)
    Tr = jnp.zeros_like(Yr).at[:, rowperm].set(Yr)
    Ti = jnp.zeros_like(Yi).at[:, rowperm].set(Yi)
    return Tr, Ti
