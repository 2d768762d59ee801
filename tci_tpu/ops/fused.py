"""Fused bond update: Π sampling + rank-revealing LU + CI factor extraction
as ONE jit-compiled device program.

TCI's two-site update (tensorci2.jl:825-930) needs, per bond: sample the Π
panel, factorize it, and extract the left/right CI factors. Doing these as
separate host-driven steps costs several dispatch+transfer round trips per
bond. When the
integrand is jax-traceable, this module compiles the whole bond update into a
single XLA program: the panel never leaves the device, and the factor algebra
(triangular solves + permutation scatters, mirroring matrixluci.jl:194-241)
runs on-device with dynamic rank handled by masking instead of dynamic shapes.
"""

from __future__ import annotations

import functools
from typing import Callable, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.scipy.linalg import solve_triangular

from .lu_kernel import _rrlu_state, bucket


def ci_factors(A, rowperm, colperm, k, leftorthogonal: bool, dtype):
    """CI factors from padded in-place LU output (device-side).

    Mirrors matrixluci.jl:194-283 with dynamic rank handled by masking: the
    k x k pivot block of the triangular solve matrix is padded to identity so
    the solve stays benign; columns/rows beyond k of the outputs are garbage
    and must be sliced away by the caller. Returns (left (mp, rmax),
    right (rmax, np)) in ORIGINAL row/column order."""
    mp = A.shape[0]
    npd = A.shape[1]
    rmax = min(mp, npd)
    ridx = jnp.arange(rmax)
    eye = jnp.eye(rmax, dtype=dtype)
    inblock = (ridx[:, None] < k) & (ridx[None, :] < k)

    if leftorthogonal:
        L_all = jnp.tril(A[:, :rmax])
        L_all = L_all.at[ridx, ridx].set(1.0)
        U_all = jnp.triu(A[:rmax, :])
        Lb = L_all[:rmax, :rmax]
        M = jnp.where(inblock, Lb, eye)
        X = solve_triangular(M.T, L_all.T, lower=False).T
        left = jnp.zeros_like(X).at[rowperm, :].set(X)
        R = Lb @ U_all
        right = jnp.zeros_like(R).at[:, colperm].set(R)
    else:
        U_all = jnp.triu(A[:rmax, :])
        U_all = U_all.at[ridx, ridx].set(1.0)
        L_all = jnp.tril(A[:, :rmax])
        Ub = U_all[:rmax, :rmax]
        M = jnp.where(inblock, Ub, eye)
        X = solve_triangular(M, U_all, lower=False)
        right = jnp.zeros_like(X).at[:, colperm].set(X)
        C = L_all @ Ub
        left = jnp.zeros_like(C).at[rowperm, :].set(C)
    return left, right


def panel_solve_pinv(Pi1, P, n_ip, dtype):
    """T = Π₁ · P^{-1} on device, with P padded to identity outside its true
    n_ip x n_ip block (complete-pivot rrLU + two masked triangular solves,
    so the dynamic rank needs no dynamic shapes)."""
    n = P.shape[0]
    A, rowperm, colperm, k, _, _ = _rrlu_state(
        P, n_ip, n_ip, n_ip, jnp.float64(0.0), jnp.float64(0.0), True
    )
    ridx = jnp.arange(n)
    L = jnp.tril(A).at[ridx, ridx].set(1.0)
    U = jnp.triu(A)
    pad = ridx >= n_ip
    L = jnp.where(pad[:, None] | pad[None, :], jnp.eye(n, dtype=dtype), L)
    U = jnp.where(pad[:, None] | pad[None, :], jnp.eye(n, dtype=dtype), U)
    Qp = Pi1[:, colperm]
    Y = solve_triangular(U.T, Qp.T, lower=True).T  # Y · U = Qp
    Y = solve_triangular(L.T, Y.T, lower=False).T  # Y' · L = Y
    return jnp.zeros_like(Y).at[:, rowperm].set(Y)


def make_fused_bond_update(fjax: Callable, dtype=jnp.float64):
    """Build the jitted fused bond-update for a jax-traceable integrand.

    fjax: int32 index vector -> scalar (traceable).
    Returns a function fused(Ic, Jc, m, n, maxrank, reltol, abstol,
    leftorthogonal) operating on padded index panels.
    """

    @functools.partial(jax.jit, static_argnames=("leftorthogonal",))
    def fused(Ic, Jc, m_true, n_true, maxrank, reltol, abstol,
              *, leftorthogonal: bool):
        mp = Ic.shape[0]
        npd = Jc.shape[0]
        rows = jnp.arange(mp)
        cols = jnp.arange(npd)
        rmax = min(mp, npd)
        ridx = jnp.arange(rmax)

        def one_row(ic):
            return jax.vmap(lambda jc: fjax(jnp.concatenate([ic, jc])))(Jc)

        if mp <= 128:
            Pi = jax.vmap(one_row)(Ic).astype(dtype)
        else:
            # chunk rows so index-assembly intermediates stay bounded
            Pi = jax.lax.map(one_row, Ic, batch_size=128).astype(dtype)
        valid = (rows[:, None] < m_true) & (cols[None, :] < n_true)
        Pi = jnp.where(valid, Pi, 0)
        maxsample = jnp.max(jnp.abs(Pi))

        A, rowperm, colperm, k, mags, err = _rrlu_state(
            Pi, m_true, n_true, maxrank, reltol, abstol, leftorthogonal
        )
        left, right = ci_factors(A, rowperm, colperm, k, leftorthogonal, dtype)
        return left, right, rowperm, colperm, k, mags, err, maxsample

    return fused


def make_fused_bond_update_pair(fjax_pair: Callable):
    """Pair-mode fused bond update for complex-free backends: fjax_pair
    returns a shape-(2,) real (re, im) array; all algebra runs on
    (re, im) f64 pairs (ops/complex_pair.py)."""
    from .complex_pair import ci_factors_pair, rrlu_state_pair

    @functools.partial(jax.jit, static_argnames=("leftorthogonal",))
    def fused(Ic, Jc, m_true, n_true, maxrank, reltol, abstol,
              *, leftorthogonal: bool):
        mp = Ic.shape[0]
        npd = Jc.shape[0]
        rows = jnp.arange(mp)
        cols = jnp.arange(npd)

        def one_row(ic):
            return jax.vmap(
                lambda jc: fjax_pair(jnp.concatenate([ic, jc]))
            )(Jc)  # (npd, 2)

        if mp <= 128:
            panel = jax.vmap(one_row)(Ic)
        else:
            panel = jax.lax.map(one_row, Ic, batch_size=128)
        valid = (rows[:, None] < m_true) & (cols[None, :] < n_true)
        Pr = jnp.where(valid, panel[..., 0].astype(jnp.float64), 0.0)
        Pi_ = jnp.where(valid, panel[..., 1].astype(jnp.float64), 0.0)
        maxsample = jnp.sqrt(jnp.max(Pr * Pr + Pi_ * Pi_))

        Ar, Ai, rowperm, colperm, k, mags, err = rrlu_state_pair(
            Pr, Pi_, m_true, n_true, maxrank, reltol, abstol, leftorthogonal
        )
        lr, li, rr, ri = ci_factors_pair(
            Ar, Ai, rowperm, colperm, k, leftorthogonal
        )
        return lr, li, rr, ri, rowperm, colperm, k, mags, err, maxsample

    return fused


def pad_index_panels(
    Ic: np.ndarray, Jc: np.ndarray, mI: int = None, mJ: int = None
) -> Tuple[np.ndarray, np.ndarray, int, int]:
    """Pad (nI, nl) / (nJ, nr) int panels to bucketed row counts (zero rows;
    the kernel masks them out of the Π panel). Explicit mI/mJ override the
    bucket (capacity mode)."""
    nI, nJ = Ic.shape[0], Jc.shape[0]
    mI = bucket(nI) if mI is None else mI
    mJ = bucket(nJ) if mJ is None else mJ
    if mI != nI:
        Ic = np.vstack([Ic, np.zeros((mI - nI, Ic.shape[1]), Ic.dtype)])
    if mJ != nJ:
        Jc = np.vstack([Jc, np.zeros((mJ - nJ, Jc.shape[1]), Jc.dtype)])
    return Ic, Jc, nI, nJ


def _pow2_at_least(n: int, floor: int = 128) -> int:
    """Monotone capacity quantum: bucket(n) (<= 25% overshoot, ~4 sizes per
    octave) with a floor. A plain next-power-of-two overshoots by up to 2x,
    and the elimination cost scales with the PADDED panel area, so a 2x pad
    on each axis costs ~4x on large panels."""
    return bucket(max(int(n), int(floor), 1))


def make_fused_site_tensor(fjax: Callable, dtype=jnp.float64):
    """Jitted site-tensor computation T = Π₁ · P^{-1} (tensorci2.jl:599-629):
    samples both panels and solves on-device, one program per shape bucket."""

    @jax.jit
    def fused(Is, Js, Ip, Jp, n_is, n_js, n_ip):
        # Π₁ panel: (|Is|, |Js|); P panel: (|Ip|, |Jp|) with |Jp| == |Js|
        def one_row(ic, J):
            return jax.vmap(lambda jc: fjax(jnp.concatenate([ic, jc])))(J)

        Pi1 = jax.vmap(lambda ic: one_row(ic, Js))(Is).astype(dtype)
        P = jax.vmap(lambda ic: one_row(ic, Jp))(Ip).astype(dtype)
        rowsP = jnp.arange(P.shape[0])
        colsP = jnp.arange(P.shape[1])
        maskP = (rowsP[:, None] < n_ip) & (colsP[None, :] < n_js)
        # pad P to identity outside the true block: the padded block passes
        # through the elimination untouched and the solves stay benign
        eye = jnp.eye(P.shape[0], P.shape[1], dtype=dtype)
        P = jnp.where(maskP, P, eye)
        maxsample = jnp.maximum(
            jnp.max(jnp.abs(jnp.where(
                (jnp.arange(Pi1.shape[0])[:, None] < n_is)
                & (jnp.arange(Pi1.shape[1])[None, :] < n_js),
                Pi1, 0,
            ))),
            jnp.max(jnp.abs(jnp.where(maskP, P, 0))),
        )
        T = panel_solve_pinv(Pi1, P, n_ip, dtype)
        return T, maxsample

    return fused


def make_fused_site_tensor_pair(fjax_pair: Callable):
    """Pair-mode site-tensor kernel: fjax_pair returns (re, im); the solve
    T = Π₁ P^{-1} runs on f64 pairs (ops/complex_pair.py)."""
    from .complex_pair import panel_solve_pinv_pair

    @jax.jit
    def fused(Is, Js, Ip, Jp, n_is, n_js, n_ip):
        def one_row(ic, J):
            return jax.vmap(
                lambda jc: fjax_pair(jnp.concatenate([ic, jc]))
            )(J)  # (|J|, 2)

        Pi1 = jax.vmap(lambda ic: one_row(ic, Js))(Is)
        P = jax.vmap(lambda ic: one_row(ic, Jp))(Ip)
        P1r = Pi1[..., 0].astype(jnp.float64)
        P1i = Pi1[..., 1].astype(jnp.float64)
        Pr = P[..., 0].astype(jnp.float64)
        Pi_ = P[..., 1].astype(jnp.float64)
        rowsP = jnp.arange(Pr.shape[0])
        colsP = jnp.arange(Pr.shape[1])
        maskP = (rowsP[:, None] < n_ip) & (colsP[None, :] < n_js)
        eye = jnp.eye(Pr.shape[0], Pr.shape[1])
        Pr = jnp.where(maskP, Pr, eye)
        Pi_ = jnp.where(maskP, Pi_, 0.0)
        mask1 = (
            (jnp.arange(P1r.shape[0])[:, None] < n_is)
            & (jnp.arange(P1r.shape[1])[None, :] < n_js)
        )
        P1r = jnp.where(mask1, P1r, 0.0)
        P1i = jnp.where(mask1, P1i, 0.0)
        maxsample = jnp.sqrt(
            jnp.maximum(
                jnp.max(P1r * P1r + P1i * P1i),
                jnp.max(jnp.where(maskP, Pr * Pr + Pi_ * Pi_, 0.0)),
            )
        )
        Tr, Ti = panel_solve_pinv_pair(P1r, P1i, Pr, Pi_, n_ip)
        return Tr, Ti, maxsample

    return fused


class FusedSiteTensors:
    """Host wrapper for the fused site-tensor kernel (see
    TensorCI2.setsitetensor_from_f)."""

    def __init__(self, fjax: Callable, dtype=np.float64, pair: bool = False,
                 capacity_mode: bool = False):
        self.pair = pair
        self.dtype = np.dtype(dtype)
        self.capacity_mode = capacity_mode
        self._row_cap = 0
        self._col_cap = 0
        if pair:
            self._fused = make_fused_site_tensor_pair(fjax)
        else:
            jdtype = jnp.dtype(np.dtype(dtype))  # width-preserving
            self._fused = make_fused_site_tensor(fjax, dtype=jdtype)
        self.nevals = 0

    def compute(self, Iset_b, localdim: int, Jset_b, Iset_b1):
        """Compute T_b given Iset[b], d_b, Jset[b], Iset[b+1]; returns the
        (|Iset[b]|, d_b, |Iset[b+1]|) tensor and the max |sample|."""
        Is = np.asarray(
            [tuple(i) + (s,) for i in Iset_b for s in range(localdim)],
            dtype=np.int32,
        ).reshape(len(Iset_b) * localdim, -1)
        Js = np.asarray([tuple(j) for j in Jset_b], dtype=np.int32).reshape(
            len(Jset_b), -1
        )
        Ip = np.asarray([tuple(i) for i in Iset_b1], dtype=np.int32).reshape(
            len(Iset_b1), -1
        )
        n_is, n_js, n_ip = Is.shape[0], Js.shape[0], Ip.shape[0]
        if n_ip != n_js:
            raise ValueError("Pivot matrix is not square!")
        if self.capacity_mode:
            self._row_cap = max(self._row_cap, _pow2_at_least(n_is))
            self._col_cap = max(self._col_cap, _pow2_at_least(n_js))
            mI, mJ = self._row_cap, self._col_cap
            mP = mJ  # keep the P panel square at the column capacity
        else:
            mI, mJ = bucket(n_is), bucket(n_js)
            mP = bucket(n_ip)
        if mI != n_is:
            Is = np.vstack([Is, np.zeros((mI - n_is, Is.shape[1]), np.int32)])
        if mJ != n_js:
            Js = np.vstack([Js, np.zeros((mJ - n_js, Js.shape[1]), np.int32)])
        if mP != n_ip:
            Ip = np.vstack([Ip, np.zeros((mP - n_ip, Ip.shape[1]), np.int32)])
        # n_ip == n_js, so the P panel pads to a square (mP == mJ) bucket
        self.nevals += Is.shape[0] * Js.shape[0] + Ip.shape[0] * Js.shape[0]
        out = self._fused(
            jnp.asarray(Is), jnp.asarray(Js), jnp.asarray(Ip),
            jnp.asarray(Js), jnp.int32(n_is), jnp.int32(n_js),
            jnp.int32(n_ip),
        )
        # slice to the true block ON DEVICE before fetching — the padded
        # buffer can be orders of magnitude larger than the valid region
        if self.pair:
            Tr_d, Ti_d, maxsample_d = out
            Tr, Ti, maxsample = jax.device_get(
                (Tr_d[:n_is, :n_ip], Ti_d[:n_is, :n_ip], maxsample_d)
            )
            T = (np.asarray(Tr) + 1j * np.asarray(Ti)).astype(self.dtype)
        else:
            T_d, maxsample_d = out
            T, maxsample = jax.device_get((T_d[:n_is, :n_ip], maxsample_d))
        T = np.asarray(T)
        return (
            T.reshape(len(Iset_b), localdim, len(Iset_b1)),
            float(maxsample),
        )


class FusedBondUpdater:
    """Host-side wrapper holding the compiled fused kernel for one integrand.

    Usage: attached to JaxBatchEvaluator; TensorCI2.updatepivots calls
    `update(Icombined, Jcombined, ...)` and receives numpy factors + pivot
    metadata, one device round trip per bond.
    """

    def __init__(self, fjax: Callable, dtype=np.float64, pair: bool = False,
                 capacity_mode: bool = False):
        self.pair = pair
        self.dtype = np.dtype(dtype)
        # capacity mode: panels pad to monotone power-of-two capacities shared
        # across bonds instead of per-size buckets — O(log maxrank) compiled
        # programs total instead of one per (mI, mJ) bucket pair. The masked
        # rrLU stops at the true rank, so results are identical; the extra
        # padded sampling is cheap on-device. Use for workloads with large
        # localdims x maxbonddim where per-bucket compiles dominate wall time
        # (e.g. GK-grid integration at d=15, rank 128).
        self.capacity_mode = capacity_mode
        self._row_cap = 0
        self._col_cap = 0
        if pair:
            self._fused = make_fused_bond_update_pair(fjax)
        else:
            jdtype = jnp.dtype(np.dtype(dtype))  # width-preserving
            self._fused = make_fused_bond_update(fjax, dtype=jdtype)
        self.nevals = 0

    def update(
        self,
        Icombined,
        Jcombined,
        reltol: float,
        abstol: float,
        maxrank: int,
        leftorthogonal: bool,
        need_factors: bool = True,
    ):
        """Run the fused bond update. Factors transfer as [:nI, :k] / [:k, :nJ]
        device slices (the padded (mI, mJ) buffers would cost ~mI*mJ*8 bytes
        per factor over the interconnect — at 2048² panels that is 33 MB each
        vs ~2 MB sliced). With need_factors=False (non-strict-nesting sweeps
        discard the factors, tensorci2.py updatepivots) no factor bytes move
        at all."""
        Ic = np.asarray([tuple(i) for i in Icombined], dtype=np.int32)
        Jc = np.asarray([tuple(j) for j in Jcombined], dtype=np.int32)
        if self.capacity_mode:
            self._row_cap = max(self._row_cap, _pow2_at_least(Ic.shape[0]))
            self._col_cap = max(self._col_cap, _pow2_at_least(Jc.shape[0]))
            Ic, Jc, nI, nJ = pad_index_panels(
                Ic, Jc, self._row_cap, self._col_cap
            )
        else:
            Ic, Jc, nI, nJ = pad_index_panels(Ic, Jc)
        self.nevals += Ic.shape[0] * Jc.shape[0]
        maxrank = min(maxrank, nI, nJ)
        out = self._fused(
            jnp.asarray(Ic),
            jnp.asarray(Jc),
            jnp.int32(nI),
            jnp.int32(nJ),
            jnp.int32(maxrank),
            jnp.float64(reltol),
            jnp.float64(abstol),
            leftorthogonal=leftorthogonal,
        )
        if self.pair:
            (lr_d, li_d, rr_d, ri_d, rowperm, colperm, k, mags, err,
             maxsample) = out
        else:
            left_d, right_d, rowperm, colperm, k, mags, err, maxsample = out
        rowperm, colperm, k, mags, err, maxsample = jax.device_get(
            (rowperm, colperm, k, mags, err, maxsample)
        )
        k = int(k)
        if need_factors:
            if self.pair:
                lr, li, rr, ri = jax.device_get(
                    (lr_d[:nI, :k], li_d[:nI, :k],
                     rr_d[:k, :nJ], ri_d[:k, :nJ])
                )
                left = (np.asarray(lr) + 1j * np.asarray(li)).astype(
                    self.dtype)
                right = (np.asarray(rr) + 1j * np.asarray(ri)).astype(
                    self.dtype)
            else:
                left, right = jax.device_get(
                    (left_d[:nI, :k], right_d[:k, :nJ])
                )
                left = np.asarray(left)
                right = np.asarray(right)
        else:
            left = right = None
        err_final = 0.0 if k >= min(nI, nJ) else float(err)
        return (
            left,
            right,
            np.asarray(rowperm)[:k],
            np.asarray(colperm)[:k],
            np.concatenate([np.abs(np.asarray(mags)[:k]), [err_final]]),
            err_final,
            float(maxsample),
        )


def make_panel_sampler(fjax: Callable, dtype=jnp.float64):
    """Jitted Π-panel sampler returning the masked panel ON DEVICE plus
    max|sample|. Feeds the device rook elimination (ops/lu_device): for a
    jax-traceable integrand, materializing the panel costs one device
    program, after which the rook slab iteration runs against device-resident
    data instead of paying one host round trip per sampled slab
    (tensorci2.jl:764-804's lazy SubMatrix, re-designed for a device)."""

    @jax.jit
    def sample(Ic, Jc, m_true, n_true):
        mp = Ic.shape[0]
        rows = jnp.arange(mp)
        cols = jnp.arange(Jc.shape[0])

        def one_row(ic):
            return jax.vmap(lambda jc: fjax(jnp.concatenate([ic, jc])))(Jc)

        if mp <= 128:
            Pi = jax.vmap(one_row)(Ic).astype(dtype)
        else:
            Pi = jax.lax.map(one_row, Ic, batch_size=128).astype(dtype)
        valid = (rows[:, None] < m_true) & (cols[None, :] < n_true)
        Pi = jnp.where(valid, Pi, 0)
        return Pi, jnp.max(jnp.abs(Pi))

    return sample


class PanelSampler:
    """Host wrapper for make_panel_sampler with monotone capacity padding
    (same compile-count rationale as FusedBondUpdater capacity mode)."""

    def __init__(self, fjax: Callable, dtype=np.float64):
        jdtype = jnp.dtype(np.dtype(dtype))  # width-preserving
        self._sample = make_panel_sampler(fjax, dtype=jdtype)
        self._row_cap = 0
        self._col_cap = 0
        self.nevals = 0

    def sample(self, Icombined, Jcombined):
        """Returns (device (nI, nJ) panel, float max|sample|)."""
        Ic = np.asarray([tuple(i) for i in Icombined], dtype=np.int32)
        Jc = np.asarray([tuple(j) for j in Jcombined], dtype=np.int32)
        self._row_cap = max(self._row_cap, _pow2_at_least(Ic.shape[0]))
        self._col_cap = max(self._col_cap, _pow2_at_least(Jc.shape[0]))
        Ic, Jc, nI, nJ = pad_index_panels(
            Ic, Jc, self._row_cap, self._col_cap
        )
        self.nevals += Ic.shape[0] * Jc.shape[0]
        Pi, maxsample = self._sample(
            jnp.asarray(Ic), jnp.asarray(Jc), jnp.int32(nI), jnp.int32(nJ)
        )
        return Pi[:nI, :nJ], float(maxsample)
