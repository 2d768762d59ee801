"""Device-resident adaptive (rook) rank-revealing LU.

The reference's ``arrlu`` (src/matrixlu.jl:492-569) avoids complete
pivoting's per-step full-matrix sweep by factorizing alternating row/column
slabs until the pivot sets are self-consistent. Complete pivoting is
bandwidth-bound (every pivot step must read+write the full trailing matrix
from device memory); the rook scheme touches only m×k / k×n slabs, so its
traffic is O(m·r²) instead of O(m·n·r) — the blocked, GEMM-friendly path
for large panels.

This module runs that control flow against a matrix that LIVES ON DEVICE:
slab gathers, the slab eliminations (lu_kernel's fused complete-pivot body)
and the final factor completion (triangular solves) all execute as jitted
XLA programs; the host only moves pivot index lists (a few hundred int32s
per rook iteration).

Semantics mirror arrlu exactly: same slab alternation, the same
self-consistency stopping rule, the same completion formulas
(cols2Lmatrix/rows2Umatrix, matrixlu.jl:627-674), and the slab LUs use the
same complete-pivot kernel (stop rule, first-max tie-break) as the exact
path.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..utils.util import pushrandomsubset
from .lu import rrLU, _finalize
from .lu_kernel import _rrlu_state, bucket

_INTMAX = 2**62


@functools.partial(jax.jit, static_argnames=("leftorthogonal", "rows_slab"))
def _slab_lu(A, idx, k_true, maxrank, reltol, abstol, *,
             leftorthogonal: bool, rows_slab: bool):
    """Complete-pivot LU of a row slab A[idx, :] (rows_slab) or column slab
    A[:, idx]. idx is padded to a bucketed length; padded slots are masked
    to zero, which the elimination kernel never selects."""
    valid = jnp.arange(idx.shape[0], dtype=jnp.int32) < k_true
    if rows_slab:
        slab = jnp.take(A, idx, axis=0)
        slab = jnp.where(valid[:, None], slab, 0)
        m_true, n_true = k_true, jnp.int32(A.shape[1])
    else:
        slab = jnp.take(A, idx, axis=1)
        slab = jnp.where(valid[None, :], slab, 0)
        m_true, n_true = jnp.int32(A.shape[0]), k_true
    maxrank = jnp.minimum(maxrank, jnp.minimum(m_true, n_true))
    return _rrlu_state(
        slab, m_true, n_true, maxrank, reltol, abstol, leftorthogonal
    )


@functools.partial(jax.jit, static_argnames=("transpose_solve",))
def _complete_factor(A, sel_idx, other_idx, block_inv, *,
                     transpose_solve: bool):
    """Missing-side completion (matrixlu.jl:627-674) on device.

    block_inv is the (host-inverted, k x k triangular) pivot-block inverse —
    the completion is then a single GEMM; a k x k host inversion takes
    microseconds.

    transpose_solve=False: U2 = L_block^{-1} · A[sel, other] (rows2Umatrix);
    True: L2 = A[other, sel] · U_block^{-1} (cols2Lmatrix)."""
    if transpose_solve:
        C = jnp.take(jnp.take(A, other_idx, axis=0), sel_idx, axis=1)
        return C @ block_inv
    R = jnp.take(jnp.take(A, sel_idx, axis=0), other_idx, axis=1)
    return block_inv @ R


def _pad_idx(idx, size: int) -> jnp.ndarray:
    out = np.zeros((size,), dtype=np.int32)
    out[: len(idx)] = idx
    return jnp.asarray(out)


def _fit_to(x, size: int):
    """Trace-time pad/trim of a 1-D array to a static length (panels
    narrower than the slab bucket Rb otherwise break the alternation's
    static shapes)."""
    if x.shape[0] == size:
        return x
    if x.shape[0] > size:
        return x[:size]
    return jnp.concatenate(
        [x, jnp.zeros((size - x.shape[0],), x.dtype)]
    )


class DeviceRRLU:
    """rrLU result whose factors stay on device (serving path: the factors
    feed downstream device ops; materializing them on the host would pay
    the full interconnect round trip). left()/right() return the permuted
    (natural-order) factors as jax arrays; to_rrlu() fetches to host."""

    def __init__(self, L_nat, U_nat, rowpermutation, colpermutation,
                 npivot: int, error: float, leftorthogonal: bool,
                 nslabs: Optional[int] = None):
        self.L_nat = L_nat  # (m, k) device, natural row order
        self.U_nat = U_nat  # (k, n) device, natural column order
        self.rowpermutation = np.asarray(rowpermutation, dtype=np.int64)
        self.colpermutation = np.asarray(colpermutation, dtype=np.int64)
        self.npivot = int(npivot)
        self.error = float(error)
        self.leftorthogonal = bool(leftorthogonal)
        # diagnostic: number of slab eliminations the rook alternation ran
        # (fused paths only; None for the host-driven loop)
        self.nslabs = None if nslabs is None else int(nslabs)

    def npivots(self) -> int:
        return self.npivot

    def left(self):
        return self.L_nat

    def right(self):
        return self.U_nat

    def rowindices(self) -> np.ndarray:
        return self.rowpermutation[: self.npivot]

    def colindices(self) -> np.ndarray:
        return self.colpermutation[: self.npivot]

    def to_rrlu(self) -> rrLU:
        """Fetch the factors and rebuild the host rrLU (pivot-order L/U)."""
        L = np.asarray(self.L_nat)[self.rowpermutation, :]
        U = np.asarray(self.U_nat)[:, self.colpermutation]
        return rrLU(
            self.rowpermutation, self.colpermutation, L, U,
            self.leftorthogonal, self.npivot, self.error,
        )


@functools.partial(jax.jit, static_argnames=("k", "unit_lower"))
def _assemble_rows_branch(A, LUp, piv_rows, j2, inv_rowperm, inv_colperm,
                          Linv, k: int, unit_lower: bool):
    """Branch 'slab spanned all rows': L = slab L (m x k), U completed over
    the remaining columns by one GEMM. Returns natural-order factors."""
    m = A.shape[0]
    L = jnp.tril(LUp[:m, :k])
    if unit_lower:
        L = jnp.where(
            jnp.arange(m)[:, None] == jnp.arange(k)[None, :], 1.0, L
        )
    Ublk = jnp.triu(LUp[:k, :k])
    if not unit_lower:
        Ublk = jnp.where(
            jnp.arange(k)[:, None] == jnp.arange(k)[None, :], 1.0, Ublk
        )
    R = jnp.take(jnp.take(A, piv_rows, axis=0), j2, axis=1)
    U = jnp.concatenate([Ublk, Linv @ R], axis=1)
    return L[inv_rowperm, :], U[:, inv_colperm]


@functools.partial(jax.jit, static_argnames=("k", "unit_lower"))
def _assemble_cols_branch(A, LUp, piv_cols, i2, inv_rowperm, inv_colperm,
                          Uinv, k: int, unit_lower: bool):
    """Branch 'slab spanned all columns': U = slab U (k x n), L completed
    over the remaining rows by one GEMM."""
    n = A.shape[1]
    U = jnp.triu(LUp[:k, :n])
    if not unit_lower:
        U = jnp.where(
            jnp.arange(k)[:, None] == jnp.arange(n)[None, :], 1.0, U
        )
    Lblk = jnp.tril(LUp[:k, :k])
    if unit_lower:
        Lblk = jnp.where(
            jnp.arange(k)[:, None] == jnp.arange(k)[None, :], 1.0, Lblk
        )
    C = jnp.take(jnp.take(A, i2, axis=0), piv_cols, axis=1)
    L = jnp.concatenate([Lblk, C @ Uinv], axis=0)
    return L[inv_rowperm, :], U[:, inv_colperm]


def _assemble_mixed_body(A, Ipad, Jpad, k, reltol, abstol, *,
                         unit_lower: bool, maxrank=None):
    """Completion of the rook factors in f64 from the PIVOT SETS alone.

    The mixed-precision rook (see rrlu_rook_device_fused(precision=
    "mixed")) hunts pivots in f32 — pivot selection is a decision process,
    not an accuracy-critical computation — and this program rebuilds full
    f64 factors from the chosen pivot rows I and columns J without ever
    running an f64 elimination over the big matrix:

      B = A[I, J]            (k x k pivot block, gathered in f64)
      PBQ = Lblk · Ublk      (COMPLETE-PIVOT f64 elimination of the block —
                              the f32 hunt fixes the pivot SETS, but its
                              ORDER is noise below f32 resolution, and a
                              fixed-order elimination in a noisy order has
                              unbounded growth: measured 1e-5 relative
                              recon on 10-decade spectra vs 1e-14 with the
                              re-pivoted block. Re-pivoting inside the
                              sampled block is exactly what the reference's
                              final slab elimination does, matrixlu.jl:566)
      Linv = Lblk⁻¹, Uinv = Ublk⁻¹   (triangular SUBSTITUTION, one fori
                              pass running both recurrences — an explicit
                              Gauss-Jordan inverse of B re-introduces the
                              growth that the pivoting removed: measured
                              catastrophic (O(1) relative error) at block
                              condition 1e18 where substitution holds 1e-14)
      L = A[:, J·Q] · Ublk⁻¹   (one GEMM; cols2Lmatrix)
      U = Lblk⁻¹ · A[I·P, :]   (one GEMM; rows2Umatrix)

    (matrixlu.jl:627-674 evaluated through the triangular inverses). The
    sequential parts touch only k² data; all O(m·k)/O(k·n) work is GEMM
    GEMMs. On pivot rows/columns the GEMM reproduces the triangular blocks
    up to f64 rounding; the blocks are scattered in exactly so the factor
    triangularity is bit-clean.

    Rank detection = the reference stop rule (matrixlu.jl:363) applied to
    the f64 complete-pivot magnitudes of the block, so f32 noise pivots
    past the true rank are rejected with full f64 resolution.

    Ipad/Jpad are the pivot ids padded to the slab width Rb; padded slots
    (>= k) are masked out of every gather/scatter (scatter indices are
    pushed out of bounds, which XLA drops). Returns natural-order L (m, Rb)
    and U (Rb, n) whose rows/columns beyond keff are zero, PLUS the
    re-pivoted id arrays (Ire, Jre) — the first keff entries are the
    accepted pivots in elimination order; callers must use these, not the
    input order.

    maxrank (optional, traced): hard cap on the accepted rank keff — the
    multi-stage deflated hunt supplies MORE candidate pivots than the
    requested rank (stage candidates are concatenated) and lets this f64
    walk pick the first `maxrank` that survive the stop rule.
    """
    from .lu_kernel import _rrlu_state

    m, n = A.shape
    Rb = Ipad.shape[0]
    dt = A.dtype
    idx = jnp.arange(Rb, dtype=jnp.int32)
    valid0 = idx < k
    Ig = jnp.where(valid0, Ipad, 0)
    Jg = jnp.where(valid0, Jpad, 0)

    eye = jnp.eye(Rb, dtype=dt)
    B0 = jnp.take(jnp.take(A, Ig, axis=0), Jg, axis=1)
    B0 = jnp.where(valid0[:, None] & valid0[None, :], B0, 0.0)

    mr = k if maxrank is None else jnp.minimum(k, maxrank)
    LUp, rp, cp, keff, _, rejerr = _rrlu_state(
        B0, k, k, mr, reltol, abstol, unit_lower
    )
    # pivot ids in elimination (complete-pivot) order
    Ire = jnp.take(Ig, rp[:Rb].astype(jnp.int32))
    Jre = jnp.take(Jg, cp[:Rb].astype(jnp.int32))
    valid = idx < keff
    v2 = valid[:, None] & valid[None, :]

    # triangular factors of the re-pivoted block; dead region = identity so
    # the substitution recurrences are exact no-ops there
    Lb = jnp.tril(LUp[:Rb, :Rb])
    Ub = jnp.triu(LUp[:Rb, :Rb])
    dia = (idx[:, None] == idx[None, :]).astype(dt)
    if unit_lower:
        Lb = Lb * (1 - dia) + dia
    else:
        Ub = Ub * (1 - dia) + dia
    Lb = jnp.where(v2, Lb, eye)
    Ub = jnp.where(v2, Ub, eye)

    # Both triangular inverses by BLOCKED substitution: row-by-row
    # substitution is Rb sequential matvec steps of pure loop latency,
    # so instead
    #   1. the G = Rb/b diagonal b×b blocks are inverted by substitution
    #      with all blocks batched into one b-step fori (both triangles
    #      share the loop: L rows forward, U rows backward), and
    #   2. the off-diagonal part folds in by Neumann doubling: T = D(I+N)
    #      with N = D⁻¹(T − D) strictly block-triangular (nilpotent,
    #      N^G = 0), so T⁻¹ = (Σ_{q<G} (−N)^q)·D⁻¹, and the polynomial
    #      is built exactly in ceil(log2 G) squarings — a handful of
    #      Rb³ GEMMs instead of Rb−b more sequential steps.
    # Numerically this is blocked back-substitution (each doubling GEMM
    # combines already-stable partial inverses); measured identical to
    # full substitution down to 21-decade spectra.
    b = 32 if Rb % 32 == 0 else (16 if Rb % 16 == 0 else 8)
    G = Rb // b
    gi = jnp.arange(G)
    bmask = (idx[:, None] // b) == (idx[None, :] // b)
    Lb4 = Lb.reshape(G, b, G, b)
    Ub4 = Ub.reshape(G, b, G, b)
    Ld = Lb4[gi, :, gi, :]      # (G, b, b) diagonal blocks
    Ud = Ub4[gi, :, gi, :]
    eb = jnp.eye(b, dtype=dt)
    ib = jnp.arange(b)

    def dinv_body(t, carry):
        Xl, Xu = carry
        rl = jnp.einsum(
            "gj,gjk->gk", Ld[:, t, :] * (ib < t).astype(dt), Xl)
        Xl = Xl.at[:, t, :].set((eb[t] - rl) / Ld[:, t, t][:, None])
        ju = b - 1 - t
        ru = jnp.einsum(
            "gj,gjk->gk", Ud[:, ju, :] * (ib > ju).astype(dt), Xu)
        Xu = Xu.at[:, ju, :].set((eb[ju] - ru) / Ud[:, ju, ju][:, None])
        return Xl, Xu

    Dli, Dui = jax.lax.fori_loop(
        0, b, dinv_body,
        (jnp.zeros((G, b, b), dt), jnp.zeros((G, b, b), dt)),
    )
    DLinv = jnp.zeros((Rb, Rb), dt).reshape(G, b, G, b).at[
        gi, :, gi, :].set(Dli).reshape(Rb, Rb)
    DUinv = jnp.zeros((Rb, Rb), dt).reshape(G, b, G, b).at[
        gi, :, gi, :].set(Dui).reshape(Rb, Rb)

    def _neumann_inv(T, Dinv):
        N = Dinv @ jnp.where(bmask, 0.0, T)
        X = -N
        P = eye + X             # covers (−N)^0..1
        rounds = max(0, (G - 1).bit_length() - 1)  # 2^(r+1) ≥ G
        for _ in range(rounds):
            X = X @ X
            P = P + P @ X
        return P @ Dinv

    Linv = _neumann_inv(Lb, DLinv) if G > 1 else DLinv
    Uinv = _neumann_inv(Ub, DUinv) if G > 1 else DUinv
    Linv = jnp.where(v2, Linv, 0)
    Uinv = jnp.where(v2, Uinv, 0)
    Lblk = jnp.where(v2, Lb, 0)
    Ublk = jnp.where(v2, Ub, 0)

    IgR = jnp.where(valid, Ire, 0)
    JgR = jnp.where(valid, Jre, 0)
    L_all = jnp.take(A, JgR, axis=1) * valid[None, :].astype(dt)
    L_nat = L_all @ Uinv        # (m, Rb): A[:, J] · Ublk^{-1}
    U_all = jnp.take(A, IgR, axis=0) * valid[:, None].astype(dt)
    U_nat = Linv @ U_all        # (Rb, n): Lblk^{-1} · A[I, :]

    # Scatter the exact triangular blocks into the pivot rows/columns
    # (the GEMM reproduces them only up to rounding). Padded slots point
    # out of bounds, which XLA scatter drops.
    Iscat = jnp.where(valid, Ire, m)
    Jscat = jnp.where(valid, Jre, n)
    L_nat = L_nat.at[Iscat, :].set(Lblk)
    U_nat = U_nat.at[:, Jscat].set(Ublk)
    # zero out the invalid factor columns/rows so L @ U is rank-keff exactly
    L_nat = L_nat * valid[None, :].astype(dt)
    U_nat = U_nat * valid[:, None].astype(dt)
    return L_nat, U_nat, keff, rejerr, Ire, Jre


_assemble_mixed = jax.jit(
    _assemble_mixed_body, static_argnames=("unit_lower",)
)


def _make_rook_alternation(M: int, N: int, Rb: int, numrookiter: int,
                           leftorthogonal: bool):
    """Build the ONE-DISPATCH rook alternation program for a device-resident
    (M, N) matrix with slab width Rb (bucketed maxrank).

    The host-driven rook loop (rrlu_rook_device) pays a dispatch + a pivot
    -list round trip per slab. Here the alternation, self-consistency stop
    and the final row-slab elimination are all traced into a single XLA
    program, the
    same collapse the whole-sweep rook applies to TCI panels
    (models/device_sweep._rook_alternate). The start set is pre-widened to
    the full slab width, so the reference's outer widen-and-retry loop
    (matrixlu.jl:512-548) collapses into this single round.
    """
    from .lu_kernel import _rrlu_state_fused

    def slab_rows(A, I0, I0len, maxrank, reltol, abstol):
        """Eliminate A[I0, :] (slab spans all columns)."""
        valid = jnp.arange(Rb, dtype=jnp.int32) < I0len
        slab = jnp.where(valid[:, None], jnp.take(A, I0, axis=0), 0.0)
        mr = jnp.minimum(maxrank, jnp.minimum(I0len, jnp.int32(N)))
        LUp, rp, cp, k, mags, err = _rrlu_state_fused(
            slab, I0len, jnp.int32(N), mr, reltol, abstol, leftorthogonal
        )
        newI = jnp.where(valid, jnp.take(I0, _fit_to(rp, Rb)), 0)
        newJ = jnp.where(valid, _fit_to(cp, Rb), 0)
        smin = jnp.minimum(I0len, jnp.int32(N))
        return newI, k, newJ, k, k, err, smin, LUp, rp, cp

    def slab_cols(A, J0, J0len, maxrank, reltol, abstol):
        """Eliminate A[:, J0] (slab spans all rows)."""
        valid = jnp.arange(Rb, dtype=jnp.int32) < J0len
        slab = jnp.where(valid[None, :], jnp.take(A, J0, axis=1), 0.0)
        mr = jnp.minimum(maxrank, jnp.minimum(jnp.int32(M), J0len))
        LUp, rp, cp, k, mags, err = _rrlu_state_fused(
            slab, jnp.int32(M), J0len, mr, reltol, abstol, leftorthogonal
        )
        newI = jnp.where(valid, _fit_to(rp, Rb), 0)
        newJ = jnp.where(valid, jnp.take(J0, _fit_to(cp, Rb)), 0)
        smin = jnp.minimum(jnp.int32(M), J0len)
        return newI, k, newJ, k, k, err, smin

    def alternation(A, I0, I0len, J0, J0len, maxrank, reltol, abstol):
        idx = jnp.arange(Rb, dtype=jnp.int32)

        def body(st):
            (I0_, I0len_, J0_, J0len_, k_, err_, errw_, smin_, it_,
             done_, LUp_c, rp_c, cp_c, rowok_) = st
            rookiter = it_ + 1
            # matrixlu.jl rook alternation: for leftorthogonal the first
            # move factorizes the column slab A[:, J0]
            colmove = ((rookiter % 2) == 0) == leftorthogonal

            def do_rows(_):
                nI, nIl, nJ, nJl, k2, e2, sm, LUp, rp, cp = slab_rows(
                    A, I0_, I0len_, maxrank, reltol, abstol
                )
                return nI, nIl, nJ, nJl, k2, e2, sm, LUp, rp, cp, True

            def do_cols(_):
                nI, nIl, nJ, nJl, k2, e2, sm = slab_cols(
                    A, J0_, J0len_, maxrank, reltol, abstol
                )
                return (nI, nIl, nJ, nJl, k2, e2, sm, LUp_c, rp_c, cp_c,
                        False)

            (nI, nIl, nJ, nJl, k2, e2, sm, LUp2, rp2, cp2, isrow) = (
                jax.lax.cond(colmove, do_rows, do_cols, None)
            )
            errw2 = jnp.where(k2 < sm, e2, errw_)
            sameI = (nIl == I0len_) & jnp.all((idx >= nIl) | (nI == I0_))
            sameJ = (nJl == J0len_) & jnp.all((idx >= nJl) | (nJ == J0_))
            done2 = sameI & sameJ
            # whenever the LAST executed move was a row move, its factors
            # ARE the LU of A[I_input, :] and its outputs (newI, cp) are the
            # final pivot sets — re-eliminating the same row set after the
            # loop would redo identical work (complete pivoting re-picks
            # the same pivots), so the epilogue reuses these factors
            # unconditionally (one full streamed slab pass saved whenever
            # the alternation ends on a row move, consistent or not)
            return (nI, nIl, nJ, nJl, k2, e2, errw2, sm, it_ + 1,
                    done2, LUp2, rp2, cp2, isrow)

        st0 = (
            I0, I0len, J0, J0len, jnp.int32(0), jnp.float64(jnp.nan),
            jnp.float64(jnp.nan), jnp.int32(0), jnp.int32(0), False,
            jnp.zeros((Rb, N), A.dtype), jnp.zeros((Rb,), jnp.int32),
            jnp.zeros((N,), jnp.int32), False,
        )
        (I0f, I0flen, J0f, J0flen, kc, errc, errw, sminc, iters, _,
         LUp_c, rp_c, cp_c, rowok) = (
            jax.lax.while_loop(lambda st: (~st[9]) & (st[8] < numrookiter),
                               body, st0)
        )

        # Final ROW slab elimination on the final row set: provides the
        # factors for the "slab spans all columns" assembly
        # (_assemble_cols_branch) in one pass. Whenever the alternation
        # ENDED on a row move, that move's factors/outputs already are
        # exactly this elimination — reuse them instead of re-eliminating
        # (one full streamed pass saved per factorization); only a
        # col-move ending needs the extra row pass.
        def reuse(_):
            return (I0f, I0flen, J0f, J0flen, kc, errc, sminc,
                    LUp_c, rp_c, cp_c)

        def rerun(_):
            return slab_rows(A, I0f, I0flen, maxrank, reltol, abstol)

        newI, _, newJ, _, kf, ef, sminf, LUp, rp, cp = jax.lax.cond(
            rowok, reuse, rerun, None
        )
        errw = jnp.where(kf < sminf, ef, errw)
        err_final = jnp.where(
            jnp.isnan(errw), jnp.where(kf >= sminf, 0.0, ef), errw
        )
        # total slab eliminations = iters + (0 if reused else 1)
        nslabs = iters + jnp.where(rowok, 0, 1).astype(jnp.int32)
        return LUp, rp, cp, kf, err_final, newI, newJ, nslabs

    return alternation


def _make_rook_fused(M: int, N: int, Rb: int, numrookiter: int,
                     leftorthogonal: bool):
    """One-dispatch plain-precision rook. Host arguments arrive PACKED in
    two arrays (ipack int32: [I0len, J0len, maxrank] ++ I0 ++ J0; tpack
    f64: [reltol, abstol]) — each separate argument of a jitted call is
    its own host->device transfer."""
    alt = _make_rook_alternation(M, N, Rb, numrookiter, leftorthogonal)

    @jax.jit
    def run(A, ipack, tpack):
        I0 = ipack[3:3 + Rb]
        J0 = ipack[3 + Rb:3 + 2 * Rb]
        return alt(A, I0, ipack[0], J0, ipack[1], ipack[2],
                   tpack[0], tpack[1])

    return run


def _make_rook_fused_mixed(M: int, N: int, Rb: int, numrookiter: int,
                           leftorthogonal: bool, hunt_stages: int = 1):
    """Whole mixed-precision rook — f32 alternation + f64 completion — as
    ONE XLA program, with the host-bound results packed into two buffers
    (one int32, one f64) so the epilogue costs exactly two device→host
    transfers. Splitting the elimination and the assembly into separate
    dispatches would cost ~5 small fetches/uploads in between.

    hunt_stages > 1 adds DEFLATED hunt rounds for extreme spectra: after
    each round the accepted pivots are completed in f64, the f64 residual
    A − L·U is rescaled to O(1) and re-hunted in f32 at the residual's OWN
    scale — each stage buys the f32 hunt a fresh dynamic-range window
    while every slab elimination stays f32 (the decision process).
    Measured, a single hunt's pivot SETS already hold the f64 floor down
    to 14-decade spectra (see _assemble_mixed_body), so stages > 1 are
    insurance for deeper/adversarial inputs. Residual rows/columns
    already covered by chosen pivots are masked to exact zero so a later
    stage can never re-pick them (they are rounding-level anyway; a
    duplicate pivot would make the combined block singular). The FINAL f64
    completion walks the concatenated candidate pivots (stage order =
    descending scale) under the caller's reltol/abstol and the maxrank
    cap, so rank detection semantics stay the reference stop rule
    (matrixlu.jl:363) applied to f64 pivot magnitudes."""
    alt = _make_rook_alternation(M, N, Rb, numrookiter, leftorthogonal)
    C = Rb * hunt_stages  # combined candidate-pivot capacity

    @jax.jit
    def run(A64, ipack, tpack):
        I0 = ipack[3:3 + Rb]
        J0 = ipack[3 + Rb:3 + 2 * Rb]
        I0len, J0len, maxrank = ipack[0], ipack[1], ipack[2]
        reltol, abstol = tpack[0], tpack[1]
        # Dynamic-range guard: a legal f64 input may live entirely outside
        # f32 range (|x| > ~3.4e38 becomes inf and poisons reltol*maxerror;
        # |x| < ~1e-38 flushes to 0 and the hunt finds nothing), and even
        # the f64 completion walk squares pivot magnitudes (reference abs2
        # pivoting), which under/overflows past ~1e±154. Normalize the
        # WHOLE program by a power-of-two scale — exact in f64, so in the
        # ordinary range every pivot decision is bit-identical to the
        # unscaled computation — run with abstol in the rescaled units
        # (reltol is scale-invariant), and scale the non-unit factor and
        # the error estimates back at the end.
        # The rounded exponent is clamped to the normal-f64 range: for
        # max|x| just above 2^1023.5, round(log2) = 1024 and exp2(1024)
        # would be inf (A64/scale0 -> 0, U * scale0 -> NaN); clamping to
        # 1023 keeps A64/scale0 in [~1, 2) instead — still in range.
        smax0 = jnp.max(jnp.abs(A64))
        scale0 = jnp.where(
            smax0 > 0, jnp.exp2(jnp.clip(jnp.round(jnp.log2(
                jnp.where(smax0 > 0, smax0, 1.0))), -1022.0, 1023.0)), 1.0
        )
        A64 = A64 / scale0
        abstol = abstol / scale0
        LUp, rp, cp, kf, err, newI, newJ, nslabs = alt(
            A64.astype(jnp.float32), I0, I0len, J0, J0len,
            maxrank, reltol, abstol,
        )
        err = err.astype(jnp.float64)  # rescaled units until the pack

        def _unscale(L_nat, U_nat):
            # the unit-diagonal factor is scale-invariant; the other one
            # carries the magnitudes and absorbs scale0
            if leftorthogonal:
                return L_nat, U_nat * scale0
            return L_nat * scale0, U_nat

        if hunt_stages == 1:
            L_nat, U_nat, keff, rejerr, Ire, Jre = _assemble_mixed_body(
                A64, newI.astype(jnp.int32),
                _fit_to(cp, Rb).astype(jnp.int32), kf,
                reltol, abstol, unit_lower=leftorthogonal,
            )
            L_nat, U_nat = _unscale(L_nat, U_nat)
            # ONE packed f64 buffer (indices are exact in f64 far beyond
            # any real m/n): scalars ++ pivot row ids ++ pivot col ids (in
            # the f64 completion's elimination order — the host completes
            # both permutations from the id lists). The epilogue then costs
            # exactly one device→host transfer.
            pack = jnp.concatenate([
                jnp.stack([
                    keff.astype(jnp.float64),
                    rejerr.astype(jnp.float64) * scale0,
                    kf.astype(jnp.float64),
                    err.astype(jnp.float64) * scale0,
                    nslabs.astype(jnp.float64),
                ]),
                Ire.astype(jnp.float64),
                Jre.astype(jnp.float64),
            ])
            return L_nat, U_nat, pack

        jj = jnp.arange(C, dtype=jnp.int32)
        Icomb = jnp.zeros((C,), jnp.int32).at[:Rb].set(
            newI.astype(jnp.int32))
        Jcomb = jnp.zeros((C,), jnp.int32).at[:Rb].set(
            _fit_to(cp, Rb).astype(jnp.int32))
        kcomb = kf
        errfin = err.astype(jnp.float64)
        for s in range(1, hunt_stages):
            # complete the so-far-trusted pivots in f64, then deflate. The
            # f64 complete-pivot walk inside the completion truncates f32
            # noise candidates under the caller's stop rule, so the
            # residual is computed from accepted pivots only.
            L1, U1, keff1, _, Icomb, Jcomb = _assemble_mixed_body(
                A64, Icomb, Jcomb, kcomb, reltol, abstol,
                unit_lower=leftorthogonal, maxrank=maxrank,
            )
            Rres = A64 - L1 @ U1
            vmask = jj < keff1
            rowmask = jnp.ones((M,), A64.dtype).at[
                jnp.where(vmask, Icomb, M)].set(0.0, mode="drop")
            colmask = jnp.ones((N,), A64.dtype).at[
                jnp.where(vmask, Jcomb, N)].set(0.0, mode="drop")
            Rres = Rres * rowmask[:, None] * colmask[None, :]
            smax = jnp.max(jnp.abs(Rres))
            scale = jnp.where(smax > 0, smax, 1.0)
            R32 = (Rres / scale).astype(jnp.float32)
            I0s = ipack[3 + 2 * s * Rb:3 + (2 * s + 1) * Rb]
            J0s = ipack[3 + (2 * s + 1) * Rb:3 + (2 * s + 2) * Rb]
            _, _, cp2, kf2, err2, newI2, _, nslabs2 = alt(
                R32, I0s, I0len, J0s, J0len, maxrank,
                reltol, abstol / scale,
            )
            # compact-append the stage candidates right after the keff1
            # trusted pivots (padded gathers; shapes stay static)
            i2e = jnp.zeros((C,), jnp.int32).at[:Rb].set(
                newI2.astype(jnp.int32))
            j2e = jnp.zeros((C,), jnp.int32).at[:Rb].set(
                _fit_to(cp2, Rb).astype(jnp.int32))
            tail = jnp.clip(jj - keff1, 0, C - 1)
            Icomb = jnp.where(jj < keff1, Icomb, jnp.take(i2e, tail))
            Jcomb = jnp.where(jj < keff1, Jcomb, jnp.take(j2e, tail))
            kcomb = jnp.minimum(keff1 + kf2, jnp.int32(C))
            nslabs = nslabs + nslabs2
            errfin = err2.astype(jnp.float64) * scale
        L_nat, U_nat, keff, rejerr, Ire, Jre = _assemble_mixed_body(
            A64, Icomb, Jcomb, kcomb, reltol, abstol,
            unit_lower=leftorthogonal, maxrank=maxrank,
        )
        L_nat, U_nat = _unscale(L_nat, U_nat)
        # multi-stage pack: scalars ++ pivot row ids ++ pivot col ids (the
        # host completes both permutations from the id lists)
        pack = jnp.concatenate([
            jnp.stack([
                keff.astype(jnp.float64),
                rejerr.astype(jnp.float64) * scale0,
                kcomb.astype(jnp.float64),
                errfin * scale0,
                nslabs.astype(jnp.float64),
            ]),
            Ire.astype(jnp.float64),
            Jre.astype(jnp.float64),
        ])
        return L_nat, U_nat, pack

    return run


class _PendingRRLU:
    """Deferred handle from ``rrlu_rook_device_fused(defer=True)``.

    The factorization program is already dispatched (JAX async); the host
    epilogue (single fetch + index bookkeeping) runs on the first
    ``result()`` call. Issue several handles, then collect — the device
    pipelines the programs and the fetches overlap device work."""

    def __init__(self, finish):
        self._finish = finish
        self._result: Optional[DeviceRRLU] = None

    def result(self) -> DeviceRRLU:
        if self._result is None:
            self._result = self._finish()
            self._finish = None
        return self._result


_rook_fused_cache: dict = {}


def rrlu_rook_device_fused(
    A,
    maxrank: int,
    reltol: float = 1e-14,
    abstol: float = 0.0,
    leftorthogonal: bool = True,
    numrookiter: int = 5,
    rng: Optional[np.random.Generator] = None,
    precision: str = "f64",
    defer: bool = False,
    hunt_stages: int = 1,
    I0=(),
    J0=(),
):
    """One-dispatch adaptive rook rrLU of a device-resident matrix.

    Same slab alternation and self-consistency stop as ``rrlu_rook_device``
    but with the entire rook loop traced into one XLA program — the
    production path for large panels (no host round trip per slab).

    The start set is the full slab width (maxrank distinct columns for
    leftorthogonal, rows otherwise — caller-provided I0/J0 pivot
    continuations first, random fills after), which collapses the
    reference's outer widen-and-retry loop (matrixlu.jl:512-548) into a
    single round — the same design as the whole-sweep rook
    (models/device_sweep). NOTE maxrank is therefore also the slab width:
    callers with an effectively unbounded rank cap should pick a start
    width near the expected rank and re-call wider on k == maxrank
    (rank-capped), as tensorci2.updatepivots does.
    Factors stay on device (DeviceRRLU); only the k×k pivot block and the
    index lists cross to the host for the triangular inversion + assembly.

    precision="mixed" (f64 inputs only): the slab eliminations — the
    sequential, elementwise part — run on an f32 copy of the matrix,
    selecting the SAME kind of rook pivot sets, and the f64 factors are
    then rebuilt from those pivot sets alone by ``_assemble_mixed``
    (fixed-order block LU + Gauss-Jordan over the k² pivot block, two GEMMs
    for the completion). The f32 hunt has no matrix
    product (rank-1 elementwise updates only), so a GPU's TF32 mode never
    touches it. Rank detection comes from the f64 complete-pivot walk
    over the chosen pivot block inside the completion
    (_assemble_mixed_body), so it holds f64 resolution; the ``error``
    estimate is the f64 walk's first-rejected-pivot magnitude whenever the
    walk rejects a candidate, and otherwise (every candidate accepted,
    keff == kf) falls back to the f32 hunt's estimate, which carries only
    ~1e-7 relative resolution — in that case the factorization is
    rank-complete up to the hunt's view and the estimate is a loose upper
    bound, not an f64-sharp residual. The f32 hunt's own stop rule
    saturating at ~1e-7 relative only means the hunt may carry extra
    candidates for the f64 walk to reject.
    Reconstruction matches the f64 path on every tested spectrum
    down to 14 decades (see
    tests/test_lu_device.py::test_rook_fused_nri2_serving_quality).

    hunt_stages (mixed only, default 1): number of deflated hunt rounds.
    Each extra round completes the accepted pivots in f64, rescales the
    f64 residual A − L·U to O(1) and re-hunts it in f32 at the residual's
    own scale, giving the f32 hunt a fresh dynamic-range window per stage
    while keeping every slab elimination f32. Insurance for spectra
    deeper than one hunt can see, at roughly 2x the single-stage cost
    (one extra m×n residual GEMM + one extra alternation + a 2Rb-wide
    final completion), still as ONE dispatch.

    defer=True returns a ``_PendingRRLU`` handle instead of a finished
    ``DeviceRRLU``: the whole program is DISPATCHED (JAX async) but no
    device→host fetch happens until ``.result()``. Issuing several
    independent factorizations deferred and then collecting the results
    pipelines the device work with the host fetches — the serving pattern
    for many-panel workloads.
    """
    if rng is None:
        rng = np.random.default_rng()
    A = jnp.asarray(A)
    m, n = A.shape
    maxrank = int(min(maxrank, m, n))
    Rb = bucket(maxrank)
    if precision not in ("f64", "mixed"):
        raise ValueError(
            f"precision must be 'f64' or 'mixed', got {precision!r}"
        )
    if precision == "mixed" and jnp.iscomplexobj(A):
        raise ValueError(
            "precision='mixed' requires a real float64 matrix (complex "
            "inputs run the pair path at full precision; f32 inputs pass "
            "through the plain-precision path)"
        )
    mixed = precision == "mixed" and A.dtype == jnp.float64
    hunt_stages = int(hunt_stages)
    if hunt_stages < 1:
        raise ValueError("hunt_stages must be >= 1")
    if hunt_stages > 1 and not mixed:
        raise ValueError(
            "hunt_stages > 1 is the deflated f32 hunt — it requires "
            "precision='mixed' on an f64 matrix (the f64 path hunts at "
            "full precision already)"
        )
    key = (m, n, Rb, numrookiter, leftorthogonal, mixed, str(A.dtype),
           hunt_stages)
    if key not in _rook_fused_cache:
        if mixed:
            _rook_fused_cache[key] = _make_rook_fused_mixed(
                m, n, Rb, numrookiter, leftorthogonal, hunt_stages
            )
        else:
            _rook_fused_cache[key] = _make_rook_fused(
                m, n, Rb, numrookiter, leftorthogonal
            )
    run = _rook_fused_cache[key]

    # ONE packed int32 upload ([I0len, J0len, maxrank] ++ I0 ++ J0, plus a
    # fresh random start-set pair per extra deflated hunt stage) and one
    # f64 upload ([reltol, abstol]) instead of one host→device transfer per
    # jitted-call argument.
    #
    # Warm starts: caller-provided J0 (leftorthogonal) / I0 (otherwise) —
    # pivot continuation from a previous factorization, the reference's
    # arrlu I0/J0 arguments (matrixlu.jl:492) — seed the first widened
    # start set; the remaining slots are filled with random distinct
    # indices up to the full slab width. (For leftorthogonal the first
    # rook move eliminates the column slab A[:, J0], which replaces I0
    # wholesale, so only the J side is seeded — and vice versa.)
    def _widened_start(seed_idx, limit):
        seed = list(dict.fromkeys(int(i) for i in seed_idx))[:maxrank]
        if len(seed) < maxrank:
            pool = np.setdiff1d(
                np.arange(limit, dtype=np.int64),
                np.asarray(seed, dtype=np.int64),
                assume_unique=True,
            )
            extra = rng.choice(pool, size=maxrank - len(seed),
                               replace=False)
            seed = np.concatenate(
                [np.asarray(seed, dtype=np.int64), extra])
        return np.asarray(seed, dtype=np.int64)

    nsets = 2 * (hunt_stages if mixed else 1)
    ipack = np.zeros((3 + nsets * Rb,), dtype=np.int32)
    ipack[2] = maxrank
    if leftorthogonal:
        ipack[1] = maxrank  # J0len
        for s in range(hunt_stages if mixed else 1):
            lo = 3 + (2 * s + 1) * Rb
            ipack[lo:lo + maxrank] = (
                _widened_start(J0, n) if s == 0
                else rng.choice(n, size=maxrank, replace=False)
            )
    else:
        ipack[0] = maxrank  # I0len
        for s in range(hunt_stages if mixed else 1):
            lo = 3 + 2 * s * Rb
            ipack[lo:lo + maxrank] = (
                _widened_start(I0, m) if s == 0
                else rng.choice(m, size=maxrank, replace=False)
            )

    run_args = (
        A, jnp.asarray(ipack),
        jnp.asarray(np.array([reltol, abstol], dtype=np.float64)),
    )

    if mixed:
        L_nat, U_nat, pack = run(*run_args)  # dispatched async
        cap = Rb * hunt_stages  # candidate capacity (factor width)

        def finish_mixed() -> DeviceRRLU:
            pk = np.asarray(pack)  # the ONE device→host transfer (also the
            #                        execution sync: outputs materialize
            #                        together, so the factors are ready)
            keff, kf = int(pk[0]), int(pk[2])
            err = float(pk[1]) if keff < kf else float(pk[3])
            nslabs = int(pk[4])
            k = keff
            I0f = pk[5:5 + cap].astype(np.int64)
            Jids = pk[5 + cap:].astype(np.int64)
            # the pack carries pivot ids (f64-completion elimination order);
            # complete both permutations with the remaining indices
            I0sel = I0f[:k]
            mask = np.ones(m, dtype=bool)
            mask[I0sel] = False
            rowpermutation = np.concatenate([I0sel, np.nonzero(mask)[0]])
            J0sel = Jids[:k]
            cmask = np.ones(n, dtype=bool)
            cmask[J0sel] = False
            colpermutation = np.concatenate([J0sel, np.nonzero(cmask)[0]])
            err_fin = 0.0 if k >= min(m, n) else err
            Lk, Uk = L_nat, U_nat
            if k < cap:  # trim the zero-padded factor columns/rows
                Lk, Uk = L_nat[:, :k], U_nat[:k, :]
            return DeviceRRLU(
                Lk, Uk, rowpermutation, colpermutation,
                k, err_fin, leftorthogonal, nslabs=nslabs,
            )

        if defer:
            return _PendingRRLU(finish_mixed)
        return finish_mixed()

    LUp, rp, cp, kdev, errdev, I0fdev, J0f, nslabsdev = run(*run_args)

    def finish_plain() -> DeviceRRLU:
        k = int(kdev)
        err = float(errdev)
        nslabs = int(nslabsdev)
        cp_h = np.asarray(cp)
        I0f = np.asarray(I0fdev)

        # assembly: final slab was the ROW slab A[I0f_prev, :] (all
        # columns) — same code path as rrlu_rook_device's
        # materialize="device" with last_full_rows=False
        from scipy.linalg import solve_triangular as _st

        blk = np.asarray(LUp[:k, :k])
        Lblk = np.tril(blk)
        Ublk = np.triu(blk)
        if leftorthogonal:
            np.fill_diagonal(Lblk, 1.0)
        else:
            np.fill_diagonal(Ublk, 1.0)
        colpermutation = np.asarray(cp_h[:n], dtype=np.int64)
        I0sel = np.asarray(I0f[:k], dtype=np.int64)
        mask = np.ones(m, dtype=bool)
        mask[I0sel] = False
        rowpermutation = np.concatenate([I0sel, np.nonzero(mask)[0]])
        I2 = rowpermutation[k:]
        Uinv = _st(Ublk, np.eye(k), lower=False)
        err_fin = 0.0 if k >= min(m, n) else err
        L_nat, U_nat = _assemble_cols_branch(
            A, LUp,
            jnp.asarray(colpermutation[:k], dtype=np.int32),
            jnp.asarray(I2 if I2.size else np.zeros((0,)), dtype=np.int32),
            jnp.asarray(np.argsort(rowpermutation), dtype=np.int32),
            jnp.asarray(np.argsort(colpermutation), dtype=np.int32),
            jnp.asarray(Uinv),
            k=k, unit_lower=leftorthogonal,
        )
        return DeviceRRLU(
            L_nat, U_nat, rowpermutation, colpermutation, k, err_fin,
            leftorthogonal, nslabs=nslabs,
        )

    if defer:
        return _PendingRRLU(finish_plain)
    return finish_plain()


def rrlu_rook_device(
    A,
    I0=(),
    J0=(),
    maxrank: int = _INTMAX,
    reltol: float = 1e-14,
    abstol: float = 0.0,
    leftorthogonal: bool = True,
    numrookiter: int = 5,
    rng: Optional[np.random.Generator] = None,
    materialize: str = "host",
):
    """Adaptive rook rrLU of a device-resident matrix (arrlu on device).

    Control flow mirrors ops/lu.py:arrlu (itself matrixlu.jl:492-569); all
    O(m·k)-sized work stays on device.
    """
    if rng is None:
        rng = np.random.default_rng()
    A = jnp.asarray(A)
    m, n = A.shape
    maxrank = min(maxrank, m, n)

    I0 = [int(i) for i in I0]
    J0 = [int(j) for j in J0]
    islowrank = False
    out = None
    last_full_rows = False
    rows_l = cols_l = None

    while True:
        if leftorthogonal:
            pushrandomsubset(J0, range(n), max(1, len(J0)), rng)
        else:
            pushrandomsubset(I0, range(m), max(1, len(I0)), rng)

        for rookiter in range(1, numrookiter + 1):
            colmove = (rookiter % 2 == 0) == leftorthogonal
            if colmove:
                # slab = A[I0, :]
                rows_l, cols_l = list(I0), list(range(n))
                last_full_rows = False
                idx = _pad_idx(rows_l, bucket(len(rows_l)))
                res = _slab_lu(
                    A, idx, jnp.int32(len(rows_l)), jnp.int32(maxrank),
                    jnp.float64(reltol), jnp.float64(abstol),
                    leftorthogonal=leftorthogonal, rows_slab=True,
                )
                mt, nt = len(rows_l), n
            else:
                # slab = A[:, J0]
                rows_l, cols_l = list(range(m)), list(J0)
                last_full_rows = True
                idx = _pad_idx(cols_l, bucket(len(cols_l)))
                res = _slab_lu(
                    A, idx, jnp.int32(len(cols_l)), jnp.int32(maxrank),
                    jnp.float64(reltol), jnp.float64(abstol),
                    leftorthogonal=leftorthogonal, rows_slab=False,
                )
                mt, nt = m, len(cols_l)
            LUp, rp, cp, k, mags, err = res
            k = int(k)
            rp = np.asarray(rp[:mt])
            cp = np.asarray(cp[:nt])
            islowrank |= k < min(mt, nt)

            newI = [rows_l[i] for i in rp[:k]]
            newJ = [cols_l[j] for j in cp[:k]]
            out = (LUp, rp, cp, k, float(err), rows_l, cols_l, mt, nt)
            if newI == I0 and newJ == J0:
                break
            I0, J0 = newI, newJ

        if islowrank or len(I0) >= maxrank:
            break

    assert out is not None
    LUp, rp, cp, k, err, rows_l, cols_l, mt, nt = out

    if materialize == "device":
        # Factors stay on device; host fetches only the k x k pivot block
        # (for the triangular inversion) and the index lists.
        from scipy.linalg import solve_triangular as _st

        err_fin = 0.0 if k >= min(mt, nt) else err
        blk = np.asarray(LUp[:k, :k])
        Lblk = np.tril(blk)
        Ublk = np.triu(blk)
        if leftorthogonal:
            np.fill_diagonal(Lblk, 1.0)
        else:
            np.fill_diagonal(Ublk, 1.0)
        if last_full_rows:
            rowpermutation = np.array(
                [rows_l[i] for i in rp], dtype=np.int64
            )
            J2 = [j for j in range(n) if j not in set(J0)]
            colpermutation = np.array(J0 + J2, dtype=np.int64)
            Linv = _st(Lblk, np.eye(k), lower=True)
            L_nat, U_nat = _assemble_rows_branch(
                A, LUp,
                jnp.asarray(rowpermutation[:k], dtype=np.int32),
                jnp.asarray(J2 if J2 else np.zeros((0,)), dtype=np.int32),
                jnp.asarray(np.argsort(rowpermutation), dtype=np.int32),
                jnp.asarray(np.argsort(colpermutation), dtype=np.int32),
                jnp.asarray(Linv),
                k=k, unit_lower=leftorthogonal,
            )
        else:
            colpermutation = np.array(
                [cols_l[j] for j in cp], dtype=np.int64
            )
            I2 = [i for i in range(m) if i not in set(I0)]
            rowpermutation = np.array(I0 + I2, dtype=np.int64)
            Uinv = _st(Ublk, np.eye(k), lower=False)
            L_nat, U_nat = _assemble_cols_branch(
                A, LUp,
                jnp.asarray(colpermutation[:k], dtype=np.int32),
                jnp.asarray(I2 if I2 else np.zeros((0,)), dtype=np.int32),
                jnp.asarray(np.argsort(rowpermutation), dtype=np.int32),
                jnp.asarray(np.argsort(colpermutation), dtype=np.int32),
                jnp.asarray(Uinv),
                k=k, unit_lower=leftorthogonal,
            )
        return DeviceRRLU(
            L_nat, U_nat, rowpermutation, colpermutation, k, err_fin,
            leftorthogonal,
        )

    # factors of the last slab (host finalize trims/pads triangles)
    lu_slab = _finalize(
        np.asarray(LUp[:mt, :nt]), rp, cp, k, err, leftorthogonal
    )
    pivotblock_L = lu_slab.L[:k, :k]
    pivotblock_U = lu_slab.U[:k, :k]

    if last_full_rows:
        # L covers all rows (permuted); complete U over the remaining columns.
        rowpermutation = np.array(
            [rows_l[i] for i in lu_slab.rowpermutation], dtype=np.int64
        )
        L = lu_slab.L
        J2 = [j for j in range(n) if j not in set(J0)]
        colpermutation = np.array(J0 + J2, dtype=np.int64)
        if J2:
            from scipy.linalg import solve_triangular as _st

            Linv = _st(pivotblock_L, np.eye(k), lower=True)
            U2 = np.asarray(
                _complete_factor(
                    A, jnp.asarray(rowpermutation[:k], dtype=np.int32),
                    jnp.asarray(J2, dtype=np.int32),
                    jnp.asarray(Linv),
                    transpose_solve=False,
                )
            )
            U = np.hstack([pivotblock_U, U2])
        else:
            U = pivotblock_U
    else:
        colpermutation = np.array(
            [cols_l[j] for j in lu_slab.colpermutation], dtype=np.int64
        )
        U = lu_slab.U
        I2 = [i for i in range(m) if i not in set(I0)]
        rowpermutation = np.array(I0 + I2, dtype=np.int64)
        if I2:
            from scipy.linalg import solve_triangular as _st

            Uinv = _st(pivotblock_U, np.eye(k), lower=False)
            L2 = np.asarray(
                _complete_factor(
                    A, jnp.asarray(colpermutation[:k], dtype=np.int32),
                    jnp.asarray(I2, dtype=np.int32),
                    jnp.asarray(Uinv),
                    transpose_solve=True,
                )
            )
            L = np.vstack([pivotblock_L, L2])
        else:
            L = pivotblock_L

    return rrLU(
        rowpermutation, colpermutation, L, U, leftorthogonal, k,
        lu_slab.error,
    )
