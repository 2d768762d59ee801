"""Jit-compiled complete-pivot rank-revealing LU elimination kernel.

This is the JAX replacement for the reference's hand-written Julia loops
(src/matrixlu.jl: submatrixargmax :46-139, addpivot! :295-322, _optimizerrlu!
:346-396). Instead of mutating a dynamically sized matrix, the kernel runs a
``lax.while_loop`` over a zero-padded fixed-shape buffer with index masks:

- the pivot argmax is a masked reduction over the active trailing submatrix,
  with column-major first-occurrence tie-breaking to match the reference;
- row/column swaps are scatter updates of the buffer plus int32 permutation
  vectors;
- the Schur complement update is a masked rank-1 outer-product subtraction,
  which XLA fuses into a single pass over the buffer.

Shapes are bucketed (see ``bucket``) so adaptive rank growth across TCI sweeps
hits a bounded set of compiled programs. True extents, maxrank and tolerances
are passed as device scalars and do not trigger recompilation.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np


def bucket(n: int) -> int:
    """Round `n` up to a padded extent; at most ~4 buckets per octave."""
    if n <= 8:
        return 8
    step = 1 << max(3, n.bit_length() - 3)
    return ((n + step - 1) // step) * step


def _abs2(x):
    if jnp.iscomplexobj(x):
        return (x * jnp.conj(x)).real
    return x * x


# Panels at or above this element count use the swap-free fused elimination
# body (_rrlu_state_fused): one fused read+write pass over the buffer per
# pivot step instead of ~3.5 (metric pass + two swap copies + update), which
# matters once the panel no longer fits in cache. Small panels keep the
# compact swap-based body (proven fast inside the whole-sweep programs).
_FUSED_MIN_ELEMS = 1 << 16


def _rrlu_state_fused(A, m_true, n_true, maxrank, reltol, abstol,
                      leftorthogonal: bool):
    """Swap-free complete-pivot elimination for large panels.

    Matches _rrlu_state exactly (same returns, same pivot order incl. the
    reference's column-major first-occurrence tie-break in the *swapped*
    layout, matrixlu.jl:70-86) but never physically permutes the buffer:

    - rowperm/colperm (position -> original index) and their inverses
      rowpos/colpos (original index -> position) are carried as int32
      vectors; "swaps" are two-element scatter updates;
    - tie-breaks use the position keys, reproducing the swapped-layout
      column-major first-max order;
    - the Schur rank-1 update, the multiplier store into the pivot column
      (or row), and the next step's per-column maxima all fuse into ONE
      read+write pass over the buffer;
    - the swapped-layout LU buffer is materialized once at the end by a
      gather A[rowperm][:, colperm].
    """
    mp, npd = A.shape
    rmax = min(mp, npd)
    rows = jnp.arange(mp, dtype=jnp.int32)
    cols = jnp.arange(npd, dtype=jnp.int32)
    BIG = jnp.int32(2**30)

    def colmax_of(A, rowpos, k):
        validr = (rowpos >= k) & (rows < m_true)
        metric = jnp.where(validr[:, None], _abs2(A), -1.0)
        return jnp.max(metric, axis=0)

    def cond(state):
        (A, rowperm, colperm, rowpos, colpos, colmax, k, maxerror, err,
         done, mags) = state
        return (k < maxrank) & (~done)

    def body(state):
        (A, rowperm, colperm, rowpos, colpos, colmax, k, maxerror, err,
         done, mags) = state

        # --- pivot column: max colmax; ties -> smallest swapped position ---
        validc = (colpos >= k) & (cols < n_true)
        cm = jnp.where(validc, colmax, -1.0)
        M = jnp.max(cm)
        bestcolpos = jnp.min(jnp.where((cm == M) & validc, colpos, BIG))
        pc = colperm[jnp.minimum(bestcolpos, npd - 1)]

        # --- pivot row within column pc: ties -> smallest swapped position --
        validr = (rowpos >= k) & (rows < m_true)
        met = jnp.where(validr, _abs2(A[:, pc]), -1.0)
        Mr = jnp.max(met)
        bestrowpos = jnp.min(jnp.where((met == Mr) & validr, rowpos, BIG))
        pr = rowperm[jnp.minimum(bestrowpos, mp - 1)]
        newerr = jnp.sqrt(jnp.maximum(Mr, 0.0)).astype(jnp.float64)

        # No valid row/column left (k reached the true rank bound with an
        # unpadded buffer): the fallback pc/pr above point at an
        # already-pivoted line — never eliminate on it.
        exhausted = (M < 0) | (Mr < 0)
        stop = ((newerr < reltol * maxerror) | (newerr < abstol)) & (k > 0)
        # An exactly-zero pivot means the remaining submatrix is exactly
        # zero; continuing would divide by zero (relevant when callers pass
        # reltol=abstol=0 for an "exact" pass).
        stop = stop | exhausted | ((newerr == 0.0) & (k > 0))
        do = ~stop

        # --- virtual swaps (identity when stopping) ------------------------
        brp = jnp.where(do, bestrowpos, k)
        r_at_k = rowperm[k]
        pr_eff = jnp.where(do, pr, r_at_k)
        rowperm = rowperm.at[brp].set(r_at_k).at[k].set(pr_eff)
        rowpos = rowpos.at[r_at_k].set(brp).at[pr_eff].set(k)

        bcp = jnp.where(do, bestcolpos, k)
        c_at_k = colperm[k]
        pc_eff = jnp.where(do, pc, c_at_k)
        colperm = colperm.at[bcp].set(c_at_k).at[k].set(pc_eff)
        colpos = colpos.at[c_at_k].set(bcp).at[pc_eff].set(k)

        # --- fused Schur update + multiplier store + next colmax -----------
        piv = A[pr_eff, pc_eff]
        safe = jnp.where(do & (piv != 0), piv, 1)
        urow = (rowpos >= k + 1) & (rows < m_true)  # unpivoted after step
        ucol = (colpos >= k + 1) & (cols < n_true)
        if leftorthogonal:
            mult = A[:, pc_eff] / safe
            x = jnp.where(urow & do, mult, 0)
            y = jnp.where(ucol, A[pr_eff, :], 0)
            Anew = A - x[:, None] * y[None, :]
            # store multipliers in the pivot column's unpivoted rows
            Anew = jnp.where(
                (cols[None, :] == pc_eff) & (urow & do)[:, None],
                mult[:, None],
                Anew,
            )
        else:
            divr = A[pr_eff, :] / safe
            y = jnp.where(ucol & do, divr, 0)
            x = jnp.where(urow, A[:, pc_eff], 0)
            Anew = A - x[:, None] * y[None, :]
            Anew = jnp.where(
                (rows[:, None] == pr_eff) & (ucol & do)[None, :],
                divr[None, :],
                Anew,
            )
        metric_next = jnp.where(urow[:, None], _abs2(Anew), -1.0)
        colmax = jnp.max(metric_next, axis=0)

        mags = jnp.where((jnp.arange(mags.shape[0]) == k) & do, newerr, mags)
        return (
            Anew,
            rowperm,
            colperm,
            rowpos,
            colpos,
            colmax,
            k + do.astype(jnp.int32),
            jnp.where(do, jnp.maximum(maxerror, newerr), maxerror),
            newerr,
            stop,
            mags,
        )

    state0 = (
        A,
        rows,
        cols,
        rows,
        cols,
        colmax_of(A, rows, 0),
        jnp.int32(0),
        jnp.float64(0.0),
        jnp.float64(jnp.nan),
        False,
        jnp.zeros((rmax,), dtype=jnp.float64),
    )
    (A, rowperm, colperm, rowpos, colpos, colmax, k, maxerror, err, done,
     mags) = jax.lax.while_loop(cond, body, state0)
    # materialize the swapped-layout LU buffer (what callers consume)
    A_sw = A[rowperm, :][:, colperm]
    return A_sw, rowperm, colperm, k, mags, err


def _rrlu_state(A, m_true, n_true, maxrank, reltol, abstol, leftorthogonal: bool):
    if A.shape[0] * A.shape[1] >= _FUSED_MIN_ELEMS and not jnp.iscomplexobj(A):
        return _rrlu_state_fused(
            A, m_true, n_true, maxrank, reltol, abstol, leftorthogonal
        )
    return _rrlu_state_small(
        A, m_true, n_true, maxrank, reltol, abstol, leftorthogonal
    )


def _rrlu_state_small(A, m_true, n_true, maxrank, reltol, abstol,
                      leftorthogonal: bool):
    """Run the complete-pivot elimination loop on a padded buffer.

    Args:
      A: (mp, np) padded matrix; entries at row >= m_true or col >= n_true are 0.
      m_true, n_true: true extents (int32 scalars).
      maxrank: maximum number of pivots (int32 scalar, <= min(m_true, n_true)).
      reltol, abstol: stopping tolerances (float64 scalars). A candidate pivot
        with |pivot| < reltol * max_so_far or |pivot| < abstol stops the loop
        (after at least one pivot, matching matrixlu.jl:363).

    Returns:
      (A_out, rowperm, colperm, npivot, pivotmags, residual_err) where A_out
      holds the in-place LU factors, rowperm/colperm are full permutations of
      the padded index ranges (true rows first), pivotmags[k] = |pivot_{k}|,
      and residual_err is the magnitude of the first rejected pivot (or the
      last accepted one if maxrank was reached).
    """
    mp, npd = A.shape
    rmax = min(mp, npd)
    rows = jnp.arange(mp, dtype=jnp.int32)
    cols = jnp.arange(npd, dtype=jnp.int32)

    def cond(state):
        A, rowperm, colperm, k, maxerror, err, done, mags = state
        return (k < maxrank) & (~done)

    def body(state):
        A, rowperm, colperm, k, maxerror, err, done, mags = state

        valid = (
            (rows[:, None] >= k)
            & (rows[:, None] < m_true)
            & (cols[None, :] >= k)
            & (cols[None, :] < n_true)
        )
        metric = jnp.where(valid, _abs2(A), -1.0)
        # Column-major first-occurrence argmax (matrixlu.jl:70-86 iterates
        # columns outer, rows inner, strict '>' keeps the first maximum).
        # Large panels: per-column max + first-row argmax, then first-col
        # argmax — two axis-0 reductions instead of a full-matrix f64
        # transpose per pivot iteration. Small panels: the flat transpose
        # reduce, which was faster inside the small scan-sweep programs.
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
        # Exactly-zero pivot => remaining submatrix is exactly zero (or no
        # valid entry remains); continuing would divide by zero when callers
        # pass reltol=abstol=0 for an "exact" pass.
        stop = stop | ((newerr == 0.0) & (k > 0))
        do = ~stop
        # Masked (branch-free) pivot step: when stopping, swap k with itself
        # and zero out the update, so the arrays pass through unchanged.
        pr_eff = jnp.where(do, pr, k)
        pc_eff = jnp.where(do, pc, k)

        # swap rows k <-> pr_eff
        rk, rp = A[k, :], A[pr_eff, :]
        A = A.at[pr_eff, :].set(rk).at[k, :].set(rp)
        pk, pp = rowperm[k], rowperm[pr_eff]
        rowperm = rowperm.at[pr_eff].set(pk).at[k].set(pp)
        # swap cols k <-> pc_eff
        ck, cp = A[:, k], A[:, pc_eff]
        A = A.at[:, pc_eff].set(ck).at[:, k].set(cp)
        qk, qp = colperm[k], colperm[pc_eff]
        colperm = colperm.at[pc_eff].set(qk).at[k].set(qp)

        Akk = A[k, k]
        safe = jnp.where(do & (Akk != 0), Akk, 1)
        if leftorthogonal:
            colk = A[:, k]
            colk = jnp.where((rows > k) & do, colk / safe, colk)
            A = A.at[:, k].set(colk)
            x = jnp.where((rows > k) & do, colk, 0)
            y = jnp.where(cols > k, A[k, :], 0)
        else:
            rowk = A[k, :]
            rowk = jnp.where((cols > k) & do, rowk / safe, rowk)
            A = A.at[k, :].set(rowk)
            x = jnp.where((rows > k) & do, A[:, k], 0)
            y = jnp.where(cols > k, rowk, 0)
        A = A - x[:, None] * y[None, :]

        mags = jnp.where(
            (jnp.arange(mags.shape[0]) == k) & do, newerr, mags
        )
        return (
            A,
            rowperm,
            colperm,
            k + do.astype(jnp.int32),
            jnp.where(do, jnp.maximum(maxerror, newerr), maxerror),
            newerr,
            stop,
            mags,
        )

    state0 = (
        A,
        rows,
        cols,
        jnp.int32(0),
        jnp.float64(0.0),
        jnp.float64(jnp.nan),
        False,
        jnp.zeros((rmax,), dtype=jnp.float64),
    )
    A, rowperm, colperm, k, maxerror, err, done, mags = jax.lax.while_loop(
        cond, body, state0
    )
    return A, rowperm, colperm, k, mags, err


@functools.partial(jax.jit, static_argnames=("leftorthogonal",))
def _rrlu_while(A, m_true, n_true, maxrank, reltol, abstol, *, leftorthogonal: bool):
    return _rrlu_state(
        A, m_true, n_true, maxrank, reltol, abstol, leftorthogonal
    )


@functools.partial(jax.jit, static_argnames=("leftorthogonal",))
def _rrlu_pair_jit(Ar, Ai, m_true, n_true, maxrank, reltol, abstol,
                   *, leftorthogonal: bool):
    from .complex_pair import rrlu_state_pair

    return rrlu_state_pair(
        Ar, Ai, m_true, n_true, maxrank, reltol, abstol, leftorthogonal
    )


# Where rrlu_raw runs the kernel for host-provided (NumPy) matrices. "cpu"
# (default) keeps the panel in host RAM and runs the elimination on JAX's CPU
# backend: the matrix already lives on the host, and a complete-pivot
# elimination is one small dependent step per pivot, so shipping the panel to
# the accelerator and the factors back buys nothing at host-tier panel sizes.
# Its times are host-CPU times, never accelerator times. The device-resident
# tiers (ops/fused.py, models/device_sweep.py) build their panels on the
# accelerator and are unaffected. Set to "default" to run host-tier
# factorizations on the default backend instead.
HOST_RRLU_BACKEND = "cpu"


def _host_compute_device():
    if HOST_RRLU_BACKEND == "cpu":
        try:
            return jax.local_devices(backend="cpu")[0]
        except RuntimeError:  # JAX_PLATFORMS excludes the CPU backend
            return None
    return None


def rrlu_raw(
    A: np.ndarray,
    maxrank: int,
    reltol: float,
    abstol: float,
    leftorthogonal: bool,
):
    """Dispatch the padded kernel for a concrete matrix.

    Runs on the host CPU backend while ``HOST_RRLU_BACKEND == "cpu"`` (the
    default), otherwise on JAX's default backend. Either way the elimination
    is ``_rrlu_while`` in float64/complex128.

    Returns numpy (LUmat (m,n), rowperm (m,), colperm (n,), npivot, pivotmags,
    residual_err) restricted to the true extents.
    """
    dev = _host_compute_device()
    if dev is not None:
        with jax.default_device(dev):
            return _rrlu_raw_impl(A, maxrank, reltol, abstol, leftorthogonal)
    return _rrlu_raw_impl(A, maxrank, reltol, abstol, leftorthogonal)


def _rrlu_raw_impl(
    A: np.ndarray,
    maxrank: int,
    reltol: float,
    abstol: float,
    leftorthogonal: bool,
):
    m, n = A.shape
    if m == 0 or n == 0:
        return (
            np.asarray(A),
            np.arange(m, dtype=np.int32),
            np.arange(n, dtype=np.int32),
            0,
            np.zeros((0,)),
            float("nan"),
        )
    dtype = np.result_type(A.dtype, np.float64)
    iscomplex = np.issubdtype(dtype, np.complexfloating)
    dtype = np.complex128 if iscomplex else np.float64
    mp, npd = bucket(m), bucket(n)
    maxrank = min(maxrank, m, n)

    if iscomplex:
        from ..parallel.batcheval import platform_supports_complex

        if not platform_supports_complex():
            # complex-free backend: run the elimination on explicit
            # (re, im) f64 pairs (ops/complex_pair.py)
            An = np.zeros((mp, npd), dtype=np.complex128)
            An[:m, :n] = A
            out = _rrlu_pair_jit(
                jnp.asarray(An.real), jnp.asarray(An.imag),
                jnp.int32(m), jnp.int32(n), jnp.int32(maxrank),
                jnp.float64(reltol), jnp.float64(abstol),
                leftorthogonal=leftorthogonal,
            )
            Ar, Ai, rowperm, colperm, k, mags, err = jax.device_get(out)
            k = int(k)
            return (
                (np.asarray(Ar) + 1j * np.asarray(Ai))[:m, :n],
                np.asarray(rowperm)[:m],
                np.asarray(colperm)[:n],
                k,
                np.asarray(mags)[:k],
                float(err),
            )

    Ap = jnp.zeros((mp, npd), dtype=dtype)
    Ap = Ap.at[:m, :n].set(jnp.asarray(A, dtype=dtype))

    Aout, rowperm, colperm, k, mags, err = _rrlu_while(
        Ap,
        jnp.int32(m),
        jnp.int32(n),
        jnp.int32(maxrank),
        jnp.float64(reltol),
        jnp.float64(abstol),
        leftorthogonal=leftorthogonal,
    )
    # One fetch for all outputs.
    Aout, rowperm, colperm, k, mags, err = jax.device_get(
        (Aout[:m, :n], rowperm[:m], colperm[:n], k, mags, err)
    )
    k = int(k)
    # Padded rows/cols are never selected as pivots, so the first m entries of
    # rowperm are a permutation of 0..m-1 (same for columns).
    return (
        np.asarray(Aout),
        np.asarray(rowperm),
        np.asarray(colperm),
        k,
        np.asarray(mags[:k]),
        float(err),
    )


def submatrixargmax_colmajor(metric: np.ndarray):
    """First-occurrence argmax in column-major order over a 2-D metric array."""
    flat = np.asarray(metric).T.reshape(-1)
    p = int(np.argmax(flat))
    m = metric.shape[0]
    return p % m, p // m
