"""Tensor-parallel (mesh-sharded) complete-pivot rank-revealing LU.

SURVEY.md §2.5 names "shard the Π matrix / rrLU panels across devices" as
the tensor-parallel equivalent this framework should offer; this module
implements it. The panel's ROWS are sharded over a 1-D ``jax.sharding.Mesh``
and the elimination runs inside ``shard_map`` as a classic distributed
right-looking LU (reference semantics: src/matrixlu.jl _optimizerrlu!
:346-396 with the swap-free formulation of ops/lu_kernel._rrlu_state_fused):

- per pivot step each device reduces its local per-column maxima, then one
  cross-device max produces the global column metric and one cross-device
  min the reference's first-occurrence (smallest swapped position)
  tie-break — both exact, so the pivot ORDER is bit-identical to the
  single-device kernel. The max/min collectives are expressed as a
  ``lax.psum`` of an axis-index one-hot table followed by a local reduce
  (exact: each table entry receives exactly one non-zero contribution);
- the pivot row is broadcast with a ``lax.psum`` of a one-owner mask (sum
  of one non-zero contribution — exact);
- the Schur rank-1 update, the multiplier store and the next step's column
  maxima are local to each device's row block (the same fused single pass
  as the single-device kernel), so per-element arithmetic is bit-identical;
- row/column permutations are carried replicated and never materialize a
  swap: the factored buffer is gathered once at the end.

On GPUs XLA hands the collectives to NCCL. Each device holds 1/P of the
panel, so panels larger than one device's memory factorize, and the
O(r·m·n/P) update FLOPs scale with the mesh. Complex dtypes work wherever
the backend executes them.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as PSpec

from jax import shard_map

from .lu_kernel import _abs2, bucket
from ..parallel.mesh import default_mesh

_INTMAX = 2**62

# program cache: (device ids, axis name, mp, npd, dtype, leftorthogonal)
_programs: dict = {}


def _make_state_fn(axis: str, Pn: int, m_blk: int, npd: int,
                   leftorthogonal: bool):
    """Per-device elimination body (runs inside shard_map)."""

    def state_fn(Ablk, m_true, n_true, maxrank, reltol, abstol):
        mp = m_blk * Pn
        rmax = min(mp, npd)
        ix = jax.lax.axis_index(axis)
        offset = ix * m_blk
        gids = offset + jnp.arange(m_blk, dtype=jnp.int32)  # global row ids
        cols = jnp.arange(npd, dtype=jnp.int32)
        BIG = jnp.int32(2**30)
        onehot_ix = (jnp.arange(Pn, dtype=jnp.int32) == ix)

        def axmax(x):
            """Exact cross-device max via a Sum all-reduce: psum a one-hot
            (Pn, ...) table (each slot gets exactly one contribution), then
            reduce locally."""
            table = jax.lax.psum(
                jnp.where(
                    onehot_ix.reshape((Pn,) + (1,) * jnp.ndim(x)),
                    x[None], jnp.zeros_like(x)[None],
                ),
                axis,
            )
            return jnp.max(table, axis=0)

        def axmin_int(x):
            table = jax.lax.psum(
                jnp.where(
                    onehot_ix.reshape((Pn,) + (1,) * jnp.ndim(x)),
                    x[None], jnp.zeros_like(x)[None],
                ),
                axis,
            )
            return jnp.min(table, axis=0)

        def global_colmax(Ablk, rowpos, k):
            validr = (rowpos[gids] >= k) & (gids < m_true)
            metric = jnp.where(validr[:, None], _abs2(Ablk), -1.0)
            return axmax(jnp.max(metric, axis=0))

        def cond(state):
            (Ablk, rowperm, colperm, rowpos, colpos, colmax, k, maxerror,
             err, done, mags) = state
            return (k < maxrank) & (~done)

        def body(state):
            (Ablk, rowperm, colperm, rowpos, colpos, colmax, k, maxerror,
             err, done, mags) = state

            # --- pivot column (replicated compute on the reduced metric) --
            validc = (colpos >= k) & (cols < n_true)
            cm = jnp.where(validc, colmax, -1.0)
            M = jnp.max(cm)
            bestcolpos = jnp.min(jnp.where((cm == M) & validc, colpos, BIG))
            pc = colperm[jnp.minimum(bestcolpos, npd - 1)]

            # --- pivot row within column pc (two exact collectives) -------
            validr = (rowpos[gids] >= k) & (gids < m_true)
            met = jnp.where(validr, _abs2(Ablk[:, pc]), -1.0)
            Mr = axmax(jnp.max(met))
            bestrowpos = axmin_int(
                jnp.min(jnp.where((met == Mr) & validr, rowpos[gids], BIG))
            )
            pr = rowperm[jnp.minimum(bestrowpos, mp - 1)]
            newerr = jnp.sqrt(jnp.maximum(Mr, 0.0)).astype(jnp.float64)

            exhausted = (M < 0) | (Mr < 0)
            stop = (
                (newerr < reltol * maxerror) | (newerr < abstol)
            ) & (k > 0)
            stop = stop | exhausted | ((newerr == 0.0) & (k > 0))
            do = ~stop

            # --- virtual swaps on replicated permutation vectors ----------
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

            # --- broadcast the pivot row (one-owner psum, exact) ----------
            owner = (pr_eff >= offset) & (pr_eff < offset + m_blk)
            lid = jnp.clip(pr_eff - offset, 0, m_blk - 1)
            yfull = jax.lax.psum(
                jnp.where(owner, Ablk[lid, :], jnp.zeros_like(Ablk[0])),
                axis,
            )
            piv = yfull[pc_eff]
            safe = jnp.where(do & (piv != 0), piv, 1)

            urow = (rowpos[gids] >= k + 1) & (gids < m_true)
            ucol = (colpos >= k + 1) & (cols < n_true)
            if leftorthogonal:
                mult = Ablk[:, pc_eff] / safe
                x = jnp.where(urow & do, mult, 0)
                y = jnp.where(ucol, yfull, 0)
                Anew = Ablk - x[:, None] * y[None, :]
                Anew = jnp.where(
                    (cols[None, :] == pc_eff) & (urow & do)[:, None],
                    mult[:, None],
                    Anew,
                )
            else:
                divr = yfull / safe
                y = jnp.where(ucol & do, divr, 0)
                x = jnp.where(urow, Ablk[:, pc_eff], 0)
                Anew = Ablk - x[:, None] * y[None, :]
                Anew = jnp.where(
                    (gids[:, None] == pr_eff) & (ucol & do)[None, :],
                    divr[None, :],
                    Anew,
                )
            metric_next = jnp.where(urow[:, None], _abs2(Anew), -1.0)
            colmax = axmax(jnp.max(metric_next, axis=0))

            mags = jnp.where(
                (jnp.arange(rmax) == k) & do, newerr, mags
            )
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

        rows_full = jnp.arange(mp, dtype=jnp.int32)
        state0 = (
            Ablk,
            rows_full,
            cols,
            rows_full,
            cols,
            global_colmax(Ablk, rows_full, 0),
            jnp.int32(0),
            jnp.float64(0.0),
            jnp.float64(jnp.nan),
            False,
            jnp.zeros((rmax,), dtype=jnp.float64),
        )
        (Ablk, rowperm, colperm, rowpos, colpos, colmax, k, maxerror, err,
         done, mags) = jax.lax.while_loop(cond, body, state0)
        return Ablk, rowperm, colperm, k, mags, err

    return state_fn


def _make_state_fn_pair(axis: str, Pn: int, m_blk: int, npd: int,
                        leftorthogonal: bool):
    """Pair-mode (re, im) per-device elimination body: the swap-free
    row-sharded complete-pivot LU of a complex panel carried as two f64
    blocks. Mirrors _make_state_fn exactly (same collectives: one-hot psum
    max/min, one-owner psum pivot-row broadcast) with |z|^2 pivot metric
    and _cdiv/_cmul complex arithmetic (ops/complex_pair.py) — the
    complex-sharded path for backends without complex dtypes."""
    from .complex_pair import _cdiv, _cmul

    def state_fn(Arblk, Aiblk, m_true, n_true, maxrank, reltol, abstol):
        mp = m_blk * Pn
        rmax = min(mp, npd)
        ix = jax.lax.axis_index(axis)
        offset = ix * m_blk
        gids = offset + jnp.arange(m_blk, dtype=jnp.int32)
        cols = jnp.arange(npd, dtype=jnp.int32)
        BIG = jnp.int32(2**30)
        onehot_ix = (jnp.arange(Pn, dtype=jnp.int32) == ix)

        def axmax(x):
            table = jax.lax.psum(
                jnp.where(
                    onehot_ix.reshape((Pn,) + (1,) * jnp.ndim(x)),
                    x[None], jnp.zeros_like(x)[None],
                ),
                axis,
            )
            return jnp.max(table, axis=0)

        def axmin_int(x):
            table = jax.lax.psum(
                jnp.where(
                    onehot_ix.reshape((Pn,) + (1,) * jnp.ndim(x)),
                    x[None], jnp.zeros_like(x)[None],
                ),
                axis,
            )
            return jnp.min(table, axis=0)

        def metric_of(Ar, Ai, rowpos, k):
            validr = (rowpos[gids] >= k) & (gids < m_true)
            return jnp.where(validr[:, None], Ar * Ar + Ai * Ai, -1.0)

        def cond(state):
            return (state[8] < maxrank) & (~state[11])

        def body(state):
            (Arblk, Aiblk, rowperm, colperm, rowpos, colpos, colmax, _mg,
             k, maxerror, err, done, mags) = state

            validc = (colpos >= k) & (cols < n_true)
            cm = jnp.where(validc, colmax, -1.0)
            M = jnp.max(cm)
            bestcolpos = jnp.min(jnp.where((cm == M) & validc, colpos, BIG))
            pc = colperm[jnp.minimum(bestcolpos, npd - 1)]

            validr = (rowpos[gids] >= k) & (gids < m_true)
            met = jnp.where(
                validr,
                Arblk[:, pc] * Arblk[:, pc] + Aiblk[:, pc] * Aiblk[:, pc],
                -1.0,
            )
            Mr = axmax(jnp.max(met))
            bestrowpos = axmin_int(
                jnp.min(jnp.where((met == Mr) & validr, rowpos[gids], BIG))
            )
            pr = rowperm[jnp.minimum(bestrowpos, mp - 1)]
            newerr = jnp.sqrt(jnp.maximum(Mr, 0.0)).astype(jnp.float64)

            exhausted = (M < 0) | (Mr < 0)
            stop = (
                (newerr < reltol * maxerror) | (newerr < abstol)
            ) & (k > 0)
            stop = stop | exhausted | ((newerr == 0.0) & (k > 0))
            do = ~stop

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

            owner = (pr_eff >= offset) & (pr_eff < offset + m_blk)
            lid = jnp.clip(pr_eff - offset, 0, m_blk - 1)
            yfull = jax.lax.psum(
                jnp.where(
                    owner,
                    jnp.stack([Arblk[lid, :], Aiblk[lid, :]]),
                    jnp.zeros((2, npd), dtype=Arblk.dtype),
                ),
                axis,
            )
            yr_full, yi_full = yfull[0], yfull[1]
            piv_r = yr_full[pc_eff]
            piv_i = yi_full[pc_eff]
            nz = do & ((piv_r != 0) | (piv_i != 0))
            safe_r = jnp.where(nz, piv_r, 1.0)
            safe_i = jnp.where(nz, piv_i, 0.0)

            urow = (rowpos[gids] >= k + 1) & (gids < m_true)
            ucol = (colpos >= k + 1) & (cols < n_true)
            if leftorthogonal:
                mr_, mi_ = _cdiv(Arblk[:, pc_eff], Aiblk[:, pc_eff],
                                 safe_r, safe_i)
                xr = jnp.where(urow & do, mr_, 0.0)
                xi = jnp.where(urow & do, mi_, 0.0)
                yr = jnp.where(ucol, yr_full, 0.0)
                yi = jnp.where(ucol, yi_full, 0.0)
                upr, upi = _cmul(xr[:, None], xi[:, None],
                                 yr[None, :], yi[None, :])
                Anr = Arblk - upr
                Ani = Aiblk - upi
                store = (cols[None, :] == pc_eff) & (urow & do)[:, None]
                Anr = jnp.where(store, mr_[:, None], Anr)
                Ani = jnp.where(store, mi_[:, None], Ani)
            else:
                dr_, di_ = _cdiv(yr_full, yi_full, safe_r, safe_i)
                yr = jnp.where(ucol & do, dr_, 0.0)
                yi = jnp.where(ucol & do, di_, 0.0)
                xr = jnp.where(urow, Arblk[:, pc_eff], 0.0)
                xi = jnp.where(urow, Aiblk[:, pc_eff], 0.0)
                upr, upi = _cmul(xr[:, None], xi[:, None],
                                 yr[None, :], yi[None, :])
                Anr = Arblk - upr
                Ani = Aiblk - upi
                store = (gids[:, None] == pr_eff) & (ucol & do)[None, :]
                Anr = jnp.where(store, dr_[None, :], Anr)
                Ani = jnp.where(store, di_[None, :], Ani)
            metric_next = jnp.where(
                ((rowpos[gids] >= k + 1) & (gids < m_true))[:, None],
                Anr * Anr + Ani * Ani, -1.0,
            )
            colmax = axmax(jnp.max(metric_next, axis=0))

            mags = jnp.where((jnp.arange(rmax) == k) & do, newerr, mags)
            return (
                Anr, Ani, rowperm, colperm, rowpos, colpos, colmax,
                _mg, k + do.astype(jnp.int32),
                jnp.where(do, jnp.maximum(maxerror, newerr), maxerror),
                newerr, stop, mags,
            )

        rows_full = jnp.arange(mp, dtype=jnp.int32)
        colmax0 = axmax(jnp.max(
            metric_of(Arblk, Aiblk, rows_full, 0), axis=0
        ))
        state0 = (
            Arblk, Aiblk, rows_full, cols, rows_full, cols, colmax0,
            jnp.int32(0), jnp.int32(0), jnp.float64(0.0),
            jnp.float64(jnp.nan), False,
            jnp.zeros((rmax,), dtype=jnp.float64),
        )
        st = jax.lax.while_loop(cond, body, state0)
        (Arblk, Aiblk, rowperm, colperm, _rp, _cp, _cm, _mg, k, _me, err,
         _dn, mags) = st
        return Arblk, Aiblk, rowperm, colperm, k, mags, err

    return state_fn


def make_lu_split_sharded_pair(mesh: Mesh, m: int, n: int, cap: int,
                               leftorthogonal: bool):
    """Pair-mode ``make_lu_split_sharded``: traceable split of a complex
    panel carried as (re, im) f64 — ``split(Cmr, Cmi, m_true, n_true,
    reltol, abstol) -> (lr, li, rr, ri, kk)`` with the elimination
    row-sharded over ``mesh`` and the factor extraction matching
    ``models.contraction_device._lu_split_pair``. Same bit-parity design as
    the real variant: panel and factored buffers are pinned replicated at
    the shard_map boundary."""
    axis = mesh.axis_names[0]
    Pn = int(np.prod(mesh.devices.shape))
    mp = ((m + Pn - 1) // Pn) * Pn
    state_fn = _make_state_fn_pair(axis, Pn, mp // Pn, n, leftorthogonal)
    mapped = shard_map(
        state_fn,
        mesh=mesh,
        in_specs=(
            PSpec(axis, None), PSpec(axis, None), PSpec(), PSpec(),
            PSpec(), PSpec(), PSpec(),
        ),
        out_specs=(
            PSpec(axis, None), PSpec(axis, None), PSpec(), PSpec(),
            PSpec(), PSpec(), PSpec(),
        ),
    )
    maxrank = min(m, n, cap)
    rep = lambda x: jax.lax.with_sharding_constraint(  # noqa: E731
        x, jax.sharding.NamedSharding(mesh, PSpec(None, None))
    )

    def split(Cmr, Cmi, m_true, n_true, reltol, abstol):
        Cmr = rep(Cmr)
        Cmi = rep(Cmi)
        if mp != m:
            Cpr = jnp.zeros((mp, n), dtype=Cmr.dtype).at[:m, :].set(Cmr)
            Cpi = jnp.zeros((mp, n), dtype=Cmi.dtype).at[:m, :].set(Cmi)
        else:
            Cpr, Cpi = Cmr, Cmi
        Ar_full, Ai_full, rowperm, colperm, kk, _, _ = mapped(
            Cpr, Cpi, m_true, n_true, jnp.int32(maxrank), reltol, abstol
        )
        Ar_full = rep(Ar_full)
        Ai_full = rep(Ai_full)
        Ar = Ar_full[rowperm, :][:, colperm]
        Ai = Ai_full[rowperm, :][:, colperm]
        rmax = min(mp, n)
        ridx = jnp.arange(rmax)
        keep = ridx < kk
        Lr = jnp.tril(Ar[:, :rmax])
        Li = jnp.tril(Ai[:, :rmax])
        Ur = jnp.triu(Ar[:rmax, :])
        Ui = jnp.triu(Ai[:rmax, :])
        if leftorthogonal:
            Lr = Lr.at[jnp.arange(mp)[:rmax], ridx].set(1.0)
            Li = Li.at[jnp.arange(mp)[:rmax], ridx].set(0.0)
        else:
            Ur = Ur.at[ridx, jnp.arange(n)[:rmax]].set(1.0)
            Ui = Ui.at[ridx, jnp.arange(n)[:rmax]].set(0.0)
        Lr = jnp.where(keep[None, :], Lr, 0.0)
        Li = jnp.where(keep[None, :], Li, 0.0)
        Ur = jnp.where(keep[:, None], Ur, 0.0)
        Ui = jnp.where(keep[:, None], Ui, 0.0)
        lr = jnp.zeros_like(Lr).at[rowperm, :].set(Lr)[:m, :cap]
        li = jnp.zeros_like(Li).at[rowperm, :].set(Li)[:m, :cap]
        rr = jnp.zeros_like(Ur).at[:, colperm].set(Ur)[:cap, :n]
        ri = jnp.zeros_like(Ui).at[:, colperm].set(Ui)[:cap, :n]
        return lr, li, rr, ri, kk

    return split


def _get_program(mesh: Mesh, mp: int, npd: int, dtype,
                 leftorthogonal: bool):
    axis = mesh.axis_names[0]
    Pn = int(np.prod(mesh.devices.shape))
    key = (
        tuple(d.id for d in mesh.devices.flat), axis, mp, npd,
        np.dtype(dtype).str, leftorthogonal,
    )
    if key not in _programs:
        state_fn = _make_state_fn(axis, Pn, mp // Pn, npd, leftorthogonal)
        mapped = shard_map(
            state_fn,
            mesh=mesh,
            in_specs=(
                PSpec(axis, None), PSpec(), PSpec(), PSpec(), PSpec(),
                PSpec(),
            ),
            out_specs=(
                PSpec(axis, None), PSpec(), PSpec(), PSpec(), PSpec(),
                PSpec(),
            ),
        )

        @jax.jit
        def run(Ap, m_true, n_true, maxrank, reltol, abstol):
            A_full, rowperm, colperm, k, mags, err = mapped(
                Ap, m_true, n_true, maxrank, reltol, abstol
            )
            # materialize the swapped-layout LU buffer callers consume
            return A_full[rowperm, :][:, colperm], rowperm, colperm, k, \
                mags, err

        _programs[key] = run
    return _programs[key]


def make_lu_split_sharded(mesh: Mesh, m: int, n: int, cap: int,
                          leftorthogonal: bool):
    """Build a TRACEABLE mesh-sharded counterpart of
    ``models.contraction_device._lu_split`` for use inside larger jitted
    programs (device contraction / whole-chain compression).

    Returns ``split(Cm, m_true, n_true, reltol, abstol) -> (left (m, cap),
    right (cap, n), kk)`` where the complete-pivot elimination runs
    row-sharded over ``mesh`` (the same per-device body as
    ``rrlu_sharded_raw`` — bit-identical pivot order vs the single-device
    kernel), and the L/U factor extraction matches ``_lu_split``'s
    convention exactly (leftorthogonal: L unit-diagonal / U carries pivots;
    otherwise the reverse; truncated rows/cols zeroed).

    The row axis is padded to a multiple of the mesh extent inside the
    returned function; padded rows are masked out of pivot selection by
    ``m_true`` exactly like padded rows of the single-device kernel, so the
    factors are identical to the unpadded single-device split.

    Bit-parity design: ONLY the elimination (the sequential hot loop with
    its O(r·m·n) Schur updates) computes sharded; the factored buffer is
    constrained back to replicated immediately, so the factor extraction
    and the caller's surrounding einsums compile exactly as in the
    single-device program (a distributed GEMM would reassociate reductions
    and break bit-identity with the single-device tier).
    """
    axis = mesh.axis_names[0]
    Pn = int(np.prod(mesh.devices.shape))
    mp = ((m + Pn - 1) // Pn) * Pn
    state_fn = _make_state_fn(axis, Pn, mp // Pn, n, leftorthogonal)
    mapped = shard_map(
        state_fn,
        mesh=mesh,
        in_specs=(
            PSpec(axis, None), PSpec(), PSpec(), PSpec(), PSpec(), PSpec(),
        ),
        out_specs=(
            PSpec(axis, None), PSpec(), PSpec(), PSpec(), PSpec(), PSpec(),
        ),
    )
    maxrank = min(m, n, cap)

    def split(Cm, m_true, n_true, reltol, abstol):
        # replicate the panel at the split boundary: without this, GSPMD
        # propagates the shard_map's row spec backward and computes the
        # producer einsum row-sharded, whose per-block GEMM tiling
        # reassociates reductions (ulp-level divergence vs the
        # single-device tier and across mesh extents)
        Cm = jax.lax.with_sharding_constraint(
            Cm, jax.sharding.NamedSharding(mesh, PSpec(None, None))
        )
        if mp != m:
            Cp = jnp.zeros((mp, n), dtype=Cm.dtype).at[:m, :].set(Cm)
        else:
            Cp = Cm
        A_full, rowperm, colperm, kk, _, _ = mapped(
            Cp, m_true, n_true, jnp.int32(maxrank), reltol, abstol
        )
        # replicate the factored buffer: everything downstream (and the
        # caller's next merge einsum) then compiles identically to the
        # single-device program — see the bit-parity note above
        A_full = jax.lax.with_sharding_constraint(
            A_full, jax.sharding.NamedSharding(mesh, PSpec(None, None))
        )
        # swapped-layout LU buffer, then the _lu_split factor extraction
        A_out = A_full[rowperm, :][:, colperm]
        rmax = min(mp, n)
        ridx = jnp.arange(rmax)
        keep = ridx < kk
        L_all = jnp.tril(A_out[:, :rmax])
        U_all = jnp.triu(A_out[:rmax, :])
        if leftorthogonal:
            L_all = L_all.at[jnp.arange(mp)[:rmax], ridx].set(1.0)
        else:
            U_all = U_all.at[ridx, jnp.arange(n)[:rmax]].set(1.0)
        L_all = jnp.where(keep[None, :], L_all, 0.0)
        U_all = jnp.where(keep[:, None], U_all, 0.0)
        left = jnp.zeros_like(L_all).at[rowperm, :].set(L_all)[:m, :cap]
        right = jnp.zeros_like(U_all).at[:, colperm].set(U_all)[:cap, :n]
        return left, right, kk

    return split


def sharded_program_args(A: np.ndarray, maxrank: int, reltol: float,
                         abstol: float, leftorthogonal: bool, mesh: Mesh):
    """The jitted sharded elimination for a nonempty panel ``A`` and its
    arguments, with the padded panel placed row-sharded over ``mesh``: each
    device receives only its own block of rows."""
    m, n = A.shape
    dtype = np.result_type(A.dtype, np.float64)
    dtype = np.complex128 if np.issubdtype(dtype, np.complexfloating) \
        else np.float64
    Pn = int(np.prod(mesh.devices.shape))
    mp = bucket(m)
    mp = ((mp + Pn - 1) // Pn) * Pn  # row extent divisible by the mesh
    npd = bucket(n)

    Ap = np.zeros((mp, npd), dtype=dtype)
    Ap[:m, :n] = A
    rows = jax.sharding.NamedSharding(mesh, PSpec(mesh.axis_names[0], None))
    args = (
        jax.device_put(Ap, rows),
        jnp.int32(m),
        jnp.int32(n),
        jnp.int32(min(maxrank, m, n)),
        jnp.float64(reltol),
        jnp.float64(abstol),
    )
    return _get_program(mesh, mp, npd, dtype, leftorthogonal), args


def rrlu_sharded_raw(
    A: np.ndarray,
    maxrank: int = _INTMAX,
    reltol: float = 1e-14,
    abstol: float = 0.0,
    leftorthogonal: bool = True,
    mesh: Optional[Mesh] = None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, int, np.ndarray, float]:
    """Mesh-sharded ``rrlu_raw``: same return contract (LU buffer in the
    swapped layout, row/col permutations, npivot, pivot magnitudes,
    residual error) with the elimination row-sharded over `mesh` (default:
    a mesh over all available devices)."""
    if mesh is None:
        mesh = default_mesh()
    A = np.asarray(A)
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
    run, args = sharded_program_args(A, maxrank, reltol, abstol,
                                     leftorthogonal, mesh)
    Aout, rowperm, colperm, k, mags, err = jax.device_get(run(*args))
    k = int(k)
    return (
        np.asarray(Aout)[:m, :n],
        np.asarray(rowperm)[:m],
        np.asarray(colperm)[:n],
        k,
        np.asarray(mags)[:k],
        float(err),
    )


def rrlu_sharded(
    A: np.ndarray,
    maxrank: int = _INTMAX,
    reltol: float = 1e-14,
    abstol: float = 0.0,
    leftorthogonal: bool = True,
    mesh: Optional[Mesh] = None,
):
    """Mesh-sharded ``rrlu``: returns the same ``rrLU`` object as the
    single-device ``ops.lu.rrlu`` (bit-identical pivot order) with the
    elimination tensor-parallel over the device mesh."""
    from .lu import _finalize

    LUmat, rowperm, colperm, k, mags, err = rrlu_sharded_raw(
        A, maxrank, reltol, abstol, leftorthogonal, mesh=mesh
    )
    return _finalize(LUmat, rowperm, colperm, k, err, leftorthogonal)
