"""Device-resident two-site sweep: all L-1 bond updates as ONE XLA program.

This is the north-star architecture of the rebuild (BASELINE.json): the
reference's sweep2site! (tensorci2.jl:1195-1258) is a host loop doing, per
bond, a Π sampling, an rrLU factorization and index-set bookkeeping. Here the
whole sweep compiles into a single jit program over padded fixed-shape pivot
buffers:

- index sets live on device as (Imax, L) int32 row buffers + length scalars;
- per bond (unrolled at trace time, shapes static) the candidate sets are
  built by broadcasting kron products, candidates from the non-strict-nesting
  history are appended *without dedup* — duplicated rows are linearly
  dependent, have zero Schur residual after one copy is pivoted, and can
  never be selected twice, so the union semantics of the reference
  (tensorci2.jl:842-843) are preserved up to tie order;
- valid rows are compacted to the front with a stable argsort so the masked
  rrLU kernel (ops/lu_kernel.py) sees a contiguous panel;
- selected pivots are gathered back into the padded buffers.

Adaptive rank growth never recompiles: rank is data (length scalars), and the
buffer capacity Imax only grows geometrically when saturated.
"""

from __future__ import annotations

from typing import Callable, List, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.fused import ci_factors, panel_solve_pinv
from ..ops.lu_kernel import _rrlu_state

MultiIndex = Tuple[int, ...]


_PANEL_ROW_CHUNK = 128


def _imax_target(current: int, needed: int) -> int:
    """Smallest buffer capacity >= needed, never below current: powers of two
    up to 32, then multiples of 32. The fine quantum matters because the
    whole-sweep program size guard is a hard edge — growing 64->96 keeps a
    workload on the engine where doubling 64->128 would overshoot the guard
    and fall back to the per-bond tier."""
    if needed <= current:
        return current
    if needed <= 32:
        t = 1 << (needed - 1).bit_length()
    else:
        t = 32 * ((needed + 31) // 32)
    return max(current, t)


def _make_shard_rows(mesh, axis: str = "batch"):
    """Sharding constraint pinning the candidate-row axis of a panel to the
    mesh's batch axis: XLA's SPMD partitioner then distributes the Π-panel
    sampling (the hot vmap over assembled index rows) across devices and
    all-gathers the small panel for the replicated rrLU elimination —
    the multi-chip layout of SURVEY.md §2.5."""
    if mesh is None:
        return None
    from jax.sharding import NamedSharding, PartitionSpec as P

    def shard_rows(x):
        spec = P(axis, *([None] * (x.ndim - 1)))
        return jax.lax.with_sharding_constraint(x, NamedSharding(mesh, spec))

    return shard_rows


def _mapped_rows(row_fn, Ic):
    """vmap over panel rows, chunked with lax.map so the (rows, cols, L)
    index-assembly intermediates stay bounded (large padded panels would
    otherwise exhaust device memory)."""
    if Ic.shape[0] <= _PANEL_ROW_CHUNK:
        return jax.vmap(row_fn)(Ic)
    return jax.lax.map(row_fn, Ic, batch_size=_PANEL_ROW_CHUNK)


def _panel(fjax, Ic, Jc, nl, nr, mI, mJ, dtype):
    """Sample the Π panel f([Ic_i[:nl], Jc_j[:nr]]) with invalid rows/cols
    masked to zero. nl/nr static; mI/mJ dynamic."""

    def one_entry(ic, jc):
        return fjax(jnp.concatenate([ic[:nl], jc[:nr]]))

    Pi = _mapped_rows(
        lambda ic: jax.vmap(lambda jc: one_entry(ic, jc))(Jc), Ic
    ).astype(dtype)
    rowsP = jnp.arange(Pi.shape[0])
    colsP = jnp.arange(Pi.shape[1])
    return jnp.where((rowsP[:, None] < mI) & (colsP[None, :] < mJ), Pi, 0)


def _make_fillsitetensors(fjax: Callable, localdims: Tuple[int, ...],
                          Imax: int, dtype, pair: bool = False):
    """All L site tensors T_b = Π₁ P^{-1} (tensorci2.jl:599-629) in one jit.

    pair=True: fjax is pair-valued; panels and solves run on f64 (re, im)
    pairs and the program returns (out_re, out_im, maxsample)."""
    L = len(localdims)
    dmax = max(localdims)
    if pair:
        from ..ops.complex_pair import panel_solve_pinv_pair

    @jax.jit
    def fill(Iset, Ilen, Jset, Jlen):
        rdtype = jnp.float64 if pair else dtype
        out = jnp.zeros((L, Imax, dmax, Imax), dtype=rdtype)
        outi = jnp.zeros((L, Imax, dmax, Imax), dtype=rdtype)
        maxsample = jnp.float64(0.0)
        for b in range(L):
            d_b = localdims[b]
            nl, nr = b, L - b - 1
            # Is = kron(Iset[b], d_b): row r = (i, s) with r = i*d + s
            kron = jnp.broadcast_to(Iset[b][:, None, :], (Imax, d_b, L))
            kron = kron.at[:, :, b].set(
                jnp.broadcast_to(
                    jnp.arange(d_b, dtype=jnp.int32)[None, :], (Imax, d_b)
                )
            )
            Is = kron.reshape(Imax * d_b, L)
            mIs = Ilen[b] * d_b
            if pair:
                P1r, P1i = _panel_pair(
                    fjax, Is, Jset[b], nl + 1, nr, mIs, Jlen[b]
                )
                maxsample = jnp.maximum(
                    maxsample, jnp.sqrt(jnp.max(P1r * P1r + P1i * P1i))
                )
                if b == L - 1:
                    out = out.at[b, :, :d_b, :1].set(
                        P1r[:, :1].reshape(Imax, d_b, 1)
                    )
                    outi = outi.at[b, :, :d_b, :1].set(
                        P1i[:, :1].reshape(Imax, d_b, 1)
                    )
                    continue
                Pr, Pi_ = _panel_pair(
                    fjax, Iset[b + 1], Jset[b], nl + 1, nr,
                    Ilen[b + 1], Jlen[b],
                )
                n = Pr.shape[0]
                ridx = jnp.arange(n)
                padmask = (ridx[:, None] >= Ilen[b + 1]) | (
                    jnp.arange(Pr.shape[1])[None, :] >= Jlen[b]
                )
                eye = jnp.eye(n, Pr.shape[1], dtype=jnp.float64)
                Pr = jnp.where(padmask, eye, Pr)
                Pi_ = jnp.where(padmask, 0.0, Pi_)
                Tr, Ti = panel_solve_pinv_pair(
                    P1r, P1i, Pr[:, :n], Pi_[:, :n], Ilen[b + 1]
                )
                out = out.at[b, :, :d_b, :].set(
                    Tr[:, :Imax].reshape(Imax, d_b, Imax)
                )
                outi = outi.at[b, :, :d_b, :].set(
                    Ti[:, :Imax].reshape(Imax, d_b, Imax)
                )
                continue
            Pi1 = _panel(fjax, Is, Jset[b], nl + 1, nr, mIs, Jlen[b], dtype)
            maxsample = jnp.maximum(maxsample, jnp.max(jnp.abs(Pi1)))
            if b == L - 1:
                # boundary: T = Π₁ reshaped; Jset[L-1] = [()] so |J| = 1
                T = Pi1[:, :1].reshape(Imax, d_b, 1)
                out = out.at[b, :, :d_b, :1].set(T)
                continue
            P = _panel(
                fjax, Iset[b + 1], Jset[b], nl + 1, nr, Ilen[b + 1], Jlen[b],
                dtype,
            )
            # pad P's off-block to identity for the solve
            n = P.shape[0]
            ridx = jnp.arange(n)
            padmask = (ridx[:, None] >= Ilen[b + 1]) | (
                jnp.arange(P.shape[1])[None, :] >= Jlen[b]
            )
            P = jnp.where(
                padmask,
                jnp.eye(n, P.shape[1], dtype=dtype),
                P,
            )
            T = panel_solve_pinv(Pi1, P[:, :n], Ilen[b + 1], dtype)
            out = out.at[b, :, :d_b, :].set(
                T[:, :Imax].reshape(Imax, d_b, Imax)
            )
        if pair:
            return out, outi, maxsample
        return out, maxsample

    return fill


def _make_sweep1site(fjax: Callable, localdims: Tuple[int, ...], Imax: int,
                     forward: bool, dtype, pair: bool = False):
    """One-site sweep (tensorci2.jl:659-725) as a single jit program,
    including the site tensors (updatetensors=True path, leftorthogonal for
    forward / rightorthogonal for backward). pair=True runs on (re, im)
    pairs and returns an extra imaginary tensor buffer."""
    L = len(localdims)
    dmax = max(localdims)
    if pair:
        from ..ops.complex_pair import ci_factors_pair, rrlu_state_pair

    @jax.jit
    def sweep(Iset, Ilen, Jset, Jlen, reltol, abstol, maxbonddim):
        rdtype = jnp.float64 if pair else dtype
        tensors = jnp.zeros((L, Imax, dmax, Imax), dtype=rdtype)
        tensorsi = jnp.zeros((L, Imax, dmax, Imax), dtype=rdtype)
        bonderrs = jnp.zeros((L - 1,), dtype=jnp.float64)
        perrs = jnp.zeros((L - 1, Imax + 1), dtype=jnp.float64)
        maxsample = jnp.float64(0.0)

        sites = range(L - 1) if forward else range(L - 1, 0, -1)
        for b in sites:
            d_b = localdims[b]
            nl, nr = b, L - b - 1
            if forward:
                # Is = kron(Iset[b], d_b); Js = Jset[b]
                kron = jnp.broadcast_to(Iset[b][:, None, :], (Imax, d_b, L))
                kron = kron.at[:, :, b].set(
                    jnp.broadcast_to(
                        jnp.arange(d_b, dtype=jnp.int32)[None, :], (Imax, d_b)
                    )
                )
                Is = kron.reshape(Imax * d_b, L)
                mIs = Ilen[b] * d_b
                Js = Jset[b]
                mJs = Jlen[b]
                if pair:
                    Pr, Pim = _panel_pair(fjax, Is, Js, nl + 1, nr, mIs, mJs)
                else:
                    Pi = _panel(fjax, Is, Js, nl + 1, nr, mIs, mJs, dtype)
            else:
                # Is = Iset[b]; Js = kron(d_b, Jset[b]) (suffix from site b)
                shifted = jnp.roll(Jset[b], 1, axis=1)
                kronJ = jnp.broadcast_to(shifted[None, :, :], (d_b, Imax, L))
                kronJ = kronJ.at[:, :, 0].set(
                    jnp.broadcast_to(
                        jnp.arange(d_b, dtype=jnp.int32)[:, None], (d_b, Imax)
                    )
                )
                Js = kronJ.reshape(d_b * Imax, L)
                mJs = Jlen[b] * d_b
                valid_kronJ = (jnp.arange(d_b * Imax) % Imax) < Jlen[b]
                orderJ = jnp.argsort(~valid_kronJ, stable=True)
                Js = Js[orderJ]
                Is = Iset[b]
                mIs = Ilen[b]
                if pair:
                    Pr, Pim = _panel_pair(fjax, Is, Js, nl, nr + 1, mIs, mJs)
                else:
                    Pi = _panel(fjax, Is, Js, nl, nr + 1, mIs, mJs, dtype)

            maxrank = jnp.minimum(
                jnp.minimum(maxbonddim, jnp.int32(Imax)),
                jnp.minimum(mIs, mJs),
            )
            if pair:
                maxsample = jnp.maximum(
                    maxsample, jnp.sqrt(jnp.max(Pr * Pr + Pim * Pim))
                )
                Ar, Ai, rowperm, colperm, k, mags, err = rrlu_state_pair(
                    Pr, Pim, mIs, mJs, maxrank, reltol, abstol, forward
                )
                lr, li, rr, ri = ci_factors_pair(
                    Ar, Ai, rowperm, colperm, k, forward
                )
            else:
                maxsample = jnp.maximum(maxsample, jnp.max(jnp.abs(Pi)))
                A, rowperm, colperm, k, mags, err = _rrlu_state(
                    Pi, mIs, mJs, maxrank, reltol, abstol,
                    leftorthogonal=forward,
                )
                left, right = ci_factors(A, rowperm, colperm, k, forward,
                                         dtype)
            err_final = jnp.where(k >= jnp.minimum(mIs, mJs), 0.0, err)

            keep = jnp.arange(Imax, dtype=jnp.int32)[:, None] < k
            if forward:
                selI = Is[rowperm[:Imax], :]
                Iset = Iset.at[b + 1].set(jnp.where(keep, selI, 0))
                Ilen = Ilen.at[b + 1].set(k)
                selJ = Js[colperm[:Imax], :]
                Jset = Jset.at[b].set(jnp.where(keep, selJ, 0))
                Jlen = Jlen.at[b].set(k)
                # T_b = left (|Is| x k) -> (Ilen[b], d, k) padded
                if pair:
                    tensors = tensors.at[b, :, :d_b, :].set(
                        lr[: Imax * d_b, :Imax].reshape(Imax, d_b, Imax)
                    )
                    tensorsi = tensorsi.at[b, :, :d_b, :].set(
                        li[: Imax * d_b, :Imax].reshape(Imax, d_b, Imax)
                    )
                else:
                    T = left[: Imax * d_b, :Imax].reshape(Imax, d_b, Imax)
                    tensors = tensors.at[b, :, :d_b, :].set(T)
                bidx = b
            else:
                selI = Is[rowperm[:Imax], :]
                Iset = Iset.at[b].set(jnp.where(keep, selI, 0))
                Ilen = Ilen.at[b].set(k)
                selJ = Js[colperm[:Imax], :]
                Jset = Jset.at[b - 1].set(jnp.where(keep, selJ, 0))
                Jlen = Jlen.at[b - 1].set(k)
                # T_b = right (k x |Js|) -> (k, d, Jlen[b]) padded; column
                # index c = s*Imax + j after the stable compaction of the
                # kron layout... compaction reorders columns, so map back:
                # right columns are in compacted order; scatter to original
                # (s, j) positions via orderJ.
                if pair:
                    Rr = jnp.zeros(
                        (Imax, d_b * Imax), dtype=rdtype
                    ).at[:, orderJ].set(rr[:Imax, :])
                    Ri = jnp.zeros(
                        (Imax, d_b * Imax), dtype=rdtype
                    ).at[:, orderJ].set(ri[:Imax, :])
                    tensors = tensors.at[b, :, :d_b, :].set(
                        Rr.reshape(Imax, d_b, Imax)
                    )
                    tensorsi = tensorsi.at[b, :, :d_b, :].set(
                        Ri.reshape(Imax, d_b, Imax)
                    )
                else:
                    Rfull = jnp.zeros(
                        (Imax, d_b * Imax), dtype=dtype
                    ).at[:, orderJ].set(right[:Imax, :])
                    T = Rfull.reshape(Imax, d_b, Imax)
                    tensors = tensors.at[b, :, :d_b, :].set(T)
                bidx = b - 1
            bonderrs = bonderrs.at[bidx].set(err_final)
            pv = jnp.where(
                jnp.arange(Imax + 1) < k,
                jnp.concatenate([mags[:Imax], jnp.zeros(1)]),
                0.0,
            )
            pv = pv.at[k].set(err_final)
            perrs = perrs.at[bidx].set(pv)

        # final boundary tensor
        last = L - 1 if forward else 0
        d_l = localdims[last]
        nl, nr = last, L - last - 1
        kron = jnp.broadcast_to(Iset[last][:, None, :], (Imax, d_l, L))
        kron = kron.at[:, :, last].set(
            jnp.broadcast_to(
                jnp.arange(d_l, dtype=jnp.int32)[None, :], (Imax, d_l)
            )
        )
        Is = kron.reshape(Imax * d_l, L)
        if pair:
            P1r, P1i = _panel_pair(
                fjax, Is, Jset[last], nl + 1, nr,
                Ilen[last] * d_l, Jlen[last],
            )
            maxsample = jnp.maximum(
                maxsample, jnp.sqrt(jnp.max(P1r * P1r + P1i * P1i))
            )
            tensors = tensors.at[last, :, :d_l, :].set(
                P1r[:, :Imax].reshape(Imax, d_l, Imax)
            )
            tensorsi = tensorsi.at[last, :, :d_l, :].set(
                P1i[:, :Imax].reshape(Imax, d_l, Imax)
            )
            return (Iset, Ilen, Jset, Jlen, tensors, tensorsi, bonderrs,
                    perrs, maxsample)
        Pi1 = _panel(
            fjax, Is, Jset[last], nl + 1, nr, Ilen[last] * d_l, Jlen[last],
            dtype,
        )
        maxsample = jnp.maximum(maxsample, jnp.max(jnp.abs(Pi1)))
        T = Pi1[:, :Imax].reshape(Imax, d_l, Imax)
        tensors = tensors.at[last, :, :d_l, :].set(T)

        return (Iset, Ilen, Jset, Jlen, tensors, bonderrs, perrs, maxsample)

    return sweep


def _match_positions(prev, prev_len, cand, cand_count, n_slots: int):
    """Device lookup of each `prev` row inside the candidate buffer `cand`
    (equality over the first `n_slots` index slots; first occurrence wins).

    Returns (pos, found): pos[r] is the candidate position of prev[r] (0 when
    absent), found[r] marks rows that are present AND within prev_len. This
    replaces the host-side dict lookups of the per-bond rook tier
    (tensorci2.py updatepivots) so pivot-continuation stays on device."""
    eq = jnp.all(
        prev[:, None, :n_slots] == cand[None, :, :n_slots], axis=-1
    )
    eq = eq & (jnp.arange(cand.shape[0])[None, :] < cand_count)
    found = jnp.any(eq, axis=1) & (jnp.arange(prev.shape[0]) < prev_len)
    pos = jnp.argmax(eq, axis=1).astype(jnp.int32)
    return pos, found


def _fill_random(sel, nsel, mvalid, ncand: int, key, Imax: int):
    """Extend the position list sel[:nsel] (positions into a candidate buffer
    of static length ncand, of which mvalid are valid) with a random subset of
    the other valid positions, to width min(mvalid, Imax).

    Plays the role of arrlu's pushrandomsubset! + outer widening loop
    (matrixlu.jl:492-569): because the resulting slab is at least maxrank
    wide, one rook round subsumes the reference's widen-and-retry rounds —
    a full-rank slab always means the maxrank cap was hit, which is a
    terminal state in the reference too."""
    insel = (
        jnp.zeros((ncand,), dtype=jnp.int32)
        .at[sel]
        .max((jnp.arange(sel.shape[0]) < nsel).astype(jnp.int32))
        > 0
    )
    pri = jax.random.uniform(key, (ncand,))
    pri = jnp.where(insel | (jnp.arange(ncand) >= mvalid), 2.0, pri)
    fill = jnp.argsort(pri).astype(jnp.int32)
    nfill = mvalid - nsel
    cand = jnp.concatenate([sel, fill])
    validc = jnp.concatenate(
        [jnp.arange(sel.shape[0]) < nsel, jnp.arange(ncand) < nfill]
    )
    out = cand[jnp.argsort(~validc, stable=True)][:Imax]
    return out, jnp.minimum(mvalid, Imax).astype(jnp.int32)


def _panel_pair(fjax_pair, Ic, Jc, nl, nr, mI, mJ):
    """Pair-valued panel: (Pr, Pi) f64 with invalid entries zeroed."""

    def one_entry(ic, jc):
        return fjax_pair(jnp.concatenate([ic[:nl], jc[:nr]]))

    panel = _mapped_rows(
        lambda ic: jax.vmap(lambda jc: one_entry(ic, jc))(Jc), Ic
    )
    rowsP = jnp.arange(panel.shape[0])
    colsP = jnp.arange(panel.shape[1])
    valid = (rowsP[:, None] < mI) & (colsP[None, :] < mJ)
    Pr = jnp.where(valid, panel[..., 0].astype(jnp.float64), 0.0)
    Pi_ = jnp.where(valid, panel[..., 1].astype(jnp.float64), 0.0)
    return Pr, Pi_


def _tt_search_on_cores(fjax, localdims, Imax, dtype, pair,
                        cores, coresi, Ilen, Jlen, starts,
                        shard_rows=None):
    """Global-pivot candidate search against a just-filled padded core
    stack, traceable inside a sweep program.

    Evaluates |f - tt| on every single-coordinate variant of each start
    point — exactly DefaultGlobalPivotFinder's candidate set
    (globalpivotfinder.jl:217-252) — and returns, per start, the FIRST
    maximum in (leg, value) iteration order:

      (best_flat (S,) int32, best_err (S,) f64)

    where best_flat = leg * dmax + value. The tt is evaluated directly on
    the fill program's padded cores (L, Imax, dmax, Imax): rows beyond
    |Iset[b]| and columns beyond the true right bond hold garbage f
    samples from padding, so the carried state vector is re-masked to the
    true right bond length after every site (the zero left components then
    annihilate garbage rows at the next site). Local-index selection is a
    one-hot contraction, not a gather. pair=True carries the complex tt as
    (re, im) f64 pairs and uses |.| = hypot, matching numpy complex abs."""
    L = len(localdims)
    dmax = max(localdims)
    dims_arr = jnp.asarray(localdims, dtype=jnp.int32)
    S = starts.shape[0]
    vgrid = jnp.arange(dmax, dtype=jnp.int32)
    # cand[s, p, v, q] = starts[s, q] except leg q == p carries value v
    # (clamped to the leg's local dim; clamped duplicates are masked out of
    # the argmax below, so they never affect the result)
    legsel = jnp.eye(L, dtype=bool)[None, :, None, :]
    vclamped = jnp.minimum(vgrid[None, :], dims_arr[:, None] - 1)
    cand = jnp.where(
        legsel, vclamped[None, :, :, None], starts[:, None, None, :]
    )
    rows = cand.reshape(S * L * dmax, L).astype(jnp.int32)
    if shard_rows is not None:
        # distribute the candidate rows (the f sampling + TT contraction
        # hot axis) over the mesh's batch axis; the (S,) argmax reduction
        # below is then an XLA cross-device reduce
        rows = shard_rows(rows)
    N = rows.shape[0]

    # right bond length per site: |Iset[b+1]| for b < L-1, |Jset[L-1]| (=1)
    # for the last site (see _store_sitetensors)
    lens_r = jnp.concatenate([Ilen[1:], Jlen[-1:]])
    col = jnp.arange(Imax)

    if pair:
        pv = _mapped_rows(fjax, rows)
        fr = pv[..., 0].astype(jnp.float64)
        fi = pv[..., 1].astype(jnp.float64)
        vr0 = jnp.zeros((N, Imax), jnp.float64).at[:, 0].set(1.0)
        vi0 = jnp.zeros((N, Imax), jnp.float64)

        def body(carry, inp):
            vr, vi = carry
            cr, ci, x, nr = inp
            oh = (x[:, None] == vgrid[None, :]).astype(jnp.float64)
            Mr = jnp.einsum("idj,nd->nij", cr, oh)
            Mi = jnp.einsum("idj,nd->nij", ci, oh)
            nvr = (jnp.einsum("ni,nij->nj", vr, Mr)
                   - jnp.einsum("ni,nij->nj", vi, Mi))
            nvi = (jnp.einsum("ni,nij->nj", vr, Mi)
                   + jnp.einsum("ni,nij->nj", vi, Mr))
            m = col[None, :] < nr
            return (jnp.where(m, nvr, 0.0), jnp.where(m, nvi, 0.0)), None

        (vr, vi), _ = jax.lax.scan(
            body, (vr0, vi0), (cores, coresi, rows.T, lens_r)
        )
        err = jnp.sqrt((fr - vr[:, 0]) ** 2 + (fi - vi[:, 0]) ** 2)
    else:
        fv = _mapped_rows(fjax, rows).astype(dtype)
        v0 = jnp.zeros((N, Imax), dtype).at[:, 0].set(1.0)

        def body(v, inp):
            core, x, nr = inp
            oh = (x[:, None] == vgrid[None, :]).astype(dtype)
            M = jnp.einsum("idj,nd->nij", core, oh)
            v = jnp.einsum("ni,nij->nj", v, M)
            return jnp.where(col[None, :] < nr, v, 0), None

        v, _ = jax.lax.scan(body, v0, (cores, rows.T, lens_r))
        err = jnp.abs(fv - v[:, 0]).astype(jnp.float64)

    err = err.reshape(S, L, dmax)
    valid = vgrid[None, None, :] < dims_arr[None, :, None]
    flat = jnp.where(valid, err, -jnp.inf).reshape(S, L * dmax)
    return jnp.argmax(flat, axis=1).astype(jnp.int32), jnp.max(flat, axis=1)


def _make_floatingzone(fjax, localdims, chi: int, S: int, dtype,
                       pair: bool = False, shard_rows=None):
    """Whole floating-zone coordinate search (globalsearch.jl:119-186) as
    ONE device program: a lax.while_loop over sweeps of a lax.scan over
    legs, all S starts in lock-step.

    Per leg, every start's d_leg single-coordinate variants evaluate as
    one f vmap and one padded-core TT contraction (one-hot local-index
    selection — no gathers); the per-start first-max update and the
    host's active/stop bookkeeping (_floatingzone_batch semantics: a
    start freezes when a full sweep leaves its running max unchanged)
    are mask arithmetic. Cores are ZERO-padded (models/jaxeval.pad_cores
    layout, boundaries embedded at index 0), so no validity masking of
    the carried state is needed. pair=True takes (re, im) core stacks
    and a pair-valued fjax.

    Returns (pivots (S, L) int32, maxerr (S,) f64, nsweeps int32)."""
    L = len(localdims)
    dmax = max(localdims)
    dims_arr = jnp.asarray(localdims, dtype=jnp.int32)
    vgrid = jnp.arange(dmax, dtype=jnp.int32)

    def tt_eval(cores, rows):
        N = rows.shape[0]
        v = jnp.zeros((N, chi), cores.dtype).at[:, 0].set(1.0)

        def b(v, inp):
            core, x = inp
            oh = (x[:, None] == vgrid[None, :]).astype(core.dtype)
            M = jnp.einsum("idj,nd->nij", core, oh)
            return jnp.einsum("ni,nij->nj", v, M), None

        v, _ = jax.lax.scan(b, v, (cores, rows.T))
        return v[:, 0]

    def tt_eval_pair(cr, ci, rows):
        N = rows.shape[0]
        vr = jnp.zeros((N, chi), jnp.float64).at[:, 0].set(1.0)
        vi = jnp.zeros((N, chi), jnp.float64)

        def b(carry, inp):
            vr, vi = carry
            corer, corei, x = inp
            oh = (x[:, None] == vgrid[None, :]).astype(jnp.float64)
            Mr = jnp.einsum("idj,nd->nij", corer, oh)
            Mi = jnp.einsum("idj,nd->nij", corei, oh)
            nvr = (jnp.einsum("ni,nij->nj", vr, Mr)
                   - jnp.einsum("ni,nij->nj", vi, Mi))
            nvi = (jnp.einsum("ni,nij->nj", vr, Mi)
                   + jnp.einsum("ni,nij->nj", vi, Mr))
            return (nvr, nvi), None

        (vr, vi), _ = jax.lax.scan(b, (vr, vi), (cr, ci, rows.T))
        return vr[:, 0], vi[:, 0]

    def abs_err(rows, *cores_args):
        if shard_rows is not None:
            # mesh-distribute the candidate rows: per leg round this is
            # S*dmax f evaluations + TT contractions, data-parallel over
            # the batch axis exactly like the sweep programs' Π panels
            rows = shard_rows(rows)
        if pair:
            pv = _mapped_rows(fjax, rows)
            tr, ti = tt_eval_pair(cores_args[0], cores_args[1], rows)
            return jnp.sqrt(
                (pv[..., 0].astype(jnp.float64) - tr) ** 2
                + (pv[..., 1].astype(jnp.float64) - ti) ** 2
            )
        fv = _mapped_rows(fjax, rows).astype(dtype)
        return jnp.abs(fv - tt_eval(cores_args[0], rows)).astype(jnp.float64)

    @jax.jit
    def fz(starts, nsweeps_cap, earlystoptol, *cores_args):
        pivots = starts.astype(jnp.int32)
        maxerr = abs_err(pivots, *cores_args)
        active = jnp.ones((S,), dtype=bool)

        def cond(c):
            k, pivots, maxerr, active = c
            return jnp.any(active) & (k < nsweeps_cap)

        def sweep(c):
            k, pivots, maxerr, active = c
            prev = maxerr

            def leg(carry, ipos):
                pivots, maxerr = carry
                d_i = dims_arr[ipos]
                legsel = jnp.arange(L) == ipos
                vclamp = jnp.minimum(vgrid, d_i - 1)
                cand = jnp.where(
                    legsel[None, None, :], vclamp[None, :, None],
                    pivots[:, None, :],
                )
                err = abs_err(
                    cand.reshape(S * dmax, L), *cores_args
                ).reshape(S, dmax)
                err = jnp.where(vgrid[None, :] < d_i, err, -jnp.inf)
                best = jnp.argmax(err, axis=1).astype(jnp.int32)
                newmax = jnp.maximum(maxerr, jnp.max(err, axis=1))
                pivots = jnp.where(
                    active[:, None] & legsel[None, :], best[:, None], pivots
                )
                maxerr = jnp.where(active, newmax, maxerr)
                return (pivots, maxerr), None

            (pivots, maxerr), _ = jax.lax.scan(
                leg, (pivots, maxerr), jnp.arange(L)
            )
            done = (maxerr == prev) | (maxerr > earlystoptol)
            return (k + 1, pivots, maxerr, active & ~done)

        k, pivots, maxerr, _ = jax.lax.while_loop(
            cond, sweep, (jnp.int32(0), pivots, maxerr, active)
        )
        return pivots, maxerr, k

    return fz


def _bond_writeback(Iset, Ilen, Jset, Jlen, bonderrs, perrs, b, Ic, Jc,
                    rowsel, colsel, k, mags, err_final, Imax: int):
    """Write one bond's selected pivots and error bookkeeping back into the
    sweep state (shared by all four sweep builders): Iset[b+1]/Jset[b] get
    the first k candidate rows/cols (zero-padded), bonderrs[b] the residual,
    perrs[b] the pivot-magnitude series with the residual appended at
    position k (reference pivoterrors, matrixlu.jl:799-801)."""
    selI = Ic[rowsel[:Imax], :]
    keep = jnp.arange(Imax, dtype=jnp.int32)[:, None] < k
    Iset = Iset.at[b + 1].set(jnp.where(keep, selI, 0))
    Ilen = Ilen.at[b + 1].set(k)
    selJ = Jc[colsel[:Imax], :]
    Jset = Jset.at[b].set(jnp.where(keep, selJ, 0))
    Jlen = Jlen.at[b].set(k)

    bonderrs = bonderrs.at[b].set(err_final)
    pv = jnp.where(
        jnp.arange(Imax + 1) < k,
        jnp.concatenate([mags[:Imax], jnp.zeros(1)]),
        0.0,
    )
    pv = pv.at[k].set(err_final)
    perrs = perrs.at[b].set(pv)
    return Iset, Ilen, Jset, Jlen, bonderrs, perrs


def _rook_alternate(col_slab, row_slab, I0, I0len, J0, J0len, Imax: int,
                    numrookiter: int, forward: bool):
    """Alternating rook slab elimination under lax.while_loop, shared by the
    unrolled and scan rook sweep builders. col_slab/row_slab take
    (I0, I0len, J0, J0len) and return
    (newI, newIlen, newJ, newJlen, k, mags[:Imax], err, smin, maxsample,
    nevals) — the builders supply the panel machinery, this supplies the
    alternation, self-consistency stop and residual bookkeeping.

    Residual rule: once the pivot sets self-consist, the final slab has
    width exactly k and reports residual 0 (k >= smin) even though the
    matrix is not exactly rank k. Keep the residual of the last WIDE slab
    (k < smin) — the magnitude of its first rejected pivot — as the bond
    error, which is what the reference's wider final slabs report.

    Returns (I0f, J0f, k, mags, err_final, maxsample, nevals)."""

    def rook_body(st):
        (I0_, I0len_, J0_, J0len_, k_, mags_, err_, errw_, smin_,
         it_, done_, ms_, ne_) = st
        rookiter = it_ + 1
        # matrixlu.jl rook alternation: for leftorthogonal the first
        # move factorizes the column slab A[:, J0]
        colmove = ((rookiter % 2) == 0) == forward
        out = jax.lax.cond(
            colmove, row_slab, col_slab,
            (I0_, I0len_, J0_, J0len_),
        )
        (nI_, nIlen, nJ_, nJlen, k2, mags2, err2, smin2, ms2,
         ne2) = out
        errw2 = jnp.where(k2 < smin2, err2, errw_)
        idx = jnp.arange(Imax)
        sameI = (nIlen == I0len_) & jnp.all(
            (idx >= nIlen) | (nI_ == I0_)
        )
        sameJ = (nJlen == J0len_) & jnp.all(
            (idx >= nJlen) | (nJ_ == J0_)
        )
        return (nI_, nIlen, nJ_, nJlen, k2, mags2, err2, errw2,
                smin2, it_ + 1, sameI & sameJ,
                jnp.maximum(ms_, ms2), ne_ + ne2)

    def rook_cond(st):
        return (~st[10]) & (st[9] < numrookiter)

    st0 = (
        I0, I0len, J0, J0len, jnp.int32(0),
        jnp.zeros((Imax,), dtype=jnp.float64),
        jnp.float64(jnp.nan), jnp.float64(jnp.nan), jnp.int32(0),
        jnp.int32(0), False, jnp.float64(0.0), jnp.float64(0.0),
    )
    st = jax.lax.while_loop(rook_cond, rook_body, st0)
    (I0f, _, J0f, _, k, mags, err, errw, smin, _, _, ms, ne) = st
    err_final = jnp.where(
        jnp.isnan(errw), jnp.where(k >= smin, 0.0, err), errw
    )
    return I0f, J0f, k, mags, err_final, ms, ne


def _make_sweep(fjax: Callable, localdims: Tuple[int, ...], Imax: int,
                forward: bool, dtype, pair: bool = False, shard_rows=None):
    """Trace one full 2-site sweep (forward or backward) into a jit program.

    pair=True: fjax is pair-valued (returns stacked (re, im)); panels and the
    elimination run on f64 pairs (ops/complex_pair.py).

    shard_rows: optional sharding constraint (from _make_shard_rows) pinning
    the candidate-row axis to a mesh axis — the Π sampling then runs
    data-parallel over the mesh."""
    L = len(localdims)
    if pair:
        from ..ops.complex_pair import rrlu_state_pair

    @jax.jit
    def sweep(Iset, Ilen, Jset, Jlen, extraI, extraIlen, extraJ, extraJlen,
              reltol, abstol, maxbonddim):
        bonderrs = jnp.zeros((L - 1,), dtype=jnp.float64)
        perrs = jnp.zeros((L - 1, Imax + 1), dtype=jnp.float64)
        maxsample = jnp.float64(0.0)

        bonds = range(L - 1) if forward else range(L - 2, -1, -1)
        for b in bonds:
            d_b = localdims[b]
            d_b1 = localdims[b + 1]

            # --- Icombined: kron(Iset[b], d_b) ++ extraI[b+1] --------------
            kron = jnp.broadcast_to(
                Iset[b][:, None, :], (Imax, d_b, L)
            )
            kron = kron.at[:, :, b].set(
                jnp.broadcast_to(jnp.arange(d_b, dtype=jnp.int32)[None, :],
                                 (Imax, d_b))
            )
            kron = kron.reshape(Imax * d_b, L)
            valid_kron = (
                jnp.arange(Imax * d_b) // d_b
            ) < Ilen[b]
            Ic_all = jnp.concatenate([kron, extraI[b + 1]], axis=0)
            validI = jnp.concatenate(
                [valid_kron, jnp.arange(Imax) < extraIlen[b + 1]]
            )
            orderI = jnp.argsort(~validI, stable=True)
            Ic = Ic_all[orderI]
            if shard_rows is not None:
                Ic = shard_rows(Ic)
            mI = jnp.sum(validI).astype(jnp.int32)

            # --- Jcombined: kron(d_{b+1}, Jset[b+1]) ++ extraJ[b] ----------
            # suffix rows of site b+1 start at site b+2; prepend s at slot 0
            # by shifting right one position (suffix length <= L-2, so the
            # last slot is always padding).
            shifted = jnp.roll(Jset[b + 1], 1, axis=1)
            kronJ = jnp.broadcast_to(
                shifted[None, :, :], (d_b1, Imax, L)
            )
            kronJ = kronJ.at[:, :, 0].set(
                jnp.broadcast_to(jnp.arange(d_b1, dtype=jnp.int32)[:, None],
                                 (d_b1, Imax))
            )
            kronJ = kronJ.reshape(d_b1 * Imax, L)
            valid_kronJ = (
                jnp.arange(d_b1 * Imax) % Imax
            ) < Jlen[b + 1]
            Jc_all = jnp.concatenate([kronJ, extraJ[b]], axis=0)
            validJ = jnp.concatenate(
                [valid_kronJ, jnp.arange(Imax) < extraJlen[b]]
            )
            orderJ = jnp.argsort(~validJ, stable=True)
            Jc = Jc_all[orderJ]
            mJ = jnp.sum(validJ).astype(jnp.int32)

            # --- Π panel + rrLU ---------------------------------------------
            nl = b + 1  # prefix length of Icombined rows
            nr = L - b - 1  # suffix length of Jcombined rows
            maxrank = jnp.minimum(
                jnp.minimum(maxbonddim, jnp.int32(Imax)),
                jnp.minimum(mI, mJ),
            )
            if pair:
                Pr, Pim = _panel_pair(fjax, Ic, Jc, nl, nr, mI, mJ)
                maxsample = jnp.maximum(
                    maxsample, jnp.sqrt(jnp.max(Pr * Pr + Pim * Pim))
                )
                _, _, rowperm, colperm, k, mags, err = rrlu_state_pair(
                    Pr, Pim, mI, mJ, maxrank, reltol, abstol, forward
                )
            else:
                Pi = _panel(fjax, Ic, Jc, nl, nr, mI, mJ, dtype)
                maxsample = jnp.maximum(maxsample, jnp.max(jnp.abs(Pi)))
                A, rowperm, colperm, k, mags, err = _rrlu_state(
                    Pi, mI, mJ, maxrank, reltol, abstol,
                    leftorthogonal=forward,
                )
            err_final = jnp.where(k >= jnp.minimum(mI, mJ), 0.0, err)

            Iset, Ilen, Jset, Jlen, bonderrs, perrs = _bond_writeback(
                Iset, Ilen, Jset, Jlen, bonderrs, perrs, b, Ic, Jc,
                rowperm, colperm, k, mags, err_final, Imax,
            )

        return Iset, Ilen, Jset, Jlen, bonderrs, perrs, maxsample

    return sweep


def _make_sweep_rook(fjax: Callable, localdims: Tuple[int, ...], Imax: int,
                     forward: bool, dtype, numrookiter: int = 5,
                     shard_rows=None):
    """UNROLLED whole-sweep ROOK program: all L-1 bond updates of a 2-site
    rook sweep as ONE XLA dispatch, with exact per-bond panel shapes.

    NOT a production path: the engine always dispatches the scan body
    (_make_sweep_rook_scan), whose compile time is flat in chain length and
    panel edge where this unrolled body's grows superlinearly in both.
    Kept as the independent BIT-PARITY ORACLE for the scan body
    (tests/test_device_sweep.py::test_rook_scan_matches_unrolled): the two
    trace the same slab alternation through different program structures,
    so agreement is a strong check on the scan body's dmax padding and
    masks.

    The reference's rook search (arrlu, matrixlu.jl:492-569) exists to save
    samples: instead of the full |I|d x d|J| panel it factorizes alternating
    row/column slabs until the pivot sets are self-consistent. The per-bond
    device tier (ops/lu_device.py) preserved that control flow but paid one
    dispatch per slab. Here the slab
    alternation itself is traced INTO the sweep program:

    - previous pivots are located in the candidate buffers by a device
      equality match (_match_positions) — no host dict lookups;
    - the column (row) start set is widened to the buffer capacity with
      random candidates (_fill_random); since the slab is then at least
      maxrank wide, the reference's outer widen-and-retry loop collapses
      into a single round;
    - the alternating slab eliminations run under lax.while_loop with the
      self-consistency stop as the loop condition, so converged bonds pay
      for exactly the slabs they use (a col slab costs |Ic| x Imax samples,
      a row slab Imax x |Jc| — a factor ~(dmax+1)/rounds fewer than full);
    - the final slab's pivot order, magnitudes and residual are written back
      exactly like the full-search path.

    Per-slab eliminations use the same complete-pivot kernel (stop rule,
    first-max tie-break) as everywhere else, so tolerance semantics match
    the host arrlu.
    """
    L = len(localdims)

    @jax.jit
    def sweep(Iset, Ilen, Jset, Jlen, extraI, extraIlen, extraJ, extraJlen,
              reltol, abstol, maxbonddim, seed):
        bonderrs = jnp.zeros((L - 1,), dtype=jnp.float64)
        perrs = jnp.zeros((L - 1, Imax + 1), dtype=jnp.float64)
        maxsample = jnp.float64(0.0)
        nevals = jnp.float64(0.0)
        base_key = jax.random.PRNGKey(seed)

        bonds = range(L - 1) if forward else range(L - 2, -1, -1)
        for b in bonds:
            d_b = localdims[b]
            d_b1 = localdims[b + 1]
            nl = b + 1
            nr = L - b - 1

            # --- candidate sets (identical to _make_sweep) -----------------
            kron = jnp.broadcast_to(Iset[b][:, None, :], (Imax, d_b, L))
            kron = kron.at[:, :, b].set(
                jnp.broadcast_to(jnp.arange(d_b, dtype=jnp.int32)[None, :],
                                 (Imax, d_b))
            )
            kron = kron.reshape(Imax * d_b, L)
            valid_kron = (jnp.arange(Imax * d_b) // d_b) < Ilen[b]
            Ic_all = jnp.concatenate([kron, extraI[b + 1]], axis=0)
            validI = jnp.concatenate(
                [valid_kron, jnp.arange(Imax) < extraIlen[b + 1]]
            )
            orderI = jnp.argsort(~validI, stable=True)
            Ic = Ic_all[orderI]
            if shard_rows is not None:
                Ic = shard_rows(Ic)
            mI = jnp.sum(validI).astype(jnp.int32)

            shifted = jnp.roll(Jset[b + 1], 1, axis=1)
            kronJ = jnp.broadcast_to(shifted[None, :, :], (d_b1, Imax, L))
            kronJ = kronJ.at[:, :, 0].set(
                jnp.broadcast_to(jnp.arange(d_b1, dtype=jnp.int32)[:, None],
                                 (d_b1, Imax))
            )
            kronJ = kronJ.reshape(d_b1 * Imax, L)
            valid_kronJ = (jnp.arange(d_b1 * Imax) % Imax) < Jlen[b + 1]
            Jc_all = jnp.concatenate([kronJ, extraJ[b]], axis=0)
            validJ = jnp.concatenate(
                [valid_kronJ, jnp.arange(Imax) < extraJlen[b]]
            )
            orderJ = jnp.argsort(~validJ, stable=True)
            Jc = Jc_all[orderJ]
            mJ = jnp.sum(validJ).astype(jnp.int32)
            Icap = Ic.shape[0]
            Jcap = Jc.shape[0]

            # --- pivot continuation: locate current pivots in the buffers --
            posI, foundI = _match_positions(Iset[b + 1], Ilen[b + 1], Ic, mI,
                                            nl)
            ordI = jnp.argsort(~foundI, stable=True)
            I0m = posI[ordI].astype(jnp.int32)
            nmI = jnp.sum(foundI).astype(jnp.int32)

            posJ, foundJ = _match_positions(Jset[b], Jlen[b], Jc, mJ, nr)
            ordJ = jnp.argsort(~foundJ, stable=True)
            J0m = posJ[ordJ].astype(jnp.int32)
            nmJ = jnp.sum(foundJ).astype(jnp.int32)

            key_b = jax.random.fold_in(base_key, b)
            if forward:
                # leftorthogonal: widen the column start set (arrlu widens J0)
                J0, J0len = _fill_random(J0m, nmJ, mJ, Jcap, key_b, Imax)
                I0, I0len = I0m, nmI
            else:
                I0, I0len = _fill_random(I0m, nmI, mI, Icap, key_b, Imax)
                J0, J0len = J0m, nmJ

            maxrank_bond = jnp.minimum(
                jnp.minimum(maxbonddim, jnp.int32(Imax)),
                jnp.minimum(mI, mJ),
            )

            def col_slab(st, _Ic=Ic, _Jc=Jc, _nl=nl, _nr=nr, _mI=mI,
                         _maxrank=maxrank_bond):
                """Factorize A[:, J0]: all candidate rows x selected cols."""
                I0_, I0len_, J0_, J0len_ = st
                Jsel = _Jc[J0_]
                Pi = _panel(fjax, _Ic, Jsel, _nl, _nr, _mI, J0len_, dtype)
                mr = jnp.minimum(_maxrank, J0len_)
                _, rp, cp, k, mags, err = _rrlu_state(
                    Pi, _mI, J0len_, mr, reltol, abstol,
                    leftorthogonal=forward,
                )
                newI = rp[:Imax].astype(jnp.int32)
                newJ = J0_[cp[:Imax]].astype(jnp.int32)
                smin = jnp.minimum(_mI, J0len_)
                return (newI, k, newJ, k, k, mags[:Imax], err, smin,
                        jnp.max(jnp.abs(Pi)),
                        jnp.float64(_Ic.shape[0] * Imax))

            def row_slab(st, _Ic=Ic, _Jc=Jc, _nl=nl, _nr=nr, _mJ=mJ,
                         _maxrank=maxrank_bond):
                """Factorize A[I0, :]: selected rows x all candidate cols."""
                I0_, I0len_, J0_, J0len_ = st
                Isel = _Ic[I0_]
                Pi = _panel(fjax, Isel, _Jc, _nl, _nr, I0len_, _mJ, dtype)
                mr = jnp.minimum(_maxrank, I0len_)
                _, rp, cp, k, mags, err = _rrlu_state(
                    Pi, I0len_, _mJ, mr, reltol, abstol,
                    leftorthogonal=forward,
                )
                newI = I0_[rp[:Imax]].astype(jnp.int32)
                newJ = cp[:Imax].astype(jnp.int32)
                smin = jnp.minimum(I0len_, _mJ)
                return (newI, k, newJ, k, k, mags[:Imax], err, smin,
                        jnp.max(jnp.abs(Pi)),
                        jnp.float64(Imax * _Jc.shape[0]))

            I0f, J0f, k, mags, err_final, ms, ne = _rook_alternate(
                col_slab, row_slab, I0, I0len, J0, J0len, Imax,
                numrookiter, forward,
            )

            Iset, Ilen, Jset, Jlen, bonderrs, perrs = _bond_writeback(
                Iset, Ilen, Jset, Jlen, bonderrs, perrs, b, Ic, Jc,
                I0f, J0f, k, mags, err_final, Imax,
            )
            maxsample = jnp.maximum(maxsample, ms)
            nevals = nevals + ne

        return Iset, Ilen, Jset, Jlen, bonderrs, perrs, maxsample, nevals

    return sweep


def _make_sweep_rook_scan(fjax: Callable, localdims: Tuple[int, ...],
                          Imax: int, forward: bool, dtype,
                          numrookiter: int = 5, shard_rows=None,
                          pair: bool = False):
    """Scan-based whole-sweep ROOK program: one traced bond body (slab
    alternation included) + lax.scan over bonds.

    Same semantics as _make_sweep_rook (slab machinery documented there);
    compile time is constant in the chain length L instead of linear —
    the unrolled rook's compile is the binding constraint at scale (d=15
    L=10: 348 s at panel edge 512, never finished at 1536). Bond-dependent
    quantities (candidate assembly, panel prefix length, pivot
    continuation) follow the dynamic-b patterns of _make_sweep_scan:
    `_kron_is_scan` one-hot writes, `_panel_dyn` rolled suffixes, and
    full-slot `_match_positions` (rows are zero-padded beyond their
    prefix/suffix, so comparing all L slots is exact).

    pair=True: fjax is pair-valued (complex as (re, im) f64, for backends
    without complex128); slab panels and eliminations run on
    ops.complex_pair.rrlu_state_pair, magnitudes via hypot. The rook
    index bookkeeping is dtype-free, so the outputs are identical in
    layout to the real case."""
    L = len(localdims)
    dmax = max(localdims)
    dims_arr = jnp.asarray(localdims, dtype=jnp.int32)
    if pair:
        from ..ops.complex_pair import rrlu_state_pair

    def bond_update(carry, b):
        (Iset, Ilen, Jset, Jlen, extraI, extraIlen, extraJ, extraJlen,
         bonderrs, perrs, maxsample, nevals, reltol, abstol, maxbonddim,
         base_key) = carry

        d_b = dims_arr[b]
        d_b1 = dims_arr[b + 1]
        pos = jnp.arange(L, dtype=jnp.int32)
        nl = b + 1

        # --- candidate sets (identical to _make_sweep_scan) ----------------
        kron = _kron_is_scan(Iset[b], b, Imax, dmax, L)
        ridk = jnp.arange(Imax * dmax)
        valid_kron = ((ridk // dmax) < Ilen[b]) & ((ridk % dmax) < d_b)
        Ic_all = jnp.concatenate([kron, extraI[b + 1]], axis=0)
        validI = jnp.concatenate(
            [valid_kron, jnp.arange(Imax) < extraIlen[b + 1]]
        )
        orderI = jnp.argsort(~validI, stable=True)
        Ic = Ic_all[orderI]
        if shard_rows is not None:
            Ic = shard_rows(Ic)
        mI = jnp.sum(validI).astype(jnp.int32)

        shifted = jnp.roll(Jset[b + 1], 1, axis=1)
        kronJ = jnp.broadcast_to(shifted[None, :, :], (dmax, Imax, L))
        svalsJ = jnp.broadcast_to(
            jnp.arange(dmax, dtype=jnp.int32)[:, None], (dmax, Imax)
        )
        kronJ = jnp.where((pos[None, None, :] == 0), svalsJ[:, :, None],
                          kronJ)
        kronJ = kronJ.reshape(dmax * Imax, L)
        ridj = jnp.arange(dmax * Imax)
        valid_kronJ = ((ridj % Imax) < Jlen[b + 1]) & ((ridj // Imax) < d_b1)
        Jc_all = jnp.concatenate([kronJ, extraJ[b]], axis=0)
        validJ = jnp.concatenate(
            [valid_kronJ, jnp.arange(Imax) < extraJlen[b]]
        )
        orderJ = jnp.argsort(~validJ, stable=True)
        Jc = Jc_all[orderJ]
        mJ = jnp.sum(validJ).astype(jnp.int32)
        Icap = Ic.shape[0]
        Jcap = Jc.shape[0]

        # --- pivot continuation (full-slot equality match) -----------------
        posI, foundI = _match_positions(Iset[b + 1], Ilen[b + 1], Ic, mI, L)
        ordI = jnp.argsort(~foundI, stable=True)
        I0m = posI[ordI].astype(jnp.int32)
        nmI = jnp.sum(foundI).astype(jnp.int32)

        posJ, foundJ = _match_positions(Jset[b], Jlen[b], Jc, mJ, L)
        ordJ = jnp.argsort(~foundJ, stable=True)
        J0m = posJ[ordJ].astype(jnp.int32)
        nmJ = jnp.sum(foundJ).astype(jnp.int32)

        key_b = jax.random.fold_in(base_key, b)
        if forward:
            J0, J0len = _fill_random(J0m, nmJ, mJ, Jcap, key_b, Imax)
            I0, I0len = I0m, nmI
        else:
            I0, I0len = _fill_random(I0m, nmI, mI, Icap, key_b, Imax)
            J0, J0len = J0m, nmJ

        maxrank_bond = jnp.minimum(
            jnp.minimum(maxbonddim, jnp.int32(Imax)),
            jnp.minimum(mI, mJ),
        )

        def _slab_factorize(rows, cols, m_rows, m_cols, mr):
            """One slab elimination; returns (rp, cp, k, mags, err, ms)."""
            if pair:
                Pr, Pi_ = _panel_pair_dyn(fjax, rows, cols, nl, m_rows,
                                          m_cols)
                _, _, rp, cp, k, mags, err = rrlu_state_pair(
                    Pr, Pi_, m_rows, m_cols, mr, reltol, abstol,
                    leftorthogonal=forward,
                )
                ms = jnp.max(jnp.hypot(Pr, Pi_))
            else:
                Pi = _panel_dyn(fjax, rows, cols, nl, m_rows, m_cols, dtype)
                _, rp, cp, k, mags, err = _rrlu_state(
                    Pi, m_rows, m_cols, mr, reltol, abstol,
                    leftorthogonal=forward,
                )
                ms = jnp.max(jnp.abs(Pi))
            return rp, cp, k, mags, err, ms

        def col_slab(st):
            """Factorize A[:, J0]: all candidate rows x selected cols."""
            I0_, I0len_, J0_, J0len_ = st
            Jsel = Jc[J0_]
            mr = jnp.minimum(maxrank_bond, J0len_)
            rp, cp, k, mags, err, ms = _slab_factorize(
                Ic, Jsel, mI, J0len_, mr
            )
            newI = rp[:Imax].astype(jnp.int32)
            newJ = J0_[cp[:Imax]].astype(jnp.int32)
            smin = jnp.minimum(mI, J0len_)
            return (newI, k, newJ, k, k, mags[:Imax], err, smin, ms,
                    jnp.float64(Icap * Imax))

        def row_slab(st):
            """Factorize A[I0, :]: selected rows x all candidate cols."""
            I0_, I0len_, J0_, J0len_ = st
            Isel = Ic[I0_]
            mr = jnp.minimum(maxrank_bond, I0len_)
            rp, cp, k, mags, err, ms = _slab_factorize(
                Isel, Jc, I0len_, mJ, mr
            )
            newI = I0_[rp[:Imax]].astype(jnp.int32)
            newJ = cp[:Imax].astype(jnp.int32)
            smin = jnp.minimum(I0len_, mJ)
            return (newI, k, newJ, k, k, mags[:Imax], err, smin, ms,
                    jnp.float64(Imax * Jcap))

        I0f, J0f, k, mags, err_final, ms, ne = _rook_alternate(
            col_slab, row_slab, I0, I0len, J0, J0len, Imax,
            numrookiter, forward,
        )

        Iset, Ilen, Jset, Jlen, bonderrs, perrs = _bond_writeback(
            Iset, Ilen, Jset, Jlen, bonderrs, perrs, b, Ic, Jc,
            I0f, J0f, k, mags, err_final, Imax,
        )
        maxsample = jnp.maximum(maxsample, ms)
        nevals = nevals + ne

        carry = (Iset, Ilen, Jset, Jlen, extraI, extraIlen, extraJ,
                 extraJlen, bonderrs, perrs, maxsample, nevals, reltol,
                 abstol, maxbonddim, base_key)
        return carry, None

    @jax.jit
    def sweep(Iset, Ilen, Jset, Jlen, extraI, extraIlen, extraJ, extraJlen,
              reltol, abstol, maxbonddim, seed):
        bonderrs = jnp.zeros((L - 1,), dtype=jnp.float64)
        perrs = jnp.zeros((L - 1, Imax + 1), dtype=jnp.float64)
        base_key = jax.random.PRNGKey(seed)
        bonds = (
            jnp.arange(L - 1, dtype=jnp.int32)
            if forward
            else jnp.arange(L - 2, -1, -1, dtype=jnp.int32)
        )
        carry = (Iset, Ilen, Jset, Jlen, extraI, extraIlen, extraJ,
                 extraJlen, bonderrs, perrs, jnp.float64(0.0),
                 jnp.float64(0.0), reltol, abstol, maxbonddim, base_key)
        carry, _ = jax.lax.scan(bond_update, carry, bonds)
        (Iset, Ilen, Jset, Jlen, _, _, _, _, bonderrs, perrs, maxsample,
         nevals, _, _, _, _) = carry
        return Iset, Ilen, Jset, Jlen, bonderrs, perrs, maxsample, nevals

    return sweep


def _make_sweep_scan(fjax: Callable, localdims: Tuple[int, ...], Imax: int,
                     forward: bool, dtype, pair: bool = False,
                     shard_rows=None):
    """Scan-based 2-site sweep: one traced bond body + lax.scan over bonds.

    Compile time is constant in the chain length L (vs linear for the
    unrolled variant), which matters for quantics chains (L = 40+,
    BASELINE config 3). Requires padding every site to dmax; validity masks
    handle non-uniform local dimensions. Semantics identical to _make_sweep.

    pair=True: fjax is pair-valued (returns stacked (re, im)); the panel and
    the elimination run on f64 pairs (ops/complex_pair.py) so long complex
    chains get whole-sweep programs too.
    """
    L = len(localdims)
    dmax = max(localdims)
    dims_arr = jnp.asarray(localdims, dtype=jnp.int32)
    Icap = Imax * dmax + Imax
    Jcap = dmax * Imax + Imax
    if pair:
        from ..ops.complex_pair import rrlu_state_pair

    def bond_update(carry, b):
        Iset, Ilen, Jset, Jlen, extraI, extraIlen, extraJ, extraJlen, \
            bonderrs, perrs, maxsample, reltol, abstol, maxbonddim = carry

        d_b = dims_arr[b]
        d_b1 = dims_arr[b + 1]
        pos = jnp.arange(L, dtype=jnp.int32)

        # --- Icombined rows (kron region padded to Imax*dmax) --------------
        Iset_b = Iset[b]  # (Imax, L)
        kron = jnp.broadcast_to(Iset_b[:, None, :], (Imax, dmax, L))
        svals = jnp.broadcast_to(
            jnp.arange(dmax, dtype=jnp.int32)[None, :], (Imax, dmax)
        )
        # set position b of each row to s (dynamic index via one-hot)
        onehot_b = (pos[None, None, :] == b)
        kron = jnp.where(onehot_b, svals[:, :, None], kron)
        kron = kron.reshape(Imax * dmax, L)
        ridk = jnp.arange(Imax * dmax)
        valid_kron = ((ridk // dmax) < Ilen[b]) & ((ridk % dmax) < d_b)
        Ic_all = jnp.concatenate([kron, extraI[b + 1]], axis=0)
        validI = jnp.concatenate(
            [valid_kron, jnp.arange(Imax) < extraIlen[b + 1]]
        )
        orderI = jnp.argsort(~validI, stable=True)
        Ic = Ic_all[orderI]
        if shard_rows is not None:
            Ic = shard_rows(Ic)
        mI = jnp.sum(validI).astype(jnp.int32)

        # --- Jcombined rows -------------------------------------------------
        Jset_b1 = Jset[b + 1]
        shifted = jnp.roll(Jset_b1, 1, axis=1)
        kronJ = jnp.broadcast_to(shifted[None, :, :], (dmax, Imax, L))
        svalsJ = jnp.broadcast_to(
            jnp.arange(dmax, dtype=jnp.int32)[:, None], (dmax, Imax)
        )
        onehot_0 = (pos[None, None, :] == 0)
        kronJ = jnp.where(onehot_0, svalsJ[:, :, None], kronJ)
        kronJ = kronJ.reshape(dmax * Imax, L)
        ridj = jnp.arange(dmax * Imax)
        valid_kronJ = ((ridj % Imax) < Jlen[b + 1]) & ((ridj // Imax) < d_b1)
        Jc_all = jnp.concatenate([kronJ, extraJ[b]], axis=0)
        validJ = jnp.concatenate(
            [valid_kronJ, jnp.arange(Imax) < extraJlen[b]]
        )
        orderJ = jnp.argsort(~validJ, stable=True)
        Jc = Jc_all[orderJ]
        mJ = jnp.sum(validJ).astype(jnp.int32)

        # --- Π panel with dynamic prefix length -----------------------------
        nl = b + 1  # dynamic

        def one_entry(ic, jc):
            jc_shift = jnp.roll(jc, nl)
            full = jnp.where(pos < nl, ic, jc_shift)
            return fjax(full)

        maxrank = jnp.minimum(
            jnp.minimum(maxbonddim, jnp.int32(Imax)), jnp.minimum(mI, mJ)
        )
        rowsP = jnp.arange(Ic.shape[0])
        colsP = jnp.arange(Jc.shape[0])
        validP = (rowsP[:, None] < mI) & (colsP[None, :] < mJ)
        if pair:
            panel = _mapped_rows(
                lambda ic: jax.vmap(lambda jc: one_entry(ic, jc))(Jc), Ic
            )
            Pr = jnp.where(validP, panel[..., 0].astype(jnp.float64), 0.0)
            Pim = jnp.where(validP, panel[..., 1].astype(jnp.float64), 0.0)
            maxsample = jnp.maximum(
                maxsample, jnp.sqrt(jnp.max(Pr * Pr + Pim * Pim))
            )
            _, _, rowperm, colperm, k, mags, err = rrlu_state_pair(
                Pr, Pim, mI, mJ, maxrank, reltol, abstol, forward
            )
        else:
            Pi = _mapped_rows(
                lambda ic: jax.vmap(lambda jc: one_entry(ic, jc))(Jc), Ic
            ).astype(dtype)
            Pi = jnp.where(validP, Pi, 0)
            maxsample = jnp.maximum(maxsample, jnp.max(jnp.abs(Pi)))
            A, rowperm, colperm, k, mags, err = _rrlu_state(
                Pi, mI, mJ, maxrank, reltol, abstol, leftorthogonal=forward
            )
        err_final = jnp.where(k >= jnp.minimum(mI, mJ), 0.0, err)

        Iset, Ilen, Jset, Jlen, bonderrs, perrs = _bond_writeback(
            Iset, Ilen, Jset, Jlen, bonderrs, perrs, b, Ic, Jc,
            rowperm, colperm, k, mags, err_final, Imax,
        )

        carry = (Iset, Ilen, Jset, Jlen, extraI, extraIlen, extraJ,
                 extraJlen, bonderrs, perrs, maxsample, reltol, abstol,
                 maxbonddim)
        return carry, None

    @jax.jit
    def sweep(Iset, Ilen, Jset, Jlen, extraI, extraIlen, extraJ, extraJlen,
              reltol, abstol, maxbonddim):
        bonderrs = jnp.zeros((L - 1,), dtype=jnp.float64)
        perrs = jnp.zeros((L - 1, Imax + 1), dtype=jnp.float64)
        bonds = (
            jnp.arange(L - 1, dtype=jnp.int32)
            if forward
            else jnp.arange(L - 2, -1, -1, dtype=jnp.int32)
        )
        carry = (Iset, Ilen, Jset, Jlen, extraI, extraIlen, extraJ,
                 extraJlen, bonderrs, perrs, jnp.float64(0.0), reltol,
                 abstol, maxbonddim)
        carry, _ = jax.lax.scan(bond_update, carry, bonds)
        (Iset, Ilen, Jset, Jlen, _, _, _, _, bonderrs, perrs, maxsample,
         _, _, _) = carry
        return Iset, Ilen, Jset, Jlen, bonderrs, perrs, maxsample

    return sweep


def _panel_dyn(fjax, Ic, Jc, nl, mI, mJ, dtype):
    """Π panel with a *dynamic* prefix length nl: row indices Ic hold the
    first nl slots, suffix indices Jc are left-aligned and rolled into
    position. Invalid rows/cols masked to zero."""
    pos = jnp.arange(Ic.shape[1], dtype=jnp.int32)

    def one_entry(ic, jc):
        full = jnp.where(pos < nl, ic, jnp.roll(jc, nl))
        return fjax(full)

    Pi = _mapped_rows(
        lambda ic: jax.vmap(lambda jc: one_entry(ic, jc))(Jc), Ic
    ).astype(dtype)
    rowsP = jnp.arange(Pi.shape[0])
    colsP = jnp.arange(Pi.shape[1])
    return jnp.where((rowsP[:, None] < mI) & (colsP[None, :] < mJ), Pi, 0)


def _panel_pair_dyn(fjax_pair, Ic, Jc, nl, mI, mJ):
    """Pair-valued Π panel with a dynamic prefix length nl (scan bodies)."""
    pos = jnp.arange(Ic.shape[1], dtype=jnp.int32)

    def one_entry(ic, jc):
        full = jnp.where(pos < nl, ic, jnp.roll(jc, nl))
        return fjax_pair(full)

    panel = _mapped_rows(
        lambda ic: jax.vmap(lambda jc: one_entry(ic, jc))(Jc), Ic
    )
    rowsP = jnp.arange(panel.shape[0])
    colsP = jnp.arange(panel.shape[1])
    valid = (rowsP[:, None] < mI) & (colsP[None, :] < mJ)
    Pr = jnp.where(valid, panel[..., 0].astype(jnp.float64), 0.0)
    Pi_ = jnp.where(valid, panel[..., 1].astype(jnp.float64), 0.0)
    return Pr, Pi_


def _kron_is_scan(Iset_b, b, Imax, dmax, L):
    """kron(Iset[b], dmax) rows with the site index written at dynamic
    position b. Row r = i*dmax + s; slots s >= d_b and i >= Ilen[b] are
    masked by the caller's valid predicate."""
    pos = jnp.arange(L, dtype=jnp.int32)
    kron = jnp.broadcast_to(Iset_b[:, None, :], (Imax, dmax, L))
    svals = jnp.broadcast_to(
        jnp.arange(dmax, dtype=jnp.int32)[None, :], (Imax, dmax)
    )
    kron = jnp.where(pos[None, None, :] == b, svals[:, :, None], kron)
    return kron.reshape(Imax * dmax, L)


def _make_fillsitetensors_scan(fjax: Callable, localdims: Tuple[int, ...],
                               Imax: int, dtype, pair: bool = False):
    """All L site tensors T_b = Π₁ P^{-1} (tensorci2.jl:599-629) with a
    lax.scan over bonds: compile time constant in L, for long (quantics)
    chains where the unrolled variant is gated off. pair=True returns
    (out_re, out_im, maxsample)."""
    L = len(localdims)
    dmax = max(localdims)
    dims_arr = jnp.asarray(localdims, dtype=jnp.int32)
    if pair:
        from ..ops.complex_pair import panel_solve_pinv_pair

    @jax.jit
    def fill(Iset, Ilen, Jset, Jlen):
        rdtype = jnp.float64 if pair else dtype

        def body(carry, b):
            tensors, tensorsi, maxsample = carry
            d_b = dims_arr[b]
            kron = _kron_is_scan(Iset[b], b, Imax, dmax, L)
            ridk = jnp.arange(Imax * dmax)
            valid = ((ridk // dmax) < Ilen[b]) & ((ridk % dmax) < d_b)
            orderI = jnp.argsort(~valid, stable=True)
            Ic = kron[orderI]
            mIs = jnp.sum(valid).astype(jnp.int32)
            nl = b + 1
            if pair:
                P1r, P1i = _panel_pair_dyn(
                    fjax, Ic, Jset[b], nl, mIs, Jlen[b]
                )
                maxsample = jnp.maximum(
                    maxsample, jnp.sqrt(jnp.max(P1r * P1r + P1i * P1i))
                )
                Pr, Pi_ = _panel_pair_dyn(
                    fjax, Iset[b + 1], Jset[b], nl, Ilen[b + 1], Jlen[b]
                )
                padmask = (
                    jnp.arange(Imax)[:, None] >= Ilen[b + 1]
                ) | (jnp.arange(Imax)[None, :] >= Jlen[b])
                Pr = jnp.where(padmask, jnp.eye(Imax, dtype=rdtype), Pr)
                Pi_ = jnp.where(padmask, 0.0, Pi_)
                Tr, Ti = panel_solve_pinv_pair(P1r, P1i, Pr, Pi_,
                                               Ilen[b + 1])
                Trf = jnp.zeros_like(Tr).at[orderI].set(Tr)
                Tif = jnp.zeros_like(Ti).at[orderI].set(Ti)
                tensors = tensors.at[b].set(Trf.reshape(Imax, dmax, Imax))
                tensorsi = tensorsi.at[b].set(Tif.reshape(Imax, dmax, Imax))
                return (tensors, tensorsi, maxsample), None
            Pi1 = _panel_dyn(fjax, Ic, Jset[b], nl, mIs, Jlen[b], dtype)
            maxsample = jnp.maximum(maxsample, jnp.max(jnp.abs(Pi1)))
            P = _panel_dyn(
                fjax, Iset[b + 1], Jset[b], nl, Ilen[b + 1], Jlen[b], dtype
            )
            padmask = (
                jnp.arange(Imax)[:, None] >= Ilen[b + 1]
            ) | (jnp.arange(Imax)[None, :] >= Jlen[b])
            P = jnp.where(padmask, jnp.eye(Imax, dtype=dtype), P)
            T = panel_solve_pinv(Pi1, P, Ilen[b + 1], dtype)
            Tfull = jnp.zeros_like(T).at[orderI].set(T)
            tensors = tensors.at[b].set(Tfull.reshape(Imax, dmax, Imax))
            return (tensors, tensorsi, maxsample), None

        tensors = jnp.zeros((L, Imax, dmax, Imax), dtype=rdtype)
        tensorsi = jnp.zeros((L, Imax, dmax, Imax), dtype=rdtype)
        (tensors, tensorsi, maxsample), _ = jax.lax.scan(
            body, (tensors, tensorsi, jnp.float64(0.0)),
            jnp.arange(L - 1, dtype=jnp.int32),
        )
        # boundary site L-1 (static): T = Π₁ reshaped; Jset[L-1] = [()]
        last = L - 1
        d_l = localdims[last]
        kron = jnp.broadcast_to(Iset[last][:, None, :], (Imax, d_l, L))
        kron = kron.at[:, :, last].set(
            jnp.broadcast_to(
                jnp.arange(d_l, dtype=jnp.int32)[None, :], (Imax, d_l)
            )
        )
        Is = kron.reshape(Imax * d_l, L)
        if pair:
            P1r, P1i = _panel_pair(
                fjax, Is, Jset[last], last + 1, 0,
                Ilen[last] * d_l, Jlen[last],
            )
            maxsample = jnp.maximum(
                maxsample, jnp.sqrt(jnp.max(P1r * P1r + P1i * P1i))
            )
            tensors = tensors.at[last, :, :d_l, :1].set(
                P1r[:, :1].reshape(Imax, d_l, 1)
            )
            tensorsi = tensorsi.at[last, :, :d_l, :1].set(
                P1i[:, :1].reshape(Imax, d_l, 1)
            )
            return tensors, tensorsi, maxsample
        Pi1 = _panel(
            fjax, Is, Jset[last], last + 1, 0, Ilen[last] * d_l, Jlen[last],
            dtype,
        )
        maxsample = jnp.maximum(maxsample, jnp.max(jnp.abs(Pi1)))
        T = Pi1[:, :1].reshape(Imax, d_l, 1)
        tensors = tensors.at[last, :, :d_l, :1].set(T)
        return tensors, maxsample

    return fill


def _make_sweep1site_scan(fjax: Callable, localdims: Tuple[int, ...],
                          Imax: int, forward: bool, dtype,
                          pair: bool = False):
    """Scan-based one-site sweep (tensorci2.jl:659-725): one traced bond
    body + lax.scan, compile time constant in L. Semantics identical to
    _make_sweep1site (same outputs), for long chains. pair=True returns an
    extra imaginary tensor buffer."""
    L = len(localdims)
    dmax = max(localdims)
    dims_arr = jnp.asarray(localdims, dtype=jnp.int32)
    rdtype = jnp.float64 if pair else dtype
    if pair:
        from ..ops.complex_pair import ci_factors_pair, rrlu_state_pair

    def body(carry, b):
        (Iset, Ilen, Jset, Jlen, tensors, tensorsi, bonderrs, perrs,
         maxsample, reltol, abstol, maxbonddim) = carry
        d_b = dims_arr[b]

        if forward:
            kron = _kron_is_scan(Iset[b], b, Imax, dmax, L)
            ridk = jnp.arange(Imax * dmax)
            valid = ((ridk // dmax) < Ilen[b]) & ((ridk % dmax) < d_b)
            orderI = jnp.argsort(~valid, stable=True)
            Is = kron[orderI]
            mIs = jnp.sum(valid).astype(jnp.int32)
            Js, mJs = Jset[b], Jlen[b]
            if pair:
                Pr, Pim = _panel_pair_dyn(fjax, Is, Js, b + 1, mIs, mJs)
            else:
                Pi = _panel_dyn(fjax, Is, Js, b + 1, mIs, mJs, dtype)
        else:
            shifted = jnp.roll(Jset[b], 1, axis=1)
            kronJ = jnp.broadcast_to(shifted[None, :, :], (dmax, Imax, L))
            svalsJ = jnp.broadcast_to(
                jnp.arange(dmax, dtype=jnp.int32)[:, None], (dmax, Imax)
            )
            pos = jnp.arange(L, dtype=jnp.int32)
            kronJ = jnp.where(pos[None, None, :] == 0,
                              svalsJ[:, :, None], kronJ)
            kronJ = kronJ.reshape(dmax * Imax, L)
            ridj = jnp.arange(dmax * Imax)
            validJ = ((ridj % Imax) < Jlen[b]) & ((ridj // Imax) < d_b)
            orderJ = jnp.argsort(~validJ, stable=True)
            Js = kronJ[orderJ]
            mJs = jnp.sum(validJ).astype(jnp.int32)
            Is, mIs = Iset[b], Ilen[b]
            if pair:
                Pr, Pim = _panel_pair_dyn(fjax, Is, Js, b, mIs, mJs)
            else:
                Pi = _panel_dyn(fjax, Is, Js, b, mIs, mJs, dtype)

        maxrank = jnp.minimum(
            jnp.minimum(maxbonddim, jnp.int32(Imax)), jnp.minimum(mIs, mJs)
        )
        if pair:
            maxsample = jnp.maximum(
                maxsample, jnp.sqrt(jnp.max(Pr * Pr + Pim * Pim))
            )
            Ar, Ai, rowperm, colperm, k, mags, err = rrlu_state_pair(
                Pr, Pim, mIs, mJs, maxrank, reltol, abstol, forward
            )
            lr, li, rr, ri = ci_factors_pair(
                Ar, Ai, rowperm, colperm, k, forward
            )
        else:
            maxsample = jnp.maximum(maxsample, jnp.max(jnp.abs(Pi)))
            A, rowperm, colperm, k, mags, err = _rrlu_state(
                Pi, mIs, mJs, maxrank, reltol, abstol, leftorthogonal=forward
            )
            left, right = ci_factors(A, rowperm, colperm, k, forward, dtype)
        err_final = jnp.where(k >= jnp.minimum(mIs, mJs), 0.0, err)

        keep = jnp.arange(Imax, dtype=jnp.int32)[:, None] < k
        selI = Is[rowperm[:Imax], :]
        selJ = Js[colperm[:Imax], :]
        if forward:
            Iset = Iset.at[b + 1].set(jnp.where(keep, selI, 0))
            Ilen = Ilen.at[b + 1].set(k)
            Jset = Jset.at[b].set(jnp.where(keep, selJ, 0))
            Jlen = Jlen.at[b].set(k)
            if pair:
                Lr = jnp.zeros(
                    (Imax * dmax, Imax), dtype=rdtype
                ).at[orderI].set(lr[:, :Imax])
                Li = jnp.zeros(
                    (Imax * dmax, Imax), dtype=rdtype
                ).at[orderI].set(li[:, :Imax])
                tensors = tensors.at[b].set(Lr.reshape(Imax, dmax, Imax))
                tensorsi = tensorsi.at[b].set(Li.reshape(Imax, dmax, Imax))
            else:
                Lfull = jnp.zeros(
                    (Imax * dmax, Imax), dtype=dtype
                ).at[orderI].set(left[:, :Imax])
                tensors = tensors.at[b].set(Lfull.reshape(Imax, dmax, Imax))
            bidx = b
        else:
            Iset = Iset.at[b].set(jnp.where(keep, selI, 0))
            Ilen = Ilen.at[b].set(k)
            Jset = Jset.at[b - 1].set(jnp.where(keep, selJ, 0))
            Jlen = Jlen.at[b - 1].set(k)
            if pair:
                Rr = jnp.zeros(
                    (Imax, dmax * Imax), dtype=rdtype
                ).at[:, orderJ].set(rr[:Imax, :])
                Ri = jnp.zeros(
                    (Imax, dmax * Imax), dtype=rdtype
                ).at[:, orderJ].set(ri[:Imax, :])
                tensors = tensors.at[b].set(Rr.reshape(Imax, dmax, Imax))
                tensorsi = tensorsi.at[b].set(Ri.reshape(Imax, dmax, Imax))
            else:
                Rfull = jnp.zeros(
                    (Imax, dmax * Imax), dtype=dtype
                ).at[:, orderJ].set(right[:Imax, :])
                tensors = tensors.at[b].set(Rfull.reshape(Imax, dmax, Imax))
            bidx = b - 1
        bonderrs = bonderrs.at[bidx].set(err_final)
        pv = jnp.where(
            jnp.arange(Imax + 1) < k,
            jnp.concatenate([mags[:Imax], jnp.zeros(1)]),
            0.0,
        )
        pv = pv.at[k].set(err_final)
        perrs = perrs.at[bidx].set(pv)

        carry = (Iset, Ilen, Jset, Jlen, tensors, tensorsi, bonderrs, perrs,
                 maxsample, reltol, abstol, maxbonddim)
        return carry, None

    @jax.jit
    def sweep(Iset, Ilen, Jset, Jlen, reltol, abstol, maxbonddim):
        tensors = jnp.zeros((L, Imax, dmax, Imax), dtype=rdtype)
        # non-pair sweeps carry a 0-d dummy so the extra buffer costs nothing
        tensorsi = (
            jnp.zeros((L, Imax, dmax, Imax), dtype=rdtype)
            if pair else jnp.zeros((), dtype=rdtype)
        )
        bonderrs = jnp.zeros((L - 1,), dtype=jnp.float64)
        perrs = jnp.zeros((L - 1, Imax + 1), dtype=jnp.float64)
        bonds = (
            jnp.arange(L - 1, dtype=jnp.int32)
            if forward
            else jnp.arange(L - 1, 0, -1, dtype=jnp.int32)
        )
        carry = (Iset, Ilen, Jset, Jlen, tensors, tensorsi, bonderrs, perrs,
                 jnp.float64(0.0), reltol, abstol, maxbonddim)
        carry, _ = jax.lax.scan(body, carry, bonds)
        (Iset, Ilen, Jset, Jlen, tensors, tensorsi, bonderrs, perrs,
         maxsample, _, _, _) = carry

        # final boundary tensor (static site index)
        last = L - 1 if forward else 0
        d_l = localdims[last]
        kron = jnp.broadcast_to(Iset[last][:, None, :], (Imax, d_l, L))
        kron = kron.at[:, :, last].set(
            jnp.broadcast_to(
                jnp.arange(d_l, dtype=jnp.int32)[None, :], (Imax, d_l)
            )
        )
        Is = kron.reshape(Imax * d_l, L)
        if pair:
            P1r, P1i = _panel_pair(
                fjax, Is, Jset[last], last + 1, L - last - 1,
                Ilen[last] * d_l, Jlen[last],
            )
            maxsample = jnp.maximum(
                maxsample, jnp.sqrt(jnp.max(P1r * P1r + P1i * P1i))
            )
            tensors = tensors.at[last, :, :d_l, :].set(
                P1r[:, :Imax].reshape(Imax, d_l, Imax)
            )
            tensorsi = tensorsi.at[last, :, :d_l, :].set(
                P1i[:, :Imax].reshape(Imax, d_l, Imax)
            )
            return (Iset, Ilen, Jset, Jlen, tensors, tensorsi, bonderrs,
                    perrs, maxsample)
        Pi1 = _panel(
            fjax, Is, Jset[last], last + 1, L - last - 1,
            Ilen[last] * d_l, Jlen[last], dtype,
        )
        maxsample = jnp.maximum(maxsample, jnp.max(jnp.abs(Pi1)))
        T = Pi1[:, :Imax].reshape(Imax, d_l, Imax)
        tensors = tensors.at[last, :, :d_l, :].set(T)

        return (Iset, Ilen, Jset, Jlen, tensors, bonderrs, perrs, maxsample)

    return sweep


class DeviceSweepEngine:
    """Host wrapper: uploads TCI2 index sets into padded device buffers, runs
    the whole-sweep jit, and writes the results back. Grows the buffer
    capacity geometrically when the rank saturates it (recompile is then
    amortized by the persistent compilation cache)."""

    def __init__(self, fjax: Callable, localdims: Sequence[int],
                 imax: int = 32, imax_cap: int = 256, dtype=np.float64,
                 pair: bool = False, mesh=None, axis: str = "batch"):
        self.fjax = fjax
        self.localdims = tuple(int(d) for d in localdims)
        self.dtype = np.dtype(dtype).type
        self.pair = pair
        self.mesh = mesh
        self._shard_rows = _make_shard_rows(mesh, axis)
        self._jdtype = jnp.dtype(np.dtype(dtype))  # width-preserving
        self.Imax = imax
        # beyond this capacity the padded whole-sweep panels get wasteful
        # (and large fused programs stress the backend); callers fall back
        # to the per-bond fused tier
        self.imax_cap = imax_cap
        # Upper bound on the per-bond panel edge Imax*(dmax+1) for
        # whole-sweep programs (Imax=256 at d=15; state arrays scale as
        # L·Imax²·dmax). Above the guard the engine declines and callers
        # fall back to the per-bond tier.
        self.max_panel_edge = 4096
        # Fuse BOTH sweeps of one optimize iteration (+ the site-tensor
        # fill) into a single device program (sweep2site_pair). Saves one
        # dispatch + one index upload per iteration; set False to force the
        # per-sweep programs.
        self.use_sweep_pair = True
        # Run up to loop_kmax PIVOT-FREE optimize iterations inside ONE
        # lax.while_loop device program (optimize_loop): sweeps, fills,
        # global-pivot candidate search and the convergence criterion all
        # evaluate on device; control returns to the host only when a
        # global pivot fires, the rank saturates the buffer, convergence
        # is reached, or the budget runs out. A full crossinterpolate2
        # then costs O(1) dispatches instead of O(iterations).
        self.use_optimize_loop = True
        self.loop_kmax = 32
        # Chain length at and above which the full-pivot sweep and fill
        # use the lax.scan bodies (one traced bond body — compile flat in
        # L) instead of the unrolled ones (exact static shapes per bond),
        # with identical convergence. Shorter chains keep the unrolled
        # exact-shape bodies (compile cost is small at L<6 anyway). The
        # rook sweep is scan-only (see _get_sweep_rook).
        self.scan_min_L = 6
        self._sweeps = {}
        # NOTE: every cached program whose body depends on the
        # scan-vs-unrolled choice keys on _scan_active(), so reassigning
        # scan_min_L after a sweep has been built (the probe-script
        # pattern) transparently builds the other variant instead of
        # silently returning the stale one.
        self.nevals = 0
        self.last_search = None
        # (program, platform of its result arrays) -> number of host
        # dispatches: which whole-sweep tier ran, and on what device
        self.dispatches = {}
        self._rng = np.random.default_rng()

    def _dispatch(self, label: str, fn, *args):
        """Run one engine program from the host and count it in
        ``dispatches``."""
        out = fn(*args)
        leaf = jax.tree_util.tree_leaves(out)[0]
        key = (label, next(iter(leaf.devices())).platform)
        self.dispatches[key] = self.dispatches.get(key, 0) + 1
        return out

    def _get_sweep_rook(self, forward: bool):
        # The SCAN rook body is the only production rook variant: one
        # traced bond body + lax.scan compiles flat in chain length and
        # panel edge, where the unrolled body's compile time grows
        # superlinearly in both. Non-uniform chains pad their per-bond
        # panels to dmax; the padding waste is bounded and buys compile time
        # flat in every dimension. `_make_sweep_rook` (unrolled) remains
        # only as the bit-parity oracle for the scan body
        # (tests/test_device_sweep.py::test_rook_scan_matches_unrolled).
        key = (forward, self.Imax, "rook")
        if key not in self._sweeps:
            self._sweeps[key] = _make_sweep_rook_scan(
                self.fjax, self.localdims, self.Imax, forward,
                self._jdtype, shard_rows=self._shard_rows, pair=self.pair,
            )
        return self._sweeps[key]

    def _scan_active(self) -> bool:
        """Whether the full-pivot sweep/fill bodies use the lax.scan
        variant at the CURRENT scan_min_L setting (part of every dependent
        program-cache key)."""
        return len(self.localdims) >= self.scan_min_L

    def _get_sweep(self, forward: bool):
        key = (forward, self.Imax, self._scan_active())
        if key not in self._sweeps:
            # Chains at L >= scan_min_L use the scan-based sweep (compile
            # time constant in L); shorter chains keep the unrolled
            # variant (exact static shapes per bond, small compile anyway).
            maker = _make_sweep_scan if self._scan_active() else _make_sweep
            self._sweeps[key] = maker(
                self.fjax, self.localdims, self.Imax, forward,
                self._jdtype, pair=self.pair, shard_rows=self._shard_rows,
            )
        return self._sweeps[key]

    def _pack(self, sets: List[List[MultiIndex]], align: str) -> Tuple:
        """Pack ragged index-set lists into an (L, Imax, L) buffer + lengths.

        align='left' stores each multi-index in row[:len] (both prefixes and
        suffixes are stored left-aligned)."""
        L = len(self.localdims)
        buf = np.zeros((L, self.Imax, L), dtype=np.int32)
        lens = np.zeros((L,), dtype=np.int32)
        for b, s in enumerate(sets):
            lens[b] = len(s)
            for r, idx in enumerate(s):
                if len(idx) > 0:
                    buf[b, r, : len(idx)] = idx
        return buf, lens

    def _unpack(self, buf: np.ndarray, lens: np.ndarray,
                lengths_per_site: List[int]) -> List[List[MultiIndex]]:
        out = []
        for b in range(buf.shape[0]):
            n = int(lens[b])
            ll = lengths_per_site[b]
            out.append([tuple(int(x) for x in buf[b, r, :ll]) for r in range(n)])
        return out

    def sweep2site(self, tci, forward: bool, reltol: float, abstol: float,
                   maxbonddim: int,
                   extraIset: List[List[MultiIndex]],
                   extraJset: List[List[MultiIndex]],
                   pivotsearch: str = "full",
                   fill_sites: bool = False) -> bool:
        """Run one full 2-site sweep on device, updating tci in place.
        Returns False when the required capacity exceeds imax_cap (caller
        falls back to the per-bond path).

        pivotsearch='rook' runs the whole-sweep scan rook program
        (_make_sweep_rook_scan): same single dispatch per sweep, slab
        sampling instead of full panels. Pair-valued (complex) integrands
        are supported too (_get_sweep_rook builds the pair variant of the
        rook body).

        fill_sites=True additionally computes ALL site tensors inside the
        same device program (_get_sweep_fused) and stores them on tci —
        saving the separate fill dispatch; success is recorded on
        `self.last_sweep_filled`."""
        L = len(self.localdims)
        self.last_sweep_filled = False
        rook = pivotsearch == "rook"
        needed = max(
            [len(s) for s in tci.Iset] + [len(s) for s in tci.Jset]
            + [len(s) for s in extraIset] + [len(s) for s in extraJset]
            + [1]
        )
        if needed > self.imax_cap:
            return False
        target = _imax_target(self.Imax, needed)
        if target * (max(self.localdims) + 1) > self.max_panel_edge:
            return False
        self.Imax = target

        Iset, Ilen = self._pack(tci.Iset, "left")
        Jset, Jlen = self._pack(tci.Jset, "left")
        eI, eIlen = self._pack(extraIset, "left")
        eJ, eJlen = self._pack(extraJset, "left")

        args = (
            jnp.asarray(Iset), jnp.asarray(Ilen),
            jnp.asarray(Jset), jnp.asarray(Jlen),
            jnp.asarray(eI), jnp.asarray(eIlen),
            jnp.asarray(eJ), jnp.asarray(eJlen),
            jnp.float64(reltol), jnp.float64(abstol),
            jnp.int32(min(maxbonddim, 2**31 - 1)),
        )
        if rook:
            seed = jnp.uint32(self._rng.integers(0, 2**31 - 1))
            fn = (self._get_sweep_fused(forward, True) if fill_sites
                  else self._get_sweep_rook(forward))
            label = ("whole rook sweep + fill" if fill_sites
                     else "whole rook sweep")
            out = jax.device_get(self._dispatch(label, fn, *args, seed))
            (Iset_b, Ilen_b, Jset_b, Jlen_b, bonderrs, perrs, maxsample,
             nevals_dev) = out[:8]
            fill_res = out[8:] if fill_sites else None
        else:
            fn = (self._get_sweep_fused(forward, False) if fill_sites
                  else self._get_sweep(forward))
            label = "whole sweep + fill" if fill_sites else "whole sweep"
            out = jax.device_get(self._dispatch(label, fn, *args))
            Iset_b, Ilen_b, Jset_b, Jlen_b, bonderrs, perrs, maxsample = (
                out[:7]
            )
            fill_res = out[7:] if fill_sites else None
            nevals_dev = None
        # saturation check: if any bond hit the cap and more rank is allowed,
        # grow and re-run this sweep with larger buffers (until imax_cap,
        # then hand back to the per-bond path)
        if (
            int(np.max(Ilen_b)) >= self.Imax
            and self.Imax < maxbonddim
        ):
            nxt = _imax_target(self.Imax, self.Imax + 1)
            if nxt > self.imax_cap or (
                nxt * (max(self.localdims) + 1) > self.max_panel_edge
            ):
                return False
            self.Imax = nxt
            return self.sweep2site(
                tci, forward, reltol, abstol, maxbonddim, extraIset,
                extraJset, pivotsearch=pivotsearch, fill_sites=fill_sites,
            )

        prefix_lens = list(range(L))
        suffix_lens = [L - b - 1 for b in range(L)]
        tci.Iset = self._unpack(Iset_b, Ilen_b, prefix_lens)
        tci.Jset = self._unpack(Jset_b, Jlen_b, suffix_lens)
        tci.maxsamplevalue = max(tci.maxsamplevalue, float(maxsample))
        for b in range(L - 1):
            tci.updateerrors(
                b, list(perrs[b][: int(Ilen_b[b + 1]) + 1])
            )
        if nevals_dev is not None:
            self.nevals += int(nevals_dev)
        else:
            for b in range(L - 1):
                Icap = self.Imax * self.localdims[b] + self.Imax
                Jcap = self.localdims[b + 1] * self.Imax + self.Imax
                self.nevals += Icap * Jcap
        if fill_res is not None:
            # site tensors computed inside the same program, against the
            # final Iset/Jset just stored on tci above
            self._store_sitetensors(tci, fill_res)
            self.last_sweep_filled = True
        return True

    def _get_fill(self):
        key = ("fill", self.Imax, self._scan_active())
        if key not in self._sweeps:
            maker = (
                _make_fillsitetensors_scan if self._scan_active()
                else _make_fillsitetensors
            )
            self._sweeps[key] = maker(
                self.fjax, self.localdims, self.Imax, self._jdtype,
                pair=self.pair,
            )
        return self._sweeps[key]

    def _get_sweep_fused(self, forward: bool, rook: bool):
        """Sweep + site-tensor fill composed into ONE device program.

        A separate fill dispatch (engine.fillsitetensors) costs one extra
        program launch plus an Iset/Jset re-upload per optimize iteration.
        Composing the two jitted programs inside an outer jit inlines them
        into a single executable; the fill consumes the sweep's on-device
        output sets directly, so no index bytes move between the two
        stages."""
        key = (forward, self.Imax, "fused_rook" if rook else "fused_full",
               self._scan_active())
        if key not in self._sweeps:
            sweep_fn = (
                self._get_sweep_rook(forward) if rook
                else self._get_sweep(forward)
            )
            fill_fn = self._get_fill()

            @jax.jit
            def fused(*args):
                out = sweep_fn(*args)
                return tuple(out) + tuple(fill_fn(*out[:4]))

            self._sweeps[key] = fused
        return self._sweeps[key]

    def _get_sweep_pair(self, fwd1: bool, fwd2: bool, rook: bool,
                        nsearch: int = 0):
        """TWO consecutive 2-site sweeps + the site-tensor fill composed
        into ONE device program (the shape of one optimize iteration:
        back-and-forth sweeps, then fill).

        The second sweep's non-strict-nesting extra sets are exactly the
        first sweep's input sets (tensorci2.jl keeps the previous sweep's
        Iset/Jset as history and feeds it to the next sweep), so the whole
        pair closes over the program's own inputs — no host round trip
        between the sweeps. `use_extra2` (0/1 scalar) gates the second
        sweep's extras for strict nesting. Returns sweep2's full output
        tuple, then sweep1's (Iset, Ilen, Jset, Jlen, maxsample[, nevals]),
        then the fill outputs.

        nsearch > 0 additionally folds the DefaultGlobalPivotFinder
        candidate search into the same program (one `starts` (nsearch, L)
        trailing argument; appends (best_flat, best_err) to the outputs):
        the optimize loop's global search then costs no extra dispatch —
        the full iteration is ONE program launch."""
        key = (fwd1, fwd2, self.Imax,
               "pair_rook" if rook else "pair_full", nsearch,
               self._scan_active())
        if key not in self._sweeps:
            s1 = (self._get_sweep_rook(fwd1) if rook
                  else self._get_sweep(fwd1))
            s2 = (self._get_sweep_rook(fwd2) if rook
                  else self._get_sweep(fwd2))
            fill_fn = self._get_fill()
            fjax, localdims, Imax = self.fjax, self.localdims, self.Imax
            jdtype, pair_mode = self._jdtype, self.pair
            shard_rows_c = self._shard_rows

            def search_tail(o2, fill_out):
                def run(starts):
                    if pair_mode:
                        cores, coresi = fill_out[0], fill_out[1]
                    else:
                        cores, coresi = fill_out[0], None
                    return _tt_search_on_cores(
                        fjax, localdims, Imax, jdtype, pair_mode,
                        cores, coresi, o2[1], o2[3], starts,
                        shard_rows=shard_rows_c,
                    )
                return run

            if rook:
                @jax.jit
                def fused(Iset, Ilen, Jset, Jlen, eI, eIl, eJ, eJl,
                          reltol, abstol, maxbonddim, use_extra2,
                          seed1, seed2, *starts):
                    o1 = s1(Iset, Ilen, Jset, Jlen, eI, eIl, eJ, eJl,
                            reltol, abstol, maxbonddim, seed1)
                    I1, Il1, J1, Jl1 = o1[:4]
                    o2 = s2(I1, Il1, J1, Jl1,
                            Iset, Ilen * use_extra2, Jset, Jlen * use_extra2,
                            reltol, abstol, maxbonddim, seed2)
                    fill_out = tuple(fill_fn(*o2[:4]))
                    tail = (search_tail(o2, fill_out)(starts[0])
                            if nsearch else ())
                    return (tuple(o2) + (I1, Il1, J1, Jl1, o1[6], o1[7])
                            + fill_out + tuple(tail))
            else:
                @jax.jit
                def fused(Iset, Ilen, Jset, Jlen, eI, eIl, eJ, eJl,
                          reltol, abstol, maxbonddim, use_extra2, *starts):
                    o1 = s1(Iset, Ilen, Jset, Jlen, eI, eIl, eJ, eJl,
                            reltol, abstol, maxbonddim)
                    I1, Il1, J1, Jl1 = o1[:4]
                    o2 = s2(I1, Il1, J1, Jl1,
                            Iset, Ilen * use_extra2, Jset, Jlen * use_extra2,
                            reltol, abstol, maxbonddim)
                    fill_out = tuple(fill_fn(*o2[:4]))
                    tail = (search_tail(o2, fill_out)(starts[0])
                            if nsearch else ())
                    return (tuple(o2) + (I1, Il1, J1, Jl1, o1[6])
                            + fill_out + tuple(tail))

            self._sweeps[key] = fused
        return self._sweeps[key]

    def sweep2site_pair(self, tci, fwd1: bool, fwd2: bool, reltol: float,
                        abstol: float, maxbonddim: int,
                        extraIset: List[List[MultiIndex]],
                        extraJset: List[List[MultiIndex]],
                        pivotsearch: str = "full",
                        strictlynested: bool = False,
                        search_starts=None) -> bool:
        """One optimize iteration's two sweeps + fill as a single dispatch.

        Updates tci in place exactly like two sweep2site calls with a fill
        on the second (incl. appending the mid-point pivot sets to
        tci.Iset_history/Jset_history — the host bookkeeping the second
        sweep's extra sets would otherwise be read from). Error series kept
        from the second sweep only, matching the per-iteration
        flushpivoterror semantics of the caller. Returns False when the
        capacity/edge guards decline (caller falls back to per-sweep).

        search_starts: optional (S, L) int array of global-search start
        points; the DefaultGlobalPivotFinder candidate search then runs
        inside the same program against the just-filled site tensors, and
        (best_flat, best_err) per start lands on `self.last_search` —
        making the whole optimize iteration (2 sweeps + fill + global
        search) ONE device dispatch."""
        L = len(self.localdims)
        self.last_sweep_filled = False
        self.last_search = None
        rook = pivotsearch == "rook"
        needed = max(
            [len(s) for s in tci.Iset] + [len(s) for s in tci.Jset]
            + [len(s) for s in extraIset] + [len(s) for s in extraJset]
            + [1]
        )
        if needed > self.imax_cap:
            return False
        target = _imax_target(self.Imax, needed)
        if target * (max(self.localdims) + 1) > self.max_panel_edge:
            return False
        self.Imax = target

        Iset, Ilen = self._pack(tci.Iset, "left")
        Jset, Jlen = self._pack(tci.Jset, "left")
        eI, eIlen = self._pack(extraIset, "left")
        eJ, eJlen = self._pack(extraJset, "left")
        args = (
            jnp.asarray(Iset), jnp.asarray(Ilen),
            jnp.asarray(Jset), jnp.asarray(Jlen),
            jnp.asarray(eI), jnp.asarray(eIlen),
            jnp.asarray(eJ), jnp.asarray(eJlen),
            jnp.float64(reltol), jnp.float64(abstol),
            jnp.int32(min(maxbonddim, 2**31 - 1)),
            jnp.int32(0 if strictlynested else 1),
        )
        nsearch = 0 if search_starts is None else int(len(search_starts))
        starts_arg = (
            (jnp.asarray(np.asarray(search_starts, dtype=np.int32)),)
            if nsearch else ()
        )
        if rook:
            # two SEPARATE scalar draws so the RNG stream matches two
            # sequential sweep2site calls exactly (bit-parity tests)
            seed1 = jnp.uint32(self._rng.integers(0, 2**31 - 1))
            seed2 = jnp.uint32(self._rng.integers(0, 2**31 - 1))
            out = jax.device_get(self._dispatch(
                "sweep pair", self._get_sweep_pair(fwd1, fwd2, True, nsearch),
                *args, seed1, seed2, *starts_arg,
            ))
            (Iset_b, Ilen_b, Jset_b, Jlen_b, bonderrs, perrs, maxsample,
             nevals2) = out[:8]
            I1, Il1, J1, Jl1, ms1, nevals1 = out[8:14]
            rest = out[14:]
            nevals_run = int(nevals1) + int(nevals2)
        else:
            out = jax.device_get(self._dispatch(
                "sweep pair", self._get_sweep_pair(fwd1, fwd2, False, nsearch),
                *args, *starts_arg,
            ))
            Iset_b, Ilen_b, Jset_b, Jlen_b, bonderrs, perrs, maxsample = (
                out[:7]
            )
            I1, Il1, J1, Jl1, ms1 = out[7:12]
            rest = out[12:]
            nevals_run = 0
            for b in range(L - 1):
                Icap = self.Imax * self.localdims[b] + self.Imax
                Jcap = self.localdims[b + 1] * self.Imax + self.Imax
                nevals_run += 2 * Icap * Jcap
        n_fill = 3 if self.pair else 2
        fill_res = rest[:n_fill]
        search_res = rest[n_fill:]
        maxsample = max(float(maxsample), float(ms1))

        # saturation: if either sweep hit the capacity, grow and redo both
        # (the discarded attempt is NOT counted toward nevals, matching
        # the per-sweep and optimize_loop tiers)
        if (
            max(int(np.max(Ilen_b)), int(np.max(Il1))) >= self.Imax
            and self.Imax < maxbonddim
        ):
            if not self._grow_capacity():
                return False
            return self.sweep2site_pair(
                tci, fwd1, fwd2, reltol, abstol, maxbonddim, extraIset,
                extraJset, pivotsearch=pivotsearch,
                strictlynested=strictlynested, search_starts=search_starts,
            )
        self.nevals += nevals_run

        prefix_lens = list(range(L))
        suffix_lens = [L - b - 1 for b in range(L)]
        # history bookkeeping matching two sequential sweep iterations:
        # first the pair's INPUT sets (tci.Iset is not yet mutated here),
        # then the mid-point sets (what the second sweep saw as extras)
        tci.Iset_history.append([list(s) for s in tci.Iset])
        tci.Jset_history.append([list(s) for s in tci.Jset])
        tci.Iset_history.append(self._unpack(I1, Il1, prefix_lens))
        tci.Jset_history.append(self._unpack(J1, Jl1, suffix_lens))
        tci.Iset = self._unpack(Iset_b, Ilen_b, prefix_lens)
        tci.Jset = self._unpack(Jset_b, Jlen_b, suffix_lens)
        tci.maxsamplevalue = max(tci.maxsamplevalue, maxsample)
        for b in range(L - 1):
            tci.updateerrors(
                b, list(perrs[b][: int(Ilen_b[b + 1]) + 1])
            )
        self._store_sitetensors(tci, fill_res)
        self.last_sweep_filled = True
        if nsearch:
            self.last_search = (
                np.asarray(search_res[0]), np.asarray(search_res[1])
            )
            # actual device f evaluations of the in-program search
            self.nevals += nsearch * L * max(self.localdims)
        return True

    def _get_optimize_loop(self, fwd1: bool, fwd2: bool, nsearch: int,
                           nch: int, rook: bool = False):
        """Up to loop_kmax optimize iterations as ONE lax.while_loop
        program.

        Each loop step is the sweep-pair body (sweep fwd1, sweep fwd2 with
        the first sweep's inputs as non-strict extras, site-tensor fill,
        global-search candidates vs the filled cores) plus the reference's
        convergence bookkeeping (tensorci2.jl:947-966: error/rank windows
        over the last `nch` iterations, the global-pivot column handled by
        the precomputed ngp_ok vector since in-loop iterations contribute
        zeros). The loop exits with a code: 0 converged, 1 a start point's
        best candidate exceeded abstol*tolmargin (host inserts the global
        pivots), 2 a sweep saturated the Imax capacity (that iteration's
        state is DISCARDED — every carried field keeps its pre-iteration
        value — and the host re-runs it with a grown buffer), 3 budget
        exhausted. Per-iteration errors/ranks and the two pivot-set history
        snapshots (input + mid) are stacked into fixed (loop_kmax, ...)
        buffers so the host can replay the exact bookkeeping of the
        per-iteration path."""
        Kmax = self.loop_kmax
        key = ("oloop", fwd1, fwd2, self.Imax, nsearch, nch, rook, Kmax,
               self._scan_active())
        if key not in self._sweeps:
            s1 = self._get_sweep_rook(fwd1) if rook else self._get_sweep(fwd1)
            s2 = self._get_sweep_rook(fwd2) if rook else self._get_sweep(fwd2)
            fill_fn = self._get_fill()
            fjax, localdims, Imax = self.fjax, self.localdims, self.Imax
            jdtype, pair_mode = self._jdtype, self.pair
            shard_rows_c = self._shard_rows
            L = len(localdims)
            dmax = max(localdims)
            S = max(nsearch, 1)
            cdtype = jnp.float64 if pair_mode else jdtype

            @jax.jit
            def loop(Iset, Ilen, Jset, Jlen, eI, eIl, eJ, eJl,
                     reltol, tol, use_norm, maxbonddim, use_extra2,
                     starts_block, tolmargin, maxsample0,
                     win_err0, win_rank0, ngp_ok_vec, count0, check_ngp,
                     k_budget, *seeds):
                def cond(c):
                    return (~c["done"]) & (c["k"] < k_budget)

                def body(c):
                    norm = jnp.where(use_norm > 0, c["ms"], 1.0)
                    abstol = tol * norm
                    if rook:
                        sk = jax.lax.dynamic_index_in_dim(
                            seeds[0], c["k"], 0, keepdims=False
                        )
                        seed_args1, seed_args2 = (sk[0],), (sk[1],)
                    else:
                        seed_args1 = seed_args2 = ()
                    o1 = s1(c["I"], c["Il"], c["J"], c["Jl"],
                            c["eI"], c["eIl"] * use_extra2,
                            c["eJ"], c["eJl"] * use_extra2,
                            reltol, abstol, maxbonddim, *seed_args1)
                    I1, Il1, J1, Jl1 = o1[:4]
                    o2 = s2(I1, Il1, J1, Jl1,
                            c["I"], c["Il"] * use_extra2,
                            c["J"], c["Jl"] * use_extra2,
                            reltol, abstol, maxbonddim, *seed_args2)
                    if rook:
                        (I2, Il2, J2, Jl2, _bonderrs2, perrs2, ms2,
                         nev2) = o2
                        nev_new = c["nev"] + o1[7] + nev2
                    else:
                        I2, Il2, J2, Jl2, _bonderrs2, perrs2, ms2 = o2
                        nev_new = c["nev"]
                    fill_out = fill_fn(I2, Il2, J2, Jl2)
                    if pair_mode:
                        cores_n, coresi_n, fms = fill_out
                    else:
                        cores_n, fms = fill_out
                        coresi_n = c["coresi"]
                    ms_new = jnp.maximum(jnp.maximum(c["ms"], o1[6]),
                                         jnp.maximum(ms2, fms))
                    err_k = jnp.max(_bonderrs2)
                    rank_k = jnp.max(Il2[1:]).astype(jnp.int32)

                    sat = (
                        jnp.maximum(jnp.max(Il2), jnp.max(Il1))
                        >= jnp.int32(Imax)
                    ) & (jnp.int32(Imax) < maxbonddim)

                    if nsearch:
                        starts_k = jax.lax.dynamic_index_in_dim(
                            starts_block, c["k"], 0, keepdims=False
                        )
                        bflat, berr = _tt_search_on_cores(
                            fjax, localdims, Imax, jdtype, pair_mode,
                            cores_n, coresi_n if pair_mode else None,
                            Il2, Jl2, starts_k,
                            shard_rows=shard_rows_c,
                        )
                        found = jnp.any(berr > abstol * tolmargin)
                    else:
                        bflat = c["bflat"]
                        berr = c["berr"]
                        found = jnp.bool_(False)

                    win_err = jnp.concatenate([c["werr"][1:], err_k[None]])
                    win_rank = jnp.concatenate(
                        [c["wrank"][1:], rank_k[None]]
                    )
                    count = c["count"] + 1
                    ngp_ok = ngp_ok_vec[jnp.minimum(c["k"], nch - 1)]
                    window_full = count >= nch
                    conv = (
                        window_full
                        & jnp.all(win_err < abstol)
                        & jnp.where(check_ngp > 0, ngp_ok, True)
                        & (jnp.min(win_rank) == win_rank[-1])
                    ) | (window_full & jnp.all(win_rank >= maxbonddim))

                    done = sat | found | conv
                    code = jnp.where(
                        sat, 2,
                        jnp.where(found, 1, jnp.where(conv, 0, c["code"])),
                    ).astype(jnp.int32)

                    out_err = c["oerr"].at[c["k"]].set(err_k)
                    out_rank = c["orank"].at[c["k"]].set(rank_k)
                    hI = c["hI"].at[c["k"], 0].set(c["I"])
                    hI = hI.at[c["k"], 1].set(I1)
                    hIl = c["hIl"].at[c["k"], 0].set(c["Il"])
                    hIl = hIl.at[c["k"], 1].set(Il1)
                    hJ = c["hJ"].at[c["k"], 0].set(c["J"])
                    hJ = hJ.at[c["k"], 1].set(J1)
                    hJl = c["hJl"].at[c["k"], 0].set(c["Jl"])
                    hJl = hJl.at[c["k"], 1].set(Jl1)

                    # a saturated iteration is discarded: every carried
                    # field keeps its pre-iteration value and k does not
                    # advance, so the host resumes from the exact state
                    # the per-iteration path would re-run from
                    def keep(new, old):
                        return jnp.where(sat, old, new)

                    return {
                        "k": keep(c["k"] + 1, c["k"]),
                        "done": done,
                        "code": code,
                        "I": keep(I2, c["I"]), "Il": keep(Il2, c["Il"]),
                        "J": keep(J2, c["J"]), "Jl": keep(Jl2, c["Jl"]),
                        "eI": keep(I1, c["eI"]),
                        "eIl": keep(Il1, c["eIl"]),
                        "eJ": keep(J1, c["eJ"]),
                        "eJl": keep(Jl1, c["eJl"]),
                        "ms": keep(ms_new, c["ms"]),
                        "nev": keep(nev_new, c["nev"]),
                        "abstol": keep(abstol, c["abstol"]),
                        "werr": keep(win_err, c["werr"]),
                        "wrank": keep(win_rank, c["wrank"]),
                        "count": keep(count, c["count"]),
                        "oerr": keep(out_err, c["oerr"]),
                        "orank": keep(out_rank, c["orank"]),
                        "hI": keep(hI, c["hI"]), "hIl": keep(hIl, c["hIl"]),
                        "hJ": keep(hJ, c["hJ"]), "hJl": keep(hJl, c["hJl"]),
                        "perrs": keep(perrs2, c["perrs"]),
                        "cores": keep(cores_n, c["cores"]),
                        "coresi": keep(coresi_n, c["coresi"]),
                        "bflat": keep(bflat, c["bflat"]),
                        "berr": keep(berr, c["berr"]),
                    }

                init = {
                    "k": jnp.int32(0),
                    "done": jnp.bool_(False),
                    "code": jnp.int32(3),
                    "I": Iset, "Il": Ilen, "J": Jset, "Jl": Jlen,
                    "eI": eI, "eIl": eIl, "eJ": eJ, "eJl": eJl,
                    "ms": jnp.float64(maxsample0),
                    "nev": jnp.float64(0.0),
                    "abstol": jnp.float64(0.0),
                    "werr": win_err0, "wrank": win_rank0,
                    "count": jnp.int32(count0),
                    "oerr": jnp.zeros((Kmax,), jnp.float64),
                    "orank": jnp.zeros((Kmax,), jnp.int32),
                    "hI": jnp.zeros((Kmax, 2, L, Imax, L), jnp.int32),
                    "hIl": jnp.zeros((Kmax, 2, L), jnp.int32),
                    "hJ": jnp.zeros((Kmax, 2, L, Imax, L), jnp.int32),
                    "hJl": jnp.zeros((Kmax, 2, L), jnp.int32),
                    "perrs": jnp.zeros((L - 1, Imax + 1), jnp.float64),
                    "cores": jnp.zeros((L, Imax, dmax, Imax), cdtype),
                    "coresi": jnp.zeros(
                        (L, Imax, dmax, Imax) if pair_mode else (1,), cdtype
                    ),
                    "bflat": jnp.zeros((S,), jnp.int32),
                    "berr": jnp.full((S,), -jnp.inf, jnp.float64),
                }
                return jax.lax.while_loop(cond, body, init)

            self._sweeps[key] = loop
        return self._sweeps[key]

    def floatingzone(self, sitetensors, starts, nsweeps: int = 10**9,
                     earlystoptol: float = float("inf")):
        """Whole floating-zone search (estimatetrueerror's engine) as one
        device dispatch against an arbitrary host tensor train.

        sitetensors: the tt's ragged (χl, d, χr) cores; they are
        zero-padded into a bond-bucketed (L, χ_b, dmax, χ_b) stack so the
        compiled program is reused across tts of similar rank. Returns
        (pivots (S, L) int32, maxerr (S,) f64) as numpy, or None when the
        tt layout doesn't match this engine's localdims (caller falls
        back to the host lock-step search)."""
        L = len(self.localdims)
        if len(sitetensors) != L:
            return None
        tensors = [np.asarray(t) for t in sitetensors]
        for b, t in enumerate(tensors):
            if t.ndim != 3 or t.shape[1] != self.localdims[b]:
                return None
        if (
            any(np.iscomplexobj(t) for t in tensors)
            and not self.pair
            and not np.issubdtype(self.dtype, np.complexfloating)
        ):
            # a complex tt cannot ride a real-valued engine's program —
            # decline so the caller's host path (which derives its dtype
            # from the tt) handles it
            return None
        S = int(len(starts))
        if S == 0:
            return None
        dmax = max(self.localdims)
        chi = max(max(t.shape[0], t.shape[-1]) for t in tensors)
        chi_b = max(8, 1 << (chi - 1).bit_length())
        if self.pair:
            cr = np.zeros((L, chi_b, dmax, chi_b), np.float64)
            ci = np.zeros((L, chi_b, dmax, chi_b), np.float64)
            for l, t in enumerate(tensors):
                cr[l, : t.shape[0], : t.shape[1], : t.shape[2]] = t.real
                ci[l, : t.shape[0], : t.shape[1], : t.shape[2]] = t.imag
            cores_args = (jnp.asarray(cr), jnp.asarray(ci))
        else:
            cores = np.zeros((L, chi_b, dmax, chi_b), self.dtype)
            for l, t in enumerate(tensors):
                cores[l, : t.shape[0], : t.shape[1], : t.shape[2]] = t
            cores_args = (jnp.asarray(cores),)
        key = ("fzone", S, chi_b)
        if key not in self._sweeps:
            self._sweeps[key] = _make_floatingzone(
                self.fjax, self.localdims, chi_b, S, self._jdtype,
                pair=self.pair, shard_rows=self._shard_rows,
            )
        pivots, maxerr, k = jax.device_get(self._sweeps[key](
            jnp.asarray(np.asarray(starts, dtype=np.int32)),
            jnp.int32(min(nsweeps, 2**31 - 1)),
            jnp.float64(earlystoptol),
            *cores_args,
        ))
        self.nevals += S + int(k) * S * L * dmax
        return np.asarray(pivots), np.asarray(maxerr)

    def _grow_capacity(self) -> bool:
        """Grow Imax one capacity step (for a saturated loop/pair sweep);
        False when the capacity or program-size guards forbid it."""
        nxt = _imax_target(self.Imax, self.Imax + 1)
        if nxt > self.imax_cap or (
            nxt * (max(self.localdims) + 1) > self.max_panel_edge
        ):
            return False
        self.Imax = nxt
        return True

    def optimize_loop(self, tci, fwd1: bool, fwd2: bool, reltol: float,
                      tol: float, use_norm: bool, maxbonddim: int,
                      extraIset, extraJset, strictlynested: bool,
                      starts_block, tolmargin: float,
                      prev_errors, prev_ranks, prev_ngp,
                      nch: int, check_ngp: bool, k_budget: int,
                      pivotsearch: str = "full"):
        """Dispatch the multi-iteration loop program; returns the fetched
        result dict (numpy values) or None when capacity/edge guards
        decline. Does NOT mutate tci — the caller replays the per-iteration
        bookkeeping from the stacked outputs.

        pivotsearch='rook' traces the whole-sweep scan rook programs into
        the loop body, with 2 slab-iteration seeds per iteration pre-drawn
        from the engine rng in the same order the per-iteration pair path
        draws them (bit-identical rook trajectories while a single block
        covers the run; re-entries draw fresh seeds)."""
        L = len(self.localdims)
        rook = pivotsearch == "rook"
        needed = max(
            [len(s) for s in tci.Iset] + [len(s) for s in tci.Jset]
            + [len(s) for s in extraIset] + [len(s) for s in extraJset]
            + [1]
        )
        if needed > self.imax_cap or k_budget <= 0:
            return None
        target = _imax_target(self.Imax, needed)
        if target * (max(self.localdims) + 1) > self.max_panel_edge:
            return None
        # The loop's stacked history buffers are Kmax·2·L·Imax·L int32 ×2;
        # for long high-rank chains that allocation (and its transfer on
        # every block exit) would dwarf the dispatch savings — decline to
        # the per-iteration pair tier instead.
        hist_bytes = 2 * self.loop_kmax * 2 * L * target * L * 4
        if hist_bytes > 64 * 2**20:
            return None
        self.Imax = target

        Kmax = self.loop_kmax
        nsearch = 0 if starts_block is None else int(starts_block.shape[1])
        S = max(nsearch, 1)
        sb = np.zeros((Kmax, S, L), dtype=np.int32)
        if nsearch:
            kfill = min(Kmax, starts_block.shape[0])
            sb[:kfill] = starts_block[:kfill]

        # convergence windows seeded with the host's last nch-1 entries
        # (left-padded so an unfilled window can never satisfy the
        # criterion before `count` reaches nch)
        win_err0 = np.full((nch,), np.inf, dtype=np.float64)
        win_rank0 = np.full((nch,), 2**30, dtype=np.int32)
        tail_e = list(prev_errors)[-(nch - 1):] if nch > 1 else []
        tail_r = list(prev_ranks)[-(nch - 1):] if nch > 1 else []
        if tail_e:
            win_err0[-len(tail_e):] = tail_e
        if tail_r:
            win_rank0[-len(tail_r):] = tail_r
        # ngp_ok_vec[j]: with j+1 in-loop iterations appended (all zero
        # global pivots), is the last-nch ngp window all-zero?
        ngp_tail = list(prev_ngp)
        ngp_ok = np.zeros((nch,), dtype=bool)
        for j in range(nch):
            host_part = ngp_tail[-(nch - 1 - j):] if (nch - 1 - j) > 0 else []
            ngp_ok[j] = all(g == 0 for g in host_part)

        seed_args = ()
        if rook:
            # scalar draws in the exact order the per-iteration pair path
            # consumes them (2 per iteration)
            sd = np.zeros((Kmax, 2), dtype=np.uint32)
            for k in range(min(k_budget, Kmax)):
                sd[k, 0] = self._rng.integers(0, 2**31 - 1)
                sd[k, 1] = self._rng.integers(0, 2**31 - 1)
            seed_args = (jnp.asarray(sd),)

        Iset, Ilen = self._pack(tci.Iset, "left")
        Jset, Jlen = self._pack(tci.Jset, "left")
        eIb, eIlen = self._pack(extraIset, "left")
        eJb, eJlen = self._pack(extraJset, "left")
        fn = self._get_optimize_loop(fwd1, fwd2, nsearch, nch, rook)
        res = jax.device_get(self._dispatch(
            "whole-optimization loop", fn,
            jnp.asarray(Iset), jnp.asarray(Ilen),
            jnp.asarray(Jset), jnp.asarray(Jlen),
            jnp.asarray(eIb), jnp.asarray(eIlen),
            jnp.asarray(eJb), jnp.asarray(eJlen),
            jnp.float64(reltol), jnp.float64(tol),
            jnp.int32(1 if use_norm else 0),
            jnp.int32(min(maxbonddim, 2**31 - 1)),
            jnp.int32(0 if strictlynested else 1),
            jnp.asarray(sb), jnp.float64(tolmargin),
            jnp.float64(tci.maxsamplevalue),
            jnp.asarray(win_err0), jnp.asarray(win_rank0),
            jnp.asarray(ngp_ok),
            jnp.int32(len(prev_errors)),
            jnp.int32(1 if check_ngp else 0),
            jnp.int32(min(k_budget, Kmax)),
            *seed_args,
        ))
        res["rook"] = rook
        return res

    def _store_sitetensors(self, tci, res) -> None:
        """Write a fill program's output stack into tci._sitetensors
        (unpadding each site to its true (|I_b|, d_b, |I_{b+1}|) shape)."""
        L = len(self.localdims)
        if self.pair:
            outr, outi, maxsample = res
            out = np.asarray(outr) + 1j * np.asarray(outi)
        else:
            out, maxsample = res
        tci.maxsamplevalue = max(tci.maxsamplevalue, float(maxsample))
        for b in range(L):
            nr_rows = len(tci.Iset[b])
            d_b = self.localdims[b]
            ncols = len(tci.Iset[b + 1]) if b < L - 1 else len(tci.Jset[b])
            T = np.asarray(out[b][:nr_rows, :d_b, :ncols])
            tci._sitetensors[b] = T
            self.nevals += self.Imax * d_b * self.Imax
            if b < L - 1:
                self.nevals += self.Imax * self.Imax

    def _get_sweep1(self, forward: bool):
        # scan body by default: the 1-site sweep runs ONCE per optimization
        # (the post-convergence cleanup, tensorci2.jl:1157-1167), so its
        # compile wall dominates its runtime; the scan body compiles once
        # for all bonds, with identical results (parity test in
        # test_device_sweep). The unrolled maker remains for tests/parity.
        key = ("sweep1", forward, self.Imax)
        if key not in self._sweeps:
            maker = _make_sweep1site_scan
            self._sweeps[key] = maker(
                self.fjax, self.localdims, self.Imax, forward, self._jdtype,
                pair=self.pair,
            )
        return self._sweeps[key]

    def fillsitetensors(self, tci) -> bool:
        """Compute all site tensors in one device program (unrolled for
        short chains, lax.scan over bonds for long ones; complex via the
        (re, im) pair program)."""
        L = len(self.localdims)
        needed = max(
            [len(s) for s in tci.Iset] + [len(s) for s in tci.Jset] + [1]
        )
        if needed > self.imax_cap:
            return False
        target = _imax_target(self.Imax, needed)
        if target * (max(self.localdims) + 1) > self.max_panel_edge:
            return False
        self.Imax = target
        Iset, Ilen = self._pack(tci.Iset, "left")
        Jset, Jlen = self._pack(tci.Jset, "left")
        res = jax.device_get(self._dispatch(
            "site-tensor fill", self._get_fill(),
            jnp.asarray(Iset), jnp.asarray(Ilen),
            jnp.asarray(Jset), jnp.asarray(Jlen),
        ))
        self._store_sitetensors(tci, res)
        return True

    def sweep1site(self, tci, forward: bool, reltol: float, abstol: float,
                   maxbonddim: int, updatetensors: bool = True) -> bool:
        """One-site sweep as one device program (unrolled for short chains,
        lax.scan over bonds for long ones; complex via the (re, im) pair
        program), updating tci in place."""
        L = len(self.localdims)
        needed = max(
            [len(s) for s in tci.Iset] + [len(s) for s in tci.Jset] + [1]
        )
        if needed > self.imax_cap:
            return False
        target = _imax_target(self.Imax, needed)
        if target * (max(self.localdims) + 1) > self.max_panel_edge:
            return False
        self.Imax = target
        Iset_h = [list(s) for s in tci.Iset]
        Jset_h = [list(s) for s in tci.Jset]
        while True:
            Iset, Ilen = self._pack(Iset_h, "left")
            Jset, Jlen = self._pack(Jset_h, "left")
            out = self._dispatch(
                "one-site sweep", self._get_sweep1(forward),
                jnp.asarray(Iset), jnp.asarray(Ilen),
                jnp.asarray(Jset), jnp.asarray(Jlen),
                jnp.float64(reltol), jnp.float64(abstol),
                jnp.int32(min(maxbonddim, 2**31 - 1)),
            )
            if self.pair:
                (Iset_b, Ilen_b, Jset_b, Jlen_b, tr, ti, bonderrs, perrs,
                 maxsample) = jax.device_get(out)
                tensors = np.asarray(tr) + 1j * np.asarray(ti)
            else:
                (Iset_b, Ilen_b, Jset_b, Jlen_b, tensors, bonderrs, perrs,
                 maxsample) = jax.device_get(out)
            if int(max(np.max(Ilen_b), np.max(Jlen_b))) >= self.Imax \
                    and self.Imax < maxbonddim:
                nxt = _imax_target(self.Imax, self.Imax + 1)
                if nxt > self.imax_cap or (
                    nxt * (max(self.localdims) + 1) > self.max_panel_edge
                ):
                    return False
                self.Imax = nxt
                continue
            break

        prefix_lens = list(range(L))
        suffix_lens = [L - b - 1 for b in range(L)]
        tci.Iset = self._unpack(Iset_b, Ilen_b, prefix_lens)
        tci.Jset = self._unpack(Jset_b, Jlen_b, suffix_lens)
        tci.maxsamplevalue = max(tci.maxsamplevalue, float(maxsample))
        if updatetensors:
            for b in range(L):
                nr_rows = len(tci.Iset[b])
                d_b = self.localdims[b]
                ncols = (
                    len(tci.Iset[b + 1]) if b < L - 1 else len(tci.Jset[b])
                )
                T = np.asarray(tensors[b][:nr_rows, :d_b, :ncols])
                if np.isnan(T).any():
                    raise ValueError(f"Error: NaN in tensor T[{b}]")
                tci._sitetensors[b] = T
        for b in range(L - 1):
            k = int(Ilen_b[b + 1]) if forward else int(Jlen_b[b])
            tci.updateerrors(b, list(perrs[b][: k + 1]))
        for b in range(L):
            self.nevals += self.Imax * self.localdims[b] * self.Imax
        return True
