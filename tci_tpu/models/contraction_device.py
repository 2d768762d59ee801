"""Device-resident zip-up MPO-MPO contraction.

Device counterpart of the streaming contract+factorize zip-up
(reference: src/contraction.jl:751-788). Each bond step is ONE XLA program:
the three-tensor einsum fused with the rank-revealing LU
truncation (ops/lu_kernel._rrlu_state) and the CI factor extraction
(ops/fused.ci_factors). Rank is data, not shape: every bond is padded to a
static per-site cap, carries a runtime rank scalar, and is masked so padded
rows/columns stay exactly zero; site tensors are unpadded on the host only
once, at the end.

Complex operands run as (re, im) f64 pair programs (ops/complex_pair.py).
"""

from __future__ import annotations

from functools import partial
from typing import List

import numpy as np

import jax
import jax.numpy as jnp

from ..ops.lu_kernel import _rrlu_state
from .tensortrain import TensorTrain

_INTMAX = 2**62

# Whole-contraction programs: the per-bond steps below are individually
# jitted, but a contraction still pays one dispatch per bond. The entry points
# compose ALL bonds into one jitted program, cached here by the operand
# shape signature (cf. the whole-sweep programs of models/device_sweep.py).
_whole_programs: dict = {}


def _cached_program(key, builder):
    if key not in _whole_programs:
        _whole_programs[key] = jax.jit(builder())
    return _whole_programs[key]


# Mesh-sharded bond splits, cached per (mesh devices, shape signature) —
# each is a shard_map program reused across whole-contraction builders.
_split_cache: dict = {}


def _mesh_key(mesh):
    if mesh is None:
        return None
    return (tuple(d.id for d in mesh.devices.flat), mesh.axis_names)


def _split_for(mesh, m: int, n: int, cap: int, leftorthogonal: bool):
    """Bond-split kernel selector: the single-device fused rrLU split, or —
    given a mesh — the row-sharded tensor-parallel elimination
    (ops/lu_sharded.make_lu_split_sharded, same per-device body as
    ``rrlu_sharded_raw``: bit-identical pivot order). Only the elimination
    — the sequential hot loop — computes sharded; the surrounding merge
    einsums are pinned replicated at the shard_map boundary so mesh and
    single-device tiers stay bit-identical (see the bit-parity note in
    make_lu_split_sharded)."""
    if mesh is None:
        def split(Cm, m_true, n_true, reltol, abstol):
            return _lu_split(Cm, m_true, n_true, reltol, abstol, cap=cap,
                             leftorthogonal=leftorthogonal)

        return split
    key = (_mesh_key(mesh), m, n, cap, leftorthogonal)
    if key not in _split_cache:
        from ..ops.lu_sharded import make_lu_split_sharded

        _split_cache[key] = make_lu_split_sharded(
            mesh, m, n, cap, leftorthogonal
        )
    return _split_cache[key]


def _split_pair_for(mesh, m: int, n: int, cap: int, leftorthogonal: bool):
    """Pair-mode (re, im) counterpart of _split_for: single-device
    _lu_split_pair, or the row-sharded pair elimination
    (ops/lu_sharded.make_lu_split_sharded_pair) when a mesh is given."""
    if mesh is None:
        def split(Cmr, Cmi, m_true, n_true, reltol, abstol):
            return _lu_split_pair(Cmr, Cmi, m_true, n_true, reltol, abstol,
                                  cap=cap, leftorthogonal=leftorthogonal)

        return split
    key = (_mesh_key(mesh), m, n, cap, leftorthogonal, "pair")
    if key not in _split_cache:
        from ..ops.lu_sharded import make_lu_split_sharded_pair

        _split_cache[key] = make_lu_split_sharded_pair(
            mesh, m, n, cap, leftorthogonal
        )
    return _split_cache[key]


def _zip_step(R, a, b, reltol, cap: int, last: bool, mesh=None):
    """One zip-up bond: C = R·A[n]·B[n], then rank-revealing LU split.

    R: (P, La, Lb) with rows >= previous rank zeroed; a: (La, i, K, Ra);
    b: (Lb, K, j, Rb). Returns (site (P, i, j, cap), newR (cap, Ra, Rb),
    rank scalar); for the last site returns the unsplit core. The split is
    the shared _lu_split kernel (leftorthogonal=False: L carries the pivot
    diagonal, U has unit diagonal, matching the host rrlu.left()/right()
    convention), so truncated device and host zip-ups carry the SAME right
    factor bond-to-bond and stay bit-comparable. With a mesh, the split's
    elimination runs row-sharded (traced inside the caller's program).
    """
    C = jnp.einsum("pab,aikr,bkjs->pijrs", R, a, b)
    P, i, j, Ra, Rb = C.shape
    if last:
        return C.reshape(P, i, j, Ra * Rb), None, None
    m, n = P * i * j, Ra * Rb
    left, right, kk = _split_for(mesh, m, n, cap, False)(
        C.reshape(m, n), jnp.int32(m), jnp.int32(n), reltol,
        jnp.float64(0.0),
    )
    return left.reshape(P, i, j, cap), right.reshape(cap, Ra, Rb), kk


def contract_zipup_device(
    A: TensorTrain,
    B: TensorTrain,
    tolerance: float = 1e-12,
    maxbonddim: int = _INTMAX,
    mesh=None,
) -> TensorTrain:
    """Zip-up contraction of two 4-leg tensor trains on device.

    Equivalent to the host ``contract_zipup(A, B, method="LU")``: the same
    rrLU truncation rule (reltol=tolerance, abstol=0, maxrank=maxbonddim) is
    applied at every bond, but the einsum + factorization run as one fused
    XLA program per bond with no host round trip until the final unpadding.

    With ``mesh`` (a 1-D ``jax.sharding.Mesh``), every bond's rrLU split
    runs row-sharded over the devices (ops/lu_sharded) with bit-identical
    pivot order; complex operands shard through the (re, im) pair
    elimination.
    """
    if len(A) != len(B):
        raise ValueError("Cannot contract tensor trains with different length.")
    dtype = np.result_type(A[0].dtype, B[0].dtype)
    wdtype = jnp.float64
    if np.issubdtype(dtype, np.complexfloating):
        # complex operands run the (re, im) f64 pair programs
        # (ops/complex_pair.py); with a mesh the pair bond splits run the
        # row-sharded pair elimination
        return _contract_zipup_device_pair(A, B, tolerance, maxbonddim,
                                           mesh=mesh)
    L = len(A)
    ajs = [jnp.asarray(A[n], dtype=wdtype) for n in range(L)]
    bjs = [jnp.asarray(B[n], dtype=wdtype) for n in range(L)]

    caps = []
    P = 1
    for n in range(L - 1):
        m = P * ajs[n].shape[1] * bjs[n].shape[2]
        nn = ajs[n].shape[3] * bjs[n].shape[3]
        caps.append(int(min(maxbonddim, m, nn)))
        P = caps[-1]
    ash = tuple(t.shape for t in ajs)
    bsh = tuple(t.shape for t in bjs)

    def builder():
        def run(reltol, *cores):
            ajs_, bjs_ = cores[:L], cores[L:]
            sites, kks = [], []
            R = jnp.ones((1, 1, 1), dtype=wdtype)
            for n in range(L):
                if n == L - 1:
                    site, _, _ = _zip_step(
                        R, ajs_[n], bjs_[n], reltol, cap=1, last=True
                    )
                    sites.append(site)
                    break
                site, R, kk = _zip_step(
                    R, ajs_[n], bjs_[n], reltol, cap=caps[n], last=False,
                    mesh=mesh,
                )
                sites.append(site)
                kks.append(kk)
            return tuple(sites) + tuple(kks)

        return run

    prog = _cached_program(
        ("zip", ash, bsh, tuple(caps), str(np.dtype(wdtype)),
         _mesh_key(mesh)),
        builder,
    )
    outs = jax.device_get(prog(jnp.float64(tolerance), *ajs, *bjs))
    host, kks = outs[:L], outs[L:]
    ranks = [max(1, int(k)) for k in kks]
    out: List[np.ndarray] = []
    for n in range(L):
        t = host[n]
        lo = 1 if n == 0 else ranks[n - 1]
        hi = 1 if n == L - 1 else ranks[n]
        out.append(np.asarray(t[:lo, :, :, :hi], dtype=dtype))
    return TensorTrain(out)


# ---------------------------------------------------------------------------
# Device product evaluator: contract_TCI's BatchEvaluator device fast path
# ---------------------------------------------------------------------------


def make_product_evaluator(A: TensorTrain, B: TensorTrain, f=None,
                           pair=None):
    """Jax-traceable evaluator of the lazy MPO-MPO product.

    Device counterpart of the Contraction environment caches
    (reference: src/contraction.jl:279-406): instead of host-side memoized
    left/right environments, the product value at one fused multi-index is a
    scan of (ra x rb) transfer-matrix contractions over sites — batched by
    vmap into GEMMs and consumed by every device tier of TCI2 (fused bond
    updates, whole-sweep programs) through JaxBatchEvaluator.

    Returns (fjax, localdims, dtype, pair) where fjax maps an (L,) int32
    vector of C-order fused indices (idx = i * d2 + j) to the scalar product
    value; `f` (optional) is a jax-traceable elementwise post-map applied on
    device (contraction.jl:131-147 applies it per evaluated entry).

    `pair` selects the (re, im) f64 pair representation for complex
    operands (fjax then returns jnp.stack([re, im]) and the caller must
    pass pair_output=True to JaxBatchEvaluator). Default None = automatic:
    pair mode whenever the result dtype is complex and the jax backend
    cannot execute complex dtypes, matching the zipup/
    naive device tiers. A complex post-map `f` in pair mode must itself be
    pair-valued: it receives and returns the stacked [re, im] vector.
    """
    L = len(A)
    if len(B) != L:
        raise ValueError("Cannot contract tensor trains with different length.")
    for n in range(L):
        if A[n].ndim != 4 or B[n].ndim != 4:
            raise ValueError("Contraction requires 4-leg tensor trains.")
        if A[n].shape[2] != B[n].shape[1]:
            raise ValueError(
                f"Tensor trains must share the identical index at n={n}!"
            )
    dtype = np.result_type(A[0].dtype, B[0].dtype).type
    iscomplex = np.issubdtype(dtype, np.complexfloating)
    if pair is None:
        from ..parallel.batcheval import platform_supports_complex

        pair = iscomplex and not platform_supports_complex()
        if pair and f is not None:
            # A complex-scalar post-map (e.g. lambda z: z**2) traces fine in
            # pair mode but silently computes [re**2, im**2] instead of the
            # complex square — backend-dependent wrong answers. Require the
            # caller to opt in with pair=True, asserting f is pair-aware
            # (maps the stacked [re, im] vector to a stacked [re, im]).
            raise ValueError(
                "complex operands on a complex-free backend require the "
                "(re, im) pair representation, but a post-map `f` written "
                "for complex scalars would silently be applied to the "
                "stacked [re, im] vector. Pass pair=True explicitly if `f` "
                "is pair-aware, or drop `f`/run on a complex-capable "
                "backend."
            )
    if pair and not iscomplex:
        raise ValueError("pair mode requires complex operands")
    ra = max(max(t.shape[0], t.shape[3]) for t in A.sitetensors())
    rb = max(max(t.shape[0], t.shape[3]) for t in B.sitetensors())
    kmax = max(t.shape[2] for t in A.sitetensors())
    d1 = max(t.shape[1] for t in A.sitetensors())
    d2 = max(t.shape[2] for t in B.sitetensors())

    stack_dtype = np.float64 if pair else dtype
    a_stack = np.zeros((L, ra, d1, kmax, ra), dtype=stack_dtype)
    b_stack = np.zeros((L, rb, kmax, d2, rb), dtype=stack_dtype)
    if pair:
        ai_stack = np.zeros_like(a_stack)
        bi_stack = np.zeros_like(b_stack)
    d2s = np.zeros((L,), dtype=np.int32)
    for n in range(L):
        ta, tb = A[n], B[n]
        sl_a = np.s_[n, : ta.shape[0], : ta.shape[1], : ta.shape[2],
                     : ta.shape[3]]
        sl_b = np.s_[n, : tb.shape[0], : tb.shape[1], : tb.shape[2],
                     : tb.shape[3]]
        if pair:
            a_stack[sl_a] = np.real(ta)
            ai_stack[sl_a] = np.imag(ta)
            b_stack[sl_b] = np.real(tb)
            bi_stack[sl_b] = np.imag(tb)
        else:
            a_stack[sl_a] = ta
            b_stack[sl_b] = tb
        d2s[n] = tb.shape[2]
    a_d = jnp.asarray(a_stack)
    b_d = jnp.asarray(b_stack)
    if pair:
        ai_d = jnp.asarray(ai_stack)
        bi_d = jnp.asarray(bi_stack)
    d2_d = jnp.asarray(d2s)
    localdims = [int(A[n].shape[1] * B[n].shape[2]) for n in range(L)]

    if pair:
        def fjax_pair(idx):
            i = idx // d2_d
            j = idx % d2_d
            vr0 = jnp.zeros((ra, rb), dtype=jnp.float64).at[0, 0].set(1.0)
            vi0 = jnp.zeros((ra, rb), dtype=jnp.float64)

            def body(carry, inp):
                vr, vi = carry
                ar_n, ai_n, br_n, bi_n, i_n, j_n = inp
                Air = jnp.take(ar_n, i_n, axis=1)  # (ra, k, ra)
                Aii = jnp.take(ai_n, i_n, axis=1)
                Bjr = jnp.take(br_n, j_n, axis=2)  # (rb, k, rb)
                Bji = jnp.take(bi_n, j_n, axis=2)
                # t = v · A_i  (complex via 4 real einsums)
                tr = jnp.einsum("ab,akc->bkc", vr, Air) - jnp.einsum(
                    "ab,akc->bkc", vi, Aii)
                ti = jnp.einsum("ab,akc->bkc", vr, Aii) + jnp.einsum(
                    "ab,akc->bkc", vi, Air)
                # v = t · B_j
                nvr = jnp.einsum("bkc,bkd->cd", tr, Bjr) - jnp.einsum(
                    "bkc,bkd->cd", ti, Bji)
                nvi = jnp.einsum("bkc,bkd->cd", tr, Bji) + jnp.einsum(
                    "bkc,bkd->cd", ti, Bjr)
                return (nvr, nvi), None

            (vr, vi), _ = jax.lax.scan(
                body, (vr0, vi0), (a_d, ai_d, b_d, bi_d, i, j)
            )
            res = jnp.stack([vr[0, 0], vi[0, 0]])
            if f is not None:
                res = f(res)
            return res

        return fjax_pair, localdims, dtype, True

    def fjax(idx):
        i = idx // d2_d
        j = idx % d2_d
        v0 = jnp.zeros((ra, rb), dtype=a_d.dtype).at[0, 0].set(1.0)

        def body(v, inp):
            a_n, b_n, i_n, j_n = inp
            Ai = jnp.take(a_n, i_n, axis=1)  # (ra, k, ra)
            Bj = jnp.take(b_n, j_n, axis=2)  # (rb, k, rb)
            t = jnp.einsum("ab,akc->bkc", v, Ai,
                           preferred_element_type=a_d.dtype)
            v = jnp.einsum("bkc,bkd->cd", t, Bj,
                           preferred_element_type=a_d.dtype)
            return v, None

        v, _ = jax.lax.scan(body, v0, (a_d, b_d, i, j))
        res = v[0, 0]
        if f is not None:
            res = f(res)
        return res

    return fjax, localdims, dtype, False


# ---------------------------------------------------------------------------
# Device naive contraction: einsum merge + two-pass LU compress on device
# ---------------------------------------------------------------------------


@partial(jax.jit, static_argnames=("cap", "leftorthogonal"))
def _lu_split(Cm, m_true, n_true, reltol, abstol, cap: int,
              leftorthogonal: bool):
    """Split Cm ≈ left · right by rank-revealing LU on device, mirroring the
    host rrlu left()/right() convention (ops/lu.py:119-131): with
    leftorthogonal, L is unit-diagonal and U carries the pivots; otherwise L
    carries the pivots and U is unit-diagonal. Truncated columns/rows beyond
    the returned rank are zeroed. Returns (left (m, cap), right (cap, n), k).
    Also used by models/compress_device.py, which needs a real abstol (the
    normalizeerror=False truncation rule).

    Real panels always run the swap-free FUSED elimination body (not the
    size-dispatched _rrlu_state): it is the same arithmetic as the
    mesh-sharded per-device body (ops/lu_sharded), so the mesh and
    single-device tiers stay bit-identical for every panel size — the
    physical-swap small-panel body differs by an ulp on rank-deficient
    panels."""
    from ..ops.lu_kernel import _rrlu_state_fused

    m, n = Cm.shape
    maxrank = min(m, n, cap)
    state_fn = _rrlu_state if jnp.iscomplexobj(Cm) else _rrlu_state_fused
    A_out, rowperm, colperm, kk, _, _ = state_fn(
        Cm, m_true, n_true, jnp.int32(maxrank), reltol, abstol,
        leftorthogonal,
    )
    rmax = min(m, n)
    ridx = jnp.arange(rmax)
    keep = ridx < kk
    L_all = jnp.tril(A_out[:, :rmax])
    U_all = jnp.triu(A_out[:rmax, :])
    if leftorthogonal:
        L_all = L_all.at[jnp.arange(m)[:rmax], ridx].set(1.0)
    else:
        U_all = U_all.at[ridx, jnp.arange(n)[:rmax]].set(1.0)
    L_all = jnp.where(keep[None, :], L_all, 0.0)
    U_all = jnp.where(keep[:, None], U_all, 0.0)
    left = jnp.zeros_like(L_all).at[rowperm, :].set(L_all)[:, :cap]
    right = jnp.zeros_like(U_all).at[:, colperm].set(U_all)[:cap, :]
    return left, right, kk


@jax.jit
def _merge_sites(a, b):
    """Kronecker site merge on device (reference contraction.jl:591-602):
    (la, i, k, ra) x (lb, k, j, rb) -> (la*lb, i, j, ra*rb)."""
    la, i, _, ra = a.shape
    lb, _, j, rb = b.shape
    ab = jnp.einsum("aikr,bkjs->abijrs", a, b,
                    preferred_element_type=a.dtype)
    return ab.reshape(la * lb, i, j, ra * rb)


def contract_naive_device(
    A: TensorTrain,
    B: TensorTrain,
    tolerance: float = 0.0,
    maxbonddim: int = _INTMAX,
    mesh=None,
) -> TensorTrain:
    """Naive contraction with every einsum and factorization on device.

    Equivalent to the host ``contract_naive`` (reference
    contraction.jl:616-637) with the LU truncation rule in place of SVD: the
    sitewise Kronecker merges are device einsums, and the two-pass compression
    (L→R exact orthogonalization, R→L truncating — tensortrain.jl:302-348)
    runs each bond as one fused rrLU program, with data staying on device
    between bonds.

    With ``mesh``, every bond's rrLU split runs row-sharded over the
    devices (ops/lu_sharded) with bit-identical pivot order.
    """
    if len(A) != len(B):
        raise ValueError("Cannot contract tensor trains with different length.")
    dtype = np.result_type(A[0].dtype, B[0].dtype)
    wdtype = jnp.float64
    if np.issubdtype(dtype, np.complexfloating):
        # complex operands run the (re, im) f64 pair programs; with a mesh
        # the pair bond splits run the row-sharded pair elimination
        return _contract_naive_device_pair(A, B, tolerance, maxbonddim,
                                           mesh=mesh)
    L = len(A)
    ajs = [jnp.asarray(A[n], dtype=wdtype) for n in range(L)]
    bjs = [jnp.asarray(B[n], dtype=wdtype) for n in range(L)]
    ash = tuple(t.shape for t in ajs)
    bsh = tuple(t.shape for t in bjs)
    truncate = tolerance > 0 or maxbonddim < _INTMAX
    mbd = int(min(maxbonddim, 2**31 - 1))

    def builder():
        def run(reltol, *cores):
            tt = [
                _merge_sites(cores[n], cores[L + n]) for n in range(L)
            ]
            if not truncate:
                return tuple(tt)

            # L→R exact pass (tolerance 0, leftorthogonal)
            zero = jnp.float64(0.0)
            for ell in range(L - 1):
                sh = tt[ell].shape
                m = int(np.prod(sh[:-1]))
                n = int(sh[-1])
                cap = min(m, n)
                left, right, _ = _split_for(mesh, m, n, cap, True)(
                    tt[ell].reshape(m, n), jnp.int32(m), jnp.int32(n),
                    zero, zero,
                )
                tt[ell] = left.reshape(*sh[:-1], cap)
                shr = tt[ell + 1].shape
                nxt = right @ tt[ell + 1].reshape(
                    shr[0], int(np.prod(shr[1:]))
                )
                tt[ell + 1] = nxt.reshape(cap, *shr[1:])

            # R→L truncating pass
            ranks = []
            for ell in range(L - 1, 0, -1):
                sh = tt[ell].shape
                m = int(sh[0])
                n = int(np.prod(sh[1:]))
                cap = int(min(m, n, mbd))
                left, right, kk = _split_for(mesh, m, n, cap, False)(
                    tt[ell].reshape(m, n), jnp.int32(m), jnp.int32(n),
                    reltol, zero,
                )
                tt[ell] = right.reshape(cap, *sh[1:])
                shl = tt[ell - 1].shape
                nxt = tt[ell - 1].reshape(
                    int(np.prod(shl[:-1])), shl[-1]
                ) @ left
                tt[ell - 1] = nxt.reshape(*shl[:-1], cap)
                ranks.append(kk)
            return tuple(tt) + tuple(ranks)

        return run

    prog = _cached_program(
        ("naive", ash, bsh, mbd, truncate, str(np.dtype(wdtype)),
         _mesh_key(mesh)),
        builder,
    )
    outs = jax.device_get(prog(jnp.float64(tolerance), *ajs, *bjs))
    if not truncate:
        return TensorTrain([np.asarray(t, dtype=dtype) for t in outs])
    host, kks = outs[:L], outs[L:]
    ranks = [max(1, int(k)) for k in kks][::-1]
    out = []
    for n in range(L):
        t = host[n]
        lo = 1 if n == 0 else ranks[n - 1]
        hi = 1 if n == L - 1 else ranks[n]
        out.append(np.asarray(t[:lo, :, :, :hi] if t.ndim == 4 else t,
                              dtype=dtype))
    return TensorTrain(out)


# ---------------------------------------------------------------------------
# Pair-mode (complex) device tiers: complex carried as (re, im) f64 pairs
# (ops/complex_pair.py)
# ---------------------------------------------------------------------------


def _zip_step_pair(Rr, Ri, ar, ai, br, bi, reltol, cap: int, last: bool,
                   mesh=None):
    """Pair-mode _zip_step: C = R·A[n]·B[n] via 4 real einsums per complex
    product, then the shared pair rrLU split (_lu_split_pair,
    leftorthogonal=False convention, matching _zip_step)."""
    # T = R·A  (pab,aikr->pbikr contracted below in one einsum each)
    Tr = jnp.einsum("pab,aikr->pbikr", Rr, ar) - jnp.einsum(
        "pab,aikr->pbikr", Ri, ai)
    Ti = jnp.einsum("pab,aikr->pbikr", Rr, ai) + jnp.einsum(
        "pab,aikr->pbikr", Ri, ar)
    # C = T·B  (pbikr,bkjs->pijrs)
    Cr = jnp.einsum("pbikr,bkjs->pijrs", Tr, br) - jnp.einsum(
        "pbikr,bkjs->pijrs", Ti, bi)
    Ci = jnp.einsum("pbikr,bkjs->pijrs", Tr, bi) + jnp.einsum(
        "pbikr,bkjs->pijrs", Ti, br)
    P, i, j, Ra, Rb = Cr.shape
    if last:
        return (Cr.reshape(P, i, j, Ra * Rb), Ci.reshape(P, i, j, Ra * Rb),
                None, None, None)
    m, n = P * i * j, Ra * Rb
    lr, li, rr, ri, kk = _split_pair_for(mesh, m, n, cap, False)(
        Cr.reshape(m, n), Ci.reshape(m, n), jnp.int32(m), jnp.int32(n),
        reltol, jnp.float64(0.0),
    )
    return (lr.reshape(P, i, j, cap), li.reshape(P, i, j, cap),
            jnp.stack([rr, ri]).reshape(2, cap, Ra, Rb), kk, None)


def _contract_zipup_device_pair(
    A: TensorTrain, B: TensorTrain, tolerance: float, maxbonddim: int,
    mesh=None,
) -> TensorTrain:
    """Complex zip-up on device via (re, im) f64 pair programs. With a
    mesh, every bond split's elimination runs row-sharded
    (ops/lu_sharded.make_lu_split_sharded_pair)."""
    L = len(A)
    ars = [jnp.asarray(np.real(A[n]), dtype=jnp.float64) for n in range(L)]
    ais = [jnp.asarray(np.imag(A[n]), dtype=jnp.float64) for n in range(L)]
    brs = [jnp.asarray(np.real(B[n]), dtype=jnp.float64) for n in range(L)]
    bis = [jnp.asarray(np.imag(B[n]), dtype=jnp.float64) for n in range(L)]

    caps = []
    P = 1
    for n in range(L - 1):
        m = P * ars[n].shape[1] * brs[n].shape[2]
        nn = ars[n].shape[3] * brs[n].shape[3]
        caps.append(int(min(maxbonddim, m, nn)))
        P = caps[-1]
    ash = tuple(t.shape for t in ars)
    bsh = tuple(t.shape for t in brs)

    def builder():
        def run(reltol, *cores):
            ars_, ais_ = cores[:L], cores[L:2 * L]
            brs_, bis_ = cores[2 * L:3 * L], cores[3 * L:]
            sites, kks = [], []
            Rr = jnp.ones((1, 1, 1), dtype=jnp.float64)
            Ri = jnp.zeros((1, 1, 1), dtype=jnp.float64)
            for n in range(L):
                if n == L - 1:
                    sr, si, _, _, _ = _zip_step_pair(
                        Rr, Ri, ars_[n], ais_[n], brs_[n], bis_[n],
                        reltol, cap=1, last=True,
                    )
                    sites.append(sr)
                    sites.append(si)
                    break
                lr, li, Rpair, kk, _ = _zip_step_pair(
                    Rr, Ri, ars_[n], ais_[n], brs_[n], bis_[n],
                    reltol, cap=caps[n], last=False, mesh=mesh,
                )
                sites.append(lr)
                sites.append(li)
                Rr, Ri = Rpair[0], Rpair[1]
                kks.append(kk)
            return tuple(sites) + tuple(kks)

        return run

    prog = _cached_program(
        ("zip_pair", ash, bsh, tuple(caps), _mesh_key(mesh)), builder
    )
    outs = jax.device_get(
        prog(jnp.float64(tolerance), *ars, *ais, *brs, *bis)
    )
    host, kks = outs[:2 * L], outs[2 * L:]
    ranks = [max(1, int(k)) for k in kks]
    out: List[np.ndarray] = []
    for n in range(L):
        t = np.asarray(host[2 * n]) + 1j * np.asarray(host[2 * n + 1])
        lo = 1 if n == 0 else ranks[n - 1]
        hi = 1 if n == L - 1 else ranks[n]
        out.append(t[:lo, :, :, :hi].astype(np.complex128))
    return TensorTrain(out)


@partial(jax.jit, static_argnames=("cap", "leftorthogonal"))
def _lu_split_pair(Cmr, Cmi, m_true, n_true, reltol, abstol, cap: int,
                   leftorthogonal: bool):
    """Pair-mode _lu_split: rrLU split of a complex matrix carried as
    (re, im) f64 pairs, mirroring the host rrlu left()/right() convention.
    Also used by models/compress_device.py (real abstol operand)."""
    from ..ops.complex_pair import rrlu_state_pair

    m, n = Cmr.shape
    maxrank = min(m, n, cap)
    Ar, Ai, rowperm, colperm, kk, _, _ = rrlu_state_pair(
        Cmr, Cmi, m_true, n_true, jnp.int32(maxrank), reltol,
        abstol, leftorthogonal,
    )
    rmax = min(m, n)
    ridx = jnp.arange(rmax)
    keep = ridx < kk
    Lr = jnp.tril(Ar[:, :rmax])
    Li = jnp.tril(Ai[:, :rmax])
    Ur = jnp.triu(Ar[:rmax, :])
    Ui = jnp.triu(Ai[:rmax, :])
    if leftorthogonal:
        Lr = Lr.at[ridx, ridx].set(1.0)
        Li = Li.at[ridx, ridx].set(0.0)
    else:
        Ur = Ur.at[ridx, ridx].set(1.0)
        Ui = Ui.at[ridx, ridx].set(0.0)
    Lr = jnp.where(keep[None, :], Lr, 0.0)
    Li = jnp.where(keep[None, :], Li, 0.0)
    Ur = jnp.where(keep[:, None], Ur, 0.0)
    Ui = jnp.where(keep[:, None], Ui, 0.0)
    lr = jnp.zeros_like(Lr).at[rowperm, :].set(Lr)[:, :cap]
    li = jnp.zeros_like(Li).at[rowperm, :].set(Li)[:, :cap]
    rr = jnp.zeros_like(Ur).at[:, colperm].set(Ur)[:cap, :]
    ri = jnp.zeros_like(Ui).at[:, colperm].set(Ui)[:cap, :]
    return lr, li, rr, ri, kk


@jax.jit
def _merge_sites_pair(ar, ai, br, bi):
    """Pair-mode Kronecker site merge: 4 real einsums per complex product."""
    la, i, _, ra = ar.shape
    lb, _, j, rb = br.shape
    abr = jnp.einsum("aikr,bkjs->abijrs", ar, br) - jnp.einsum(
        "aikr,bkjs->abijrs", ai, bi)
    abi = jnp.einsum("aikr,bkjs->abijrs", ar, bi) + jnp.einsum(
        "aikr,bkjs->abijrs", ai, br)
    return (abr.reshape(la * lb, i, j, ra * rb),
            abi.reshape(la * lb, i, j, ra * rb))


def _contract_naive_device_pair(
    A: TensorTrain, B: TensorTrain, tolerance: float, maxbonddim: int,
    mesh=None,
) -> TensorTrain:
    """Complex naive contraction on device via (re, im) f64 pair programs.
    With a mesh, every bond split's elimination runs row-sharded."""
    from ..ops.complex_pair import _matmul_pair

    L = len(A)
    ars = [jnp.asarray(np.real(A[n]), dtype=jnp.float64) for n in range(L)]
    ais = [jnp.asarray(np.imag(A[n]), dtype=jnp.float64) for n in range(L)]
    brs = [jnp.asarray(np.real(B[n]), dtype=jnp.float64) for n in range(L)]
    bis = [jnp.asarray(np.imag(B[n]), dtype=jnp.float64) for n in range(L)]
    ash = tuple(t.shape for t in ars)
    bsh = tuple(t.shape for t in brs)
    truncate = tolerance > 0 or maxbonddim < _INTMAX
    mbd = int(min(maxbonddim, 2**31 - 1))

    def builder():
        def run(reltol, *cores):
            ars_, ais_ = cores[:L], cores[L:2 * L]
            brs_, bis_ = cores[2 * L:3 * L], cores[3 * L:]
            tt = [
                _merge_sites_pair(ars_[n], ais_[n], brs_[n], bis_[n])
                for n in range(L)
            ]
            if not truncate:
                return tuple(x for pairt in tt for x in pairt)

            zero = jnp.float64(0.0)
            for ell in range(L - 1):
                tr, ti = tt[ell]
                sh = tr.shape
                m = int(np.prod(sh[:-1]))
                n = int(sh[-1])
                cap = min(m, n)
                lr, li, rr, ri, _ = _split_pair_for(mesh, m, n, cap, True)(
                    tr.reshape(m, n), ti.reshape(m, n),
                    jnp.int32(m), jnp.int32(n),
                    zero, zero,
                )
                tt[ell] = (
                    lr.reshape(*sh[:-1], cap), li.reshape(*sh[:-1], cap)
                )
                nr, ni = tt[ell + 1]
                shr = nr.shape
                nxr, nxi = _matmul_pair(
                    rr, ri,
                    nr.reshape(shr[0], int(np.prod(shr[1:]))),
                    ni.reshape(shr[0], int(np.prod(shr[1:]))),
                )
                tt[ell + 1] = (
                    nxr.reshape(cap, *shr[1:]), nxi.reshape(cap, *shr[1:])
                )

            ranks = []
            for ell in range(L - 1, 0, -1):
                tr, ti = tt[ell]
                sh = tr.shape
                m = int(sh[0])
                n = int(np.prod(sh[1:]))
                cap = int(min(m, n, mbd))
                lr, li, rr, ri, kk = _split_pair_for(mesh, m, n, cap, False)(
                    tr.reshape(m, n), ti.reshape(m, n),
                    jnp.int32(m), jnp.int32(n),
                    reltol, zero,
                )
                tt[ell] = (
                    rr.reshape(cap, *sh[1:]), ri.reshape(cap, *sh[1:])
                )
                pr, pi = tt[ell - 1]
                shl = pr.shape
                nxr, nxi = _matmul_pair(
                    pr.reshape(int(np.prod(shl[:-1])), shl[-1]),
                    pi.reshape(int(np.prod(shl[:-1])), shl[-1]),
                    lr, li,
                )
                tt[ell - 1] = (
                    nxr.reshape(*shl[:-1], cap), nxi.reshape(*shl[:-1], cap)
                )
                ranks.append(kk)
            return tuple(
                x for pairt in tt for x in pairt
            ) + tuple(ranks)

        return run

    prog = _cached_program(
        ("naive_pair", ash, bsh, mbd, truncate, _mesh_key(mesh)), builder
    )
    outs = jax.device_get(
        prog(jnp.float64(tolerance), *ars, *ais, *brs, *bis)
    )
    if not truncate:
        return TensorTrain([
            np.asarray(outs[2 * n]) + 1j * np.asarray(outs[2 * n + 1])
            for n in range(L)
        ])
    host, kks = outs[:2 * L], outs[2 * L:]
    ranks = [max(1, int(k)) for k in kks][::-1]
    out = []
    for n in range(L):
        t = np.asarray(host[2 * n]) + 1j * np.asarray(host[2 * n + 1])
        lo = 1 if n == 0 else ranks[n - 1]
        hi = 1 if n == L - 1 else ranks[n]
        out.append(t[:lo, :, :, :hi].astype(np.complex128))
    return TensorTrain(out)
