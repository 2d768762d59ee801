"""Device-resident tensor-train compression.

Device counterpart of the two-pass ``TensorTrain.compress`` sweep
(reference: src/tensortrain.jl:302-348): the L→R exact orthogonalization
pass and the R→L truncating pass run as ONE XLA program over the whole
chain — every bond split is the masked rank-revealing LU kernel
(ops/lu_kernel._rrlu_state) fused with the neighbouring-core matmuls, and
data never returns to the host between bonds. Rank is data, not shape:
each truncated bond is padded to its static cap ``min(m, n, maxbonddim)``
with zeroed tails, and the runtime ranks come back with the cores for one
final host-side unpad.

Truncation semantics mirror ops/factorize.factorize exactly (reference
src/tensortrain.jl:219-272): ``normalizeerror=True`` → reltol=tolerance,
abstol=0; ``normalizeerror=False`` → reltol=1e-14, abstol=tolerance. Only
``method="LU"`` is available on device (the production default; CI/SVD
stay on the host tier).

Complex tensor trains run as (re, im) f64 pair programs
(ops/complex_pair.py).
"""

from __future__ import annotations

from typing import List

import numpy as np

import jax
import jax.numpy as jnp

from .tensortrain import TensorTrain

_INTMAX = 2**62

# Whole-compression programs cached by the chain's shape signature, like
# contraction_device._whole_programs (tolerances are traced operands, so a
# tolerance change never recompiles).
_programs: dict = {}


def _two_pass(cores: List, reltol, abstol, mbd: int, mesh=None):
    """Traced body: L→R exact orthogonalization then R→L truncation
    (reference tensortrain.jl:302-348). Returns cores + per-bond ranks
    (appended from the last bond to the first). With ``mesh``, every bond
    split's elimination runs row-sharded (contraction_device._split_for)."""
    from .contraction_device import _split_for

    if mesh is not None:
        from jax.sharding import NamedSharding, PartitionSpec

        def _rep(x):
            # pin the connecting matmuls replicated: GSPMD otherwise
            # computes some of them sharded (output-distribution choices),
            # whose per-block GEMM tiling reassociates reductions and
            # breaks bit-parity with the single-device tier
            return jax.lax.with_sharding_constraint(
                x, NamedSharding(mesh, PartitionSpec(*(None,) * x.ndim))
            )
    else:
        def _rep(x):
            return x

    L = len(cores)
    tt = list(cores)
    zero = jnp.float64(0.0)
    for ell in range(L - 1):
        sh = tt[ell].shape
        m = int(np.prod(sh[:-1]))
        n = int(sh[-1])
        cap = min(m, n)
        left, right, _ = _split_for(mesh, m, n, cap, True)(
            tt[ell].reshape(m, n), jnp.int32(m), jnp.int32(n), zero, zero,
        )
        tt[ell] = left.reshape(*sh[:-1], cap)
        shr = tt[ell + 1].shape
        nxt = _rep(right @ tt[ell + 1].reshape(shr[0], int(np.prod(shr[1:]))))
        tt[ell + 1] = nxt.reshape(cap, *shr[1:])

    ranks = []
    for ell in range(L - 1, 0, -1):
        sh = tt[ell].shape
        m = int(sh[0])
        n = int(np.prod(sh[1:]))
        cap = int(min(m, n, mbd))
        left, right, kk = _split_for(mesh, m, n, cap, False)(
            tt[ell].reshape(m, n), jnp.int32(m), jnp.int32(n), reltol,
            abstol,
        )
        tt[ell] = right.reshape(cap, *sh[1:])
        shl = tt[ell - 1].shape
        nxt = _rep(tt[ell - 1].reshape(int(np.prod(shl[:-1])), shl[-1]) @ left)
        tt[ell - 1] = nxt.reshape(*shl[:-1], cap)
        ranks.append(kk)
    return tuple(tt) + tuple(ranks)


def _two_pass_pair(crs: List, cis: List, reltol, abstol, mbd: int,
                   mesh=None):
    """Pair-mode _two_pass over (re, im) core stacks. With ``mesh``, every
    bond split's elimination runs row-sharded via the pair elimination
    (contraction_device._split_pair_for)."""
    from .contraction_device import _split_pair_for

    L = len(crs)
    ttr = list(crs)
    tti = list(cis)
    zero = jnp.float64(0.0)
    for ell in range(L - 1):
        sh = ttr[ell].shape
        m = int(np.prod(sh[:-1]))
        n = int(sh[-1])
        cap = min(m, n)
        lr, li, rr, ri, _ = _split_pair_for(mesh, m, n, cap, True)(
            ttr[ell].reshape(m, n), tti[ell].reshape(m, n),
            jnp.int32(m), jnp.int32(n), zero, zero,
        )
        ttr[ell] = lr.reshape(*sh[:-1], cap)
        tti[ell] = li.reshape(*sh[:-1], cap)
        shr = ttr[ell + 1].shape
        nr = ttr[ell + 1].reshape(shr[0], int(np.prod(shr[1:])))
        ni = tti[ell + 1].reshape(shr[0], int(np.prod(shr[1:])))
        ttr[ell + 1] = (rr @ nr - ri @ ni).reshape(cap, *shr[1:])
        tti[ell + 1] = (rr @ ni + ri @ nr).reshape(cap, *shr[1:])

    ranks = []
    for ell in range(L - 1, 0, -1):
        sh = ttr[ell].shape
        m = int(sh[0])
        n = int(np.prod(sh[1:]))
        cap = int(min(m, n, mbd))
        lr, li, rr, ri, kk = _split_pair_for(mesh, m, n, cap, False)(
            ttr[ell].reshape(m, n), tti[ell].reshape(m, n),
            jnp.int32(m), jnp.int32(n), reltol, abstol,
        )
        ttr[ell] = rr.reshape(cap, *sh[1:])
        tti[ell] = ri.reshape(cap, *sh[1:])
        shl = ttr[ell - 1].shape
        pl = ttr[ell - 1].reshape(int(np.prod(shl[:-1])), shl[-1])
        pi = tti[ell - 1].reshape(int(np.prod(shl[:-1])), shl[-1])
        ttr[ell - 1] = (pl @ lr - pi @ li).reshape(*shl[:-1], cap)
        tti[ell - 1] = (pl @ li + pi @ lr).reshape(*shl[:-1], cap)
        ranks.append(kk)
    return tuple(ttr) + tuple(tti) + tuple(ranks)


def _unpad(host: List[np.ndarray], ranks: List[int],
           dtype) -> List[np.ndarray]:
    """Slice the padded cores down to the runtime ranks. ``ranks[b]`` is the
    rank of bond b (between sites b and b+1)."""
    L = len(host)
    out = []
    for n in range(L):
        t = host[n]
        lo = 1 if n == 0 else ranks[n - 1]
        hi = 1 if n == L - 1 else ranks[n]
        out.append(np.asarray(t[:lo, ..., :hi], dtype=dtype))
    return out


def compress_device(
    tt: TensorTrain,
    method: str = "LU",
    tolerance: float = 1e-12,
    maxbonddim: int = _INTMAX,
    normalizeerror: bool = True,
    mesh=None,
) -> TensorTrain:
    """Compress a tensor train with the whole two-pass sweep as one device
    program. Returns a new TensorTrain; same truncation semantics as the
    host ``TensorTrain.compress`` with ``method="LU"``
    (reference tensortrain.jl:302-348 + :219-272).

    With ``mesh`` (1-D ``jax.sharding.Mesh``), every bond split's
    complete-pivot elimination runs row-sharded over the devices
    (ops/lu_sharded; bit-identical pivot order); complex chains shard
    through the (re, im) pair elimination."""
    if method != "LU":
        raise ValueError(
            "compress_device supports method='LU' only (the production "
            "default); use the host TensorTrain.compress for CI/SVD."
        )
    cores = tt.sitetensors()
    L = len(cores)
    if L <= 1:
        # copy=True: np.asarray would alias the caller's ndarrays, making
        # the advertised non-mutating form return a view for 1-site chains
        # while returning fresh arrays otherwise.
        return TensorTrain([np.array(t, copy=True) for t in cores])
    dtype = np.result_type(*[t.dtype for t in cores])
    mbd = int(min(maxbonddim, 2**31 - 1))
    reltol, abstol = (
        (float(tolerance), 0.0) if normalizeerror else (1e-14, float(tolerance))
    )
    shapes = tuple(t.shape for t in cores)

    from .contraction_device import _mesh_key

    if np.issubdtype(dtype, np.complexfloating):
        crs = [jnp.asarray(np.real(t), dtype=jnp.float64) for t in cores]
        cis = [jnp.asarray(np.imag(t), dtype=jnp.float64) for t in cores]
        key = ("compress_pair", shapes, mbd, _mesh_key(mesh))
        if key not in _programs:
            def run(rt, at, *cs):
                return _two_pass_pair(
                    list(cs[:L]), list(cs[L:]), rt, at, mbd, mesh=mesh
                )

            _programs[key] = jax.jit(run)
        outs = jax.device_get(
            _programs[key](jnp.float64(reltol), jnp.float64(abstol),
                           *crs, *cis)
        )
        hr, hi, kks = outs[:L], outs[L:2 * L], outs[2 * L:]
        ranks = [max(1, int(k)) for k in kks][::-1]
        host = [np.asarray(r) + 1j * np.asarray(i)
                for r, i in zip(hr, hi)]
        return TensorTrain(_unpad(host, ranks, dtype))

    cjs = [jnp.asarray(t, dtype=jnp.float64) for t in cores]
    key = ("compress", shapes, mbd, _mesh_key(mesh))
    if key not in _programs:
        def run(rt, at, *cs):
            return _two_pass(list(cs), rt, at, mbd, mesh=mesh)

        _programs[key] = jax.jit(run)
    outs = jax.device_get(
        _programs[key](jnp.float64(reltol), jnp.float64(abstol), *cjs)
    )
    host, kks = outs[:L], outs[L:]
    ranks = [max(1, int(k)) for k in kks][::-1]
    return TensorTrain(_unpad(list(host), ranks, dtype))
