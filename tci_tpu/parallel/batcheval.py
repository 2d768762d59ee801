"""Batched evaluation protocol and adapters.

Parity reference: src/batcheval.jl and the BatchEvaluator abstract type in
src/cachedtensortrain.jl:31. The protocol: an evaluator supports

- single call:  f(indexset) -> scalar
- batch call:   f.batch_evaluate(Iset, Jset, ncent) -> array of shape
                (|Iset|, d_{nl}, ..., d_{nl+ncent-1}, |Jset|)

where each entry is f at the concatenated index [left..., center..., right...].
Index panels are assembled host-side as int arrays; the device adapters
(JaxBatchEvaluator) evaluate them as one vmapped/jitted program, optionally
shard_mapped over a device mesh — this replaces the reference's threaded
sampling loop (batcheval.jl:247-308).
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Optional, Sequence

import numpy as np

MultiIndex = tuple


class BatchEvaluator:
    """Base class for batch-evaluable functions."""

    def __call__(self, *args):
        if len(args) == 1:
            return self.evaluate_single(args[0])
        if len(args) in (2, 3):
            Iset, Jset = args[0], args[1]
            ncent = args[2] if len(args) == 3 else None
            return self.batch_evaluate(Iset, Jset, ncent)
        raise TypeError("BatchEvaluator takes (indexset) or (Iset, Jset[, M])")

    def evaluate_single(self, indexset):
        raise NotImplementedError

    def batch_evaluate(self, Iset, Jset, ncent=None):
        raise NotImplementedError


def isbatchevaluable(f) -> bool:
    """True when `f` implements the batch-evaluation protocol."""
    return isinstance(f, BatchEvaluator) or hasattr(f, "batch_evaluate")


def evaluate_rows(f, indices: np.ndarray, dtype=np.float64) -> np.ndarray:
    """Evaluate f at every row of an (B, L) index matrix with as few
    dispatches as possible: one call when f exposes `evaluate_many`
    (JaxBatchEvaluator and friends), otherwise a host loop."""
    indices = np.asarray(indices, dtype=np.int32)
    if hasattr(f, "evaluate_many"):
        return np.asarray(f.evaluate_many(indices))
    if hasattr(f, "evaluate_single"):
        call = f.evaluate_single
    else:
        call = f
    out = np.empty(indices.shape[0], dtype=dtype)
    for r in range(indices.shape[0]):
        out[r] = call(tuple(int(x) for x in indices[r]))
    return out


def _empty_result(nl_dims, dtype):
    return np.zeros(tuple(0 for _ in range(len(nl_dims) + 2)), dtype=dtype)


def _assemble_indices(
    localdims: Sequence[int],
    leftindexset: Sequence[MultiIndex],
    rightindexset: Sequence[MultiIndex],
    ncent: int,
) -> np.ndarray:
    """Build the (|I|·Πd·|J|, nl+ncent+nr) int32 matrix of full multi-indices
    in C order (left slowest, right fastest). The total index length is
    nl + ncent + nr, which may be shorter than len(localdims) — the reference
    dispatch concatenates [left..., center..., right...] verbatim
    (batcheval.jl:131-175)."""
    nl = len(leftindexset[0]) if leftindexset else 0
    nr = len(rightindexset[0]) if rightindexset else 0
    L = nl + ncent + nr
    left = np.asarray([tuple(x) for x in leftindexset], dtype=np.int32).reshape(
        len(leftindexset), nl
    )
    right = np.asarray([tuple(x) for x in rightindexset], dtype=np.int32).reshape(
        len(rightindexset), nr
    )
    centerdims = [localdims[nl + i] for i in range(ncent)]
    ncenter = int(np.prod(centerdims)) if ncent > 0 else 1
    if ncent > 0:
        center = np.stack(
            np.meshgrid(*[np.arange(d, dtype=np.int32) for d in centerdims],
                        indexing="ij"),
            axis=-1,
        ).reshape(ncenter, ncent)
    else:
        center = np.zeros((1, 0), dtype=np.int32)

    nI, nC, nJ = len(left), ncenter, len(right)
    out = np.empty((nI, nC, nJ, L), dtype=np.int32)
    out[:, :, :, :nl] = left[:, None, None, :]
    out[:, :, :, nl : nl + ncent] = center[None, :, None, :]
    out[:, :, :, nl + ncent :] = right[None, None, :, :]
    return out.reshape(nI * nC * nJ, L)


def _result_shape(localdims, leftindexset, rightindexset, ncent):
    nl = len(leftindexset[0]) if leftindexset else 0
    return (
        len(leftindexset),
        *[localdims[nl + i] for i in range(ncent)],
        len(rightindexset),
    )


def _infer_ncent(localdims, leftindexset, rightindexset, ncent):
    if ncent is not None:
        return ncent
    nl = len(leftindexset[0]) if leftindexset else 0
    nr = len(rightindexset[0]) if rightindexset else 0
    return len(localdims) - nl - nr


def _batchevaluate_dispatch(
    valuetype,
    f,
    localdims: Sequence[int],
    leftindexset: Sequence[MultiIndex],
    rightindexset: Sequence[MultiIndex],
    ncent: Optional[int] = None,
) -> np.ndarray:
    """Evaluate f on the product set left x (free center dims) x right.

    BatchEvaluators get one batched call (batcheval.jl:196-214); plain
    callables are evaluated per assembled index row (batcheval.jl:131-175).
    Returns shape (|I|, d..., |J|).
    """
    if len(leftindexset) * len(rightindexset) == 0:
        nl = len(leftindexset[0]) if leftindexset else 0
        nc = _infer_ncent(localdims, leftindexset, rightindexset, ncent)
        return np.zeros(
            (len(leftindexset),)
            + tuple(localdims[nl + i] for i in range(nc))
            + (len(rightindexset),),
            dtype=valuetype,
        )

    ncent = _infer_ncent(localdims, leftindexset, rightindexset, ncent)
    if isbatchevaluable(f):
        res = f.batch_evaluate(leftindexset, rightindexset, ncent)
        return np.asarray(res)

    indices = _assemble_indices(localdims, leftindexset, rightindexset, ncent)
    vals = np.empty(indices.shape[0], dtype=valuetype)
    for r in range(indices.shape[0]):
        vals[r] = f(tuple(int(x) for x in indices[r]))
    return vals.reshape(_result_shape(localdims, leftindexset, rightindexset, ncent))


class BatchEvaluatorAdapter(BatchEvaluator):
    """Wrap a plain callable into the batch protocol (batcheval.jl:32-57)."""

    def __init__(self, f: Callable, localdims: Sequence[int], dtype=np.float64):
        self.f = f
        self.localdims = list(localdims)
        self.dtype = dtype

    def evaluate_single(self, indexset):
        return self.f(indexset)

    def batch_evaluate(self, Iset, Jset, ncent=None):
        if len(Iset) * len(Jset) == 0:
            ncent = _infer_ncent(self.localdims, Iset, Jset, ncent)
            nl = len(Iset[0]) if Iset else 0
            return np.zeros(
                (len(Iset),)
                + tuple(self.localdims[nl + i] for i in range(ncent))
                + (len(Jset),),
                dtype=self.dtype,
            )
        ncent = _infer_ncent(self.localdims, Iset, Jset, ncent)
        indices = _assemble_indices(self.localdims, Iset, Jset, ncent)
        vals = np.empty(indices.shape[0], dtype=self.dtype)
        for r in range(indices.shape[0]):
            vals[r] = self.f(tuple(int(x) for x in indices[r]))
        return vals.reshape(_result_shape(self.localdims, Iset, Jset, ncent))


def makebatchevaluatable(valuetype, f, localdims) -> BatchEvaluatorAdapter:
    return BatchEvaluatorAdapter(f, localdims, dtype=valuetype)


class ThreadedBatchEvaluator(BatchEvaluator):
    """Thread-pool fan-out over the sample grid (parity with the reference's
    Threads.@threads loop, batcheval.jl:247-308). The wrapped f must be
    thread-safe. Prefer JaxBatchEvaluator for jax-traceable functions."""

    def __init__(self, f: Callable, localdims, dtype=np.float64, nthreads=None):
        self.f = f
        self.localdims = list(localdims)
        self.dtype = dtype
        self.nthreads = nthreads

    def evaluate_single(self, indexset):
        return self.f(indexset)

    def batch_evaluate(self, Iset, Jset, ncent=None):
        ncent = _infer_ncent(self.localdims, Iset, Jset, ncent)
        if len(Iset) * len(Jset) == 0:
            nl = len(Iset[0]) if Iset else 0
            return np.zeros(
                (len(Iset),)
                + tuple(self.localdims[nl + i] for i in range(ncent))
                + (len(Jset),),
                dtype=self.dtype,
            )
        indices = _assemble_indices(self.localdims, Iset, Jset, ncent)
        rows = [tuple(int(x) for x in indices[r]) for r in range(indices.shape[0])]
        with ThreadPoolExecutor(max_workers=self.nthreads) as pool:
            vals = list(pool.map(self.f, rows))
        return np.asarray(vals, dtype=self.dtype).reshape(
            _result_shape(self.localdims, Iset, Jset, ncent)
        )


class VectorizedBatchEvaluator(BatchEvaluator):
    """Adapter for a function that consumes a whole (B, L) index matrix at
    once (numpy-vectorized user code)."""

    def __init__(self, fvec: Callable[[np.ndarray], np.ndarray], localdims,
                 dtype=np.float64):
        self.fvec = fvec
        self.localdims = list(localdims)
        self.dtype = dtype

    def evaluate_single(self, indexset):
        arr = np.asarray([tuple(indexset)], dtype=np.int32)
        return self.fvec(arr)[0]

    def batch_evaluate(self, Iset, Jset, ncent=None):
        ncent = _infer_ncent(self.localdims, Iset, Jset, ncent)
        if len(Iset) * len(Jset) == 0:
            nl = len(Iset[0]) if Iset else 0
            return np.zeros(
                (len(Iset),)
                + tuple(self.localdims[nl + i] for i in range(ncent))
                + (len(Jset),),
                dtype=self.dtype,
            )
        indices = _assemble_indices(self.localdims, Iset, Jset, ncent)
        vals = np.asarray(self.fvec(indices), dtype=self.dtype)
        return vals.reshape(_result_shape(self.localdims, Iset, Jset, ncent))


_COMPLEX_SUPPORT_CACHE = {}


def platform_supports_complex() -> bool:
    """Probe (once per backend) whether the default jax backend can compile
    complex128 arithmetic. The CPU and GPU backends can; where it cannot,
    complex integrands run as (re, im) f64 pairs (ops/complex_pair.py)."""
    import jax

    backend = jax.default_backend()
    if backend not in _COMPLEX_SUPPORT_CACHE:
        try:
            import jax.numpy as jnp

            # Compile-only probe: executing an unsupported op could leave
            # the backend in a failed state.
            jax.jit(lambda x: x * (1 + 1j)).lower(
                jax.ShapeDtypeStruct((2,), jnp.complex128)
            ).compile()
            _COMPLEX_SUPPORT_CACHE[backend] = True
        except Exception:
            _COMPLEX_SUPPORT_CACHE[backend] = False
    return _COMPLEX_SUPPORT_CACHE[backend]


class JaxBatchEvaluator(BatchEvaluator):
    """Device evaluator: fjax is a jax-traceable scalar function of an
    int32 index vector; panels evaluate as one jitted vmap, padded to shape
    buckets so repeated sweeps reuse compiled programs, and optionally
    shard_mapped over a device mesh axis (data-parallel sampling).
    """

    def __init__(self, fjax: Callable, localdims, dtype=np.float64,
                 mesh=None, axis: str = "batch", pair_output: bool = False,
                 enable_device_sweep: bool = True,
                 fused_panel_capacity: bool = False):
        import jax
        import jax.numpy as jnp

        self.fjax = fjax
        self.localdims = list(localdims)
        self.dtype = dtype
        self.mesh = mesh
        self.axis = axis
        self.pair_output = pair_output
        # whole-sweep programs pad panels to Imax buckets; workloads with
        # large local dims and high rank may prefer the per-bond fused tier
        # (panels sized to the actual rank)
        self.enable_device_sweep = enable_device_sweep
        # capacity mode for the per-bond fused tier: panels pad to monotone
        # shared capacities (O(log maxrank) compiles) instead of per-size
        # buckets — right for large-localdim/high-rank workloads where
        # per-bucket compiles dominate (see ops/fused.FusedBondUpdater)
        self.fused_panel_capacity = fused_panel_capacity
        self._nevals = 0

        self._iscomplex = np.issubdtype(np.dtype(dtype), np.complexfloating)
        complex_ok = platform_supports_complex() if self._iscomplex else True
        if self._iscomplex and not complex_ok and not pair_output:
            raise ValueError(
                "This jax backend has no complex128 support. Write the "
                "integrand pair-valued — fjax(idx) returning "
                "jnp.stack([re, im]) with real arithmetic only — and pass "
                "pair_output=True."
            )
        # pair mode: sampling and the fused bond algebra run on (re, im)
        # f64 pairs; the host recombines to complex.
        self._complex_as_pair = self._iscomplex and pair_output
        fn = jax.vmap(fjax)
        if mesh is not None:
            from jax.sharding import NamedSharding, PartitionSpec as P

            self._insharding = NamedSharding(mesh, P(axis))
            self._outsharding = NamedSharding(mesh, P(axis))
            self._fn = jax.jit(
                fn, in_shardings=self._insharding, out_shardings=self._outsharding
            )
            self._pad_quantum = int(np.prod([mesh.shape[a] for a in mesh.axis_names]))
        else:
            self._fn = jax.jit(fn)
            self._pad_quantum = 1
        self._jnp = jnp
        self._fused_updater = None
        self._fused_site_tensors = None

    @property
    def fused_updater(self):
        """Fused on-device bond update (Π sampling + rrLU + factor
        extraction in one XLA program); used by TensorCI2.updatepivots
        when pivotsearch='full'. Pair-valued integrands use the complex-pair
        algebra kernels (ops/complex_pair.py)."""
        if self._fused_updater is None:
            from ..ops.fused import FusedBondUpdater

            self._fused_updater = FusedBondUpdater(
                self.fjax, self.dtype, pair=self._complex_as_pair,
                capacity_mode=self.fused_panel_capacity,
            )
        return self._fused_updater

    @property
    def device_sweep_engine(self):
        """Whole-sweep device engine: all bond updates of a 2-site sweep run
        as one XLA program (models/device_sweep.py); pair mode runs the
        (re, im) f64 pair kernels."""
        if not self.enable_device_sweep:
            return None
        if getattr(self, "_device_sweep_engine", None) is None:
            from ..models.device_sweep import DeviceSweepEngine

            self._device_sweep_engine = DeviceSweepEngine(
                self.fjax, self.localdims, dtype=self.dtype,
                pair=self._complex_as_pair,
                mesh=self.mesh, axis=self.axis,
            )
        return self._device_sweep_engine

    @property
    def panel_sampler(self):
        """Device Π-panel sampler feeding the device rook elimination
        (ops/lu_device.rrlu_rook_device); None for pair-valued (complex)
        integrands — the rook slab kernels are real-only."""
        if self._complex_as_pair or self._iscomplex:
            return None
        if getattr(self, "_panel_sampler", None) is None:
            from ..ops.fused import PanelSampler

            self._panel_sampler = PanelSampler(self.fjax, self.dtype)
        return self._panel_sampler

    @property
    def fused_site_tensors(self):
        """Fused on-device site-tensor computation (see ops/fused.py)."""
        if getattr(self, "_fused_site_tensors", None) is None:
            from ..ops.fused import FusedSiteTensors

            self._fused_site_tensors = FusedSiteTensors(
                self.fjax, self.dtype, pair=self._complex_as_pair,
                capacity_mode=self.fused_panel_capacity,
            )
        return self._fused_site_tensors

    @property
    def nevals(self) -> int:
        """Number of f evaluations performed through this adapter."""
        n = self._nevals
        if self._fused_updater is not None:
            n += self._fused_updater.nevals
        if getattr(self, "_fused_site_tensors", None) is not None:
            n += self._fused_site_tensors.nevals
        if getattr(self, "_device_sweep_engine", None) is not None:
            n += self._device_sweep_engine.nevals
        if getattr(self, "_panel_sampler", None) is not None:
            n += self._panel_sampler.nevals
        return n

    def evaluate_single(self, indexset):
        arr = np.asarray([tuple(indexset)], dtype=np.int32)
        return complex(self.evaluate_many(arr)[0]) if np.issubdtype(
            np.dtype(self.dtype), np.complexfloating
        ) else float(self.evaluate_many(arr)[0])

    def evaluate_many(self, indices: np.ndarray) -> np.ndarray:
        B = indices.shape[0]
        self._nevals += B
        # pad the batch to a bucketed size (divisible by the mesh extent) so
        # XLA reuses compiled programs across sweeps
        q = self._pad_quantum
        Bpad = max(q, 1 << (int(B - 1).bit_length())) if B > 0 else q
        Bpad = ((Bpad + q - 1) // q) * q
        if Bpad != B:
            pad = np.zeros((Bpad - B, indices.shape[1]), dtype=np.int32)
            inp = np.vstack([indices.astype(np.int32), pad])
        else:
            inp = indices.astype(np.int32)
        vals = self._fn(self._jnp.asarray(inp))
        if self._complex_as_pair:
            pair = np.asarray(vals)[:B]
            return (pair[:, 0] + 1j * pair[:, 1]).astype(self.dtype)
        return np.asarray(vals)[:B]

    def batch_evaluate(self, Iset, Jset, ncent=None):
        ncent = _infer_ncent(self.localdims, Iset, Jset, ncent)
        if len(Iset) * len(Jset) == 0:
            nl = len(Iset[0]) if Iset else 0
            return np.zeros(
                (len(Iset),)
                + tuple(self.localdims[nl + i] for i in range(ncent))
                + (len(Jset),),
                dtype=self.dtype,
            )
        indices = _assemble_indices(self.localdims, Iset, Jset, ncent)
        vals = self.evaluate_many(indices).astype(self.dtype)
        return vals.reshape(_result_shape(self.localdims, Iset, Jset, ncent))

    def __call__(self, *args):
        if len(args) == 1 and not (
            isinstance(args[0], (list, tuple))
            and args[0]
            and isinstance(args[0][0], (list, tuple))
        ):
            return self.evaluate_single(args[0])
        return super().__call__(*args)
