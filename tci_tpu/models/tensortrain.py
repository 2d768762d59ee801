"""Tensor-train (TT/MPS) container and shared operations.

Parity reference: src/abstracttensortrain.jl and src/tensortrain.jl. Site
tensors are (χ_{k-1}, d_1, ..., d_m, χ_k) arrays; evaluation is a chain of
matrix products (abstracttensortrain.jl:328-342), `sum` is the factorized
O(n d r^2) reduction (:428-441), addition is block-diagonal core stacking
(:467-495), and compression is a two-pass orthogonalize/truncate sweep
(tensortrain.jl:302-348) over LU/CI/SVD splits.

Core data lives in numpy on the host (TT cores are small); batched evaluation
for device throughput is provided separately via `batch_evaluator` which builds
a jitted einsum chain.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np

from ..ops.factorize import factorize

_INTMAX = 2**62


class AbstractTensorTrain:
    """Base class: anything holding a list of site tensors and evaluable as a
    function of one index per site."""

    def sitetensors(self) -> List[np.ndarray]:
        return self._sitetensors

    def sitetensor(self, i: int) -> np.ndarray:
        return self.sitetensors()[i]

    def __len__(self) -> int:
        return len(self.sitetensors())

    def __iter__(self):
        return iter(self.sitetensors())

    def __getitem__(self, i):
        return self.sitetensors()[i]

    def linkdims(self) -> List[int]:
        return [t.shape[0] for t in self.sitetensors()[1:]]

    def linkdim(self, i: int) -> int:
        return self.sitetensor(i + 1).shape[0]

    def sitedims(self) -> List[List[int]]:
        return [list(t.shape[1:-1]) for t in self.sitetensors()]

    def sitedim(self, i: int) -> List[int]:
        return list(self.sitetensor(i).shape[1:-1])

    def rank(self) -> int:
        ld = self.linkdims()
        return max(ld) if ld else 1

    def evaluate(self, indexset):
        """Evaluate at one multi-index; entries may be ints (one site leg) or
        tuples (multi-leg sites)."""
        tensors = self.sitetensors()
        if len(indexset) != len(tensors):
            raise ValueError(
                f"To evaluate a tt of length {len(tensors)}, provide "
                f"{len(tensors)} indices, got {len(indexset)}."
            )
        v = None
        for T, i in zip(tensors, indexset):
            if isinstance(i, (int, np.integer)):
                if T.ndim != 3:
                    raise ValueError(
                        f"Tensor with {T.ndim - 2} site legs needs a tuple index."
                    )
                mat = T[:, i, :]
            else:
                if T.ndim != len(i) + 2:
                    raise ValueError(
                        f"Index {tuple(i)} has wrong length for tensor of "
                        f"shape {T.shape}."
                    )
                mat = T[(slice(None), *i, slice(None))]
            v = mat if v is None else v @ mat
        return v[0, 0]

    def __call__(self, indexset):
        return self.evaluate(indexset)

    def evaluate_batch(self, indices) -> np.ndarray:
        """Evaluate at a whole (B, L) batch of multi-indices with vectorized
        per-site batched matrix products (one gather + one einsum per site).
        Single-leg sites only."""
        indices = np.asarray(indices, dtype=np.int64)
        tensors = self.sitetensors()
        if indices.ndim != 2 or indices.shape[1] != len(tensors):
            raise ValueError("indices must have shape (B, L).")
        v = None
        for l, T in enumerate(tensors):
            mats = T[:, indices[:, l], :]  # (chi_l, B, chi_r)
            if v is None:
                v = mats[0]  # (B, chi_r); left boundary chi=1
            else:
                v = np.einsum("bi,ibj->bj", v, mats)
        return v[:, 0]

    def sum(self):
        """Σ over all grid points via per-site reductions
        (abstracttensortrain.jl:428-441)."""
        tensors = self.sitetensors()
        t0 = tensors[0]
        v = np.sum(
            t0.reshape(t0.shape[0], -1, t0.shape[-1]), axis=(0, 1)
        )[None, :]
        for T in tensors[1:]:
            v = v @ np.sum(T.reshape(T.shape[0], -1, T.shape[-1]), axis=1)
        return v[0, 0]

    def norm2(self) -> float:
        """Squared Frobenius norm via transfer matrices
        (abstracttensortrain.jl:625-639)."""
        result = None
        for t in self.sitetensors():
            t3 = t.reshape(t.shape[0], -1, t.shape[-1])
            # (lc, s, rc) x (l, s, r) -> (lc, rc, l, r) -> (lc*l, rc*r)
            tct = np.einsum("asb,csd->acbd", np.conj(t3), t3)
            mat = tct.reshape(
                t3.shape[0] * t3.shape[0], t3.shape[2] * t3.shape[2]
            )
            result = mat if result is None else result @ mat
        return float(np.real(result[0, 0]))

    def norm(self) -> float:
        return float(np.sqrt(self.norm2()))

    def __add__(self, other):
        return add(self, other)

    def __sub__(self, other):
        return subtract(self, other)

    def __repr__(self):
        return f"{type(self).__name__} with rank {self.rank()}"


class TensorTrain(AbstractTensorTrain):
    """Concrete TT with bond-consistency validation (tensortrain.jl:58-79)."""

    def __init__(self, sitetensors: Sequence[np.ndarray]):
        if isinstance(sitetensors, AbstractTensorTrain):
            sitetensors = sitetensors.sitetensors()
        tensors = [np.asarray(t) for t in sitetensors]
        for i in range(len(tensors) - 1):
            if tensors[i].shape[-1] != tensors[i + 1].shape[0]:
                raise ValueError(
                    f"The tensors at {i} and {i + 1} must have consistent "
                    "dimensions for a tensor train."
                )
        self._sitetensors = tensors

    @classmethod
    def from_tci(cls, tci) -> "TensorTrain":
        return cls(tci.sitetensors())

    def astype(self, dtype) -> "TensorTrain":
        # A complex->real cast discards the imaginary part BY DESIGN (the
        # reference's value-type conversion does the same,
        # tensortrain.jl:101-174); silence numpy's ComplexWarning for this
        # documented narrowing only.
        import warnings

        with warnings.catch_warnings():
            warnings.simplefilter("ignore", np.exceptions.ComplexWarning)
            return TensorTrain([t.astype(dtype) for t in self._sitetensors])

    def reshape_sites(self, localdims) -> "TensorTrain":
        """Reshape site legs: localdims[n] lists the per-site leg extents
        (tensortrain.jl:161-174)."""
        for n, t in enumerate(self._sitetensors):
            if int(np.prod(t.shape[1:-1])) != int(np.prod(localdims[n])):
                raise ValueError(f"Local dimensions at n={n} must match.")
        return TensorTrain(
            [
                t.reshape(t.shape[0], *localdims[n], t.shape[-1])
                for n, t in enumerate(self._sitetensors)
            ]
        )

    def copy(self) -> "TensorTrain":
        return TensorTrain([t.copy() for t in self._sitetensors])

    def deepcopy(self) -> "TensorTrain":
        return self.copy()

    # -- compression (tensortrain.jl:302-348) ------------------------------

    def compress(
        self,
        method: str = "LU",
        tolerance: float = 1e-12,
        maxbonddim: int = _INTMAX,
        normalizeerror: bool = True,
        jax_native: bool = False,
        mesh=None,
    ) -> None:
        """In-place two-pass compression: L→R orthogonalization (no
        truncation), then R→L truncation. With ``jax_native=True`` (and
        ``method="LU"``) the whole two-pass sweep runs as one device
        program (models/compress_device.py); ``mesh`` additionally shards
        every bond split's elimination over the devices."""
        if jax_native:
            from .compress_device import compress_device

            out = compress_device(
                self, method, tolerance=tolerance, maxbonddim=maxbonddim,
                normalizeerror=normalizeerror, mesh=mesh,
            )
            self._sitetensors = out.sitetensors()
            return
        tt = self._sitetensors
        for ell in range(len(tt) - 1):
            shapel = tt[ell].shape
            left, right, newbond = factorize(
                tt[ell].reshape(int(np.prod(shapel[:-1])), shapel[-1]),
                method, tolerance=0.0, maxbonddim=_INTMAX, leftorthogonal=True,
            )
            tt[ell] = left.reshape(*shapel[:-1], newbond)
            shaper = tt[ell + 1].shape
            nexttensor = right @ tt[ell + 1].reshape(
                shaper[0], int(np.prod(shaper[1:]))
            )
            tt[ell + 1] = nexttensor.reshape(newbond, *shaper[1:])

        for ell in range(len(tt) - 1, 0, -1):
            shaper = tt[ell].shape
            left, right, newbond = factorize(
                tt[ell].reshape(shaper[0], int(np.prod(shaper[1:]))),
                method, tolerance=tolerance, maxbonddim=maxbonddim,
                normalizeerror=normalizeerror, leftorthogonal=False,
            )
            tt[ell] = right.reshape(newbond, *shaper[1:])
            shapel = tt[ell - 1].shape
            nexttensor = tt[ell - 1].reshape(
                int(np.prod(shapel[:-1])), shapel[-1]
            ) @ left
            tt[ell - 1] = nexttensor.reshape(*shapel[:-1], newbond)

    # -- scalar algebra (tensortrain.jl:355-435) ----------------------------

    def multiply(self, a) -> "TensorTrain":
        out = self.copy()
        out._sitetensors[-1] = out._sitetensors[-1] * a
        return out

    def divide(self, a) -> "TensorTrain":
        out = self.copy()
        out._sitetensors[-1] = out._sitetensors[-1] / a
        return out

    def __mul__(self, a):
        return self.multiply(a)

    def __rmul__(self, a):
        return self.multiply(a)

    def __truediv__(self, a):
        return self.divide(a)


def tensortrain(tci) -> TensorTrain:
    """Convert any AbstractTensorTrain (TCI1/TCI2/TT) to a plain TensorTrain."""
    return TensorTrain(tci.sitetensors())


def sitedims(tt) -> List[List[int]]:
    return tt.sitedims()


def evaluate(tt, indexset, **kwargs):
    return tt.evaluate(indexset, **kwargs) if kwargs else tt.evaluate(indexset)


def _addtttensor(
    A: np.ndarray,
    B: np.ndarray,
    factorA=1,
    factorB=1,
    lefttensor=False,
    righttensor=False,
) -> np.ndarray:
    """Stack two cores block-diagonally for TT addition
    (abstracttensortrain.jl:467-495)."""
    if A.ndim != B.ndim:
        raise ValueError(
            "Elementwise addition requires the same number of indices."
        )
    nd = A.ndim
    offset1 = 0 if lefttensor else A.shape[0]
    offset3 = 0 if righttensor else A.shape[-1]
    dtype = np.result_type(A.dtype, B.dtype, type(factorA), type(factorB))
    C = np.zeros(
        (offset1 + B.shape[0], *A.shape[1 : nd - 1], offset3 + B.shape[-1]),
        dtype=dtype,
    )
    sl = (slice(None),) * (nd - 2)
    C[(slice(0, A.shape[0]), *sl, slice(0, A.shape[-1]))] = factorA * A
    C[(slice(offset1, None), *sl, slice(offset3, None))] = factorB * B
    return C


def add(
    lhs,
    rhs,
    factorlhs=1,
    factorrhs=1,
    tolerance: float = 0.0,
    maxbonddim: int = _INTMAX,
) -> TensorTrain:
    """factorlhs*lhs + factorrhs*rhs with SVD recompression
    (abstracttensortrain.jl:524-553)."""
    if len(lhs) != len(rhs):
        raise ValueError(
            f"Two tensor trains with different length ({len(lhs)} and "
            f"{len(rhs)}) cannot be added elementwise."
        )
    L = len(lhs)
    tt = TensorTrain(
        [
            _addtttensor(
                lhs[ell],
                rhs[ell],
                factorA=factorlhs if ell == L - 1 else 1,
                factorB=factorrhs if ell == L - 1 else 1,
                lefttensor=(ell == 0),
                righttensor=(ell == L - 1),
            )
            for ell in range(L)
        ]
    )
    tt.compress("SVD", tolerance=tolerance, maxbonddim=maxbonddim)
    return tt


def subtract(lhs, rhs, tolerance: float = 0.0, maxbonddim: int = _INTMAX):
    return add(lhs, rhs, factorrhs=-1, tolerance=tolerance, maxbonddim=maxbonddim)


def norm(tt) -> float:
    return tt.norm()


def norm2(tt) -> float:
    return tt.norm2()


def tt_reverse(tt) -> TensorTrain:
    """Reverse site order (tensortrain.jl:452-457)."""
    return TensorTrain(
        [
            np.transpose(T, (T.ndim - 1, *range(1, T.ndim - 1), 0))
            for T in reversed(list(tt.sitetensors()))
        ]
    )


def fulltensor(tt) -> np.ndarray:
    """Materialize the full tensor; exponential in length
    (tensortrain.jl:580-600)."""
    sitedims_ = tt.sitedims()
    localdims = [int(np.prod(d)) for d in sitedims_]
    tensors = tt.sitetensors()
    result = tensors[0].reshape(localdims[0], -1)
    leftdim = localdims[0]
    for l in range(1, len(tensors)):
        t = tensors[l]
        nextmatrix = t.reshape(t.shape[0], localdims[l] * t.shape[-1])
        leftdim *= localdims[l]
        result = (result @ nextmatrix).reshape(leftdim, t.shape[-1])
    returnsize = [d for dims in sitedims_ for d in dims]
    return result.reshape(*returnsize)


class TensorTrainFit:
    """Least-squares TT fit objective over flattened cores
    (tensortrain.jl:483-557). Jax-differentiable: use `loss_jax` with
    jax.grad for gradient-based optimization."""

    def __init__(self, indexsets, values, tt: TensorTrain):
        self.indexsets = [tuple(i) for i in indexsets]
        self.values = np.asarray(values)
        self.tt = tt
        offsets = [0]
        for n in range(len(tt)):
            offsets.append(offsets[-1] + int(np.prod(tt[n].shape)))
        self.offsets = offsets

    def flatten(self) -> np.ndarray:
        return np.concatenate([t.reshape(-1) for t in self.tt.sitetensors()])

    def to_tensors(self, x):
        return [
            np.asarray(x[self.offsets[n] : self.offsets[n + 1]]).reshape(
                self.tt[n].shape
            )
            for n in range(len(self.tt))
        ]

    def __call__(self, x) -> float:
        tensors = self.to_tensors(x)
        total = 0.0
        for i, indexset in enumerate(self.indexsets):
            v = None
            for T, idx in zip(tensors, indexset):
                mat = T[:, idx, :]
                v = mat if v is None else v @ mat
            total += abs(v[0, 0] - self.values[i]) ** 2
        return total

    def loss_jax(self, x):
        """Same objective, traceable by jax (use with jax.grad / optimizers)."""
        import jax.numpy as jnp

        shapes = [self.tt[n].shape for n in range(len(self.tt))]
        tensors = [
            jnp.reshape(x[self.offsets[n] : self.offsets[n + 1]], shapes[n])
            for n in range(len(self.tt))
        ]
        idxmat = jnp.asarray(np.asarray(self.indexsets, dtype=np.int32))
        vals = jnp.asarray(self.values)

        def eval_one(idx):
            v = tensors[0][:, idx[0], :]
            for n in range(1, len(tensors)):
                v = v @ tensors[n][:, idx[n], :]
            return v[0, 0]

        import jax

        preds = jax.vmap(eval_one)(idxmat)
        return jnp.sum(jnp.abs(preds - vals) ** 2)
