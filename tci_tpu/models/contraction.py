"""MPO x MPO / MPO x MPS contraction via :TCI, :naive and :zipup algorithms.

Parity reference: src/contraction.jl. The Contraction object is a lazy
BatchEvaluator over the product of two 4-leg TTs with memoized left/right
environments; contract_TCI re-enters crossinterpolate2 with it, contract_naive
does sitewise Kronecker merge + SVD recompression, contract_zipup streams
left-to-right with factorize-as-you-go. Tensor contractions lower to einsum.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..ops.factorize import factorize
from ..parallel.batcheval import BatchEvaluator, _infer_ncent
from ..utils.util import optfirstpivot, projector_to_slice
from .tensortrain import TensorTrain

MultiIndex = Tuple[int, ...]

_INTMAX = 2**62


def _contract(a: np.ndarray, b: np.ndarray, idx_a: Tuple[int, ...],
              idx_b: Tuple[int, ...]) -> np.ndarray:
    """General pairwise tensor contraction (contraction.jl:193-215)."""
    return np.tensordot(a, b, axes=(idx_a, idx_b))


class Contraction(BatchEvaluator):
    """Lazy product of two MPOs (contraction.jl:60-152)."""

    def __init__(self, a: TensorTrain, b: TensorTrain, f=None):
        if len(a) != len(b):
            raise ValueError("Tensor trains must have the same length.")
        for n in range(len(a)):
            if a[n].ndim != 4 or b[n].ndim != 4:
                raise ValueError("Contraction requires 4-leg tensor trains.")
            if a[n].shape[2] != b[n].shape[1]:
                raise ValueError(
                    f"Tensor trains must share the identical index at n={n}!"
                )
        self.mpo = (a, b)
        self.leftcache: Dict[Tuple, np.ndarray] = {}
        self.rightcache: Dict[Tuple, np.ndarray] = {}
        self.f = f
        self._sitedims = [
            [a[n].shape[1], b[n].shape[2]] for n in range(len(a))
        ]
        self.dtype = np.result_type(a[0].dtype, b[0].dtype).type

    def __len__(self) -> int:
        return len(self.mpo[0])

    def sitedims(self) -> List[List[int]]:
        return self._sitedims

    def __getitem__(self, i):
        return self.mpo[0][i]

    def __repr__(self):
        return (
            f"Contraction of tensor trains with ranks "
            f"{self.mpo[0].rank()} and {self.mpo[1].rank()}"
        )

    def _localdims(self, n: int) -> Tuple[int, int]:
        return (self.mpo[0][n].shape[1], self.mpo[1][n].shape[2])

    def _unfuse_idx(self, n: int, idx: int) -> Tuple[int, int]:
        # C-order fusion (last leg fastest), consistent with numpy reshapes of
        # (chi, d1, d2, chi) site tensors used throughout this package.
        d2 = self._localdims(n)[1]
        return (idx // d2, idx % d2)

    def _fuse_idx(self, n: int, ij: Tuple[int, int]) -> int:
        d2 = self._localdims(n)[1]
        return ij[0] * d2 + ij[1]

    # -- environments (contraction.jl:279-354) ------------------------------

    def evaluateleft(self, indexset: Sequence[Tuple[int, int]]) -> np.ndarray:
        if len(indexset) >= len(self.mpo[0]):
            raise ValueError(f"Invalid indexset: {indexset}")
        a, b = self.mpo
        if len(indexset) == 0:
            return np.ones((1, 1), dtype=self.dtype)
        ell = len(indexset)
        if ell == 1:
            i, j = indexset[0]
            return a[0][0, i, :, :].T @ b[0][0, :, j, :]
        key = tuple(indexset)
        hit = self.leftcache.get(key)
        if hit is None:
            i, j = indexset[-1]
            hit = _extend_cache(
                self.evaluateleft(key[:-1]), a[ell - 1], b[ell - 1], i, j
            )
            self.leftcache[key] = hit
        return hit

    def evaluateright(self, indexset: Sequence[Tuple[int, int]]) -> np.ndarray:
        if len(indexset) >= len(self.mpo[0]):
            raise ValueError(f"Invalid indexset: {indexset}")
        a, b = self.mpo
        N = len(self)
        if len(indexset) == 0:
            return np.ones((1, 1), dtype=self.dtype)
        if len(indexset) == 1:
            i, j = indexset[0]
            return a[N - 1][:, i, :, 0] @ b[N - 1][:, :, j, 0].T
        ell = N - len(indexset)
        key = tuple(indexset)
        hit = self.rightcache.get(key)
        if hit is None:
            i, j = indexset[0]
            hit = _extend_cache(
                self.evaluateright(key[1:]),
                np.transpose(a[ell], (3, 1, 2, 0)),
                np.transpose(b[ell], (3, 1, 2, 0)),
                i, j,
            )
            self.rightcache[key] = hit
        return hit

    # -- evaluation (contraction.jl:361-406) ---------------------------------

    def evaluate(self, indexset) -> complex:
        if len(self) != len(indexset):
            raise ValueError(
                f"Length mismatch: {len(self)} != {len(indexset)}"
            )
        if len(indexset) and isinstance(indexset[0], (int, np.integer)):
            indexset = [
                self._unfuse_idx(n, idx) for n, idx in enumerate(indexset)
            ]
        midpoint = len(self) // 2
        res = np.sum(
            self.evaluateleft(indexset[:midpoint])
            * self.evaluateright(indexset[midpoint:])
        )
        if self.f is not None:
            return self.f(res)
        return res

    def evaluate_single(self, indexset):
        if len(indexset) and isinstance(indexset[0], (list, tuple)):
            indexset = [
                _lineari(self._sitedims[l], mi)
                for l, mi in enumerate(indexset)
            ]
        return self.evaluate(list(indexset))

    def __call__(self, *args):
        if len(args) == 1:
            return self.evaluate_single(args[0])
        return self.batch_evaluate(*args)

    def batch_evaluate(self, leftindexset, rightindexset, ncent=None,
                       projector=None):
        """(contraction.jl:483-575)"""
        N = len(self)
        localdims = [int(np.prod(d)) for d in self._sitedims]
        ncent = _infer_ncent(localdims, leftindexset, rightindexset, ncent)
        if len(leftindexset) * len(rightindexset) == 0:
            nl = len(leftindexset[0]) if leftindexset else 0
            return np.zeros(
                (len(leftindexset),)
                + tuple(localdims[nl + i] for i in range(ncent))
                + (len(rightindexset),),
                dtype=self.dtype,
            )
        Nr = len(rightindexset[0])
        s_ = len(leftindexset[0])  # first center site (0-based)
        e_ = N - Nr  # one-past-last center site
        a, b = self.mpo

        if projector is None:
            projector = [
                [0] * len(self._sitedims[n]) for n in range(s_, e_)
            ]
        if len(projector) != ncent:
            raise ValueError(
                f"Length mismatch: projector length must be {ncent}"
            )
        for n in range(s_, e_):
            p = projector[n - s_]
            if len(p) != 2:
                raise ValueError(f"Invalid projector at {n}: {p}")
            if not all(0 <= x <= d for x, d in zip(p, self._sitedims[n])):
                raise ValueError(f"Invalid projector: {p}")

        left_unfused = [
            [self._unfuse_idx(n, idx) for n, idx in enumerate(idxs)]
            for idxs in leftindexset
        ]
        right_unfused = [
            [self._unfuse_idx(N - Nr + n, idx) for n, idx in enumerate(idxs)]
            for idxs in rightindexset
        ]

        linkdims_a = [1] + [t.shape[0] for t in a][1:] + [1]
        linkdims_b = [1] + [t.shape[0] for t in b][1:] + [1]

        left_ = np.empty(
            (len(leftindexset), a[s_].shape[0] if s_ < N else 1,
             b[s_].shape[0] if s_ < N else 1),
            dtype=self.dtype,
        )
        for i, idx in enumerate(left_unfused):
            left_[i, :, :] = self.evaluateleft(idx)

        right_ = np.empty(
            (a[e_ - 1].shape[-1] if e_ >= 1 else 1,
             b[e_ - 1].shape[-1] if e_ >= 1 else 1,
             len(rightindexset)),
            dtype=self.dtype,
        )
        for i, idx in enumerate(right_unfused):
            right_[:, :, i] = self.evaluateright(idx)

        # sitewise contraction of the center legs
        leftobj = left_.reshape(*left_.shape, 1)  # (B, la, lb, 1)
        return_size_siteinds: List[int] = []
        for n in range(s_, e_):
            p = projector[n - s_]
            slices, _ = projector_to_slice(p)
            a_n = a[n][:, slices[0], :, :]
            if a_n.ndim == 3:
                a_n = a_n[:, None, :, :]
            b_n = b[n][:, :, slices[1], :]
            if b_n.ndim == 3:
                b_n = b_n[:, :, None, :]
            return_size_siteinds.append(a_n.shape[1] * b_n.shape[2])

            # leftobj: (B, la, lb, S); a_n: (la, i, k, ra); b_n: (lb, k, j, rb)
            tmp1 = np.tensordot(leftobj, a_n, axes=((1,), (0,)))
            # tmp1: (B, lb, S, i, k, ra)
            tmp2 = np.tensordot(tmp1, b_n, axes=((1, 4), (0, 1)))
            # tmp2: (B, S, i, ra, j, rb)
            tmp3 = np.transpose(tmp2, (0, 3, 5, 1, 2, 4))
            # (B, ra, rb, S, i, j)
            leftobj = tmp3.reshape(*tmp3.shape[:3], -1)

        res = np.tensordot(leftobj, right_, axes=((1, 2), (0, 1)))
        # res: (B, S, |J|)
        res = np.transpose(res, (0, 1, 2))
        if self.f is not None:
            res = np.vectorize(self.f)(res)
        return res.reshape(
            len(leftindexset), *return_size_siteinds, len(rightindexset)
        )


def _extend_cache(oldcache: np.ndarray, a_ell: np.ndarray, b_ell: np.ndarray,
                  i: int, j: int) -> np.ndarray:
    """(contraction.jl:253-259)"""
    # (la, lb) x (la, k, ra) -> (lb, k, ra)
    tmp1 = np.tensordot(oldcache, a_ell[:, i, :, :], axes=((0,), (0,)))
    # (lb, k, ra) x (lb, k, rb) -> (ra, rb)
    return np.tensordot(tmp1, b_ell[:, :, j, :], axes=((0, 1), (0, 1)))


def _lineari(dims: Sequence[int], mi: Sequence[int]) -> int:
    """Multi-index -> fused linear index in C order (last leg fastest; the
    Julia reference uses column-major, contraction.jl:413-417 — this package
    uses row-major consistently with numpy reshapes)."""
    return int(np.ravel_multi_index(tuple(int(m) for m in mi), tuple(dims)))


def lineari(sitedims: Sequence[Sequence[int]],
            indexset: Sequence[Sequence[int]]) -> List[int]:
    return [_lineari(sitedims[l], mi) for l, mi in enumerate(indexset)]


def _contractsitetensors(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """(contraction.jl:591-602)"""
    ab = np.tensordot(a, b, axes=((2,), (1,)))  # (la, s1, ra, lb, s3, rb)
    abp = np.transpose(ab, (0, 3, 1, 4, 2, 5))
    return abp.reshape(
        a.shape[0] * b.shape[0], a.shape[1], b.shape[2],
        a.shape[3] * b.shape[3],
    )


def contract_naive(
    a: TensorTrain, b: TensorTrain, f=None,
    tolerance: float = 0.0, maxbonddim: int = _INTMAX,
    jax_native: bool = False, mesh=None,
) -> TensorTrain:
    """(contraction.jl:616-637)

    With ``jax_native=True`` (real dtypes) the sitewise Kronecker merges are
    device einsums and the two-pass compression runs each bond as one fused
    rrLU program (models/contraction_device.contract_naive_device); ``mesh``
    shards each bond split's elimination over the devices."""
    if f is not None:
        raise ValueError(
            "Naive contraction cannot apply an elementwise function. "
            "Use algorithm='TCI' instead."
        )
    if jax_native:
        from .contraction_device import contract_naive_device

        return contract_naive_device(
            a, b, tolerance=tolerance, maxbonddim=maxbonddim, mesh=mesh
        )
    if mesh is not None:
        raise ValueError("mesh= requires jax_native=True")
    if len(a) != len(b):
        raise ValueError("Cannot contract tensor trains with different length.")
    tt = TensorTrain(
        [_contractsitetensors(a[n], b[n]) for n in range(len(a))]
    )
    if tolerance > 0 or maxbonddim < _INTMAX:
        tt.compress("SVD", tolerance=tolerance, maxbonddim=maxbonddim)
    return tt


def _findinitialpivots(f, localdims, nmaxpivots,
                       rng: Optional[np.random.Generator] = None):
    """(contraction.jl:666-677)"""
    if rng is None:
        rng = np.random.default_rng()
    pivots = []
    for _ in range(nmaxpivots):
        pivot = [int(rng.integers(0, d)) for d in localdims]
        pivot = optfirstpivot(f, localdims, pivot)
        if abs(f(pivot)) == 0.0:
            continue
        pivots.append(tuple(pivot))
    return pivots


def contract_TCI(
    A: TensorTrain, B: TensorTrain,
    initialpivots=10, f=None,
    rng: Optional[np.random.Generator] = None,
    jax_native: bool = False, mesh=None,
    **kwargs,
) -> TensorTrain:
    """Fit the product with TCI2 (contraction.jl:692-732).

    With ``jax_native=True`` the lazy product evaluates on device as scanned
    transfer-matrix GEMMs (models/contraction_device.make_product_evaluator)
    wrapped in a JaxBatchEvaluator, so TCI2 runs its fused bond-update and
    whole-sweep device tiers; `f` must then be jax-traceable (or None).
    ``mesh`` shards the Π-panel product sampling over the device mesh (the
    batch axis of the transfer-matrix GEMMs — data-parallel over candidate
    indices, like the engine's own mesh sampling).
    """
    from .tensorci2 import crossinterpolate2

    if len(A) != len(B):
        raise ValueError("Cannot contract tensor trains with different length.")
    if not all(A[i].shape[2] == B[i].shape[1] for i in range(len(A))):
        raise ValueError(
            "Cannot contract tensor trains with non-matching site dimensions."
        )
    matrixproduct = Contraction(A, B, f=f)
    localdims = [int(np.prod(d)) for d in matrixproduct.sitedims()]
    if jax_native:
        from ..parallel.batcheval import JaxBatchEvaluator
        from .contraction_device import make_product_evaluator

        # On backends without complex128 a complex product runs
        # in (re, im) f64 pair mode; a post-map `f` must then be pair-valued
        # (see make_product_evaluator).
        fjax, localdims, dtype, pair = make_product_evaluator(A, B, f=f)
        evaluator = JaxBatchEvaluator(fjax, localdims, dtype=dtype,
                                      pair_output=pair, mesh=mesh)
    else:
        if mesh is not None:
            raise ValueError("mesh= requires jax_native=True")
        evaluator = matrixproduct
    if isinstance(initialpivots, int):
        initialpivots = _findinitialpivots(
            matrixproduct.evaluate_single, localdims, initialpivots, rng=rng
        )
        if not initialpivots:
            raise ValueError("No initial pivots found.")

    tci, ranks, errors = crossinterpolate2(
        matrixproduct.dtype, evaluator, localdims, initialpivots, **kwargs
    )
    legdims = [matrixproduct._localdims(i) for i in range(len(tci))]
    return TensorTrain(
        [
            t.reshape(t.shape[0], *d, t.shape[-1])
            for t, d in zip(tci.sitetensors(), legdims)
        ]
    )


def contract_zipup(
    A: TensorTrain, B: TensorTrain,
    tolerance: float = 1e-12, method: str = "SVD",
    maxbonddim: int = _INTMAX,
    jax_native: bool = False, mesh=None,
) -> TensorTrain:
    """Streaming contract+factorize (contraction.jl:751-788).

    With ``jax_native=True`` (real dtypes, method="LU") each bond runs as one
    fused einsum+rrLU XLA program on device (models/contraction_device.py);
    ``mesh`` shards each bond split's elimination over the devices.
    """
    if jax_native:
        if method != "LU":
            raise ValueError(
                "jax_native zip-up uses rrLU truncation; pass method='LU'."
            )
        from .contraction_device import contract_zipup_device

        return contract_zipup_device(
            A, B, tolerance=tolerance, maxbonddim=maxbonddim, mesh=mesh
        )
    if mesh is not None:
        raise ValueError("mesh= requires jax_native=True")
    if len(A) != len(B):
        raise ValueError("Cannot contract tensor trains with different length.")
    dtype = np.result_type(A[0].dtype, B[0].dtype)
    R = np.ones((1, 1, 1), dtype=dtype)
    sitetensors: List[np.ndarray] = [None] * len(A)
    for n in range(len(A)):
        # R: (l, la, lb); A[n]: (la, i, k, ra)
        RA = np.tensordot(R, A[n], axes=((1,), (0,)))
        # RA: (l, lb, i, k, ra); B[n]: (lb, k, j, rb)
        C = np.tensordot(RA, B[n], axes=((1, 3), (0, 1)))
        # C: (l, i, ra, j, rb) -> (l, i, j, ra, rb)
        C = np.transpose(C, (0, 1, 3, 2, 4))
        if n == len(A) - 1:
            sitetensors[n] = C.reshape(*C.shape[:3], 1)
            break
        left, right, newbond = factorize(
            C.reshape(int(np.prod(C.shape[:3])), int(np.prod(C.shape[3:]))),
            method, tolerance=tolerance, maxbonddim=maxbonddim,
        )
        sitetensors[n] = left.reshape(*C.shape[:3], newbond)
        R = right.reshape(newbond, *C.shape[3:])
    return TensorTrain(sitetensors)


def _promote_mps_to_mpo(tt, side: str) -> TensorTrain:
    """Promote a 3-leg TT to 4 legs with a singleton leg on the given side."""
    tensors = []
    for t in tt.sitetensors():
        t3 = t.reshape(t.shape[0], -1, t.shape[-1])
        if side == "up":
            tensors.append(t3[:, None, :, :].transpose(0, 1, 2, 3))
        else:
            tensors.append(t3[:, :, None, :])
    return TensorTrain(tensors)


def contract(
    A, B,
    algorithm: str = "TCI",
    tolerance: float = 1e-12,
    maxbonddim: int = _INTMAX,
    f=None,
    method: str = "SVD",
    jax_native: bool = False,
    mesh=None,
    **kwargs,
) -> TensorTrain:
    """Contract two tensor trains (contraction.jl:832-891).

    4-leg x 4-leg gives a 4-leg MPO; a 3-leg operand (MPS) is promoted with a
    singleton leg and the result squeezed back to 3 legs.

    With ``jax_native=True``, ``mesh`` (a 1-D ``jax.sharding.Mesh``) runs
    the device tier multi-chip: naive/zipup shard every bond split's rrLU
    elimination over the devices (bit-identical pivot order vs single
    device); TCI shards the Π-panel product sampling.
    """
    A_is_mps = all(t.ndim == 3 for t in A.sitetensors())
    B_is_mps = all(t.ndim == 3 for t in B.sitetensors())

    if A_is_mps and not B_is_mps:
        A4 = _promote_mps_to_mpo(A, "up")
        tt = contract(A4, B, algorithm=algorithm, tolerance=tolerance,
                      maxbonddim=maxbonddim, f=f, method=method,
                      jax_native=jax_native, mesh=mesh, **kwargs)
        return TensorTrain(
            [t.reshape(t.shape[0], -1, t.shape[-1]) for t in tt.sitetensors()]
        )
    if B_is_mps and not A_is_mps:
        B4 = _promote_mps_to_mpo(B, "down")
        tt = contract(A, B4, algorithm=algorithm, tolerance=tolerance,
                      maxbonddim=maxbonddim, f=f, method=method,
                      jax_native=jax_native, mesh=mesh, **kwargs)
        return TensorTrain(
            [t.reshape(t.shape[0], -1, t.shape[-1]) for t in tt.sitetensors()]
        )
    if A_is_mps and B_is_mps:
        raise ValueError("At least one operand must be a 4-leg tensor train.")

    if algorithm == "TCI":
        return contract_TCI(A, B, tolerance=tolerance, maxbonddim=maxbonddim,
                            f=f, jax_native=jax_native, mesh=mesh, **kwargs)
    elif algorithm == "naive":
        return contract_naive(A, B, f=f, tolerance=tolerance,
                              maxbonddim=maxbonddim, jax_native=jax_native,
                              mesh=mesh)
    elif algorithm == "zipup":
        if f is not None:
            raise ValueError(
                "Zipup contraction cannot apply an elementwise function. "
                "Use algorithm='TCI' instead."
            )
        return contract_zipup(A, B, tolerance=tolerance, method=method,
                              maxbonddim=maxbonddim, jax_native=jax_native,
                              mesh=mesh)
    raise ValueError(f"Unknown algorithm {algorithm}.")
