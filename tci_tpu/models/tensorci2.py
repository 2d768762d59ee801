"""TCI2: two-site sweep tensor cross interpolation with rrLU pivot selection.

Parity reference: src/tensorci2.jl. The state machine (Iset/Jset per bond,
non-strict nesting via set history, 0/1/2-site sweeps, global pivot insertion,
convergence criterion) is kept bondwise-identical; the per-bond Π panel is
sampled through the batched evaluation runtime (vmap / shard_map on device) and
factorized by the jit-compiled rrLU kernel (ops/lu_kernel.py).

Indices are 0-based tuples.
"""

from __future__ import annotations

import time
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

from ..ops.luci import MatrixLUCI
from ..parallel.batcheval import (
    BatchEvaluator,
    _batchevaluate_dispatch,
    evaluate_rows,
    isbatchevaluable,
)
from ..utils.indexset import isnested
from ..utils.sweep import forwardsweep
from ..utils.util import maxabs, padzero, pushunique
from .tensortrain import AbstractTensorTrain, TensorTrain

_INTMAX = 2**62

MultiIndex = Tuple[int, ...]


def kronecker_is(Iset: Sequence[MultiIndex], localdim: int) -> List[MultiIndex]:
    """Product Iset ⊗ {0..d-1}, appended on the right; ordered so that
    position p = i*d + j matches a C-order reshape of (|I|, d)
    (tensorci2.jl:512-517, adapted from column-major to row-major)."""
    return [tuple(i) + (j,) for i in Iset for j in range(localdim)]


def kronecker_sj(localdim: int, Jset: Sequence[MultiIndex]) -> List[MultiIndex]:
    """Product {0..d-1} ⊗ Jset, prepended on the left; position p = i*|J| + j
    matches a C-order reshape of (d, |J|) (tensorci2.jl:524-529)."""
    return [(i,) + tuple(j) for i in range(localdim) for j in Jset]


def kronecker(a, b) -> List[MultiIndex]:
    """Dispatching helper matching the reference's two kronecker methods."""
    if isinstance(a, (int, np.integer)):
        return kronecker_sj(int(a), b)
    return kronecker_is(a, int(b))


def _union(a: Sequence[MultiIndex], b: Sequence[MultiIndex]) -> List[MultiIndex]:
    """Order-preserving union (Julia's union, tensorci2.jl:842-843)."""
    return list(dict.fromkeys([tuple(x) for x in a] + [tuple(x) for x in b]))


def filltensor(
    valuetype,
    f,
    localdims: Sequence[int],
    Iset: Sequence[MultiIndex],
    Jset: Sequence[MultiIndex],
    ncent: int,
) -> np.ndarray:
    """Sample f on Iset x (free center legs) x Jset; shape (|I|, d..., |J|)
    (tensorci2.jl:475-497)."""
    if len(Iset) * len(Jset) == 0:
        return np.zeros((0,) * (ncent + 2), dtype=valuetype)
    N = len(localdims)
    nl = len(Iset[0])
    nr = len(Jset[0])
    if ncent != N - nl - nr:
        raise ValueError("Invalid number of central indices")
    return _batchevaluate_dispatch(valuetype, f, list(localdims), Iset, Jset, ncent)


class SubMatrix:
    """Lazy Π-matrix view used by rook pivot search: entries are sampled on
    demand through f (tensorci2.jl:764-804)."""

    def __init__(self, f, rows: Sequence[MultiIndex], cols: Sequence[MultiIndex],
                 valuetype=np.float64):
        self.f = f
        self.rows = [tuple(r) for r in rows]
        self.cols = [tuple(c) for c in cols]
        self.valuetype = valuetype
        self.maxsamplevalue = 0.0

    def __call__(self, irows: Sequence[int], icols: Sequence[int]) -> np.ndarray:
        if isbatchevaluable(self.f):
            Iset = [self.rows[i] for i in irows]
            Jset = [self.cols[j] for j in icols]
            res = np.asarray(self.f.batch_evaluate(Iset, Jset, 0))
        else:
            res = np.array(
                [
                    [self.f(self.rows[i] + self.cols[j]) for j in icols]
                    for i in irows
                ],
                dtype=self.valuetype,
            ).reshape(len(irows), len(icols))
        if res.size:
            self.maxsamplevalue = max(
                self.maxsamplevalue, float(np.max(np.abs(res)))
            )
        return res


class TensorCI2(AbstractTensorTrain):
    """TCI2 interpolation state (tensorci2.jl:50-93)."""

    def __init__(self, localdims: Sequence[int], dtype=np.float64):
        if len(localdims) <= 1:
            raise ValueError("localdims should have at least 2 elements!")
        n = len(localdims)
        self.localdims = [int(d) for d in localdims]
        self.dtype = np.dtype(dtype).type
        self.Iset: List[List[MultiIndex]] = [[] for _ in range(n)]
        self.Jset: List[List[MultiIndex]] = [[] for _ in range(n)]
        self._sitetensors: List[np.ndarray] = [
            np.zeros((0, d, 0), dtype=dtype) for d in self.localdims
        ]
        self.pivoterrors: List[float] = []
        self.bonderrors = np.zeros(n - 1)
        self.maxsamplevalue = 0.0
        self.Iset_history: List[List[List[MultiIndex]]] = []
        self.Jset_history: List[List[List[MultiIndex]]] = []

    # -- constructors ------------------------------------------------------

    @classmethod
    def from_function(
        cls,
        f: Callable,
        localdims: Sequence[int],
        initialpivots: Optional[Sequence[Sequence[int]]] = None,
        dtype=np.float64,
    ) -> "TensorCI2":
        tci = cls(localdims, dtype=dtype)
        if initialpivots is None:
            initialpivots = [tuple(0 for _ in localdims)]
        initialpivots = [tuple(p) for p in initialpivots]
        tci.addglobalpivots(initialpivots)
        tci.maxsamplevalue = max(abs(_call_f(f, x)) for x in initialpivots)
        if not tci.maxsamplevalue > 0.0:
            raise ValueError("maxsamplevalue is zero!")
        tci.invalidatesitetensors()
        return tci

    @classmethod
    def from_ijsets(
        cls,
        f: Callable,
        localdims: Sequence[int],
        Iset: Sequence[Sequence[MultiIndex]],
        Jset: Sequence[Sequence[MultiIndex]],
        dtype=np.float64,
    ) -> "TensorCI2":
        tci = cls(localdims, dtype=dtype)
        tci.Iset = [[tuple(i) for i in s] for s in Iset]
        tci.Jset = [[tuple(j) for j in s] for s in Jset]
        pivots = reconstructglobalpivotsfromijset(
            tci.localdims, tci.Iset, tci.Jset
        )
        tci.maxsamplevalue = max(abs(_call_f(f, p)) for p in pivots)
        if not tci.maxsamplevalue > 0.0:
            raise ValueError("maxsamplevalue is zero!")
        tci.invalidatesitetensors()
        return tci

    # -- basic state -------------------------------------------------------

    def __len__(self) -> int:
        return len(self.localdims)

    def linkdims(self) -> List[int]:
        return [len(self.Iset[b + 1]) for b in range(len(self) - 1)]

    def rank(self) -> int:
        ld = self.linkdims()
        return max(ld) if ld else 1

    def invalidatesitetensors(self) -> None:
        for b in range(len(self)):
            self._sitetensors[b] = np.zeros((0, 0, 0), dtype=self.dtype)

    def issitetensorsavailable(self) -> bool:
        return all(t.size != 0 for t in self._sitetensors)

    def printnestinginfo(self, file=None) -> None:
        import sys

        io = file or sys.stdout
        print("Nesting info: Iset", file=io)
        for i in range(len(self.Iset) - 1):
            if isnested(self.Iset[i], self.Iset[i + 1], "row"):
                print(f"  Nested: {i} < {i + 1}", file=io)
            else:
                print(f"  Not nested: {i} !< {i + 1}", file=io)
        print("", file=io)
        print("Nesting info: Jset", file=io)
        for i in range(len(self.Jset) - 1):
            if isnested(self.Jset[i + 1], self.Jset[i], "col"):
                print(f"  Nested: {i + 1} < {i}", file=io)
            else:
                print(f"  Not nested: ! {i + 1} < {i}", file=io)

    # -- error bookkeeping (tensorci2.jl:231-289) ---------------------------

    def updatebonderror(self, b: int, error: float) -> None:
        self.bonderrors[b] = error

    def maxbonderror(self) -> float:
        return float(np.max(self.bonderrors))

    def updatepivoterror(self, errors: Sequence[float]) -> None:
        n = max(len(self.pivoterrors), len(errors))
        pe = padzero(self.pivoterrors)
        er = padzero(errors)
        self.pivoterrors = [
            max(next(pe), next(er)) for _ in range(n)
        ]

    def flushpivoterror(self) -> None:
        self.pivoterrors = []

    def pivoterror(self) -> float:
        return self.maxbonderror()

    def updateerrors(self, b: int, errors: Sequence[float]) -> None:
        self.updatebonderror(b, float(errors[-1]))
        self.updatepivoterror(errors)

    def updatemaxsample(self, samples) -> None:
        self.maxsamplevalue = maxabs(self.maxsamplevalue, samples)

    # -- global pivots (tensorci2.jl:295-453) --------------------------------

    def addglobalpivots(self, pivots: Sequence[MultiIndex]) -> None:
        if any(len(self) != len(p) for p in pivots):
            raise ValueError(
                "Please specify a pivot as one index per leg of the MPS."
            )
        for pivot in pivots:
            pivot = tuple(pivot)
            for b in range(len(self)):
                pushunique(self.Iset[b], pivot[:b])
                pushunique(self.Jset[b], pivot[b + 1 :])
        if len(pivots) > 0:
            self.invalidatesitetensors()

    def existaspivot(self, indexset: Sequence[int]) -> List[bool]:
        indexset = tuple(indexset)
        return [
            indexset[:b] in self.Iset[b] and indexset[b + 1 :] in self.Jset[b]
            for b in range(len(self))
        ]

    def addglobalpivots1sitesweep(
        self,
        f,
        pivots: Sequence[MultiIndex],
        reltol: float = 1e-14,
        abstol: float = 0.0,
        maxbonddim: int = _INTMAX,
    ) -> None:
        self.addglobalpivots(pivots)
        self.makecanonical(f, reltol=reltol, abstol=abstol, maxbonddim=maxbonddim)

    def addglobalpivots2sitesweep(
        self,
        f,
        pivots: Sequence[MultiIndex],
        tolerance: float = 1e-8,
        normalizeerror: bool = True,
        maxbonddim: int = _INTMAX,
        pivotsearch: str = "full",
        verbosity: int = 0,
        ntry: int = 10,
        strictlynested: bool = False,
    ) -> int:
        if any(len(self) != len(p) for p in pivots):
            raise ValueError(
                "Please specify a pivot as one index per leg of the MPS."
            )
        pivots_ = [tuple(p) for p in pivots]
        for _ in range(ntry):
            errornormalization = self.maxsamplevalue if normalizeerror else 1.0
            abstol = tolerance * errornormalization
            self.addglobalpivots(pivots_)
            self.sweep2site(
                f, 2,
                abstol=abstol, maxbonddim=maxbonddim, pivotsearch=pivotsearch,
                strictlynested=strictlynested, verbosity=verbosity,
            )
            pivmat = np.asarray([tuple(p) for p in pivots], dtype=np.int32)
            fvals = evaluate_rows(f, pivmat, dtype=self.dtype)
            ttvals = TensorTrain(self.sitetensors()).evaluate_batch(pivmat)
            newpivots = [
                tuple(p) for p, fv, tv in zip(pivots, fvals, ttvals)
                if abs(tv - fv) > abstol
            ]
            if verbosity > 0:
                print(
                    f"Trying to add {len(pivots_)} global pivots, "
                    f"{len(newpivots)} still remain."
                )
            if len(newpivots) == 0 or set(map(tuple, newpivots)) == set(pivots_):
                return len(newpivots)
            pivots_ = [tuple(p) for p in newpivots]
        return len(pivots_)

    # -- site tensors --------------------------------------------------------

    def setsitetensor(self, b: int, T: np.ndarray) -> None:
        self._sitetensors[b] = np.asarray(T).reshape(
            len(self.Iset[b]), self.localdims[b], len(self.Jset[b])
        )

    def setsitetensor_from_f(self, f, b: int, leftorthogonal: bool = True):
        """Compute site tensor b as Π_1 · P^{-1} (tensorci2.jl:599-629)."""
        if not leftorthogonal:
            raise ValueError("leftorthogonal=False is not supported!")
        fst = getattr(f, "fused_site_tensors", None)
        if fst is not None and b < len(self) - 1:
            # one fused device program: sample both panels + solve on-device
            T, maxsample = fst.compute(
                self.Iset[b], self.localdims[b], self.Jset[b], self.Iset[b + 1]
            )
            self.maxsamplevalue = max(self.maxsamplevalue, maxsample)
            self._sitetensors[b] = T
            return T
        Is = kronecker_is(self.Iset[b], self.localdims[b])
        Js = self.Jset[b]
        Pi1 = filltensor(
            self.dtype, f, self.localdims, self.Iset[b], self.Jset[b], 1
        ).reshape(len(Is), len(Js))
        self.updatemaxsample(Pi1)

        if b == len(self) - 1:
            self.setsitetensor(b, Pi1)
            return self._sitetensors[b]

        P = filltensor(
            self.dtype, f, self.localdims, self.Iset[b + 1], self.Jset[b], 0
        ).reshape(len(self.Iset[b + 1]), len(self.Jset[b]))
        if len(self.Iset[b + 1]) != len(self.Jset[b]):
            raise ValueError(f"Pivot matrix at bond {b} is not square!")
        # T = Pi1 · P^{-1}
        Tmat = np.linalg.solve(P.T, Pi1.T).T
        self._sitetensors[b] = Tmat.reshape(
            len(self.Iset[b]), self.localdims[b], len(self.Iset[b + 1])
        )
        return self._sitetensors[b]

    def fillsitetensors(self, f) -> None:
        engine = getattr(f, "device_sweep_engine", None)
        if engine is not None and engine.fillsitetensors(self):
            return
        for b in range(len(self)):
            self.setsitetensor_from_f(f, b)

    # -- 0-site sweep (bad pivot removal, tensorci2.jl:559-586) --------------

    def sweep0site(self, f, b: int, reltol: float = 1e-14,
                   abstol: float = 0.0) -> None:
        self.invalidatesitetensors()
        P = filltensor(
            self.dtype, f, self.localdims, self.Iset[b + 1], self.Jset[b], 0
        ).reshape(len(self.Iset[b + 1]), len(self.Jset[b]))
        self.updatemaxsample(P)
        F = MatrixLUCI(P, reltol=reltol, abstol=abstol, leftorthogonal=True)
        diag = np.abs(F.lu.diag())
        if len(diag) > 0:
            ndiag = int(
                np.sum(
                    (diag > abstol) & (diag / np.abs(F.lu.U[0, 0]) > reltol)
                )
            )
        else:
            ndiag = 0
        self.Iset[b + 1] = [
            self.Iset[b + 1][i] for i in F.rowindices()[:ndiag]
        ]
        self.Jset[b] = [self.Jset[b][j] for j in F.colindices()[:ndiag]]

    # -- 1-site sweep (tensorci2.jl:659-725) ----------------------------------

    def sweep1site(
        self,
        f,
        sweepdirection: str = "forward",
        reltol: float = 1e-14,
        abstol: float = 0.0,
        maxbonddim: int = _INTMAX,
        updatetensors: bool = True,
    ) -> None:
        self.flushpivoterror()
        self.invalidatesitetensors()
        if sweepdirection not in ("forward", "backward"):
            raise ValueError(
                f"Unknown sweep direction {sweepdirection}: "
                "choose between forward, backward."
            )
        fwd = sweepdirection == "forward"
        engine = getattr(f, "device_sweep_engine", None)
        if engine is not None and engine.sweep1site(
            self, fwd, reltol, abstol, maxbonddim, updatetensors=updatetensors
        ):
            return
        n = len(self)
        brange = range(n - 1) if fwd else range(n - 1, 0, -1)
        for b in brange:
            Is = kronecker_is(self.Iset[b], self.localdims[b]) if fwd else self.Iset[b]
            Js = self.Jset[b] if fwd else kronecker_sj(self.localdims[b], self.Jset[b])
            Pi = filltensor(
                self.dtype, f, self.localdims, self.Iset[b], self.Jset[b], 1
            ).reshape(len(Is), len(Js))
            self.updatemaxsample(Pi)
            luci = MatrixLUCI(
                Pi, reltol=reltol, abstol=abstol, maxrank=maxbonddim,
                leftorthogonal=fwd,
            )
            if fwd:
                self.Iset[b + 1] = [Is[i] for i in luci.rowindices()]
                self.Jset[b] = [Js[j] for j in luci.colindices()]
            else:
                self.Iset[b] = [Is[i] for i in luci.rowindices()]
                self.Jset[b - 1] = [Js[j] for j in luci.colindices()]
            if updatetensors:
                self.setsitetensor(b, luci.left() if fwd else luci.right())
                if np.isnan(self._sitetensors[b]).any():
                    raise ValueError(f"Error: NaN in tensor T[{b}]")
            self.updateerrors(b if fwd else b - 1, luci.pivoterrors())

        if updatetensors:
            lastindex = n - 1 if fwd else 0
            shape = (
                (len(self.Iset[-1]), self.localdims[-1])
                if fwd
                else (self.localdims[0], len(self.Jset[0]))
            )
            localtensor = filltensor(
                self.dtype, f, self.localdims,
                self.Iset[lastindex], self.Jset[lastindex], 1,
            ).reshape(shape)
            self.setsitetensor(lastindex, localtensor)

    def makecanonical(
        self,
        f,
        reltol: float = 1e-14,
        abstol: float = 0.0,
        maxbonddim: int = _INTMAX,
    ) -> None:
        """Exact forward pass, truncating backward pass, truncating forward
        pass with tensors (tensorci2.jl:738-749)."""
        self.sweep1site(f, "forward", reltol=0.0, abstol=0.0,
                        maxbonddim=_INTMAX, updatetensors=False)
        self.sweep1site(f, "backward", reltol=reltol, abstol=abstol,
                        maxbonddim=maxbonddim, updatetensors=False)
        self.sweep1site(f, "forward", reltol=reltol, abstol=abstol,
                        maxbonddim=maxbonddim, updatetensors=True)

    # -- 2-site pivot update (tensorci2.jl:825-930) ---------------------------

    def updatepivots(
        self,
        b: int,
        f,
        leftorthogonal: bool,
        reltol: float = 1e-14,
        abstol: float = 0.0,
        maxbonddim: int = _INTMAX,
        sweepdirection: str = "forward",
        pivotsearch: str = "full",
        verbosity: int = 0,
        extraIset: Sequence[MultiIndex] = (),
        extraJset: Sequence[MultiIndex] = (),
    ) -> None:
        self.invalidatesitetensors()
        Icombined = _union(
            kronecker_is(self.Iset[b], self.localdims[b]), extraIset
        )
        Jcombined = _union(
            kronecker_sj(self.localdims[b + 1], self.Jset[b + 1]), extraJset
        )

        if pivotsearch == "full" and getattr(f, "fused_updater", None) is not None:
            # One-device-program path: Π sampling + rrLU + factor extraction
            # fused into a single XLA call (ops/fused.py). Factors are only
            # fetched when they become site tensors — non-strict-nesting
            # sweeps (extra sets present) discard them (tensorci2.jl:923-926
            # guard), so no factor bytes cross the interconnect.
            need_factors = len(extraIset) == 0 and len(extraJset) == 0
            (left, right, rowind, colind, perrs, err, maxsample) = (
                f.fused_updater.update(
                    Icombined, Jcombined, reltol, abstol, maxbonddim,
                    leftorthogonal, need_factors=need_factors,
                )
            )
            self.maxsamplevalue = max(self.maxsamplevalue, maxsample)
            self.Iset[b + 1] = [Icombined[i] for i in rowind]
            self.Jset[b] = [Jcombined[j] for j in colind]
            if need_factors:
                self.setsitetensor(b, left)
                self.setsitetensor(b + 1, right)
            self.updateerrors(b, perrs)
            return
        elif pivotsearch == "full":
            t1 = time.time()
            Pi = filltensor(
                self.dtype, f, self.localdims, Icombined, Jcombined, 0
            ).reshape(len(Icombined), len(Jcombined))
            t2 = time.time()
            self.updatemaxsample(Pi)
            luci = MatrixLUCI(
                Pi, reltol=reltol, abstol=abstol, maxrank=maxbonddim,
                leftorthogonal=leftorthogonal,
            )
            t3 = time.time()
            if verbosity > 2:
                print(
                    f"    Computing Pi ({len(Icombined)} x {len(Jcombined)}) "
                    f"at bond {b}: {t2 - t1:.3f} sec, LU: {t3 - t2:.3f} sec"
                )
        elif pivotsearch == "rook":
            Iset_pos = {idx: pos for pos, idx in enumerate(Icombined)}
            Jset_pos = {idx: pos for pos, idx in enumerate(Jcombined)}
            I0 = [Iset_pos[i] for i in self.Iset[b + 1] if i in Iset_pos]
            J0 = [Jset_pos[j] for j in self.Jset[b] if j in Jset_pos]
            sampler = getattr(f, "panel_sampler", None)
            if (
                getattr(f, "fused_updater", None) is not None
                and not getattr(self, "_rook_tier_warned", False)
            ):
                # Footgun guard: the per-bond rook tiers cost one device
                # dispatch per slab (device rook) or host round trips per
                # slab (SubMatrix rook). For a jax-traceable integrand whose
                # whole-sweep / fused full tier is available, that dispatch
                # count dominates wall time on cheap integrands. Reached
                # only when the
                # whole-sweep rook program declined (rank above engine
                # capacity).
                import warnings

                warnings.warn(
                    "pivotsearch='rook' is running the per-bond rook tier "
                    "(the whole-sweep rook program declined this "
                    "configuration). For jax-traceable integrands, "
                    "pivotsearch='full' is typically far faster because "
                    "the whole sweep compiles to one device program.",
                    RuntimeWarning,
                    stacklevel=3,
                )
                self._rook_tier_warned = True
            if sampler is not None:
                # Device rook tier: materialize the Π panel with ONE device
                # program (cheap for a jax-traceable integrand), then run
                # the whole arrlu slab alternation + factor completion as
                # ONE further XLA dispatch (ops/lu_device.py fused serving
                # rook — f32 pivot hunt + f64 completion for f64 panels,
                # the config-2 headline path). Slab width starts near the
                # continuation rank and doubles on a rank-capped result,
                # playing the reference's widen-and-retry loop
                # (matrixlu.jl:512-548) at one dispatch per round.
                # (reference arrlu: matrixlu.jl:492-569).
                from ..ops.lu_device import rrlu_rook_device_fused

                Pi_dev, maxsample = sampler.sample(Icombined, Jcombined)
                m_p, n_p = Pi_dev.shape
                cap = int(min(maxbonddim, m_p, n_p))
                mixed = Pi_dev.dtype == np.float64
                # hunt resolution: one deflated re-hunt stage (2x hunt
                # cost) only when the requested tolerance is below what a
                # single f32 hunt can see (~1e-7 relative) — abstol is a
                # magnitude, so compare it against the panel's scale (a
                # bare `abstol > 0` made every optimize() call "deep":
                # abstol = tolerance * errornormalization is always > 0)
                scale = float(abs(maxsample)) if maxsample else 0.0
                deep = (0 < reltol < 1e-6) or (
                    scale > 0 and 0 < abstol < 1e-6 * scale
                )
                width = min(cap, max(16, 2 * max(len(I0), len(J0), 1)))
                rng = getattr(self, "rng", None) or np.random.default_rng()
                wI0, wJ0 = I0, J0
                while True:
                    dev = rrlu_rook_device_fused(
                        Pi_dev, maxrank=width, reltol=reltol,
                        abstol=abstol, leftorthogonal=leftorthogonal,
                        rng=rng, I0=wI0, J0=wJ0,
                        precision="mixed" if mixed else "f64",
                        hunt_stages=2 if (mixed and deep) else 1,
                    )
                    if dev.npivots() < width or width >= cap:
                        break
                    # rank-capped below the true cap: widen, warm-started
                    # from the pivots just found
                    wI0 = [int(i) for i in dev.rowindices()]
                    wJ0 = [int(j) for j in dev.colindices()]
                    width = min(cap, 2 * width)
                lu = dev.to_rrlu()
                luci = MatrixLUCI(lu=lu)
                self.updatemaxsample(np.asarray([maxsample]))
            else:
                Pif = SubMatrix(f, Icombined, Jcombined, self.dtype)
                luci = MatrixLUCI(
                    f=Pif,
                    valuetype=self.dtype,
                    matrixsize=(len(Icombined), len(Jcombined)),
                    I0=I0,
                    J0=J0,
                    reltol=reltol,
                    abstol=abstol,
                    maxrank=maxbonddim,
                    leftorthogonal=leftorthogonal,
                    pivotsearch="rook",
                    usebatcheval=True,
                )
                self.updatemaxsample(np.asarray([Pif.maxsamplevalue]))
            if luci.npivots() == 0:
                # fall back to full search (tensorci2.jl:892-906)
                Pi = filltensor(
                    self.dtype, f, self.localdims, Icombined, Jcombined, 0
                ).reshape(len(Icombined), len(Jcombined))
                self.updatemaxsample(Pi)
                luci = MatrixLUCI(
                    Pi, reltol=reltol, abstol=abstol, maxrank=maxbonddim,
                    leftorthogonal=leftorthogonal,
                )
        else:
            raise ValueError(
                f"Unknown pivot search strategy {pivotsearch}. "
                "Choose from rook, full."
            )

        self.Iset[b + 1] = [Icombined[i] for i in luci.rowindices()]
        self.Jset[b] = [Jcombined[j] for j in luci.colindices()]
        if len(extraIset) == 0 and len(extraJset) == 0:
            self.setsitetensor(b, luci.left())
            self.setsitetensor(b + 1, luci.right())
        self.updateerrors(b, luci.pivoterrors())

    # -- 2-site sweep (tensorci2.jl:1195-1258) --------------------------------

    def sweep2site(
        self,
        f,
        niter: int,
        iter1: int = 1,
        abstol: float = 1e-8,
        maxbonddim: int = _INTMAX,
        sweepstrategy: str = "backandforth",
        pivotsearch: str = "full",
        verbosity: int = 0,
        strictlynested: bool = False,
        fillsitetensors: bool = True,
        _search_starts=None,
    ) -> None:
        self.invalidatesitetensors()
        n = len(self)
        engine_filled = False
        self._pair_search = None
        engine = getattr(f, "device_sweep_engine", None)
        if (
            niter == 2
            and engine is not None
            and getattr(engine, "use_sweep_pair", False)
            and pivotsearch in ("full", "rook")
            and fillsitetensors
        ):
            # One optimize iteration = two sweeps + fill as a SINGLE device
            # program (device_sweep.sweep2site_pair): halves the dispatch
            # count per iteration vs sweep-then-fused-sweep. The pair
            # handles the history bookkeeping itself; on capacity decline
            # it returns False and we fall through to the per-sweep loop.
            # _search_starts (from optimize) additionally folds the global
            # pivot candidate search into the same program.
            extraIset: List[List[MultiIndex]] = [[] for _ in range(n)]
            extraJset: List[List[MultiIndex]] = [[] for _ in range(n)]
            if not strictlynested and len(self.Iset_history) > 0:
                extraIset = self.Iset_history[-1]
                extraJset = self.Jset_history[-1]
            self.flushpivoterror()
            if engine.sweep2site_pair(
                self,
                forwardsweep(sweepstrategy, iter1),
                forwardsweep(sweepstrategy, iter1 + 1),
                1e-14, abstol, maxbonddim, extraIset, extraJset,
                pivotsearch=pivotsearch, strictlynested=strictlynested,
                search_starts=_search_starts,
            ):
                self._pair_search = getattr(engine, "last_search", None)
                return
        for it in range(iter1, iter1 + niter):
            extraIset: List[List[MultiIndex]] = [[] for _ in range(n)]
            extraJset: List[List[MultiIndex]] = [[] for _ in range(n)]
            if not strictlynested and len(self.Iset_history) > 0:
                extraIset = self.Iset_history[-1]
                extraJset = self.Jset_history[-1]

            self.Iset_history.append([list(s) for s in self.Iset])
            self.Jset_history.append([list(s) for s in self.Jset])

            self.flushpivoterror()
            fwd = forwardsweep(sweepstrategy, it)
            engine = getattr(f, "device_sweep_engine", None)
            if pivotsearch in ("full", "rook") and engine is not None:
                # whole sweep as one jit-compiled device program (rook runs
                # the traced slab-alternation variant); falls back to the
                # per-bond path when the rank exceeds the engine cap. On
                # the final sweep the site-tensor fill is fused into the
                # same program (one dispatch fewer per optimize iteration).
                self.invalidatesitetensors()
                want_fill = fillsitetensors and it == iter1 + niter - 1
                if engine.sweep2site(
                    self, fwd, 1e-14, abstol, maxbonddim,
                    extraIset, extraJset, pivotsearch=pivotsearch,
                    fill_sites=want_fill,
                ):
                    engine_filled = (
                        want_fill
                        and getattr(engine, "last_sweep_filled", False)
                    )
                    continue
            if fwd:
                brange = range(n - 1)
                leftorth = True
                direction = "forward"
            else:
                brange = range(n - 2, -1, -1)
                leftorth = False
                direction = "backward"
            for b in brange:
                self.updatepivots(
                    b, f, leftorth,
                    abstol=abstol, maxbonddim=maxbonddim,
                    sweepdirection=direction, pivotsearch=pivotsearch,
                    verbosity=verbosity,
                    extraIset=extraIset[b + 1],
                    extraJset=extraJset[b],
                )
        if fillsitetensors and not engine_filled:
            self.fillsitetensors(f)

    def _optimize_device_block(self, engine, finder, tol, normalizeerror,
                               maxbonddim, strictlynested, sweepstrategy,
                               all_starts, it, maxiter, errors, ranks,
                               nglobalpivots, ncheckhistory,
                               checkconvglobalpivot, pivotsearch="full"):
        """Run up to loop_kmax pivot-free optimize iterations as ONE device
        program (DeviceSweepEngine.optimize_loop) and replay the exact
        per-iteration bookkeeping from its stacked outputs.

        Returns None when the engine declines (caller falls through to the
        per-iteration path for this iteration), else (niter, stop): niter
        iterations were fully accounted (0 means the first iteration
        saturated and the buffer was grown — retry), stop True means the
        convergence criterion fired."""
        n = len(self)
        k_budget = min(maxiter - it + 1, engine.loop_kmax)
        sb = None
        if all_starts is not None:
            sb = np.asarray(
                [all_starts[j] for j in range(it - 1, it - 1 + k_budget)],
                dtype=np.int32,
            )
        extraIset: List[List[MultiIndex]] = [[] for _ in range(n)]
        extraJset: List[List[MultiIndex]] = [[] for _ in range(n)]
        if not strictlynested and len(self.Iset_history) > 0:
            extraIset = self.Iset_history[-1]
            extraJset = self.Jset_history[-1]
        t0 = time.time()
        res = engine.optimize_loop(
            self,
            forwardsweep(sweepstrategy, 1), forwardsweep(sweepstrategy, 2),
            1e-14, tol, normalizeerror, maxbonddim, extraIset, extraJset,
            strictlynested, sb, finder.tolmarginglobalsearch,
            errors, ranks, nglobalpivots, ncheckhistory,
            checkconvglobalpivot, k_budget, pivotsearch=pivotsearch,
        )
        if res is None:
            return None
        wall = time.time() - t0
        K_done = int(res["k"])
        code = int(res["code"])
        if K_done == 0:
            # the first in-loop iteration saturated the buffer: grow and
            # retry; if growth is impossible the fused path declines
            if code == 2 and engine._grow_capacity():
                return (0, False)
            return None

        L = len(self.localdims)
        prefix_lens = list(range(L))
        suffix_lens = [L - b - 1 for b in range(L)]
        for j in range(K_done):
            for h in (0, 1):
                self.Iset_history.append(engine._unpack(
                    res["hI"][j, h], res["hIl"][j, h], prefix_lens
                ))
                self.Jset_history.append(engine._unpack(
                    res["hJ"][j, h], res["hJl"][j, h], suffix_lens
                ))
        self.Iset = engine._unpack(res["I"], res["Il"], prefix_lens)
        self.Jset = engine._unpack(res["J"], res["Jl"], suffix_lens)
        self.maxsamplevalue = max(self.maxsamplevalue, float(res["ms"]))
        self.invalidatesitetensors()
        self.flushpivoterror()
        Il = res["Il"]
        for b in range(L - 1):
            self.updateerrors(
                b, list(res["perrs"][b][: int(Il[b + 1]) + 1])
            )
        if engine.pair:
            engine._store_sitetensors(
                self, (res["cores"], res["coresi"], res["ms"])
            )
        else:
            engine._store_sitetensors(self, (res["cores"], res["ms"]))
        engine.last_sweep_filled = True
        if res.get("rook"):
            engine.nevals += int(res["nev"])
        else:
            for j in range(K_done):
                for b in range(L - 1):
                    Icap = engine.Imax * self.localdims[b] + engine.Imax
                    Jcap = self.localdims[b + 1] * engine.Imax + engine.Imax
                    engine.nevals += 2 * Icap * Jcap
        # the device loop computes a fill EVERY iteration (the search needs
        # it); _store_sitetensors above accounted for one
        fill_per_iter = sum(
            engine.Imax * d * engine.Imax for d in self.localdims
        ) + (L - 1) * engine.Imax * engine.Imax
        engine.nevals += (K_done - 1) * fill_per_iter
        if sb is not None:
            engine.nevals += K_done * finder.nsearch * L * max(self.localdims)

        abstol_exit = float(res["abstol"])
        stop = False
        for j in range(K_done):
            errors.append(float(res["oerr"][j]))
            if code == 1 and j == K_done - 1:
                pivots = finder.select_device_result(
                    all_starts[it - 1 + j], res["bflat"], res["berr"],
                    max(self.localdims), abstol_exit,
                )
                self.addglobalpivots(pivots)
                nglobalpivots.append(len(pivots))
                ranks.append(self.rank())
            else:
                nglobalpivots.append(0)
                ranks.append(int(res["orank"][j]))
            self.stats["sweep_walltime"].append(wall / K_done)
            self.stats["globalsearch_walltime"].append(0.0)
            self.stats["iteration_walltime"].append(wall / K_done)
            self.stats["ranks"].append(ranks[-1])
            self.stats["errors"].append(errors[-1])
            self.stats["nglobalpivots"].append(nglobalpivots[-1])
        if code == 0:
            stop = True
        elif code == 1:
            stop = convergencecriterion(
                ranks, errors, nglobalpivots, abstol_exit, maxbonddim,
                ncheckhistory, checkconvglobalpivot=checkconvglobalpivot,
            )
        elif code == 2:
            # saturation after >= 1 completed iterations: bookkeeping above
            # covers the completed ones; grow (best effort) and re-enter
            engine._grow_capacity()
        return (K_done, stop)

    # -- main optimization loop (tensorci2.jl:1018-1172) ----------------------

    def optimize(
        self,
        f,
        tolerance: Optional[float] = None,
        pivottolerance: Optional[float] = None,
        maxbonddim: int = _INTMAX,
        maxiter: int = 20,
        sweepstrategy: str = "backandforth",
        pivotsearch: str = "full",
        verbosity: int = 0,
        loginterval: int = 10,
        normalizeerror: bool = True,
        ncheckhistory: int = 3,
        globalpivotfinder=None,
        maxnglobalpivot: int = 5,
        nsearchglobalpivot: int = 5,
        tolmarginglobalsearch: float = 10.0,
        strictlynested: bool = False,
        checkbatchevaluatable: bool = False,
        checkconvglobalpivot: bool = True,
        rng: Optional[np.random.Generator] = None,
        profile_dir: Optional[str] = None,
    ):
        """`profile_dir` (SURVEY §5 tracing plan): when set, the whole
        optimization records a ``jax.profiler`` trace into that directory
        (viewable in TensorBoard/Perfetto) in addition to the per-iteration
        ``self.stats`` time series."""
        import warnings

        from .globalpivotfinder import (
            DefaultGlobalPivotFinder,
            GlobalPivotSearchInput,
        )

        errors: List[float] = []
        ranks: List[int] = []
        nglobalpivots: List[int] = []

        if checkbatchevaluatable and not isbatchevaluable(f):
            raise ValueError("Function `f` is not batch evaluatable")
        if nsearchglobalpivot > 0 and nsearchglobalpivot < maxnglobalpivot:
            raise ValueError("nsearchglobalpivot < maxnglobalpivot!")

        if pivottolerance is not None:
            if tolerance is not None and tolerance != pivottolerance:
                raise ValueError(
                    "Got different values for pivottolerance and tolerance in "
                    "optimize (TCI2). Both options have the same meaning; "
                    "please assign only `tolerance`."
                )
            warnings.warn(
                "The option `pivottolerance` of `optimize` is deprecated. "
                "Please use `tolerance` instead.",
                DeprecationWarning,
            )
            tol = pivottolerance
        elif tolerance is not None:
            tol = tolerance
        else:
            tol = 1e-8

        if maxbonddim >= _INTMAX and tol <= 0:
            raise ValueError(
                "Specify either tolerance > 0 or some maxbonddim; otherwise, "
                "the convergence criterion is not reachable!"
            )

        if rng is None:
            rng = np.random.default_rng()
        # visible to updatepivots' device rook tier (start-set fills), so a
        # caller-provided rng makes whole-optimization trajectories
        # reproducible
        self.rng = rng

        tstart = time.time()
        finder = globalpivotfinder or DefaultGlobalPivotFinder(
            nsearch=nsearchglobalpivot,
            maxnglobalpivot=maxnglobalpivot,
            tolmarginglobalsearch=tolmarginglobalsearch,
        )

        # tracing/observability (SURVEY.md §5): per-iteration time series
        # returned alongside ranks/errors, replacing the reference's
        # verbosity println timings (tensorci2.jl:1092-1143)
        self.stats = {
            "iteration_walltime": [],
            "sweep_walltime": [],
            "globalsearch_walltime": [],
            "ranks": [],
            "errors": [],
            "nglobalpivots": [],
        }

        # With the stock DefaultGlobalPivotFinder, ALL search start points
        # are drawn upfront (maxiter blocks, in the finder's own
        # per-iteration rng order). Every execution tier then sees the SAME
        # start points for iteration k — the host finder (via
        # initial_points), the sweep-pair fused search, and the
        # multi-iteration device loop — so trajectories agree exactly
        # across tiers regardless of where each tier exits, re-enters, or
        # grows buffers.
        _default_finder = type(finder) is DefaultGlobalPivotFinder
        all_starts = (
            [finder.draw_starts(self.localdims, rng) for _ in range(maxiter)]
            if _default_finder and finder.nsearch > 0 else None
        )
        engine = getattr(f, "device_sweep_engine", None)
        # Multi-iteration device loop: pivot-free iterations are pure
        # device state transitions — run up to loop_kmax of them inside
        # ONE lax.while_loop program, exiting to the host only for
        # global-pivot insertion, buffer growth, or convergence.
        _fused_loop_ok = (
            verbosity == 0
            and _default_finder
            and pivotsearch in ("full", "rook")
            and engine is not None
            and getattr(engine, "use_optimize_loop", False)
        )

        if profile_dir is not None:
            import jax

            jax.profiler.start_trace(profile_dir)
        try:
            return self._optimize_loop_body(
                f, tol, maxbonddim, maxiter, sweepstrategy, pivotsearch,
                verbosity, loginterval, normalizeerror, ncheckhistory,
                tolmarginglobalsearch, strictlynested, checkconvglobalpivot,
                rng, errors, ranks, nglobalpivots, tstart, finder,
                all_starts, engine, _fused_loop_ok,
            )
        finally:
            if profile_dir is not None:
                import jax

                jax.profiler.stop_trace()

    def _optimize_loop_body(
        self, f, tol, maxbonddim, maxiter, sweepstrategy, pivotsearch,
        verbosity, loginterval, normalizeerror, ncheckhistory,
        tolmarginglobalsearch, strictlynested, checkconvglobalpivot,
        rng, errors, ranks, nglobalpivots, tstart, finder,
        all_starts, engine, _fused_loop_ok,
    ):
        from .globalpivotfinder import GlobalPivotSearchInput

        globalpivots: List[MultiIndex] = []
        it = 1
        while it <= maxiter:
            titer = time.time()
            errornormalization = self.maxsamplevalue if normalizeerror else 1.0
            abstol = tol * errornormalization

            if _fused_loop_ok:
                blk = self._optimize_device_block(
                    engine, finder, tol, normalizeerror, maxbonddim,
                    strictlynested, sweepstrategy, all_starts, it, maxiter,
                    errors, ranks, nglobalpivots, ncheckhistory,
                    checkconvglobalpivot, pivotsearch=pivotsearch,
                )
                if blk is not None:
                    niter_blk, stop_blk = blk
                    it += niter_blk
                    if stop_blk:
                        break
                    continue

            if verbosity > 1:
                print(
                    f"  Walltime {time.time() - tstart:.3f} sec: "
                    "starting 2site sweep"
                )
            starts = all_starts[it - 1] if all_starts is not None else None
            tsweep = time.time()
            self.sweep2site(
                f, 2, iter1=1,
                abstol=abstol, maxbonddim=maxbonddim, pivotsearch=pivotsearch,
                strictlynested=strictlynested, verbosity=verbosity,
                sweepstrategy=sweepstrategy, fillsitetensors=True,
                _search_starts=starts,
            )
            self.stats["sweep_walltime"].append(time.time() - tsweep)
            if verbosity > 0 and len(globalpivots) > 0 and it % loginterval == 0:
                gp = np.asarray([tuple(p) for p in globalpivots], dtype=np.int32)
                abserr = list(
                    np.abs(
                        TensorTrain(self.sitetensors()).evaluate_batch(gp)
                        - evaluate_rows(f, gp, dtype=self.dtype)
                    )
                )
                nrejections = sum(e > abstol for e in abserr)
                if nrejections > 0:
                    print(
                        f"  Rejected {nrejections} global pivots added in the "
                        f"previous iteration, errors are {abserr}"
                    )
            errors.append(self.pivoterror())

            if verbosity > 1:
                print(
                    f"  Walltime {time.time() - tstart:.3f} sec: "
                    "start searching global pivots"
                )
            tsearch = time.time()
            pair_search = getattr(self, "_pair_search", None)
            if starts is not None and pair_search is not None:
                # search already ran inside the sweep-pair device program
                best_flat, best_err = pair_search
                globalpivots = finder.select_device_result(
                    starts, best_flat, best_err, max(self.localdims),
                    abstol, verbosity=verbosity,
                )
            else:
                input_ = GlobalPivotSearchInput.from_tci(self)
                globalpivots = finder(
                    input_, f, abstol, verbosity=verbosity, rng=rng,
                    initial_points=starts,
                ) if starts is not None else finder(
                    input_, f, abstol, verbosity=verbosity, rng=rng
                )
            self.addglobalpivots(globalpivots)
            nglobalpivots.append(len(globalpivots))
            self.stats["globalsearch_walltime"].append(time.time() - tsearch)
            if verbosity > 1:
                print(
                    f"  Walltime {time.time() - tstart:.3f} sec: "
                    "done searching global pivots"
                )

            ranks.append(self.rank())
            self.stats["iteration_walltime"].append(time.time() - titer)
            self.stats["ranks"].append(self.rank())
            self.stats["errors"].append(errors[-1])
            self.stats["nglobalpivots"].append(len(globalpivots))
            if verbosity > 0 and it % loginterval == 0:
                print(
                    f"iteration = {it}, rank = {ranks[-1]}, "
                    f"error= {errors[-1]}, "
                    f"maxsamplevalue= {self.maxsamplevalue}, "
                    f"nglobalpivot={len(globalpivots)}"
                )
            if convergencecriterion(
                ranks, errors, nglobalpivots, abstol, maxbonddim, ncheckhistory,
                checkconvglobalpivot=checkconvglobalpivot,
            ):
                break
            it += 1

        # Remove unnecessary pivots added by global pivot insertion and
        # compute site tensors (tensorci2.jl:1157-1167)
        errornormalization = self.maxsamplevalue if normalizeerror else 1.0
        abstol = tol * errornormalization
        self.sweep1site(f, abstol=abstol, maxbonddim=maxbonddim)
        _sanitycheck(self)

        return ranks, [e / errornormalization for e in errors]


def _call_f(f, x):
    """Call f at one multi-index whether it is plain or a BatchEvaluator."""
    if isbatchevaluable(f):
        if hasattr(f, "evaluate_single"):
            return f.evaluate_single(tuple(x))
        return f(tuple(x))
    return f(tuple(x))


def reconstructglobalpivotsfromijset(localdims, Isets, Jsets):
    """(tensorci2.jl:303-320)"""
    pivots: List[MultiIndex] = []
    l = len(Isets)
    for i in range(l):
        for I in Isets[i]:
            for J in Jsets[i]:
                for j in range(localdims[i]):
                    pushunique(pivots, tuple(I) + (j,) + tuple(J))
    return pivots


def convergencecriterion(
    ranks: Sequence[int],
    errors: Sequence[float],
    nglobalpivots: Sequence[int],
    tolerance: float,
    maxbonddim: int,
    ncheckhistory: int,
    checkconvglobalpivot: bool = True,
) -> bool:
    """(tensorci2.jl:947-966)"""
    if len(errors) < ncheckhistory:
        return False
    lastranks = list(ranks[-ncheckhistory:])
    lastngpivots = list(nglobalpivots[-ncheckhistory:])
    converged = (
        all(e < tolerance for e in errors[-ncheckhistory:])
        and (all(g == 0 for g in lastngpivots) if checkconvglobalpivot else True)
        and min(lastranks) == lastranks[-1]
    )
    return converged or all(r >= maxbonddim for r in lastranks)


def _sanitycheck(tci: TensorCI2) -> bool:
    """(globalsearch.jl:226-233)"""
    for b in range(len(tci) - 1):
        if len(tci.Iset[b + 1]) != len(tci.Jset[b]):
            raise ValueError(f"Pivot matrix at bond {b} is not square!")
    return True


def crossinterpolate2(
    valuetype,
    f,
    localdims: Sequence[int],
    initialpivots: Optional[Sequence[Sequence[int]]] = None,
    **kwargs,
):
    """Cross-interpolate f by TCI2 (tensorci2.jl:1313-1323).

    Returns (tci, ranks, errors). Keyword arguments are forwarded to
    TensorCI2.optimize; see that method for the canonical knob set.
    """
    tci = TensorCI2.from_function(f, localdims, initialpivots, dtype=valuetype)
    ranks, errors = tci.optimize(f, **kwargs)
    return tci, ranks, errors


def searchglobalpivots(
    tci: TensorCI2,
    f,
    abstol: float,
    verbosity: int = 0,
    nsearch: int = 100,
    maxnglobalpivot: int = 5,
    rng: Optional[np.random.Generator] = None,
) -> List[MultiIndex]:
    """Find pivots where the interpolation error exceeds abstol
    (tensorci2.jl:1344-1384).

    All nsearch starts run in lock-step through the batched floating-zone
    (globalsearch._floatingzone_batch — one batched f call + one batched TT
    evaluation per leg round instead of one f dispatch per start per leg);
    results are consumed in start order with the reference's
    maxnglobalpivot early stop, so the selected pivots match the
    sequential-loop semantics."""
    from .globalsearch import _floatingzone_batch

    if nsearch == 0 or maxnglobalpivot == 0:
        return []
    if not tci.issitetensorsavailable():
        tci.fillsitetensors(f)
    if rng is None:
        rng = np.random.default_rng()

    initps = [
        tuple(int(rng.integers(0, d)) for d in tci.localdims)
        for _ in range(nsearch)
    ]
    results = None
    engine = getattr(f, "device_sweep_engine", None)
    if engine is not None:
        # whole search as ONE device program (identical lock-step
        # trajectory up to float associativity in the TT contraction)
        dev = engine.floatingzone(
            tci.sitetensors(), np.asarray(initps, dtype=np.int32),
            nsweeps=100, earlystoptol=10 * abstol,
        )
        if dev is not None:
            parr, merr = dev
            results = [
                (tuple(int(x) for x in parr[s]), float(merr[s]))
                for s in range(nsearch)
            ]
    if results is None:
        results = _floatingzone_batch(
            TensorTrain(tci.sitetensors()), f, initps,
            earlystoptol=10 * abstol, nsweeps=100,
        )
    pivots = {}
    for pivot, error in results:
        if error > abstol:
            pivots[error] = pivot
        if len(pivots) == maxnglobalpivot:
            break

    if len(pivots) == 0:
        if verbosity > 1:
            print("  No global pivot found")
        return []
    if verbosity > 1:
        maxerr = max(pivots.keys())
        print(f"  Found {len(pivots)} global pivots: max error {maxerr}")
    return list(pivots.values())
