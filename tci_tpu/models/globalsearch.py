"""True-error estimation by floating-zone coordinate search.

Parity reference: src/globalsearch.jl (estimatetrueerror :52-83,
_floatingzone :119-186).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

from .tensortrain import TensorTrain
from .ttcache import TTCache

MultiIndex = Tuple[int, ...]


def estimatetrueerror(
    tt: TensorTrain,
    f,
    nsearch: int = 100,
    initialpoints: Optional[Sequence[MultiIndex]] = None,
    rng: Optional[np.random.Generator] = None,
) -> List[Tuple[MultiIndex, float]]:
    """Floating-zone search for large-interpolation-error points; returns
    unique (pivot, error) pairs sorted by error descending.

    All starts advance in lock-step (_floatingzone_batch): per leg round,
    every active start's candidate rows evaluate in ONE batched f call and
    one batched TT evaluation — on a device evaluator this is
    ~(starts x legs) fewer dispatches than the reference's per-start sweep
    (globalsearch.jl:52-83), with identical per-start trajectories."""
    if nsearch <= 0 and initialpoints is None:
        raise ValueError("No search is performed")
    if nsearch < 0:
        raise ValueError("nsearch must be non-negative")
    if rng is None:
        rng = np.random.default_rng()

    if initialpoints is None and nsearch > 0:
        dims = [d[0] for d in tt.sitedims()]
        initialpoints = [
            tuple(int(rng.integers(0, d)) for d in dims) for _ in range(nsearch)
        ]

    # Device tier: with a device-sweep-capable evaluator the WHOLE search
    # (every sweep of every start) runs as one device program
    # (DeviceSweepEngine.floatingzone); identical lock-step trajectories,
    # ~(sweeps x legs) fewer dispatches than the batched host loop below.
    pivoterror = None
    engine = getattr(f, "device_sweep_engine", None)
    if engine is not None and len(initialpoints) > 0:
        dev = engine.floatingzone(
            tt.sitetensors(),
            np.asarray([list(p) for p in initialpoints], dtype=np.int32),
        )
        if dev is not None:
            pivots, maxerr = dev
            pivoterror = [
                (tuple(int(x) for x in pivots[s]), float(maxerr[s]))
                for s in range(len(initialpoints))
            ]
    if pivoterror is None:
        pivoterror = _floatingzone_batch(tt, f, initialpoints)
    pivoterror.sort(key=lambda pe: -pe[1])
    seen = set()
    out = []
    for p, e in pivoterror:
        if (p, e) not in seen:
            seen.add((p, e))
            out.append((p, e))
    return out


def _floatingzone_batch(
    tt: TensorTrain,
    f,
    initialpoints: Sequence[MultiIndex],
    earlystoptol: float = float("inf"),
    nsweeps: int = 2**62,
) -> List[Tuple[MultiIndex, float]]:
    """Lock-step batched coordinate sweeps maximizing |f - tt|.

    Each start follows EXACTLY the sequential _floatingzone trajectory
    (same leg order, same first-max argmax, same stop rule); batching only
    changes how the evaluations are dispatched."""
    from ..parallel.batcheval import evaluate_rows

    S = len(initialpoints)
    if S == 0:
        return []
    localdims = [d[0] for d in tt.sitedims()]
    n = len(localdims)
    dtype = tt.sitetensors()[0].dtype.type
    pivots = np.asarray([list(p) for p in initialpoints], dtype=np.int64)

    fv0 = np.asarray(evaluate_rows(f, pivots, dtype=dtype))
    tv0 = np.asarray(tt.evaluate_batch(pivots))
    maxerr = np.abs(fv0 - tv0).astype(float)
    active = np.ones(S, dtype=bool)

    for _ in range(min(nsweeps, 10**9)):
        prev = maxerr.copy()
        for ipos in range(n):
            act = np.flatnonzero(active)
            if act.size == 0:
                break
            d = localdims[ipos]
            cand = np.repeat(pivots[act], d, axis=0)
            cand[:, ipos] = np.tile(np.arange(d), act.size)
            fv = np.asarray(evaluate_rows(f, cand, dtype=dtype))
            tv = np.asarray(tt.evaluate_batch(cand))
            err = np.abs(fv - tv).reshape(act.size, d)
            best = np.argmax(err, axis=1)  # first max, like np.argmax 1-D
            pivots[act, ipos] = best
            maxerr[act] = np.maximum(
                maxerr[act], err[np.arange(act.size), best]
            )
        done = (maxerr == prev) | (maxerr > earlystoptol)
        active &= ~done
        if not active.any():
            break

    return [
        (tuple(int(x) for x in pivots[s]), float(maxerr[s])) for s in range(S)
    ]


def _floatingzone(
    ttcache: TTCache,
    f,
    earlystoptol: float = float("inf"),
    nsweeps: int = 2**62,
    initp: Optional[MultiIndex] = None,
    rng: Optional[np.random.Generator] = None,
) -> Tuple[MultiIndex, float]:
    """Coordinate sweep maximizing |f - tt| (globalsearch.jl:119-186)."""
    from .tensorci2 import _call_f, filltensor

    if nsweeps <= 0:
        raise ValueError("nsweeps should be positive!")
    if rng is None:
        rng = np.random.default_rng()

    localdims = [d[0] for d in ttcache.sitedims()]
    n = len(ttcache)
    if initp is None:
        pivot = [int(rng.integers(0, d)) for d in localdims]
    else:
        pivot = list(initp)

    dtype = ttcache.sitetensors[0].dtype.type
    maxerror = abs(_call_f(f, pivot) - ttcache.evaluate(pivot))

    for _ in range(min(nsweeps, 10**9)):
        prev_maxerror = maxerror
        for ipos in range(n):
            exactdata = filltensor(
                dtype, f, localdims,
                [tuple(pivot[:ipos])], [tuple(pivot[ipos + 1 :])], 1,
            )
            prediction = filltensor(
                dtype, ttcache, localdims,
                [tuple(pivot[:ipos])], [tuple(pivot[ipos + 1 :])], 1,
            )
            err = np.abs(exactdata - prediction).reshape(-1)
            pivot[ipos] = int(np.argmax(err))
            maxerror = max(float(np.max(err)), maxerror)
        if maxerror == prev_maxerror or maxerror > earlystoptol:
            break

    return tuple(pivot), maxerror
