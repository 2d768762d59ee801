"""Dispatch-fusion tier benchmarks: whole-optimization loop, device
floating-zone, and whole-contraction programs.

Measures, on JAX's default backend:
  1. crossinterpolate2 warm wall with the multi-iteration loop ON vs OFF
     (the OFF tier is the per-iteration sweep-pair program) — same
     trajectories bit-for-bit, so the ratio is pure dispatch overhead.
  2. estimatetrueerror (100 starts) on the device floating-zone program
     vs the batched host lock-step loop.
  3. contract zipup/naive device tiers (whole-contraction programs).

Prints one JSON line per section.
"""

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from _common import setup_cache  # noqa: E402


def _median3(fn):
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        fn()
        walls.append(time.perf_counter() - t0)
    return float(np.median(walls))


def main():
    setup_cache()
    import jax.numpy as jnp

    import tci_tpu as tci
    from tci_tpu.parallel.batcheval import JaxBatchEvaluator

    localdims = [10] * 8

    def fjax(idx):
        v = idx.astype(jnp.float64) + 1.0
        return 1.0 / (1.0 + jnp.sum(v * v))

    # -- 1. optimize loop vs per-iteration pair -----------------------------
    res = {}
    for use_loop in (True, False):
        bf = JaxBatchEvaluator(fjax, localdims, dtype=np.float64)
        bf.device_sweep_engine.use_optimize_loop = use_loop
        t0 = time.perf_counter()
        tci.crossinterpolate2(np.float64, bf, localdims, tolerance=1e-8)
        cold = time.perf_counter() - t0
        wall = _median3(lambda: tci.crossinterpolate2(
            np.float64, bf, localdims, tolerance=1e-8
        ))
        res["loop" if use_loop else "pair"] = {
            "warm_s": round(wall, 3), "cold_s": round(cold, 3),
        }
    print(json.dumps({
        "metric": "optimize_loop_vs_pair_warm_wall",
        "value": res["loop"]["warm_s"],
        "unit": "s (loop tier; pair tier + ratio in detail)",
        "vs_baseline": round(res["pair"]["warm_s"] / res["loop"]["warm_s"], 3),
        "detail": res,
    }), flush=True)

    # -- 2. floating-zone device vs host lock-step --------------------------
    from tci_tpu.models.globalsearch import (
        _floatingzone_batch,
        estimatetrueerror,
    )

    bf = JaxBatchEvaluator(fjax, localdims, dtype=np.float64)
    t, _, _ = tci.crossinterpolate2(np.float64, bf, localdims,
                                    tolerance=1e-8)
    tt = tci.tensortrain(t)
    starts = [
        tuple(int(x) for x in row)
        for row in np.random.default_rng(0).integers(0, 10, (100, 8))
    ]
    estimatetrueerror(tt, bf, initialpoints=starts)  # warm-up compile
    dev_wall = _median3(
        lambda: estimatetrueerror(tt, bf, initialpoints=starts)
    )
    _floatingzone_batch(tt, bf, starts)  # warm-up
    host_wall = _median3(lambda: _floatingzone_batch(tt, bf, starts))
    print(json.dumps({
        "metric": "floatingzone_device_warm_wall",
        "value": round(dev_wall, 4),
        "unit": "s (100 starts; host lock-step tier in detail)",
        "vs_baseline": round(host_wall / dev_wall, 2),
        "detail": {"host_lockstep_s": round(host_wall, 4)},
    }), flush=True)

    # -- 3. whole-contraction programs --------------------------------------
    rng = np.random.default_rng(1)
    L, chi, d = 8, 16, 2
    A = tci.TensorTrain([
        rng.standard_normal(
            (1 if n == 0 else chi, d, d, 1 if n == L - 1 else chi)
        ) / np.sqrt(chi) for n in range(L)
    ])
    B = tci.TensorTrain([
        rng.standard_normal(
            (1 if n == 0 else chi, d, d, 1 if n == L - 1 else chi)
        ) / np.sqrt(chi) for n in range(L)
    ])
    out = {}
    for alg, kw in (("zipup", {"method": "LU"}), ("naive", {})):
        tci.contract(A, B, algorithm=alg, jax_native=True,
                     tolerance=1e-10, **kw)  # warm-up
        out[alg] = round(_median3(lambda: tci.contract(
            A, B, algorithm=alg, jax_native=True, tolerance=1e-10, **kw
        )), 4)
    print(json.dumps({
        "metric": "contract_whole_program_warm_wall",
        "value": out["zipup"],
        "unit": "s (zipup; naive in detail; L=8 chi=16 MPO-MPO)",
        "vs_baseline": None,
        "detail": out,
    }), flush=True)


if __name__ == "__main__":
    main()
