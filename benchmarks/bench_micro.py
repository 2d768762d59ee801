"""Micro-benchmarks of the evaluation runtime (analogue of the reference's
benchmark/batcheval.jl:14-66 and benchmark/cache.jl:20-52): batched dispatch
latency on 100x100 index panels, and CachedFunction insert/query throughput
with 10^5 cached entries at L=30 (the reference's fixed-width key regime)."""

import json
import time

import numpy as np


def main():
    import jax.numpy as jnp

    from tci_tpu import CachedFunction
    from tci_tpu.parallel.batcheval import (
        JaxBatchEvaluator,
        _batchevaluate_dispatch,
    )

    results = {}

    # --- batched dispatch on 100x100 panels (Val(1)/Val(2) analogue) ------
    L = 10
    localdims = [2] * L
    rng = np.random.default_rng(0)
    Iset = [tuple(rng.integers(0, 2, 4)) for _ in range(100)]
    Jset = [tuple(rng.integers(0, 2, L - 4 - 1)) for _ in range(100)]
    fpy = lambda x: float(sum(x))
    t0 = time.perf_counter()
    _batchevaluate_dispatch(np.float64, fpy, localdims, Iset, Jset, 1)
    results["dispatch_python_10k_evals_s"] = round(time.perf_counter() - t0, 4)

    fjax = lambda idx: jnp.sum(idx.astype(jnp.float64))
    bf = JaxBatchEvaluator(fjax, localdims)
    bf.batch_evaluate(Iset, Jset, 1)  # warm-up (same padded bucket)
    t0 = time.perf_counter()
    bf.batch_evaluate(Iset, Jset, 1)
    results["dispatch_jax_10k_evals_s"] = round(time.perf_counter() - t0, 4)

    # --- CachedFunction with 1e5 entries at L=30 ---------------------------
    L = 30
    cf = CachedFunction(lambda x: 1.0, [2] * L)
    n = 10**5
    keys = [tuple(map(int, row)) for row in rng.integers(0, 2, size=(n, L))]
    t0 = time.perf_counter()
    for k in keys:
        cf(k)
    fill_t = time.perf_counter() - t0
    results["cache_inserts_per_s"] = round(cf.ncacheddata() / fill_t, 1)

    t0 = time.perf_counter()
    hits = sum(cf.haskey(k) for k in keys[:10000])
    query_t = time.perf_counter() - t0
    assert hits == 10000
    results["cache_queries_per_s"] = round(10000 / query_t, 1)
    results["cache_entries"] = cf.ncacheddata()

    print(
        json.dumps(
            {
                "metric": "runtime_micro_cache_queries_per_s",
                "value": results["cache_queries_per_s"],
                "unit": "queries/s",
                "vs_baseline": None,
                "detail": results,
            }
        )
    )


if __name__ == "__main__":
    import os
    import sys

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from _common import setup_cache

    setup_cache()
    main()
