"""rrLU wall time vs N (analogue of the reference's benchmark/rrlu.jl:8-37,
which times TCI.rrlu against dense LU for N in {100, 500, 1000, 2000} with
BLAS pinned to one thread). Prints one JSON line with the full sweep."""

import json
import time

import numpy as np


def main():
    import jax
    import jax.numpy as jnp
    import scipy.linalg

    from tci_tpu.ops.lu_kernel import _rrlu_while

    results = {}
    key = jax.random.PRNGKey(0)
    for N in [100, 500, 1000, 2000]:
        rank = max(16, N // 16)
        k1, k2 = jax.random.split(jax.random.fold_in(key, N))
        U = jax.random.normal(k1, (N, rank), dtype=jnp.float64)
        V = jax.random.normal(k2, (rank, N), dtype=jnp.float64)
        s = jnp.exp(-jnp.arange(rank, dtype=jnp.float64) / 8.0)
        A = jax.block_until_ready((U * s) @ V)
        args = (
            A, jnp.int32(N), jnp.int32(N), jnp.int32(rank),
            jnp.float64(1e-10), jnp.float64(0.0),
        )
        jax.block_until_ready(_rrlu_while(*args, leftorthogonal=True))
        t0 = time.perf_counter()
        out = jax.block_until_ready(_rrlu_while(*args, leftorthogonal=True))
        wall = time.perf_counter() - t0
        r = int(out[3])

        Ah = np.asarray(A)
        t0 = time.perf_counter()
        scipy.linalg.lu(Ah)
        cpu = time.perf_counter() - t0
        results[str(N)] = {
            "rrlu_device_s": round(wall, 4),
            "scipy_dense_lu_s": round(cpu, 4),
            "npivots": r,
        }

    speedup_2000 = (results["2000"]["scipy_dense_lu_s"]
                    / results["2000"]["rrlu_device_s"])
    print(
        json.dumps(
            {
                "metric": "rrlu_scaling_speedup_n2000",
                "value": round(speedup_2000, 3),
                "unit": "x vs scipy dense LU",
                "vs_baseline": round(speedup_2000, 3),
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
