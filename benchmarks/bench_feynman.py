"""BASELINE config 5: complex-valued Feynman-diagram-type integrand with
batched evaluation + global pivot search.

The integrand follows the structure of the computations in PRX 12, 041018
(cited in the reference README): an oscillatory complex product over time
arguments with pairwise interaction kernels — evaluated on a GK grid per
dimension, cross-interpolated with TCI2 including global pivot search, then
summed to an integral. Implemented jax-native so sampling runs batched on the
accelerator.
"""

import json
import time

import numpy as np


def main(N: int = 6, GKorder: int = 15, tol: float = 1e-7):
    import jax.numpy as jnp

    import tci_tpu as tci
    from tci_tpu.ops.kronrod import kronrod
    from tci_tpu.parallel.batcheval import JaxBatchEvaluator

    nodes1d, weights1d, _ = kronrod(GKorder // 2)
    a, b = 0.0, 1.0
    nodes = jnp.asarray((b - a) * (nodes1d + 1) / 2 + a)
    weights = jnp.asarray((b - a) * weights1d / 2)
    normalization = float(GKorder) ** N

    # pair-valued integrand: the oscillatory phase is written as (cos, sin)
    # in pure f64 real arithmetic and the complex-pair device kernels
    # (ops/complex_pair.py) do the rest.
    def fpair(idx):
        t = nodes[idx]
        w = jnp.prod(weights[idx])
        s = 10.0 * jnp.sum(t)
        damp = jnp.exp(-jnp.sum((t[:, None] - t[None, :]) ** 2))
        amp = w * damp * normalization
        return jnp.stack([amp * jnp.cos(s), amp * jnp.sin(s)])

    localdims = [len(nodes1d)] * N
    bf = JaxBatchEvaluator(fpair, localdims, dtype=np.complex128,
                           pair_output=True)

    # bench.py methodology: untimed warm-up optimization, then a timed run
    # that re-does all sampling, factorization and global search on chip.
    t0 = time.perf_counter()
    tci.crossinterpolate2(
        np.complex128, bf, localdims, tolerance=tol, nsearchglobalpivot=10
    )
    cold_wall = time.perf_counter() - t0
    nevals_before = int(bf.nevals)
    t0 = time.perf_counter()
    t, ranks, errors = tci.crossinterpolate2(
        np.complex128, bf, localdims, tolerance=tol, nsearchglobalpivot=10
    )
    integral = t.sum() / normalization
    wall = time.perf_counter() - t0
    nevals_timed = int(bf.nevals) - nevals_before

    # Proxy baseline (BASELINE.md config-5 row; bench.py config-1
    # methodology): the reference-style per-point host sampling loop of the
    # same complex integrand, measured on this host and modeled over the
    # timed run's sample count.
    nodes_np = np.asarray(nodes)
    weights_np = np.asarray(weights)
    rng = np.random.default_rng(0)
    proxy_idx = rng.integers(0, len(nodes1d), size=(3000, N))
    t0 = time.perf_counter()
    for row in proxy_idx:
        tt = nodes_np[row]
        w = float(np.prod(weights_np[row]))
        s = 10.0 * float(np.sum(tt))
        damp = float(np.exp(-np.sum((tt[:, None] - tt[None, :]) ** 2)))
        w * damp * normalization * complex(np.cos(s), np.sin(s))
    proxy_rate = len(proxy_idx) / (time.perf_counter() - t0)
    modeled_scalar_wall = nevals_timed / proxy_rate
    vs_baseline = round(modeled_scalar_wall / wall, 2)

    print(
        json.dumps(
            {
                "metric": "feynman_6d_walltime",
                "value": round(wall, 3),
                "unit": "s",
                "vs_baseline": vs_baseline,
                "detail": {
                    "rank": int(t.rank()),
                    "integral_re": float(np.real(integral)),
                    "integral_im": float(np.imag(integral)),
                    "final_error": float(errors[-1]),
                    "nevals": int(bf.nevals),
                    "nevals_timed_run": nevals_timed,
                    "cold_wall_s": round(cold_wall, 3),
                    "baseline_kind": "python-scalar-proxy (modeled wall = "
                                     "nevals_timed / measured scalar rate)",
                    "baseline_scalar_evals_per_sec": round(proxy_rate, 1),
                    "modeled_scalar_wall_s": round(modeled_scalar_wall, 3),
                },
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
