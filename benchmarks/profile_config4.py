"""Component profile of the config-4 (10-D GK integration) device path.

Where does integrate(jax_native=True)'s wall go? This script reproduces
integrate()'s jax_native integrand exactly (models/integration.py: GK
nodes/weights as one-hot contractions) and runs crossinterpolate2 directly
so the per-iteration stats dict (models/tensorci2.py optimize) is visible:
sweep wall, global-search wall, ranks, plus engine capacity growth.

Usage: python profile_config4.py [--rook] [--no-device-sweep]
"""

import json
import sys
import time

import numpy as np

from _common import setup_cache


def main(pivotsearch: str = "full", enable_device_sweep: bool = True):
    setup_cache()
    import jax
    import jax.numpy as jnp

    import tci_tpu as tci
    from tci_tpu.ops.kronrod import kronrod
    from tci_tpu.parallel.batcheval import JaxBatchEvaluator

    N = 10
    a = np.full(N, -1.0)
    b = np.full(N, 1.0)
    GKorder = 15
    nodes1d, weights1d, _ = kronrod(GKorder // 2)
    nodes = (b[:, None] - a[:, None]) * (nodes1d[None, :] + 1) / 2 + a[:, None]
    weights = (b[:, None] - a[:, None]) * weights1d[None, :] / 2
    normalization = float(GKorder) ** N
    localdims = [len(nodes1d)] * N

    nodes_d = jnp.asarray(nodes)
    logw_d = jnp.log(jnp.abs(jnp.asarray(weights)))
    sgnw_d = jnp.sign(jnp.asarray(weights))
    ngrid = nodes_d.shape[1]

    def Fjax(idx):
        oh = jax.nn.one_hot(idx, ngrid, dtype=nodes_d.dtype)
        x = jnp.sum(oh * nodes_d, axis=1)
        w = jnp.exp(jnp.sum(jnp.where(oh > 0, logw_d * oh, 0.0))) * jnp.prod(
            jnp.sum(oh * sgnw_d, axis=1)
        )
        f = 1000 * jnp.cos(10 * jnp.sum(x**2)) * jnp.exp(
            -jnp.sum(x) ** 4 / 1000
        )
        return w * f * normalization

    F = JaxBatchEvaluator(
        Fjax, localdims, dtype=np.float64,
        enable_device_sweep=enable_device_sweep,
        fused_panel_capacity=True,
    )

    def run():
        t0 = time.perf_counter()
        tci2, ranks, errors = tci.crossinterpolate2(
            np.float64, F, localdims, tolerance=1e-8, maxbonddim=64,
            nsearchglobalpivot=10, pivotsearch=pivotsearch,
            rng=np.random.default_rng(5),
        )
        wall = time.perf_counter() - t0
        return tci2, ranks, errors, wall

    tci2, ranks, errors, cold = run()
    tci2, ranks, errors, warm = run()
    integral = float(tci2.sum() / normalization)
    Iref = -5.4960415218049

    stats = getattr(tci2, "stats", {})
    eng = getattr(F, "_device_sweep_engine", None)
    print(
        json.dumps(
            {
                "metric": "config4_device_profile",
                "value": round(warm, 3),
                "unit": "s (warm wall)",
                "vs_baseline": None,
                "detail": {
                    "pivotsearch": pivotsearch,
                    "enable_device_sweep": enable_device_sweep,
                    "cold_wall_s": round(cold, 3),
                    "integral": integral,
                    "abs_err_vs_reference": abs(integral - Iref),
                    "ranks": ranks,
                    "niter": len(ranks),
                    "sweep_walltime": [
                        round(x, 3) for x in stats.get("sweep_walltime", [])
                    ],
                    "globalsearch_walltime": [
                        round(x, 3)
                        for x in stats.get("globalsearch_walltime", [])
                    ],
                    "iteration_walltime": [
                        round(x, 3)
                        for x in stats.get("iteration_walltime", [])
                    ],
                    "engine_imax": getattr(eng, "Imax", None),
                    "engine_nevals": getattr(eng, "nevals", None),
                    "evaluator_nevals": F.nevals,
                },
            }
        )
    )


if __name__ == "__main__":
    import os

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    main(
        pivotsearch="rook" if "--rook" in sys.argv else "full",
        enable_device_sweep="--no-device-sweep" not in sys.argv,
    )
