"""BASELINE config 4: 10-D TT integration via GK quadrature
(test_integration.jl:29-38 as a benchmark)."""

import json
import time

import numpy as np


def main(jax_native: bool = False, scalar: bool = False,
         pivotsearch: str = "full"):
    import tci_tpu as tci

    if jax_native:
        import jax.numpy as jnp

        f = lambda x: 1000 * jnp.cos(10 * jnp.sum(x**2)) * jnp.exp(
            -jnp.sum(x) ** 4 / 1000
        )
    elif scalar:
        # per-point host integrand (--scalar; reference-style Python loop)
        f = lambda x: 1000 * np.cos(10 * np.sum(np.asarray(x) ** 2)) * np.exp(
            -np.sum(np.asarray(x)) ** 4 / 1000
        )
    else:
        # default: vectorized host sampling — each Π panel is one numpy call
        # over the (B, 10) coordinate batch. The d=15 high-rank device path
        # stresses this backend; pass --jax-native to use it anyway.
        f = lambda X: 1000 * np.cos(10 * np.sum(X**2, axis=1)) * np.exp(
            -np.sum(X, axis=1) ** 4 / 1000
        )

    # maxbonddim=64: the converged rank is 28 (err 1.9e-4 identical at cap
    # 64 or 128; the reference test uses no cap at all) — the tighter cap
    # bounds the transient first-sweep rank overshoot so the device path
    # stays on the whole-sweep engine (panel-edge guard at Imax*(d+1)).
    kw = dict(
        GKorder=15, tolerance=1e-8, jax_native=jax_native,
        vectorized=not (jax_native or scalar), maxbonddim=64,
        pivotsearch=pivotsearch,
    )
    # Same methodology as bench.py: one untimed warm-up optimization
    # compiles every device program this workload uses (a one-off
    # per-process cost); the timed run re-does ALL sampling, factorization
    # and global search. cold_wall_s is reported.
    t0 = time.perf_counter()
    I15 = tci.integrate(np.float64, f, [-1.0] * 10, [1.0] * 10, **kw)
    cold_wall = time.perf_counter() - t0

    def _gk_nevals():
        # the jax_native evaluator is reused via integrate()'s weak cache —
        # its counter gives the timed run's sample count
        from tci_tpu.models.integration import _GK_EVAL_CACHE

        slots = _GK_EVAL_CACHE.get(f)
        if not slots:
            return None
        return sum(int(F.nevals) for F in slots.values())

    nevals_before = _gk_nevals() if jax_native else None
    t0 = time.perf_counter()
    I15 = tci.integrate(np.float64, f, [-1.0] * 10, [1.0] * 10, **kw)
    wall = time.perf_counter() - t0
    Iref = -5.4960415218049

    # Proxy baseline (BASELINE.md config-4 row; bench.py config-1
    # methodology): the reference-style per-point host loop over the SAME
    # weighted GK integrand (integrate()'s scalar branch), measured on this
    # host and modeled over the timed run's sample count.
    vs_baseline = None
    proxy = {}
    if jax_native and nevals_before is not None:
        nevals_timed = _gk_nevals() - nevals_before
        from tci_tpu.ops.kronrod import kronrod

        nodes1d, weights1d, _ = kronrod(kw["GKorder"] // 2)
        lo, hi = np.full(10, -1.0), np.full(10, 1.0)
        nodes = (hi[:, None] - lo[:, None]) * (nodes1d[None, :] + 1) / 2 \
            + lo[:, None]
        weights = (hi[:, None] - lo[:, None]) * weights1d[None, :] / 2
        normalization = float(kw["GKorder"]) ** 10
        rng = np.random.default_rng(0)
        proxy_idx = rng.integers(0, len(nodes1d), size=(2000, 10))
        t0 = time.perf_counter()
        for row in proxy_idx:
            x = nodes[np.arange(10), row]
            w = float(np.prod(weights[np.arange(10), row]))
            w * 1000 * np.cos(10 * np.sum(x**2)) * np.exp(
                -np.sum(x) ** 4 / 1000) * normalization
        proxy_rate = len(proxy_idx) / (time.perf_counter() - t0)
        modeled_scalar_wall = nevals_timed / proxy_rate
        vs_baseline = round(modeled_scalar_wall / wall, 2)
        proxy = {
            "nevals_timed_run": int(nevals_timed),
            "baseline_kind": "python-scalar-proxy (modeled wall = "
                             "nevals_timed / measured scalar rate)",
            "baseline_scalar_evals_per_sec": round(proxy_rate, 1),
            "modeled_scalar_wall_s": round(modeled_scalar_wall, 3),
        }
    print(
        json.dumps(
            {
                "metric": "integration_10d_walltime",
                "value": round(wall, 3),
                "unit": "s",
                "vs_baseline": vs_baseline,
                "detail": {
                    "integral": float(I15),
                    "abs_err_vs_reference": abs(I15 - Iref),
                    "cold_wall_s": round(cold_wall, 3),
                    "jax_native": jax_native,
                    "pivotsearch": pivotsearch,
                    **proxy,
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
    main(
        jax_native="--jax-native" in sys.argv,
        scalar="--scalar" in sys.argv,
        # --rook: the whole-sweep rook program — at d=15 the slabs are 16x
        # narrower than the full GK panels, the main lever on the device
        # path for this config
        pivotsearch="rook" if "--rook" in sys.argv else "full",
    )
