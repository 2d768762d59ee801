"""Whole-sweep rook vs full-search timing on BASELINE config 1.

The rook slab alternation is traced INTO the whole-sweep program
(models/device_sweep._make_sweep_rook_scan), so a rook sweep is one dispatch
like the full tier. This benchmark records both warm walls and their ratio.

Methodology as in bench.py: the same evaluator object for the cold and the
timed run; crossinterpolate2 returns host arrays, so each wall ends in a
host fetch.
"""

import json
import time

import numpy as np

from _common import setup_cache


def main():
    setup_cache()
    import jax
    import jax.numpy as jnp

    import tci_tpu as tci
    from tci_tpu.parallel.batcheval import JaxBatchEvaluator

    localdims = [10] * 8

    def fjax(idx):
        v = idx.astype(jnp.float64) + 1.0
        return 1.0 / (1.0 + jnp.sum(v * v))

    def fpy(x):
        v = np.asarray(x, dtype=float) + 1.0
        return 1.0 / (1.0 + v @ v)

    out = {}
    for search in ("full", "rook"):
        bf = JaxBatchEvaluator(fjax, localdims, dtype=np.float64)
        bf.evaluate_many(np.zeros((1024, 8), dtype=np.int32))
        t0 = time.perf_counter()
        tci.crossinterpolate2(
            np.float64, bf, localdims, tolerance=1e-8, pivotsearch=search,
            rng=np.random.default_rng(3),
        )
        cold = time.perf_counter() - t0
        nev0 = bf.nevals
        t0 = time.perf_counter()
        t, ranks, errors = tci.crossinterpolate2(
            np.float64, bf, localdims, tolerance=1e-8, pivotsearch=search,
            rng=np.random.default_rng(3),
        )
        wall = time.perf_counter() - t0
        assert errors[-1] < 1e-8, (search, errors)
        chk = abs(t((1, 2, 3, 4, 5, 4, 3, 2)) - fpy((1, 2, 3, 4, 5, 4, 3, 2)))
        assert chk < 1e-7, (search, chk)
        out[search] = {
            "wall_s": round(wall, 3),
            "cold_wall_s": round(cold, 3),
            "rank": int(t.rank()),
            "nevals": int(bf.nevals - nev0),
            "final_error": float(errors[-1]),
        }

    print(
        json.dumps(
            {
                "metric": "tci2_8d_rook_vs_full_wall_ratio",
                "value": round(out["rook"]["wall_s"] / out["full"]["wall_s"], 3),
                "unit": "x (rook/full warm wall)",
                "vs_baseline": None,
                "detail": out,
            }
        )
    )


if __name__ == "__main__":
    main()
