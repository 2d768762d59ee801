"""BASELINE config 2: rank-revealing LU of a 4096x4096 numerically low-rank
float64 matrix (reference: benchmark/rrlu.jl scaled up), on JAX's default
device.

Three factorizations of the same device-resident matrix are timed (median of
`reps` warm runs, each ending in ``block_until_ready``):

- exact complete pivoting (ops/lu_kernel._rrlu_while): every pivot step
  reads+writes the full trailing matrix, so it is bound by memory bandwidth;
- adaptive rook (ops/lu_device.rrlu_rook_device_fused, the reference's arrlu
  matrixlu.jl:492-569 as one device program), precision "f64";
- the same rook with precision "mixed" (f32 pivot hunt, f64 completion).

Each is validated by the relative reconstruction error max|L·U - A| / max|A|
computed on device in float64. vs_baseline is scipy's dense partial-pivot LU
of the same matrix on the host CPU.
"""

import json
import time

import numpy as np


def _recon_relerr(A, L, U):
    import jax
    import jax.numpy as jnp

    return float(jax.jit(lambda L, U, A: jnp.max(jnp.abs(L @ U - A))
                         / jnp.max(jnp.abs(A)))(L, U, A))


def _median_wall(fn, reps):
    import jax

    jax.block_until_ready(fn())  # compile
    walls = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn())
        walls.append(time.perf_counter() - t0)
    return out, float(np.median(walls))


def main(N: int = 4096, rank: int = 256, tol: float = 1e-10, reps: int = 3):
    import jax
    import jax.numpy as jnp
    import scipy.linalg

    from tci_tpu.ops.lu import _finalize
    from tci_tpu.ops.lu_device import rrlu_rook_device_fused
    from tci_tpu.ops.lu_kernel import _rrlu_while

    @jax.jit
    def makeA(key):
        k1, k2 = jax.random.split(key)
        U = jax.random.normal(k1, (N, rank), dtype=jnp.float64)
        V = jax.random.normal(k2, (rank, N), dtype=jnp.float64)
        s = jnp.exp(-jnp.arange(rank, dtype=jnp.float64) / 16.0)
        return (U * s) @ V

    A = jax.block_until_ready(makeA(jax.random.PRNGKey(0)))
    rows = {}

    args = (A, jnp.int32(N), jnp.int32(N), jnp.int32(rank),
            jnp.float64(tol), jnp.float64(0.0))
    out, wall = _median_wall(
        lambda: _rrlu_while(*args, leftorthogonal=True), reps)
    k = int(out[3])
    lu = _finalize(np.asarray(out[0]), np.asarray(out[1]),
                   np.asarray(out[2]), k, float(out[5]), True)
    rows["complete_pivot"] = dict(
        wall_s=wall, npivots=k,
        relerr=_recon_relerr(A, jnp.asarray(lu.left()),
                             jnp.asarray(lu.right())))

    for precision in ("f64", "mixed"):
        def rook():
            dev = rrlu_rook_device_fused(
                A, maxrank=rank, reltol=tol, rng=np.random.default_rng(7),
                precision=precision,
                hunt_stages=2 if precision == "mixed" else 1)
            return dev.left(), dev.right()

        (L, U), wall = _median_wall(rook, reps)
        rows[f"rook_{precision}"] = dict(
            wall_s=wall, npivots=int(L.shape[1]) if L.ndim == 2 else None,
            relerr=_recon_relerr(A, L, U))

    A_host = np.asarray(A)
    t0 = time.perf_counter()
    scipy.linalg.lu(A_host)
    base_wall = time.perf_counter() - t0

    dev = jax.devices()[0]
    best = min(r["wall_s"] for r in rows.values())
    print(json.dumps({
        "metric": "rrlu_4096_rank256_walltime",
        "value": best,
        "unit": "s",
        "vs_baseline": base_wall / best,
        "detail": dict(device=dict(platform=dev.platform,
                                   kind=dev.device_kind,
                                   count=len(jax.devices())),
                       N=N, rank=rank, reltol=tol, reps=reps, rows=rows,
                       baseline="scipy.linalg.lu on the host CPU",
                       baseline_wall_s=base_wall),
    }))


if __name__ == "__main__":
    import os
    import sys

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from _common import setup_cache

    setup_cache()
    main()
