"""Quickstart: TCI of the 8-D Lorentzian (reference README.md:21-43).

f(v) = 1 / (1 + v·v) on the grid {0..9}^8 — 10^8 points, learned from a
few hundred thousand adaptively chosen samples. Two ways to supply f:

1. a plain Python callable (sampled point-by-point on the host),
2. a jax-traceable callable wrapped in JaxBatchEvaluator — the device
   path where whole sweeps compile into single device programs.
"""

import _common  # noqa: F401  (repo root on sys.path)

import numpy as np

import tci_tpu as tci

localdims = [10] * 8


# --- 1. host-callable f ----------------------------------------------------
def f(v):
    v = np.asarray(v, dtype=float)
    return 1.0 / (1.0 + v @ v)


tt, ranks, errors = tci.crossinterpolate2(
    np.float64, f, localdims, tolerance=1e-8
)
print(f"host path:   rank {tt.rank()}, final error {errors[-1]:.2e}")

pt = (0, 1, 2, 3, 4, 3, 2, 1)
assert abs(tt(pt) - f(pt)) < 1e-8
print(f"  tt{pt} = {tt(pt):.12f}   f{pt} = {f(pt):.12f}")

# factorized sum over all 10^8 grid points — O(L d r^2), no enumeration
print(f"  sum over the full grid: {tt.sum():.10f}")


# --- 2. device path: jax-traceable integrand -------------------------------
import jax.numpy as jnp

from tci_tpu import JaxBatchEvaluator


def fjax(idx):  # idx: int32[8]
    v = idx.astype(jnp.float64)
    return 1.0 / (1.0 + jnp.sum(v * v))


bf = JaxBatchEvaluator(fjax, localdims)
tt2, ranks2, errors2 = tci.crossinterpolate2(
    np.float64, bf, localdims, tolerance=1e-8
)
print(f"device path: rank {tt2.rank()}, final error {errors2[-1]:.2e}, "
      f"{bf.nevals:,} samples")
assert abs(tt2(pt) - f(pt)) < 1e-8
assert abs(tt2.sum() - tt.sum()) < 1e-6 * abs(tt.sum())
print("ok")
