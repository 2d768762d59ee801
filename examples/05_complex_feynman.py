"""Complex-valued TCI end-to-end (BASELINE config 5 pattern).

A Feynman-type complex integrand exp(i·Σv)/(1+|v|²) learned by TCI2. The
device path here carries the value as an explicit (re, im) f64 pair — the
integrand is written pair-valued and passed with pair_output=True; the host
recombines to complex128. On backends that execute complex128 (CPU, GPU) a
complex-valued integrand with dtype=np.complex128 works as well.
"""

import _common  # noqa: F401  (repo root on sys.path)

import numpy as np

import tci_tpu as tci
from tci_tpu import JaxBatchEvaluator

localdims = [6] * 6


def fpy(x):
    v = np.asarray(x, dtype=float) + 1.0
    return np.exp(1j * v.sum()) / (1.0 + v @ v)


# --- host complex path -------------------------------------------------------
tt, ranks, errors = tci.crossinterpolate2(
    np.complex128, fpy, localdims, tolerance=1e-7
)
print(f"host path:   rank {tt.rank()}, final error {errors[-1]:.2e}")

# --- pair-kernel device path -------------------------------------------------
import jax.numpy as jnp


def fpair(idx):  # returns stack([Re f, Im f]) in pure real arithmetic
    v = idx.astype(jnp.float64) + 1.0
    s = jnp.sum(v)
    den = 1.0 + jnp.sum(v * v)
    return jnp.stack([jnp.cos(s) / den, jnp.sin(s) / den])


bf = JaxBatchEvaluator(fpair, localdims, dtype=np.complex128,
                       pair_output=True)
tt2, ranks2, errors2 = tci.crossinterpolate2(
    np.complex128, bf, localdims, tolerance=1e-7
)
print(f"device path: rank {tt2.rank()}, final error {errors2[-1]:.2e}, "
      f"{bf.nevals:,} samples")

for pt in [(0, 0, 0, 0, 0, 0), (1, 2, 3, 4, 5, 0), (5, 4, 3, 2, 1, 0)]:
    assert abs(tt(pt) - fpy(pt)) < 1e-6
    assert abs(tt2(pt) - fpy(pt)) < 1e-6
print("pointwise complex checks ok")
