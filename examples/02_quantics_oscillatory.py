"""Quantics TCI: an oscillatory 1-D function on a 2^30-point grid.

The quantics representation encodes x ∈ [0, 3) with R=30 binary legs, so
the tensor train resolves the function on a grid of ~10^9 points while the
TCI rank stays tiny (pattern of reference test_tensorci2.jl:346-364 at
production R; BASELINE config 3 runs R=40).
"""

import _common  # noqa: F401  (repo root on sys.path)

import numpy as np

import tci_tpu as tci
from tci_tpu.utils.quantics import DiscretizedGrid

R = 30
grid = DiscretizedGrid(R, 0.0, 3.0)


def fx(x):
    return np.exp(-x) * np.cos(10.0 * x)


def f(bits):
    (x,) = grid.quantics_to_origcoord(bits)
    return fx(x)


tt, ranks, errors = tci.crossinterpolate2(
    np.float64, f, grid.localdims, tolerance=1e-10
)
print(f"R={R} quantics: rank {tt.rank()}, final error {errors[-1]:.2e}, "
      f"link dims {tt.linkdims()[:6]}...")

# spot-check against the function on a few grid points
for m in (0, 12345678, 2**29 + 7):
    bits = grid.grididx_to_quantics([m])
    (x,) = grid.quantics_to_origcoord(bits)
    assert abs(tt(tuple(bits)) - fx(x)) < 1e-8
print("pointwise spot checks ok")

# the factorized sum approximates the integral: sum * dx
dx = 3.0 / 2**R
integral = tt.sum() * dx
exact = (np.exp(-3.0) * (10.0 * np.sin(30.0) - np.cos(30.0)) + 1.0) / 101.0
print(f"integral via factorized sum: {integral:.10f}   exact: {exact:.10f}")
assert abs(integral - exact) < 1e-6
print("ok")
