"""10-D integration: Gauss-Kronrod grids × TCI2 × factorized sum.

The reference's flagship application (integration.jl; test_integration.jl
:29-38): ∫ over [-1,1]^10 of an oscillatory integrand whose value is known.
Two paths: host-sampled, and jax_native=True where the weighted integrand
samples on the accelerator through whole-sweep device programs.
"""

import _common  # noqa: F401  (repo root on sys.path)

import time

import numpy as np

import tci_tpu as tci

N = 10
REFVALUE = -5.4960415218049  # reference test_integration.jl:35


def f(X):
    # vectorized=True: f receives a (B, N) coordinate batch and returns (B,)
    # values — each Π panel is ONE numpy call instead of B Python calls
    return 1000 * np.cos(10 * np.sum(X**2, axis=1)) * np.exp(
        -np.sum(X, axis=1) ** 4 / 1000
    )


t0 = time.time()
val = tci.integrate(
    np.float64, f, [-1.0] * N, [1.0] * N,
    GKorder=15, tolerance=1e-8, maxbonddim=64, vectorized=True,
)
t_host = time.time() - t0
print(f"host path:   {val:.10f}  ({t_host:.1f} s)")
assert abs(val - REFVALUE) < 1e-3

# device path: the integrand must be jax-traceable on a coordinate vector
import jax.numpy as jnp


def fjax(x):
    return 1000 * jnp.cos(10 * jnp.sum(x**2)) * jnp.exp(
        -jnp.sum(x) ** 4 / 1000
    )


t0 = time.time()
val_dev = tci.integrate(
    np.float64, fjax, [-1.0] * N, [1.0] * N,
    GKorder=15, tolerance=1e-8, maxbonddim=64, jax_native=True,
)
t_dev = time.time() - t0
print(f"device path: {val_dev:.10f}  ({t_dev:.1f} s)")
assert abs(val_dev - REFVALUE) < 1e-3
print("ok")
