"""Multi-device TCI on a device mesh over the default platform's devices (up
to 8; under JAX_PLATFORMS=cpu these are 8 virtual CPU devices).

Parallel axes (SURVEY §2.5):
1. data-parallel sampling — JaxBatchEvaluator(mesh=...) shards the Π-panel
   sample batch over the mesh; the full crossinterpolate2 runs mesh-sharded
   and matches the single-device result exactly;
2. tensor-parallel rrLU — rrlu_sharded row-shards the elimination itself
   (exact collectives, bit-identical pivot order);
3. mesh-sharded L5/L3 device tiers — contract(..., mesh=),
   TensorTrain.compress(..., mesh=) and integrate(..., mesh=) run every
   bond split's elimination tensor-parallel, bit-identical to the
   single-device device tier.

On a multi-GPU host the same code runs over the GPUs, with XLA handing the
collectives to NCCL.
"""

import os

os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "")
    + " --xla_force_host_platform_device_count=8"
)

import _common  # noqa: F401  (repo root on sys.path)

import numpy as np

import tci_tpu as tci
from tci_tpu import JaxBatchEvaluator
from tci_tpu.parallel.mesh import default_mesh

import jax
import jax.numpy as jnp

mesh = default_mesh(min(8, len(jax.devices())))
print(f"mesh: {mesh.devices.shape} over {mesh.devices.flat[0].platform}")

localdims = [6] * 6


def fjax(idx):
    v = idx.astype(jnp.float64) + 1.0
    return 1.0 / (1.0 + jnp.sum(v * v))


# --- 1. mesh-sharded sampling ------------------------------------------------
bf = JaxBatchEvaluator(fjax, localdims, mesh=mesh)
tt, ranks, errors = tci.crossinterpolate2(
    np.float64, bf, localdims, tolerance=1e-9
)
bf1 = JaxBatchEvaluator(fjax, localdims)  # single-device control
tt1, ranks1, errors1 = tci.crossinterpolate2(
    np.float64, bf1, localdims, tolerance=1e-9
)
assert tt.linkdims() == tt1.linkdims()
pt = (1, 2, 3, 0, 2, 1)
assert tt(pt) == tt1(pt)
print(f"mesh-sharded crossinterpolate2: rank {tt.rank()}, "
      f"error {errors[-1]:.2e} — identical to single-device")

# --- 2. tensor-parallel rrLU --------------------------------------------------
from tci_tpu import rrlu, rrlu_sharded

rng = np.random.default_rng(0)
A = rng.standard_normal((512, 12)) @ rng.standard_normal((12, 384))
lu_tp = rrlu_sharded(A, reltol=1e-10, mesh=mesh)
lu_1d = rrlu(A, reltol=1e-10)
assert lu_tp.npivot == lu_1d.npivot == 12
assert np.array_equal(lu_tp.rowpermutation, lu_1d.rowpermutation)
print(f"tensor-parallel rrLU: rank {lu_tp.npivot}, pivot order "
      "bit-identical to the single-device kernel")

# --- 3. mesh-sharded contraction / compression / integration -----------------
from tci_tpu import TensorTrain, contract, integrate
from tci_tpu.models.tensortrain import fulltensor


def _mpo(seed, L, chi, d):
    g = np.random.default_rng(seed)
    bonds = [1] + [chi] * (L - 1) + [1]
    return TensorTrain([g.standard_normal((bonds[i], d, d, bonds[i + 1]))
                        for i in range(L)])


A4, B4 = _mpo(1, 4, 3, 2), _mpo(2, 4, 3, 2)
cm = contract(A4, B4, algorithm="zipup", method="LU", tolerance=1e-10,
              jax_native=True, mesh=mesh)
c1 = contract(A4, B4, algorithm="zipup", method="LU", tolerance=1e-10,
              jax_native=True)
assert all(np.array_equal(a, b)
           for a, b in zip(cm.sitetensors(), c1.sitetensors()))
print(f"mesh zip-up contraction: linkdims {cm.linkdims()} — bitwise "
      "identical to single-device")

ttm = TensorTrain([t.copy() for t in cm.sitetensors()])
ttm.compress("LU", tolerance=1e-10, jax_native=True, mesh=mesh)
exact = fulltensor(contract(A4, B4, algorithm="naive"))
assert np.allclose(fulltensor(ttm), exact, atol=1e-9 * np.abs(exact).max())
print(f"mesh compression: linkdims {ttm.linkdims()}")

val = integrate(np.float64, lambda x: jnp.prod(x), [0.0] * 3, [1.0] * 3,
                jax_native=True, mesh=mesh, tolerance=1e-10,
                rng=np.random.default_rng(5))
assert abs(val - 0.5 ** 3) < 1e-10
print(f"mesh-sharded GK integration: {val:.12f} (exact 0.125)")
print("ok")
