"""Jit-compiled batched tensor-train evaluation.

The host-side TensorTrain stores ragged cores; for device throughput we pad
all cores to a uniform (chi, d, chi) shape and evaluate a whole batch of
multi-indices as a lax.scan over sites of batched (B, chi) x (chi, chi)
matmuls — each scan step is one batched GEMM after gathering the per-sample
core slices.

Products run at ``lax.Precision.HIGHEST``: a float32 product on a GPU may
otherwise run in TF32 (~1e-3 relative), which 20 chained sites would
compound; float64 products are unaffected.

This replaces pointwise `evaluate` (abstracttensortrain.jl:328-342) for bulk
workloads (global search, benchmarks, serving).
"""

from __future__ import annotations

from typing import List, Tuple

import jax
import jax.numpy as jnp
import numpy as np


def pad_cores(sitetensors: List[np.ndarray], dtype=None) -> np.ndarray:
    """Stack ragged (χl, d, χr) cores into one (L, χ, d, χ) array, zero-padded
    to the max bond/site dimension. Boundary bonds embed at index 0."""
    if dtype is None:
        dtype = sitetensors[0].dtype
    L = len(sitetensors)
    chi = max(max(t.shape[0], t.shape[-1]) for t in sitetensors)
    d = max(t.shape[1] for t in sitetensors)
    out = np.zeros((L, chi, d, chi), dtype=dtype)
    for l, t in enumerate(sitetensors):
        out[l, : t.shape[0], : t.shape[1], : t.shape[2]] = t
    return out


def tt_evaluate_batched(cores: jnp.ndarray, indices: jnp.ndarray) -> jnp.ndarray:
    """Evaluate a padded TT at a batch of multi-indices.

    Args:
      cores: (L, chi, d, chi) padded site tensors (boundaries embedded at 0).
      indices: (B, L) int32.
    Returns:
      (B,) values.
    """
    L, chi, d, _ = cores.shape
    B = indices.shape[0]
    v0 = jnp.zeros((B, chi), dtype=cores.dtype).at[:, 0].set(1.0)

    def body(v, inp):
        core, idx = inp  # core: (chi, d, chi), idx: (B,)
        mats = jnp.take(core, idx, axis=1)  # (chi, B, chi)
        v = jnp.einsum(
            "bi,ibj->bj", v, mats, preferred_element_type=cores.dtype,
            precision=jax.lax.Precision.HIGHEST,
        )
        return v, None

    v, _ = jax.lax.scan(body, v0, (cores, indices.T))
    return v[:, 0]


tt_evaluate_batched_jit = jax.jit(tt_evaluate_batched)


def tt_evaluate_sharded(
    cores: jnp.ndarray,
    indices: jnp.ndarray,
    mesh,
    axis: str = "batch",
) -> jnp.ndarray:
    """Serving-scale TT evaluation sharded over a device mesh.

    Data-parallel over the sample batch: `cores` are replicated on every
    device, the (B, L) index batch is sharded along the mesh axis, and the
    per-site batched GEMMs of `tt_evaluate_batched` then run fully
    device-local — XLA inserts no collectives on the hot loop (the only
    cross-device traffic is the initial index scatter and final gather).
    B is padded up to a multiple of the mesh size; padded rows are sliced
    off the result.
    """
    from jax.sharding import NamedSharding, PartitionSpec

    n = int(mesh.devices.size)
    B = int(indices.shape[0])
    Bp = ((B + n - 1) // n) * n
    idx = jnp.pad(indices, ((0, Bp - B), (0, 0)))
    idx = jax.device_put(idx, NamedSharding(mesh, PartitionSpec(axis, None)))
    cores = jax.device_put(cores, NamedSharding(mesh, PartitionSpec()))
    vals = tt_evaluate_batched_jit(cores, idx)
    return vals[:B]


def tt_sum_jax(cores: jnp.ndarray, linkdims: Tuple[int, ...] = None) -> jnp.ndarray:
    """Factorized sum over the full grid for padded cores (matches
    AbstractTensorTrain.sum; padding contributes zero)."""
    L, chi, d, _ = cores.shape
    v = jnp.zeros((chi,), dtype=cores.dtype).at[0].set(1.0)

    def body(v, core):
        m = jnp.sum(core, axis=1)  # (chi, chi)
        return jnp.matmul(v, m, precision=jax.lax.Precision.HIGHEST), None

    v, _ = jax.lax.scan(body, v, cores)
    return v[0]
