"""High-dimensional integration: Gauss-Kronrod grids x TCI2 x factorized sum.

Parity reference: src/integration.jl. The GK nodes/weights come from
ops/kronrod.py (Laurie's algorithm) instead of QuadGK.
"""

from __future__ import annotations

from typing import Callable, Sequence

import numpy as np

from ..ops.kronrod import kronrod
from .tensorci2 import crossinterpolate2

# jax_native evaluator reuse across integrate() calls: every NEW jit closure
# re-traces and re-loads its compiled programs, so a "warm" second
# integrate() call that rebuilt its evaluator would re-pay them. Keyed weakly
# by the user integrand, then by the grid/type signature: alternating two
# grids or GK orders on the same f keeps both evaluators live (one slot per
# signature, not per integrand).
import weakref

_GK_EVAL_CACHE: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def integrate(
    valuetype,
    f: Callable[[Sequence[float]], complex],
    a: Sequence[float],
    b: Sequence[float],
    GKorder: int = 15,
    jax_native: bool = False,
    vectorized: bool = False,
    enable_device_sweep: bool = True,
    mesh=None,
    **kwargs,
):
    """∫_a^b f(x) d^N x via TCI2 over a tensor-product GK grid
    (integration.jl:68-161).

    GKorder must be odd (2n+1 Kronrod points with n = GKorder // 2 Gauss
    points). Additional kwargs go to crossinterpolate2 (e.g. tolerance).

    With jax_native=True, `f` must be jax-traceable on a coordinate vector;
    the weighted integrand then samples on the accelerator through the
    batched evaluation runtime and device-resident sweeps. A
    `jax.sharding.Mesh` passed as `mesh=` shards the Π panel sampling over
    its devices (data-parallel over the pivot-product index set).

    With vectorized=True (host sampling), `f` must accept a (B, N) coordinate
    matrix and return (B,) values; each Π panel is then one numpy call
    instead of B Python-level point evaluations.
    """
    if GKorder % 2 == 0:
        raise ValueError("Gauss--Kronrod order must be odd, e.g. 15 or 61.")
    a = np.asarray(a, dtype=float)
    b = np.asarray(b, dtype=float)
    if len(a) != len(b):
        raise ValueError(
            f"Integral bounds must have the same dimensionality, got "
            f"{len(a)} lower and {len(b)} upper bounds."
        )

    if mesh is not None and not jax_native:
        raise ValueError(
            "mesh= shards the accelerator sampling path; it requires "
            "jax_native=True (host-sampled tiers ignore the mesh)."
        )

    nodes1d, weights1d, _ = kronrod(GKorder // 2)
    # affine map [-1, 1] -> [a_n, b_n] per dimension
    nodes = (b[:, None] - a[:, None]) * (nodes1d[None, :] + 1) / 2 + a[:, None]
    weights = (b[:, None] - a[:, None]) * weights1d[None, :] / 2
    normalization = float(GKorder) ** len(a)
    localdims = [len(nodes1d)] * len(a)
    kwargs.setdefault("nsearchglobalpivot", 10)

    if jax_native:
        import jax.numpy as jnp

        from ..parallel.batcheval import JaxBatchEvaluator

        import jax

        cache_key = (
            GKorder, tuple(a.tolist()), tuple(b.tolist()),
            np.dtype(valuetype).str, enable_device_sweep,
            # stable device identity (platform, id) — Python id() values can
            # be recycled after a mesh is garbage-collected, which would let
            # a stale evaluator (sharded for a dead mesh) leak into a new one
            None if mesh is None else (
                tuple(mesh.shape.items()),
                tuple((d.platform, d.id) for d in mesh.devices.flat),
            ),
        )
        try:
            slots = _GK_EVAL_CACHE.get(f)
        except TypeError:  # unhashable/weakref-incompatible integrand
            slots = None
        if slots is not None and cache_key in slots:
            F = slots[cache_key]
            tci2, ranks, errors = crossinterpolate2(
                valuetype, F, localdims, **kwargs
            )
            return tci2.sum() / normalization

        nodes_d = jnp.asarray(nodes)
        logw_d = jnp.log(jnp.abs(jnp.asarray(weights)))
        sgnw_d = jnp.sign(jnp.asarray(weights))
        ngrid = nodes_d.shape[1]

        def Fjax(idx):
            # Node/weight lookups as one-hot contractions, not gathers: the
            # (N, d) one-hot contraction is elementwise work that fuses into
            # the sampling program.
            oh = jax.nn.one_hot(idx, ngrid, dtype=nodes_d.dtype)  # (N, d)
            x = jnp.sum(oh * nodes_d, axis=1)
            # Product of weights via log-sum for numerical range. Mask the
            # log table before multiplying: a zero weight (degenerate bounds
            # a_n == b_n) has logw = -inf and 0 * -inf = NaN; the sign factor
            # below already carries the exact zero.
            w = jnp.exp(jnp.sum(jnp.where(oh > 0, logw_d * oh, 0.0))) * jnp.prod(
                jnp.sum(oh * sgnw_d, axis=1)
            )
            return w * f(x) * normalization

        F = JaxBatchEvaluator(
            Fjax, localdims, dtype=valuetype, mesh=mesh,
            enable_device_sweep=enable_device_sweep,
            # GK grids have large localdims (GKorder nodes per leg) and high
            # rank: monotone panel capacities keep the fused tier at
            # O(log maxrank) compiled programs instead of a compile storm
            fused_panel_capacity=True,
        )
        try:
            _GK_EVAL_CACHE.setdefault(f, {})[cache_key] = F
        except TypeError:
            pass
    elif vectorized:
        from ..parallel.batcheval import VectorizedBatchEvaluator

        dims = np.arange(len(a))

        def Fvec(idx):
            X = nodes[dims[None, :], idx]  # (B, N) coordinates
            W = np.prod(weights[dims[None, :], idx], axis=1)
            y = np.asarray(f(X))
            if y.shape != (X.shape[0],):
                raise ValueError(
                    f"vectorized integrand must map a (B, N) coordinate "
                    f"matrix to shape (B,) = ({X.shape[0]},); got {y.shape}. "
                    f"Pass vectorized=False for a per-point integrand."
                )
            return W * y * normalization

        F = VectorizedBatchEvaluator(Fvec, localdims, dtype=valuetype)
    else:
        def F(indices):
            x = [nodes[n, i] for n, i in enumerate(indices)]
            w = float(np.prod([weights[n, i] for n, i in enumerate(indices)]))
            return w * f(x) * normalization

    tci2, ranks, errors = crossinterpolate2(valuetype, F, localdims, **kwargs)
    return tci2.sum() / normalization
