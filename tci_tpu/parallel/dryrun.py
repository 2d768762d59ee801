"""Checks of the public mesh paths against their single-device runs.

``mesh_checks(mesh, size)`` runs each multi-device entry point a user calls —
``JaxBatchEvaluator(mesh=)`` sampling inside a full ``crossinterpolate2``,
``rrlu_sharded``, ``contract(mesh=)``, ``TensorTrain.compress(mesh=)`` and
``integrate(mesh=)`` — beside the single-device run it must reproduce, and
returns one result dict per check. The same code serves two callers:

- ``run(n)``, the dry run: the CPU platform with ``n`` virtual host devices at
  ``size="small"`` (``__graft_entry__.dryrun_multichip`` starts it in a fresh
  subprocess with ``--xla_force_host_platform_device_count=n``);
- ``chip_smoke.py --mesh4``: a 1-D mesh over four GPUs at ``size="full"``.
"""

from __future__ import annotations

import time

import numpy as np

SIZES = {
    # grid: config-1 Lorentzian grid; panel: (rows, cols, rank) of the
    # rrlu_sharded panel; mpo: (L, bond, numerical rank) of the contraction
    # operands; integ_ndim: dimension of the GK integration (10 = config 4)
    "small": dict(grid=[4] * 6, panel=(96, 64, 9), mpo=(4, 4, 2),
                  integ_ndim=3),
    "full": dict(grid=[10] * 8, panel=(4096, 4096, 64), mpo=(10, 32, 4),
                 integ_ndim=10),
}

# config-4 integrand (reference test/test_integration.jl:29-38)
CONFIG4_REFERENCE = -5.4960415218049


def config4_integrand(x):
    import jax.numpy as jnp

    return 1000 * jnp.cos(10 * jnp.sum(x ** 2)) * jnp.exp(
        -jnp.sum(x) ** 4 / 1000)


def lowrank_mpo(seed: int, L: int, chi: int, r: int, d: int = 2):
    """Random MPO with bond dimension ``chi`` whose every bond has numerical
    rank ``r``: each core is a random (chi, d, d, r) @ (r, chi) product."""
    from ..models.tensortrain import TensorTrain

    g = np.random.default_rng(seed)
    bonds = [1] + [chi] * (L - 1) + [1]
    cores = []
    for n in range(L):
        u = g.standard_normal((bonds[n], d, d, r))
        v = g.standard_normal((r, bonds[n + 1]))
        cores.append((u @ v) / np.sqrt(r * bonds[n]))
    return TensorTrain(cores)


def mpo_values(tt, pts):
    """Values of a tensor train (3- or 4-leg cores, legs fused in C order)
    at a (B, L) batch of fused indices."""
    from ..models.tensortrain import TensorTrain

    return TensorTrain([T.reshape(T.shape[0], -1, T.shape[-1])
                        for T in tt.sitetensors()]).evaluate_batch(pts)


def mpo_product_values(A, B, pts):
    """Exact values of the MPO product A·B (d = 2 legs, fused in C order)
    at a (P, L) batch of fused indices, carrying the (P, bond_A, bond_B)
    environment without forming the product."""
    env = np.ones((len(pts), 1, 1))
    for n, (a, b) in enumerate(zip(A.sitetensors(), B.sitetensors())):
        an = np.transpose(a[:, pts[:, n] // 2, :, :], (1, 0, 2, 3))
        bn = np.transpose(b[:, :, pts[:, n] % 2, :], (2, 0, 1, 3))
        env = np.einsum("pab,pajc,pbjd->pcd", env, an, bn,
                        optimize="greedy")
    return env[:, 0, 0]


def _mem(devices):
    out = []
    for d in devices:
        st = d.memory_stats()
        out.append(None if st is None else (st.get("bytes_in_use", 0),
                                            st.get("peak_bytes_in_use", 0)))
    return out


def _per_device_growth(devices, before):
    """Peak bytes each device gained over its in-use bytes before a call
    (None where the backend keeps no memory statistics, e.g. the CPU)."""
    after = _mem(devices)
    return [None if b is None or a is None else int(a[1] - b[0])
            for b, a in zip(before, after)]


def _timed(fn):
    t0 = time.perf_counter()
    out = fn()
    return out, time.perf_counter() - t0


def check_sampling(mesh, size):
    """Mesh-sharded Π sampling inside a full crossinterpolate2 of the
    config-1 Lorentzian vs the single-device run and vs the integrand."""
    import jax
    import jax.numpy as jnp

    import tci_tpu as tci
    from .batcheval import JaxBatchEvaluator

    grid = SIZES[size]["grid"]

    def fjax(idx):
        v = idx.astype(jnp.float64) + 1.0
        return 1.0 / (1.0 + jnp.sum(v * v))

    def solve(m):
        bf = JaxBatchEvaluator(fjax, grid, dtype=np.float64, mesh=m)
        t, ranks, errors = tci.crossinterpolate2(
            np.float64, bf, grid, tolerance=1e-8,
            rng=np.random.default_rng(0))
        return bf, t, errors

    (bf1, t1, err1), wall1 = _timed(lambda: solve(None))
    (bfm, tm, errm), wallm = _timed(lambda: solve(mesh))

    # where the evaluator's sampled panel lives: one shard per mesh device
    rng = np.random.default_rng(1)
    pts = rng.integers(0, grid[0], size=(1024, len(grid))).astype(np.int32)
    out = bfm._fn(jnp.asarray(pts))
    shard_devs = sorted(s.device.id for s in out.addressable_shards)
    sharded = (shard_devs == sorted(d.id for d in mesh.devices.flat)
               and all(s.data.shape[0] == len(pts) // mesh.devices.size
                       for s in out.addressable_shards))
    jax.block_until_ready(out)

    v1 = np.array([t1(tuple(p)) for p in pts[:200]])
    vm = np.array([tm(tuple(p)) for p in pts[:200]])
    exact = 1.0 / (1.0 + np.sum((pts[:200] + 1.0) ** 2, axis=1))
    perr = float(np.max(np.abs(vm - exact)))
    # Sampling is elementwise and the sweeps run replicated, so the mesh
    # run reproduces the single-device run bit for bit.
    bitwise = bool(np.array_equal(v1, vm))
    return dict(
        check="sampling_crossinterpolate2", grid=grid,
        rank_single=int(t1.rank()), rank_mesh=int(tm.rank()),
        final_error_mesh=float(errm[-1]), bitwise=bitwise,
        max_pointwise_err_vs_f=perr, pointwise_tol=1e-7,
        precision="float64", shard_devices=shard_devs,
        wall_single_s=wall1, wall_mesh_s=wallm,
        ok=bool(sharded and bitwise and t1.rank() == tm.rank()
                and np.isfinite(errm).all() and errm[-1] < 1e-8
                and perr < 1e-7),
    )


def check_rrlu_sharded(mesh, size):
    """Row-sharded complete-pivot rrLU vs the single-device kernel on the
    mesh's first device: each device holds its own block of rows, and both
    give the same rank and the same pivot order."""
    import jax

    from ..ops import lu_kernel
    from ..ops.lu_sharded import rrlu_sharded_raw, sharded_program_args

    m, n, r = SIZES[size]["panel"]
    rng = np.random.default_rng(0)
    A = rng.standard_normal((m, r)) @ rng.standard_normal((r, n))
    devices = list(mesh.devices.flat)
    args = (A, r + 8, 1e-10, 0.0, True)

    # the placed panel: one block of its padded rows on each device
    panel = sharded_program_args(*args, mesh)[1][0]
    rows = panel.shape[0] // len(devices)
    blocks = sorted((s.device.id, s.data.shape[0])
                    for s in panel.addressable_shards)
    holds = blocks == sorted((d.id, rows) for d in devices)
    del panel

    before = _mem(devices)
    s, walls = _timed(lambda: rrlu_sharded_raw(*args, mesh=mesh))
    growth = _per_device_growth(devices, before)
    k = s[3]

    saved = lu_kernel.HOST_RRLU_BACKEND
    lu_kernel.HOST_RRLU_BACKEND = "default"  # the single-device kernel
    try:
        with jax.default_device(devices[0]):
            d, walld = _timed(lambda: lu_kernel.rrlu_raw(*args))
    finally:
        lu_kernel.HOST_RRLU_BACKEND = saved
    same_order = bool(np.array_equal(s[1], d[1])
                      and np.array_equal(s[2], d[2]))
    # the one-hot Sum collectives are exact: identical pivot order, and the
    # LU buffers agree to float64 roundoff
    lu_close = bool(np.allclose(s[0], d[0], atol=1e-12))
    return dict(
        check="rrlu_sharded", panel=[m, n], rank_sharded=k,
        rank_single=d[3], pivot_order_identical=same_order,
        max_lu_diff=float(np.max(np.abs(s[0] - d[0]))), lu_atol=1e-12,
        precision="float64", row_blocks=blocks,
        device_peak_growth_bytes=growth, wall_sharded_s=walls,
        wall_single_s=walld,
        ok=bool(holds and k == d[3] == r and same_order and lu_close),
    )


def check_contract_compress(mesh, size):
    """contract(algorithm="zipup", mesh=) and TensorTrain.compress(mesh=)
    vs their single-device device tiers, core for core bit for bit, and the
    mesh contraction vs the exact product."""
    from ..models.contraction import contract
    from ..models.tensortrain import TensorTrain

    L, chi, r = SIZES[size]["mpo"]
    A, B = lowrank_mpo(1, L, chi, r), lowrank_mpo(2, L, chi, r)
    kw = dict(algorithm="zipup", method="LU", tolerance=1e-10,
              jax_native=True)
    c1, wall1 = _timed(lambda: contract(A, B, **kw))
    cm, wallm = _timed(lambda: contract(A, B, mesh=mesh, **kw))
    tt1 = TensorTrain([t.copy() for t in A.sitetensors()])
    ttm = TensorTrain([t.copy() for t in A.sitetensors()])
    tt1.compress("LU", tolerance=1e-10, jax_native=True)
    ttm.compress("LU", tolerance=1e-10, jax_native=True, mesh=mesh)

    # every index of a small product, 1000 random ones of a large one
    if 4 ** L <= 1000:
        pts = np.stack(np.unravel_index(np.arange(4 ** L), (4,) * L), -1)
    else:
        pts = np.random.default_rng(1).integers(0, 4, size=(1000, L))
    exact = mpo_product_values(A, B, pts)
    scale = float(np.max(np.abs(exact)))
    exact_err = float(np.max(np.abs(mpo_values(cm, pts) - exact))) / scale

    # only the eliminations run sharded; the factored buffers are pinned
    # replicated, so every core matches the single-device tier bit for bit
    bitwise = all(np.array_equal(a, b) for a, b in
                  zip(c1.sitetensors() + tt1.sitetensors(),
                      cm.sitetensors() + ttm.sitetensors()))
    return dict(
        check="contract_compress", L=L, bond=chi,
        contract_linkdims=cm.linkdims(), compress_linkdims=ttm.linkdims(),
        bitwise=bool(bitwise), exact_points=len(pts),
        max_rel_err_vs_exact=exact_err, exact_tol=1e-9,
        precision="float64", wall_single_s=wall1, wall_mesh_s=wallm,
        ok=bool(bitwise and c1.linkdims() == cm.linkdims()
                and tt1.linkdims() == ttm.linkdims() and exact_err < 1e-9),
    )


def check_serving_rook(mesh, size):
    """A deferred mixed-precision rook factorization (the serving path, a
    one-device program) dispatched while the mesh is live, on the mesh's
    first device: the handle round-trips to the exact rank."""
    import jax

    from ..ops.lu_device import rrlu_rook_device_fused

    m, n, r = SIZES[size]["panel"]
    rng = np.random.default_rng(2)
    A = rng.standard_normal((m, r)) @ rng.standard_normal((r, n))
    with jax.default_device(mesh.devices.flat[0]):
        pend = rrlu_rook_device_fused(
            A, maxrank=2 * r, reltol=1e-11, rng=np.random.default_rng(3),
            precision="mixed", defer=True)
        lu, wall = _timed(pend.result)
    rel = float(np.max(np.abs(np.asarray(lu.left()) @ np.asarray(lu.right())
                              - A)) / np.abs(A).max())
    return dict(
        check="serving_rook", panel=[m, n], rank=r, npivots=lu.npivots(),
        max_rel_recon=rel, recon_tol=1e-9, precision="mixed (f32 hunt)",
        wall_s=wall, ok=bool(lu.npivots() == r and rel < 1e-9),
    )


def check_integrate(mesh, size):
    """integrate(mesh=) vs the single-device integrate, both jax_native:
    the same value bit for bit, and the reference value."""
    import jax.numpy as jnp

    from ..models.integration import integrate

    ndim = SIZES[size]["integ_ndim"]
    if ndim == 10:
        f, lo, hi, ref, reftol = (config4_integrand, -1.0, 1.0,
                                  CONFIG4_REFERENCE, 1e-3)
    else:  # polynomial with an exact integral
        f, lo, hi, ref, reftol = (lambda x: jnp.prod(x), 0.0, 1.0,
                                  0.5 ** ndim, 1e-10)
    kw = dict(GKorder=15, tolerance=1e-8, jax_native=True, maxbonddim=64)
    v1, wall1 = _timed(lambda: integrate(
        np.float64, f, [lo] * ndim, [hi] * ndim,
        rng=np.random.default_rng(5), **kw))
    vm, wallm = _timed(lambda: integrate(
        np.float64, f, [lo] * ndim, [hi] * ndim, mesh=mesh,
        rng=np.random.default_rng(5), **kw))
    # sampling is data-parallel, so the mesh run follows the single-device
    # trajectory exactly
    return dict(
        check="integrate", ndim=ndim, value_single=float(v1),
        value_mesh=float(vm), bitwise=bool(vm == v1),
        abs_err_vs_reference=abs(vm - ref), reference_tol=reftol,
        precision="float64", wall_single_s=wall1, wall_mesh_s=wallm,
        ok=bool(vm == v1 and abs(vm - ref) < reftol),
    )


MESH_CHECKS = (check_rrlu_sharded, check_sampling, check_contract_compress,
               check_serving_rook, check_integrate)


def mesh_checks(mesh, size: str = "small"):
    """Run every mesh check; a check that raises is reported as failed.
    ``check_rrlu_sharded`` runs first, while the devices' peak-memory
    counters show the sharded elimination alone."""
    results = []
    for check in MESH_CHECKS:
        try:
            results.append(check(mesh, size))
        except Exception as e:  # noqa: BLE001 - report every check
            results.append(dict(check=check.__name__, ok=False,
                                error=f"{type(e).__name__}: {e}"))
    return results


def run(n_devices: int) -> None:
    import jax

    # Before the backend initializes: the dry run validates sharding on
    # virtual host devices whatever platform the caller's environment sets.
    jax.config.update("jax_platforms", "cpu")

    from .mesh import default_mesh

    cpus = jax.devices("cpu")
    if len(cpus) < n_devices:
        raise RuntimeError(
            f"dryrun_multichip needs {n_devices} CPU devices but found "
            f"{len(cpus)}; XLA_FLAGS must contain "
            f"--xla_force_host_platform_device_count={n_devices} before "
            "jax initializes"
        )
    results = mesh_checks(default_mesh(n_devices), "small")
    failed = [r for r in results if not r["ok"]]
    if failed:
        raise AssertionError(f"mesh checks failed: {failed}")
    print(f"dryrun_multichip({n_devices}): ok — platform=cpu, "
          + ", ".join(r["check"] for r in results))


if __name__ == "__main__":
    import sys

    run(int(sys.argv[1]) if len(sys.argv) > 1 else 8)
