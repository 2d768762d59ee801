"""Multi-chip sharding paths on the virtual 8-device CPU mesh.

The real algorithm runs end-to-end mesh-sharded: crossinterpolate2 with a
JaxBatchEvaluator whose device-sweep Π sampling carries a mesh sharding
constraint must produce identical ranks/errors to the single-device run.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp


def _lorentz(idx):
    v = idx.astype(jnp.float64) + 1.0
    return 1.0 / (1.0 + jnp.sum(v * v))


@pytest.mark.slow
def test_crossinterpolate2_on_mesh_matches_single_device():
    import tci_tpu as tci
    from tci_tpu.parallel.batcheval import JaxBatchEvaluator
    from tci_tpu.parallel.mesh import default_mesh

    assert len(jax.devices()) >= 8, "conftest should provide 8 virtual devices"
    localdims = [3] * 5

    def run(mesh):
        bf = JaxBatchEvaluator(_lorentz, localdims, mesh=mesh)
        t, ranks, errors = tci.crossinterpolate2(
            np.float64, bf, localdims, tolerance=1e-8, maxiter=4,
            rng=np.random.default_rng(7),
        )
        return t, ranks, errors

    t1, ranks1, errors1 = run(None)
    t8, ranks8, errors8 = run(default_mesh(8))

    assert ranks8 == ranks1
    np.testing.assert_allclose(errors8, errors1, rtol=1e-10, atol=1e-14)
    # identical pivot selection => identical interpolants
    pt = (1, 2, 0, 2, 1)
    assert abs(t8(pt) - t1(pt)) < 1e-12


def test_sharded_jax_evaluator():
    from tci_tpu.parallel.batcheval import JaxBatchEvaluator
    from tci_tpu.parallel.mesh import default_mesh

    mesh = default_mesh(8)
    localdims = [4] * 6
    bf = JaxBatchEvaluator(_lorentz, localdims, mesh=mesh)
    rng = np.random.default_rng(0)
    idx = rng.integers(0, 4, size=(37, 6)).astype(np.int32)
    vals = bf.evaluate_many(idx)
    ref = np.array([1.0 / (1.0 + ((r + 1.0) ** 2).sum()) for r in idx.astype(float)])
    assert np.allclose(vals, ref)


def test_default_mesh_spans_default_platform_devices():
    from tci_tpu.parallel.mesh import default_mesh

    mesh = default_mesh(8)
    assert mesh.devices.shape == (8,)
    assert mesh.axis_names == ("batch",)
    assert list(mesh.devices) == jax.devices()[:8]


def test_default_mesh_raises_when_platform_has_too_few_devices():
    from tci_tpu.parallel.mesh import default_mesh

    with pytest.raises(ValueError, match="requested a 9-device mesh"):
        default_mesh(9)


def test_graft_entry_single_chip():
    import __graft_entry__ as g

    fn, args = g.entry()
    out = jax.jit(fn)(*args)
    assert out.shape == (256,)


@pytest.mark.slow
def test_graft_entry_dryrun_subprocess():
    """dryrun_multichip must succeed regardless of the caller's platform —
    it spawns a subprocess that forces an 8-virtual-CPU mesh."""
    import __graft_entry__ as g

    g.dryrun_multichip(8)


@pytest.mark.slow
def test_rook_on_mesh_matches_single_device():
    """The scan rook body carries the same mesh sharding constraint on its
    slab panels (shard_rows on the candidate-row axis): mesh-sharded rook
    must select identical pivots to the single-device rook run."""
    import tci_tpu as tci
    from tci_tpu.parallel.batcheval import JaxBatchEvaluator
    from tci_tpu.parallel.mesh import default_mesh

    localdims = [3] * 5

    def run(mesh):
        bf = JaxBatchEvaluator(_lorentz, localdims, mesh=mesh)
        t, ranks, errors = tci.crossinterpolate2(
            np.float64, bf, localdims, tolerance=1e-8, maxiter=4,
            pivotsearch="rook", rng=np.random.default_rng(7),
        )
        return t, ranks, errors

    t1, ranks1, errors1 = run(None)
    t8, ranks8, errors8 = run(default_mesh(8))
    assert ranks8 == ranks1
    np.testing.assert_allclose(errors8, errors1, rtol=1e-10, atol=1e-14)
    pt = (1, 2, 0, 2, 1)
    assert abs(t8(pt) - t1(pt)) < 1e-12


@pytest.mark.slow
def test_floatingzone_on_mesh_matches_single_device():
    """estimatetrueerror's whole-search device program carries the mesh
    sharding constraint on its candidate-row axis: the mesh-sharded search
    must follow the identical trajectory (same pivots, same errors) as the
    single-device program — row sharding only distributes the per-row f
    evaluations and TT contractions, never reorders any reduction."""
    import tci_tpu as tci
    from tci_tpu.models.globalsearch import estimatetrueerror
    from tci_tpu.parallel.batcheval import JaxBatchEvaluator
    from tci_tpu.parallel.mesh import default_mesh

    def fj(idx):
        v = idx.astype(jnp.float64) + 1.0
        return 1.0 / (1.0 + jnp.sum(v * v)) + 0.05 * jnp.cos(
            2.7 * jnp.prod(v) ** 0.5
        )

    localdims = [4] * 5
    starts = [
        tuple(int(x) for x in row)
        for row in np.random.default_rng(3).integers(0, 4, (12, 5))
    ]

    def run(mesh):
        bf = JaxBatchEvaluator(fj, localdims, mesh=mesh)
        t, _, _ = tci.crossinterpolate2(
            np.float64, bf, localdims, tolerance=1e-2, maxbonddim=4,
            rng=np.random.default_rng(5),
        )
        tt = tci.tensortrain(t)
        assert bf.device_sweep_engine.floatingzone(
            tt.sitetensors(), np.asarray(starts, dtype=np.int32)
        ) is not None
        return estimatetrueerror(tt, bf, initialpoints=starts)

    res1 = run(None)
    res8 = run(default_mesh(8))
    assert [p for p, _ in res8] == [p for p, _ in res1]
    np.testing.assert_allclose(
        [e for _, e in res8], [e for _, e in res1], rtol=1e-12
    )


def test_tt_evaluate_sharded_matches_single_device(rng):
    """Serving path: mesh-sharded batch evaluation == single-device, and
    the compiled result is genuinely sharded over the mesh axis."""
    from jax.sharding import NamedSharding, PartitionSpec

    from tci_tpu.models.jaxeval import (
        pad_cores,
        tt_evaluate_batched_jit,
        tt_evaluate_sharded,
    )
    from tci_tpu.models.tensortrain import TensorTrain
    from tci_tpu.parallel.mesh import default_mesh

    mesh = default_mesh(8)
    linkdims = [1, 3, 5, 4, 1]
    tt = TensorTrain(
        [
            rng.standard_normal((linkdims[i], 3, linkdims[i + 1]))
            for i in range(4)
        ]
    )
    cores = jnp.asarray(pad_cores(tt.sitetensors()))
    # B=37 exercises the pad-to-multiple-of-mesh path (37 -> 40)
    idx = jnp.asarray(rng.integers(0, 3, size=(37, 4)).astype(np.int32))

    vals = tt_evaluate_sharded(cores, idx, mesh)
    ref = tt_evaluate_batched_jit(cores, idx)
    np.testing.assert_allclose(np.asarray(vals), np.asarray(ref), rtol=1e-12)
    for i in [0, 5, 36]:
        assert abs(float(vals[i]) - tt.evaluate(tuple(np.asarray(idx[i])))) < 1e-10

    # the device computation must actually be distributed: evaluating the
    # padded sharded batch directly yields an output laid out over all 8
    # devices along the batch axis
    n = mesh.devices.size
    idx_p = jnp.pad(idx, ((0, 40 - 37), (0, 0)))
    idx_p = jax.device_put(idx_p, NamedSharding(mesh, PartitionSpec("batch", None)))
    cores_r = jax.device_put(cores, NamedSharding(mesh, PartitionSpec()))
    out = tt_evaluate_batched_jit(cores_r, idx_p)
    assert len(out.sharding.device_set) == n

@pytest.mark.slow
def test_integrate_on_mesh_matches_single_device():
    """integrate(jax_native=True, mesh=) shards the GK panel sampling over
    the mesh and must agree with the single-device result (same pivot
    trajectory => same quadrature value). Ref: integration.jl:68-161."""
    import tci_tpu as tci
    from tci_tpu.parallel.mesh import default_mesh

    N = 4

    def fjax(x):
        return jnp.prod(x) + jnp.sum(x * x)

    def run(mesh):
        # distinct lambda per run: the GK evaluator cache is keyed on the
        # integrand object first, then (grid, dtype, mesh) — reusing one
        # object would also exercise the cache, but this isolates the runs
        return tci.integrate(
            np.float64, lambda x: fjax(x), [0.0] * N, [1.0] * N,
            GKorder=15, jax_native=True, mesh=mesh, tolerance=1e-10,
            rng=np.random.default_rng(3),
        )

    v1 = run(None)
    v8 = run(default_mesh(8))
    exact = (0.5 ** N) + N / 3.0  # ∫ prod(x) + sum(x^2) over [0,1]^4
    assert abs(v1 - exact) < 1e-8
    assert abs(v8 - v1) < 1e-12


def test_integrate_mesh_requires_jax_native():
    import tci_tpu as tci
    from tci_tpu.parallel.mesh import default_mesh

    with pytest.raises(ValueError, match="jax_native"):
        tci.integrate(np.float64, lambda x: 1.0, [0.0], [1.0],
                      mesh=default_mesh(8))
