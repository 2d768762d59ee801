"""Device-resident rook rrLU (ops/lu_device.py) and the fused swap-free
exact elimination body (ops/lu_kernel._rrlu_state_fused).

The fused body must be bit-compatible with the swap-based small body
(same pivots, permutations, LU buffer, pivot magnitudes — including the
reference's swapped-layout column-major tie-break, matrixlu.jl:70-86); the
device rook must reproduce the host arrlu (matrixlu.jl:492-569) exactly
when driven by the same rng.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from tci_tpu.ops.lu import arrlu
from tci_tpu.ops.lu_device import rrlu_rook_device
from tci_tpu.ops.lu_kernel import _rrlu_state_fused, _rrlu_state_small


def _lowrank(rng, m, n, r):
    return rng.standard_normal((m, r)) @ rng.standard_normal((r, n))


@pytest.mark.parametrize("leftorthogonal", [True, False])
@pytest.mark.parametrize("shape", [(40, 30, 10), (33, 57, 20)])
def test_fused_body_matches_small_body(rng, shape, leftorthogonal):
    m, n, r = shape
    A = jnp.asarray(_lowrank(rng, m, n, r))
    for maxrank, reltol, abstol in [
        (min(m, n), 1e-10, 0.0),
        (7, 0.0, 0.0),
        (min(m, n), 0.0, 1e-3),
    ]:
        args = (
            A, jnp.int32(m), jnp.int32(n), jnp.int32(maxrank),
            jnp.float64(reltol), jnp.float64(abstol),
        )
        o1 = jax.jit(_rrlu_state_small, static_argnames="leftorthogonal")(
            *args, leftorthogonal=leftorthogonal
        )
        o2 = jax.jit(_rrlu_state_fused, static_argnames="leftorthogonal")(
            *args, leftorthogonal=leftorthogonal
        )
        assert int(o1[3]) == int(o2[3])
        np.testing.assert_array_equal(np.asarray(o1[1]), np.asarray(o2[1]))
        np.testing.assert_array_equal(np.asarray(o1[2]), np.asarray(o2[2]))
        np.testing.assert_allclose(
            np.asarray(o1[0]), np.asarray(o2[0]), rtol=1e-12, atol=1e-12
        )
        np.testing.assert_allclose(np.asarray(o1[4]), np.asarray(o2[4]),
                                   rtol=1e-12)


@pytest.mark.parametrize("leftorthogonal", [True, False])
def test_fused_body_tie_break(leftorthogonal):
    """Exact ties must resolve in the swapped-layout column-major order,
    identically in both bodies."""
    A = np.array(
        [[2.0, 2.0, 1.0], [2.0, 2.0, 1.0], [1.0, 1.0, 1.0], [2.0, 1.0, 2.0]]
    )
    Ap = jnp.zeros((8, 8)).at[:4, :3].set(A)
    args = (
        Ap, jnp.int32(4), jnp.int32(3), jnp.int32(3),
        jnp.float64(1e-12), jnp.float64(0.0),
    )
    o1 = jax.jit(_rrlu_state_small, static_argnames="leftorthogonal")(
        *args, leftorthogonal=leftorthogonal
    )
    o2 = jax.jit(_rrlu_state_fused, static_argnames="leftorthogonal")(
        *args, leftorthogonal=leftorthogonal
    )
    assert int(o1[3]) == int(o2[3])
    np.testing.assert_array_equal(np.asarray(o1[1]), np.asarray(o2[1]))
    np.testing.assert_array_equal(np.asarray(o1[2]), np.asarray(o2[2]))


@pytest.mark.slow
@pytest.mark.parametrize("leftorthogonal", [True, False])
def test_rook_device_matches_host_arrlu(rng, leftorthogonal):
    m, n, r = 120, 90, 17
    A = _lowrank(rng, m, n, r)
    lu = rrlu_rook_device(
        A, reltol=1e-10, leftorthogonal=leftorthogonal,
        rng=np.random.default_rng(1),
    )
    assert lu.npivots() == r
    rec = lu.left() @ lu.right()
    assert np.max(np.abs(rec - A)) / np.max(np.abs(A)) < 1e-9

    f = lambda rows, cols: A[np.ix_(rows, cols)]
    lu_h = arrlu(
        np.float64, f, (m, n), reltol=1e-10,
        leftorthogonal=leftorthogonal, usebatcheval=True,
        rng=np.random.default_rng(1),
    )
    assert lu_h.npivots() == lu.npivots()
    np.testing.assert_array_equal(lu.rowindices(), lu_h.rowindices())
    np.testing.assert_array_equal(lu.colindices(), lu_h.colindices())


@pytest.mark.parametrize("leftorthogonal", [True, False])
@pytest.mark.parametrize("transpose", [False, True])
def test_rook_device_materialize_device(rng, leftorthogonal, transpose):
    m, n, r = 120, 90, 17
    A = _lowrank(rng, m, n, r)
    if transpose:
        A = A.T
    lu_h = rrlu_rook_device(
        A, reltol=1e-10, leftorthogonal=leftorthogonal,
        rng=np.random.default_rng(2),
    )
    lu_d = rrlu_rook_device(
        A, reltol=1e-10, leftorthogonal=leftorthogonal,
        rng=np.random.default_rng(2), materialize="device",
    )
    assert lu_d.npivots() == lu_h.npivots()
    np.testing.assert_array_equal(lu_d.rowindices(), lu_h.rowindices())
    np.testing.assert_allclose(np.asarray(lu_d.left()), lu_h.left(),
                               atol=1e-10)
    np.testing.assert_allclose(np.asarray(lu_d.right()), lu_h.right(),
                               atol=1e-10)
    lu_rt = lu_d.to_rrlu()
    np.testing.assert_allclose(lu_rt.left() @ lu_rt.right(), A, atol=1e-9)


def test_rook_device_maxrank(rng):
    A = _lowrank(rng, 60, 60, 30)
    lu = rrlu_rook_device(A, maxrank=8, rng=np.random.default_rng(3))
    assert lu.npivots() <= 8


@pytest.mark.slow
@pytest.mark.filterwarnings(
    "ignore:pivotsearch='rook' is running the per-bond rook tier"
    ":RuntimeWarning"
)
def test_tci2_rook_device_tier_matches_host(rng):
    """pivotsearch='rook' with a JaxBatchEvaluator routes through the device
    rook (materialized panel + device slab iteration) and converges like the
    host SubMatrix path (reference arrlu semantics, matrixlu.jl:492-569).
    The engine's advisory per-bond-tier warning is the expected, intended
    behavior here (enable_device_sweep=False forces this tier)."""
    import jax.numpy as jnp

    import tci_tpu as tci
    from tci_tpu.parallel.batcheval import JaxBatchEvaluator

    localdims = [6] * 5

    def fjax(idx):
        v = idx.astype(jnp.float64) + 1.0
        return 1.0 / (1.0 + jnp.sum(v * v))

    fpy = lambda x: 1.0 / (
        1.0 + float(np.sum((np.asarray(x, dtype=float) + 1.0) ** 2))
    )
    bf = JaxBatchEvaluator(fjax, localdims, dtype=np.float64,
                           enable_device_sweep=False)
    assert bf.panel_sampler is not None
    t1, r1, e1 = tci.crossinterpolate2(
        np.float64, bf, localdims, tolerance=1e-9, pivotsearch="rook",
        rng=np.random.default_rng(7),
    )
    t2, r2, e2 = tci.crossinterpolate2(
        np.float64, fpy, localdims, tolerance=1e-9, pivotsearch="rook",
        rng=np.random.default_rng(7),
    )
    assert e1[-1] < 1e-9 and e2[-1] < 1e-9
    for v in [(0, 0, 0, 0, 0), (1, 2, 3, 4, 5), (5, 4, 3, 2, 1)]:
        assert abs(t1.evaluate(v) - fpy(v)) < 1e-8
        assert abs(t2.evaluate(v) - fpy(v)) < 1e-8


def test_rook_fused_one_dispatch_matches_reconstruction(rng):
    """rrlu_rook_device_fused: whole rook alternation in ONE XLA program;
    factors must reconstruct the matrix to working precision and respect
    the maxrank cap on both orthogonality conventions."""
    from tci_tpu.ops.lu_device import rrlu_rook_device_fused

    N, rank = 96, 11
    U = rng.standard_normal((N, rank))
    V = rng.standard_normal((rank, N))
    A = (U * np.exp(-np.arange(rank) / 4.0)) @ V
    for lo in (True, False):
        lu = rrlu_rook_device_fused(
            A, maxrank=32, reltol=1e-11, leftorthogonal=lo,
            rng=np.random.default_rng(7),
        )
        L = np.asarray(lu.left())
        R = np.asarray(lu.right())
        err = np.abs(L @ R - A).max() / np.abs(A).max()
        assert lu.npivots() <= 32
        assert err < 1e-9, (lo, err)
        # permutations are real permutations
        assert sorted(lu.rowpermutation.tolist()) == list(range(N))
        assert sorted(lu.colpermutation.tolist()) == list(range(N))


def test_rook_fused_maxrank_cap(rng):
    from tci_tpu.ops.lu_device import rrlu_rook_device_fused

    A = rng.standard_normal((40, 60))
    lu = rrlu_rook_device_fused(A, maxrank=8, reltol=1e-13,
                                rng=np.random.default_rng(1))
    assert lu.npivots() == 8
    # rank-8 cross approximation of a random matrix is inexact: the
    # reported error must be finite (residual bookkeeping ran)
    assert np.isfinite(lu.error)


@pytest.mark.parametrize("leftorthogonal", [True, False])
def test_rook_fused_mixed_precision(rng, leftorthogonal):
    """precision="mixed": pivot hunting in f32, f64 factors rebuilt from the
    pivot sets by _assemble_mixed (fixed-order block LU + Gauss-Jordan +
    completion GEMMs). Rank, reconstruction quality and factor
    triangularity must match the pure-f64 path; the f64 rank-detection
    prepass must reject f32 noise pivots past the true rank."""
    from tci_tpu.ops.lu_device import rrlu_rook_device_fused

    for (m, n, r, cap) in [(200, 160, 40, 64), (96, 96, 96, 96),
                           (300, 100, 25, 40)]:
        U = rng.standard_normal((m, r))
        V = rng.standard_normal((r, n))
        A = (U * np.exp(-np.arange(r) / 8.0)) @ V
        lu64 = rrlu_rook_device_fused(
            A, maxrank=cap, reltol=1e-12, leftorthogonal=leftorthogonal,
            rng=np.random.default_rng(7),
        )
        lumx = rrlu_rook_device_fused(
            A, maxrank=cap, reltol=1e-12, leftorthogonal=leftorthogonal,
            rng=np.random.default_rng(7), precision="mixed",
        )
        assert lumx.npivots() == lu64.npivots()
        scale = np.abs(A).max()
        emx = np.abs(
            np.asarray(lumx.left() @ lumx.right()) - A
        ).max() / scale
        assert emx < 1e-11, (m, n, emx)
        # factors are triangular (with unit diagonal on the orthogonal
        # side) in pivot order — the scattered exact blocks
        k = lumx.npivots()
        Lp = np.asarray(lumx.left())[lumx.rowpermutation[:k], :]
        Up = np.asarray(lumx.right())[:, lumx.colpermutation[:k]]
        assert np.allclose(np.triu(Lp[:k], 1), 0)
        assert np.allclose(np.tril(Up[:, :k], -1), 0)
        if leftorthogonal:
            assert np.allclose(np.diagonal(Lp), 1.0)
        else:
            assert np.allclose(np.diagonal(Up), 1.0)
        # permutations are real permutations
        assert sorted(lumx.rowpermutation.tolist()) == list(range(m))
        assert sorted(lumx.colpermutation.tolist()) == list(range(n))


def test_rook_fused_mixed_extreme_scale(rng):
    """The f32 hunt must survive f64 inputs outside f32 range: |x| > ~3.4e38
    would round to inf (poisoning reltol*maxerror), |x| < ~1e-38 would flush
    to zero (hunt finds nothing). The hunt rescales the matrix to O(1)
    before the cast, so pivot quality is scale-invariant."""
    from tci_tpu.ops.lu_device import rrlu_rook_device_fused

    r = 24
    U = np.linalg.qr(rng.standard_normal((128, r)))[0]
    V = np.linalg.qr(rng.standard_normal((96, r)))[0]
    base = (U * np.logspace(0, -6, r)) @ V.T
    for scale in (1.0, 1e300, 1e30, 1e-30, 1e-250, "top"):
        if scale == "top":
            # max|x| above 2^1023.5 ~ 1.35e308: an unclamped power-of-two
            # scale rounds its exponent to 1024 and exp2(1024) = inf,
            # zeroing A64/scale0 and returning NaN factors — the clamp to
            # exponent 1023 must keep this legal f64 input working
            A = base / np.abs(base).max() * 1.6e308
        else:
            A = base * scale
        lu = rrlu_rook_device_fused(A, maxrank=48, reltol=1e-10,
                                    precision="mixed",
                                    rng=np.random.default_rng(5))
        amax = np.abs(A).max()
        rel = np.abs(np.asarray(lu.left() @ lu.right()) - A).max() / amax
        assert lu.npivots() >= r - 2, (scale, lu.npivots())
        assert rel < 1e-9, (scale, rel)
    # At the very bottom of f64 range the factor entries themselves fall
    # into subnormal territory (< 2.2e-308), which XLA flushes to zero —
    # an f64 representability limit, not an algorithm property. The guard
    # must still find the full rank and degrade gracefully.
    A = base * 1e-300
    lu = rrlu_rook_device_fused(A, maxrank=48, reltol=1e-10,
                                precision="mixed",
                                rng=np.random.default_rng(5))
    rel = np.abs(
        np.asarray(lu.left() @ lu.right()) - A
    ).max() / np.abs(A).max()
    assert lu.npivots() >= r - 2, lu.npivots()
    assert rel < 1e-5, rel


def test_rook_fused_precision_validation(rng):
    """Unknown precision strings and mixed-on-complex raise instead of
    silently running the plain-precision path."""
    from tci_tpu.ops.lu_device import rrlu_rook_device_fused

    A = rng.standard_normal((32, 32))
    with pytest.raises(ValueError, match="precision"):
        rrlu_rook_device_fused(A, maxrank=8, precision="Mixed")
    with pytest.raises(ValueError, match="mixed"):
        rrlu_rook_device_fused(A.astype(np.complex128), maxrank=8,
                               precision="mixed")


def test_rook_fused_mixed_f32_input_passthrough(rng):
    """precision="mixed" on an f32 input degrades to the plain f32 path
    (nothing to mix); result must equal precision="f64" on the same rng."""
    from tci_tpu.ops.lu_device import rrlu_rook_device_fused

    A = (rng.standard_normal((64, 48, 8)) @ np.ones(8)).astype(np.float32)
    a = rrlu_rook_device_fused(A, maxrank=16, reltol=1e-6,
                               rng=np.random.default_rng(3))
    b = rrlu_rook_device_fused(A, maxrank=16, reltol=1e-6,
                               rng=np.random.default_rng(3),
                               precision="mixed")
    assert a.npivots() == b.npivots()
    np.testing.assert_array_equal(np.asarray(a.left()), np.asarray(b.left()))


@pytest.mark.parametrize("precision", ["f64", "mixed"])
def test_rook_fused_defer_pipelines_batches(rng, precision):
    """defer=True: several factorizations issued back-to-back, collected
    afterwards. Each result must equal the eager call with the same rng,
    and the slab-elimination count diagnostic must be recorded."""
    from tci_tpu.ops.lu_device import _PendingRRLU, rrlu_rook_device_fused

    mats = []
    for r in (6, 9, 13):
        U = rng.standard_normal((80, r))
        V = rng.standard_normal((r, 72))
        mats.append((U * np.exp(-np.arange(r) / 3.0)) @ V)

    pending = [
        rrlu_rook_device_fused(
            A, maxrank=24, reltol=1e-11,
            rng=np.random.default_rng(11 + i), precision=precision,
            defer=True,
        )
        for i, A in enumerate(mats)
    ]
    assert all(isinstance(p, _PendingRRLU) for p in pending)
    for i, (p, A) in enumerate(zip(pending, mats)):
        lu = p.result()
        assert lu is p.result()  # memoized
        eager = rrlu_rook_device_fused(
            A, maxrank=24, reltol=1e-11,
            rng=np.random.default_rng(11 + i), precision=precision,
        )
        assert lu.npivots() == eager.npivots()
        np.testing.assert_allclose(
            np.asarray(lu.left() @ lu.right()), A, atol=1e-9 * np.abs(A).max()
        )
        assert lu.nslabs is not None and lu.nslabs >= 1
        assert lu.nslabs == eager.nslabs


@pytest.mark.parametrize(
    "spectrum", ["exp8", "exp2", "deep14", "flat", "steps"])
def test_rook_fused_nri2_serving_quality(rng, spectrum):
    """numrookiter=2 (the tuned serving config benchmarked at 4096²):
    one col-slab + one row-slab alternation, closing row move's factors
    reused. The reduced hunt must still produce reconstruction at the
    f64 floor across qualitatively different spectra — INCLUDING deep
    (10-14 decade) ones — for both precisions, with real permutations
    and the maxrank cap held.

    The mixed path's f32 hunt fixes good pivot SETS even past f32
    resolution (measured: direct f64 cross interpolation from the f32
    sets reaches 1e-14 on 14-decade spectra); what used to cap mixed
    recon at ~1e-5 on deep spectra was the completion eliminating the
    pivot block in the hunt's (noise) ORDER — fixed by the complete-pivot
    re-ordering + triangular-substitution inverses inside
    _assemble_mixed_body, so mixed now matches the f64 path everywhere.
    """
    from tci_tpu.ops.lu_device import rrlu_rook_device_fused

    m, n, r = 220, 180, 48
    s = {
        "exp8": np.exp(-np.arange(r) / 8.0),
        "exp2": np.exp(-np.arange(r) / 2.0),          # 10 decades
        "deep14": np.exp(-np.arange(r) * 0.67),       # 14 decades
        "flat": np.ones(r),
        "steps": np.repeat([1.0, 1e-2, 1e-4], [16, 16, 16]),
    }[spectrum]
    U = rng.standard_normal((m, r))
    V = rng.standard_normal((r, n))
    A = (U * s) @ V
    for prec in ("f64", "mixed"):
        lu = rrlu_rook_device_fused(
            A, maxrank=64, reltol=1e-12, numrookiter=2,
            rng=np.random.default_rng(5), precision=prec,
        )
        assert lu.nslabs == 2
        assert lu.npivots() <= 64
        err = np.abs(
            np.asarray(lu.left() @ lu.right()) - A
        ).max() / np.abs(A).max()
        # both precisions sit at the f64 floor (the deepest spectra pay
        # a little growth: reltol=1e-12 keeps pivots 12 decades down)
        tol = 5e-11 if spectrum == "deep14" else 1e-9
        assert err < tol, (spectrum, prec, err)
        assert sorted(lu.rowpermutation.tolist()) == list(range(m))
        assert sorted(lu.colpermutation.tolist()) == list(range(n))


@pytest.mark.parametrize("spectrum", ["exp2", "deep14", "exp8"])
def test_rook_fused_mixed_hunt_stages(rng, spectrum):
    """hunt_stages=2 (the deflated re-hunt): completes the trusted pivots
    in f64, rescales the residual to O(1) and re-hunts it in f32 at the
    residual's own scale, then walks the concatenated candidates under the
    caller's stop rule — still ONE dispatch. Must match the single-stage
    floor on every spectrum (it is insurance for spectra deeper than one
    f32 hunt can see), hold the maxrank cap, and produce real
    permutations."""
    from tci_tpu.ops.lu_device import rrlu_rook_device_fused

    m, n, r = 220, 180, 48
    s = {
        "exp8": np.exp(-np.arange(r) / 8.0),
        "exp2": np.exp(-np.arange(r) / 2.0),
        "deep14": np.exp(-np.arange(r) * 0.67),
    }[spectrum]
    U = rng.standard_normal((m, r))
    V = rng.standard_normal((r, n))
    A = (U * s) @ V
    lu = rrlu_rook_device_fused(
        A, maxrank=64, reltol=1e-12, numrookiter=2,
        rng=np.random.default_rng(5), precision="mixed", hunt_stages=2,
    )
    assert lu.nslabs == 4  # two alternations of two slabs each
    assert lu.npivots() <= 64
    err = np.abs(
        np.asarray(lu.left() @ lu.right()) - A
    ).max() / np.abs(A).max()
    tol = 5e-11 if spectrum == "deep14" else 1e-9
    assert err < tol, (spectrum, err)
    assert sorted(lu.rowpermutation.tolist()) == list(range(m))
    assert sorted(lu.colpermutation.tolist()) == list(range(n))
    # factors stay triangular in pivot order (scattered exact blocks)
    k = lu.npivots()
    Lp = np.asarray(lu.left())[lu.rowpermutation[:k], :]
    Up = np.asarray(lu.right())[:, lu.colpermutation[:k]]
    assert np.allclose(np.triu(Lp[:k], 1), 0)
    assert np.allclose(np.tril(Up[:, :k], -1), 0)
    assert np.allclose(np.diagonal(Lp), 1.0)


def test_rook_fused_hunt_stages_exact_rank(rng):
    """hunt_stages=2 on an EXACTLY low-rank matrix: stage 1 resolves the
    full rank, the deflated residual is ~0 (the rescale guard keeps the
    division defined), the stage-2 hunt finds only zero pivots and the
    final f64 walk rejects them — rank must not inflate."""
    from tci_tpu.ops.lu_device import rrlu_rook_device_fused

    U = rng.standard_normal((150, 12))
    V = rng.standard_normal((12, 120))
    A = U @ V
    lu = rrlu_rook_device_fused(
        A, maxrank=40, reltol=1e-12, numrookiter=2,
        rng=np.random.default_rng(5), precision="mixed", hunt_stages=2,
    )
    assert lu.npivots() == 12
    err = np.abs(
        np.asarray(lu.left() @ lu.right()) - A
    ).max() / np.abs(A).max()
    assert err < 1e-12


def test_rook_fused_hunt_stages_validation(rng):
    """hunt_stages is mixed-only and must be >= 1."""
    from tci_tpu.ops.lu_device import rrlu_rook_device_fused

    A = rng.standard_normal((32, 24))
    with pytest.raises(ValueError, match="mixed"):
        rrlu_rook_device_fused(A, maxrank=8, hunt_stages=2)
    with pytest.raises(ValueError, match=">= 1"):
        rrlu_rook_device_fused(A, maxrank=8, hunt_stages=0,
                               precision="mixed")
