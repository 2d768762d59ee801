"""Port of test/test_matrixlu.jl (0-based indices; fixtures verbatim)."""

import numpy as np
import pytest

import tci_tpu as tci

A10x8 = np.array([
    [0.0698159, 0.334367, -0.589437, 0.145762, 0.812079, -0.756145, 0.295355, 0.474037],
    [0.700284, 0.53583, -0.879161, 0.0259543, -0.17721, 0.872417, -0.130773, 0.806836],
    [-0.27785, 0.75619, -0.6596, 0.697439, 0.751422, -0.694813, 0.5158, -0.812036],
    [-0.621557, 0.183863, -0.163899, -0.0200506, 0.418512, 0.456449, 0.779305, 0.771141],
    [-0.71849, -0.343808, 0.360291, 0.311619, -0.609726, 0.309062, -0.214459, -0.830421],
    [-0.320604, -0.998123, 0.45783, 0.990825, -0.790207, -0.227163, -0.535666, -0.950299],
    [-0.136987, -0.0648093, -0.960298, 0.454315, -0.722124, 0.782378, 0.356427, 0.987233],
    [-0.209571, -0.0171136, 0.189971, 0.578491, -0.663334, -0.482773, -0.0205025, 0.570071],
    [-0.942577, 0.306031, 0.696775, -0.853113, 0.554776, -0.25695, 0.229594, -0.0306027],
    [-0.490229, -0.0501003, 0.163198, -0.253586, 0.941586, 0.0345018, 0.737874, -0.963045],
])


def _argmax_colmajor(M):
    flat = np.asarray(M).T.reshape(-1)
    p = int(np.argmax(flat))
    return p % M.shape[0], p // M.shape[0]


class TestArgmaxFinder:
    def test_basic(self):
        A = A10x8
        assert tci.submatrixargmax(A, [2], [4]) == (2, 4)
        assert tci.submatrixargmax(A) == _argmax_colmajor(A)
        assert tci.submatrixargmax(A, [0], None) == (0, int(np.argmax(A[0, :])))
        assert tci.submatrixargmax(A, None, [0]) == (int(np.argmax(A[:, 0])), 0)
        assert tci.submatrixargmax(A, 0) == _argmax_colmajor(A)
        m = min(A.shape) - 1
        assert tci.submatrixargmax(A, m) == (m, m)

    def test_throws(self):
        A = np.random.rand(10, 10)
        with pytest.raises(ValueError, match="rows must not be empty"):
            tci.submatrixargmax(A, 100)
        with pytest.raises(ValueError, match="cols must not be empty"):
            tci.submatrixargmax(A, [3], [])
        with pytest.raises(ValueError, match="rows must be a subset"):
            tci.submatrixargmax(A, [1, 100, 1000], [1])
        with pytest.raises(ValueError, match="cols must be a subset"):
            tci.submatrixargmax(A, [1], [1, 100, 1000])

    def test_complex(self):
        A = np.array([
            [0, 1, 2, 3, 4, 5],
            [1, 1j, 2 + 1j, 3 + 1j, 4 + 1j, 5 + 1j],
            [1, 2j, 2 + 2j, 3 + 2j, 4 + 2j, 5 + 2j],
        ], dtype=complex)
        abs2 = lambda x: (x * x.conjugate()).real
        assert tci.submatrixargmax(A, [2], [4], f=abs2) == (2, 4)
        assert tci.submatrixargmax(A, f=abs2) == _argmax_colmajor(np.abs(A) ** 2)
        assert tci.submatrixargmax(A, [0], None, f=abs2) == (
            0, int(np.argmax(np.abs(A[0, :]) ** 2))
        )
        assert tci.submatrixargmax(A, 0, f=abs2) == _argmax_colmajor(np.abs(A) ** 2)


class TestRRLU:
    def test_exact(self):
        A = np.array([
            [0.711002, 0.724557, 0.789335, 0.382373],
            [0.910429, 0.726781, 0.719957, 0.486302],
            [0.632716, 0.39967, 0.571809, 0.0803125],
            [0.885709, 0.531645, 0.569399, 0.481214],
        ])
        LU = tci.rrlu(A)
        assert LU.shape == A.shape
        L = LU.left(permute=False)
        assert np.allclose(L, np.tril(L))
        assert np.allclose(np.diag(L), 1.0)
        U = LU.right(permute=False)
        assert np.allclose(U, np.triu(U))
        assert np.allclose(LU.left() @ LU.right(), A)

    def test_arrlu_exact(self, rng):
        A = np.array([
            [0.711002, 0.724557, 0.789335, 0.382373],
            [0.910429, 0.726781, 0.719957, 0.486302],
            [0.632716, 0.39967, 0.571809, 0.0803125],
            [0.885709, 0.531645, 0.569399, 0.481214],
        ])
        LU = tci.arrlu(np.float64, lambda i, j: A[i, j], A.shape, [0], [0],
                       rng=rng)
        assert LU.shape == A.shape
        L = LU.left(permute=False)
        assert np.allclose(L, np.tril(L))
        assert np.allclose(np.diag(L), 1.0)
        U = LU.right(permute=False)
        assert np.allclose(U, np.triu(U))
        assert np.allclose(LU.left() @ LU.right(), A)

    def test_truncated(self):
        A = np.zeros((3, 3))
        A[0, 0] = 1.0
        LU = tci.rrlu(A)
        assert LU.npivot == 1

    def test_approximation(self, rng):
        A = np.array([
            [0.684025, 0.784249, 0.826742, 0.054321, 0.0234695, 0.467096],
            [0.73928, 0.295516, 0.877126, 0.111711, 0.103509, 0.653785],
            [0.394016, 0.753239, 0.889128, 0.291669, 0.873509, 0.0965536],
            [0.378539, 0.0123737, 0.20112, 0.758088, 0.973042, 0.308372],
            [0.235156, 0.51939, 0.788184, 0.363171, 0.230001, 0.984971],
            [0.893223, 0.220834, 0.18001, 0.258537, 0.396583, 0.142105],
            [0.0417881, 0.890706, 0.328631, 0.279332, 0.963188, 0.706944],
            [0.914298, 0.792345, 0.311083, 0.129653, 0.350062, 0.683966],
        ])
        LU = tci.rrlu(A, maxrank=4)
        assert LU.shape == A.shape
        assert len(LU.rowindices()) == 4
        assert len(LU.colindices()) == 4
        L = LU.left(permute=False)
        assert L.shape == (8, 4)
        assert np.allclose(L, np.tril(L))
        U = LU.right(permute=False)
        assert U.shape == (4, 6)
        assert np.allclose(U, np.triu(U))

        A2 = np.hstack([A, A + 1e-3 * rng.random((8, 6))])
        LU = tci.rrlu(A2, reltol=1e-2)
        assert LU.shape == A2.shape
        assert len(LU.rowindices()) < A2.shape[0]
        assert len(LU.colindices()) < A2.shape[1]
        L = LU.left(permute=False)
        assert L.shape[0] == A2.shape[0]
        assert np.allclose(L, np.tril(L))
        U = LU.right(permute=False)
        assert U.shape[1] == A2.shape[1]
        assert np.allclose(U, np.triu(U))
        assert L.shape[1] == U.shape[0]
        assert np.max(np.abs(LU.left() @ LU.right() - A2)) < 1e-2

    def test_exact_lowrank(self):
        p = np.array([
            [0.284975, 0.505168, 0.570921],
            [0.302884, 0.475901, 0.645776],
            [0.622955, 0.361755, 0.99539],
            [0.748447, 0.354849, 0.431366],
            [0.28338, 0.0378148, 0.994162],
            [0.643177, 0.74173, 0.802733],
            [0.58113, 0.526715, 0.879048],
            [0.238002, 0.557812, 0.251512],
            [0.458861, 0.141355, 0.0306212],
            [0.490269, 0.810266, 0.7946],
        ])
        q = np.array([
            [0.239552, 0.306094, 0.299063, 0.0382492, 0.185462, 0.0334971,
             0.697561, 0.389596, 0.105665, 0.0912763],
            [0.0570609, 0.56623, 0.97183, 0.994184, 0.371695, 0.284437,
             0.993251, 0.902347, 0.572944, 0.0531369],
            [0.45002, 0.461168, 0.6086, 0.613702, 0.543997, 0.759954,
             0.0959818, 0.638499, 0.407382, 0.482592],
        ])
        A = p @ q
        lu = tci.rrlu(A)
        assert lu.npivots() == 3
        assert np.allclose(lu.left() @ lu.right(), A)

    def test_lastpivoterror_fullrank(self):
        A = np.eye(2)
        LU1 = tci.rrlu(A)
        assert np.array_equal(LU1.pivoterrors(), [1.0, 1.0, 0.0])
        assert LU1.lastpivoterror() == 0.0

    def test_lastpivoterror_limited(self):
        A = np.array([
            [0.433088, 0.956638, 0.0907974, 0.0447859, 0.0196053],
            [0.855517, 0.782503, 0.291197, 0.540828, 0.358579],
            [0.37455, 0.536457, 0.205479, 0.75896, 0.701206],
            [0.47272, 0.0172539, 0.518177, 0.242864, 0.461635],
            [0.0676373, 0.450878, 0.672335, 0.77726, 0.540691],
        ])
        lu = tci.rrlu(A, maxrank=2)
        assert len(lu.pivoterrors()) == 3
        assert lu.lastpivoterror() > 0

        lu2 = tci.rrlu(A, abstol=0.5)
        assert lu2.lastpivoterror() < 0.5

        lu3 = tci.rrlu(A, abstol=0.0)
        assert lu3.lastpivoterror() == 0.0

    def test_small_values(self):
        A = 1e-13 * np.array([
            [0.585383, 0.124568, 0.352426, 0.573507],
            [0.865875, 0.600153, 0.727443, 0.902388],
            [0.913477, 0.954081, 0.116965, 0.817],
            [0.985918, 0.516114, 0.600366, 0.0200085],
        ])
        lu = tci.rrlu(A, abstol=1e-3)
        assert lu.npivots() == 1
        assert len(lu.pivoterrors()) > 0
        assert lu.lastpivoterror() > 0
        assert lu.shape == A.shape
        assert np.max(np.abs(lu.left() @ lu.right() - A)) < 1e-3

    def test_transpose(self, rng):
        A = rng.random((5, 10))
        tlu = tci.rrlu(A).transpose()
        assert np.allclose(tlu.left() @ tlu.right(), A.T)

    def test_solve(self, rng):
        N, M = 5, 2
        L = np.tril(rng.random((N, N)))
        U = np.triu(rng.random((N, N)))
        b = rng.random((N, M))
        A = L @ U
        lua = tci.rrlu(A)
        assert np.allclose(lua.left() @ lua.right(), A)
        assert np.allclose(A @ tci.lu_solve(lua, b), b)
        assert np.allclose(A @ lua.solve(b), b)

    def test_complex(self, rng):
        A = rng.random((6, 6)) + 1j * rng.random((6, 6))
        lu = tci.rrlu(A)
        assert np.allclose(lu.left() @ lu.right(), A)


class TestEliminationEdgeCases:
    """Regression tests for the round-3 elimination-kernel fixes: rank
    overrun on unpadded power-of-two panels and exactly-zero pivots on
    reltol=abstol=0 'exact' passes."""

    def test_fused_kernel_stops_at_true_rank_unpadded(self, rng):
        # bucket(8) == 8: the column buffer has NO padding, so before the
        # exhaustion fix the fallback pivot re-eliminated an already-
        # pivoted column and the reported rank overran the true rank.
        import jax.numpy as jnp

        from tci_tpu.ops.lu_kernel import _rrlu_while

        A = rng.standard_normal((64, 8))
        out = _rrlu_while(
            jnp.asarray(A), jnp.int32(64), jnp.int32(8), jnp.int32(32),
            jnp.float64(0.0), jnp.float64(0.0), leftorthogonal=True,
        )
        k = int(out[3])
        assert k == 8
        mags = np.asarray(out[4])[:k]
        assert np.all(np.isfinite(mags)) and np.all(mags > 0)

    def test_exact_pass_zero_pivot_stops(self):
        # Exactly rank-1 matrix, reltol=abstol=0: the second pivot is
        # exactly zero; before the fix the kernel divided by zero.
        import jax.numpy as jnp

        from tci_tpu.ops.lu_kernel import _rrlu_while

        A = np.outer([1.0, 2.0, 3.0, 4.0], [2.0, 1.0, 0.5, 0.25])
        out = _rrlu_while(
            jnp.asarray(A), jnp.int32(4), jnp.int32(4), jnp.int32(4),
            jnp.float64(0.0), jnp.float64(0.0), leftorthogonal=True,
        )
        k = int(out[3])
        LU = np.asarray(out[0])
        assert k == 1
        assert np.all(np.isfinite(LU))


class TestRrluRookPublicAPI:
    """rrlu(pivotsearch='rook'): the fused serving rook (arrlu,
    matrixlu.jl:492-569 / :593-611) through the public host-facing API."""

    def test_rook_matches_full_rank_and_reconstructs(self, rng):
        import tci_tpu as tci

        A = rng.standard_normal((300, 48)) @ rng.standard_normal((48, 240))
        full = tci.rrlu(A, reltol=1e-12)
        rook = tci.rrlu(A, maxrank=96, reltol=1e-12, pivotsearch="rook",
                        rng=np.random.default_rng(3))
        assert rook.npivot == full.npivot == 48
        amax = np.abs(A).max()
        assert np.abs(rook.left() @ rook.right() - A).max() < 1e-9 * amax
        # host rrLU contract: triangular factors, true permutations
        k = rook.npivot
        assert np.allclose(np.triu(rook.L[:k, :k], 1), 0)
        assert np.allclose(np.diagonal(rook.L[:k, :k]), 1.0)
        assert sorted(rook.rowpermutation.tolist()) == list(range(300))

    def test_rook_mixed_precision_through_public_api(self, rng):
        import tci_tpu as tci

        r = 20
        A = (rng.standard_normal((256, r)) * np.logspace(0, -9, r)) \
            @ rng.standard_normal((r, 200))
        rook = tci.rrlu(A, maxrank=64, reltol=1e-11, pivotsearch="rook",
                        precision="mixed", rng=np.random.default_rng(5))
        amax = np.abs(A).max()
        rel = np.abs(rook.left() @ rook.right() - A).max() / amax
        assert rook.npivot == r
        assert rel < 1e-9, rel

    def test_rook_mixed_on_f32_input_passthrough(self, rng):
        """precision='mixed' on an f32 matrix must run the plain f32
        passthrough, not raise: the auto hunt_stages default used to pick
        2 without checking the dtype, and rrlu_rook_device_fused rejects
        hunt_stages > 1 on non-f64 inputs."""
        import tci_tpu as tci

        r = 10
        A = (rng.standard_normal((96, r)) @ rng.standard_normal((r, 80))
             ).astype(np.float32)
        rook = tci.rrlu(A, maxrank=32, reltol=1e-5, pivotsearch="rook",
                        precision="mixed", rng=np.random.default_rng(9))
        amax = np.abs(A).max()
        assert rook.npivot == r
        assert np.abs(rook.left() @ rook.right() - A).max() < 1e-4 * amax

    def test_rook_complex_passthrough(self, rng):
        import tci_tpu as tci

        r = 12
        A = (rng.standard_normal((96, r)) + 1j * rng.standard_normal((96, r))) \
            @ (rng.standard_normal((r, 80)) + 1j * rng.standard_normal((r, 80)))
        rook = tci.rrlu(A, maxrank=32, reltol=1e-11, pivotsearch="rook",
                        precision="mixed", rng=np.random.default_rng(7))
        amax = np.abs(A).max()
        assert rook.npivot == r
        assert np.abs(rook.left() @ rook.right() - A).max() < 1e-9 * amax

    def test_rook_rejects_mesh_and_unknown_search(self, rng):
        import pytest

        import tci_tpu as tci

        A = rng.standard_normal((16, 16))
        with pytest.raises(ValueError, match="single-device"):
            tci.rrlu(A, pivotsearch="rook", mesh=object())
        with pytest.raises(ValueError, match="pivot search"):
            tci.rrlu(A, pivotsearch="banana")

    def test_rrlu_serving_export(self, rng):
        """rrlu_serving is the exported device-resident serving entry
        (DeviceRRLU factors stay on device; defer= pipelines batches)."""
        import tci_tpu as tci

        A = rng.standard_normal((128, 16)) @ rng.standard_normal((16, 96))
        pend = [
            tci.rrlu_serving(A, maxrank=32, reltol=1e-12, defer=True,
                             precision="mixed",
                             rng=np.random.default_rng(11 + i))
            for i in range(3)
        ]
        for p in pend:
            lu = p.result()
            assert isinstance(lu, tci.DeviceRRLU)
            assert lu.npivots() == 16
            amax = np.abs(A).max()
            assert np.abs(
                np.asarray(lu.left() @ lu.right()) - A
            ).max() < 1e-9 * amax


@pytest.mark.parametrize("placement", ["cpu", "default"])
def test_rrlu_raw_f32_panel_takes_xla_route(monkeypatch, placement):
    """A float32 panel runs the same XLA elimination (_rrlu_while, in
    float64) as its float64 copy, on either placement, and agrees with it
    within float32 resolution."""
    from tci_tpu.ops import lu_kernel

    monkeypatch.setattr(lu_kernel, "HOST_RRLU_BACKEND", placement)
    dtypes = []
    kernel = lu_kernel._rrlu_while

    def counted(A, *args, **kwargs):
        dtypes.append(A.dtype)
        return kernel(A, *args, **kwargs)

    monkeypatch.setattr(lu_kernel, "_rrlu_while", counted)
    rng = np.random.default_rng(3)
    A = (rng.standard_normal((40, 6)) @ rng.standard_normal((6, 30))).astype(
        np.float32)
    out32 = lu_kernel.rrlu_raw(A, 20, 1e-5, 0.0, True)
    out64 = lu_kernel.rrlu_raw(A.astype(np.float64), 20, 1e-5, 0.0, True)
    assert dtypes == [np.float64, np.float64]
    assert out32[3] == out64[3] == 6
    np.testing.assert_array_equal(out32[1], out64[1])
    np.testing.assert_array_equal(out32[2], out64[2])
    amax = float(np.abs(A).max())
    np.testing.assert_allclose(out32[0], out64[0], rtol=0,
                               atol=1e-6 * amax)
