"""Device-resident zip-up contraction (models/contraction_device.py) vs the
host zip-up (reference: src/contraction.jl:751-788) on the virtual CPU mesh."""

import numpy as np
import pytest

from tci_tpu.models.contraction import contract, contract_zipup
from tci_tpu.models.tensortrain import TensorTrain, fulltensor


def _rand_mpo(rng, L, chi, d1, d2):
    bonds = [1] + [chi] * (L - 1) + [1]
    return TensorTrain(
        [
            rng.standard_normal((bonds[n], d1, d2, bonds[n + 1]))
            for n in range(L)
        ]
    )


def _lowrank_mpo(rng, L, chi, d1, d2, r):
    bonds = [1] + [chi] * (L - 1) + [1]
    ts = []
    for n in range(L):
        u = rng.standard_normal((bonds[n], d1, d2, r))
        v = rng.standard_normal((r, bonds[n + 1]))
        ts.append((u @ v) / np.sqrt(r))
    return TensorTrain(ts)


def test_device_zipup_matches_host(rng):
    A = _rand_mpo(rng, 5, 4, 3, 3)
    B = _rand_mpo(rng, 5, 5, 3, 2)
    host = contract_zipup(A, B, tolerance=1e-10, method="LU")
    dev = contract_zipup(A, B, tolerance=1e-10, method="LU", jax_native=True)
    assert host.linkdims() == dev.linkdims()
    fh, fd = fulltensor(host), fulltensor(dev)
    assert np.allclose(fh, fd, atol=1e-9 * np.abs(fh).max())
    # and both reproduce the exact product
    exact = fulltensor(contract(A, B, algorithm="naive"))
    assert np.allclose(fd, exact, atol=1e-9 * np.abs(exact).max())


def test_device_zipup_maxbonddim_matches_host(rng):
    A = _rand_mpo(rng, 5, 4, 3, 3)
    B = _rand_mpo(rng, 5, 5, 3, 2)
    host = contract_zipup(A, B, tolerance=1e-10, method="LU", maxbonddim=6)
    dev = contract_zipup(
        A, B, tolerance=1e-10, method="LU", maxbonddim=6, jax_native=True
    )
    assert host.linkdims() == dev.linkdims() == [6, 6, 6, 6]
    fh, fd = fulltensor(host), fulltensor(dev)
    assert np.allclose(fh, fd, atol=1e-9 * np.abs(fh).max())


def test_device_zipup_tolerance_truncates(rng):
    A = _lowrank_mpo(rng, 5, 8, 3, 3, 2)
    B = _lowrank_mpo(rng, 5, 8, 3, 2, 2)
    host = contract_zipup(A, B, tolerance=1e-8, method="LU")
    dev = contract_zipup(A, B, tolerance=1e-8, method="LU", jax_native=True)
    assert dev.linkdims() == host.linkdims()
    assert max(dev.linkdims()) < 64  # genuinely truncated
    fh, fd = fulltensor(host), fulltensor(dev)
    assert np.allclose(fh, fd, atol=1e-7 * np.abs(fh).max())


def test_device_zipup_via_contract_mps(rng):
    B = _rand_mpo(rng, 4, 5, 3, 2)
    mps = TensorTrain(
        [
            rng.standard_normal((b1, 2, b2))
            for b1, b2 in zip([1, 3, 3, 3], [3, 3, 3, 1])
        ]
    )
    c_host = contract(B, mps, algorithm="zipup", method="LU", tolerance=1e-10)
    c_dev = contract(
        B, mps, algorithm="zipup", method="LU", tolerance=1e-10,
        jax_native=True,
    )
    assert all(t.ndim == 3 for t in c_dev.sitetensors())
    assert np.allclose(fulltensor(c_host), fulltensor(c_dev), atol=1e-8)


def test_device_zipup_rejects_nonlu(rng):
    A = _rand_mpo(rng, 3, 2, 2, 2)
    B = _rand_mpo(rng, 3, 2, 2, 2)
    with pytest.raises(ValueError, match="method='LU'"):
        contract_zipup(A, B, method="SVD", jax_native=True)


def _rand_cmpo(rng, L, chi, d1, d2):
    bonds = [1] + [chi] * (L - 1) + [1]
    return TensorTrain(
        [
            rng.standard_normal((bonds[n], d1, d2, bonds[n + 1]))
            + 1j * rng.standard_normal((bonds[n], d1, d2, bonds[n + 1]))
            for n in range(L)
        ]
    )


def test_device_zipup_complex_pair_matches_host(rng):
    """Complex zip-up runs the (re, im) f64 pair programs on device and
    matches the host LU zip-up (same truncation rule)."""
    A = _rand_cmpo(rng, 4, 3, 2, 2)
    B = _rand_cmpo(rng, 4, 3, 2, 2)
    host = contract_zipup(A, B, tolerance=1e-10, method="LU")
    dev = contract_zipup(A, B, tolerance=1e-10, method="LU", jax_native=True)
    assert host.linkdims() == dev.linkdims()
    fh, fd = fulltensor(host), fulltensor(dev)
    assert np.allclose(fh, fd, atol=1e-9 * np.abs(fh).max())
    exact = fulltensor(contract(A, B, algorithm="naive"))
    assert np.allclose(fd, exact, atol=1e-9 * np.abs(exact).max())


def test_device_zipup_complex_pair_truncates(rng):
    A = _rand_cmpo(rng, 4, 4, 2, 2)
    B = _rand_cmpo(rng, 4, 4, 2, 2)
    host = contract_zipup(A, B, tolerance=1e-10, method="LU", maxbonddim=5)
    dev = contract_zipup(A, B, tolerance=1e-10, method="LU", maxbonddim=5,
                         jax_native=True)
    assert host.linkdims() == dev.linkdims()
    assert max(dev.linkdims()) <= 5
    assert np.allclose(fulltensor(host), fulltensor(dev),
                       atol=1e-8 * np.abs(fulltensor(host)).max())


# -- device naive contraction (einsum merge + device LU compress) ------------


def test_device_naive_exact_product(rng):
    A = _rand_mpo(rng, 4, 3, 3, 3)
    B = _rand_mpo(rng, 4, 4, 3, 2)
    exact = fulltensor(contract(A, B, algorithm="naive"))
    dev = contract(A, B, algorithm="naive", jax_native=True)
    assert np.allclose(fulltensor(dev), exact, atol=1e-10 * np.abs(exact).max())


def test_device_naive_compress_truncates(rng):
    A = _lowrank_mpo(rng, 5, 8, 3, 3, 2)
    B = _lowrank_mpo(rng, 5, 8, 3, 2, 2)
    exact = fulltensor(contract(A, B, algorithm="naive"))
    dev = contract(A, B, algorithm="naive", tolerance=1e-8, jax_native=True)
    # exact product rank is <= 4 per bond (2x2 low-rank factors)
    assert max(dev.linkdims()) <= 8
    assert np.allclose(fulltensor(dev), exact, atol=1e-6 * np.abs(exact).max())


def test_device_naive_maxbonddim(rng):
    A = _rand_mpo(rng, 4, 3, 3, 3)
    B = _rand_mpo(rng, 4, 3, 3, 2)
    dev = contract(
        A, B, algorithm="naive", tolerance=1e-12, maxbonddim=5,
        jax_native=True,
    )
    assert max(dev.linkdims()) <= 5


def test_device_naive_complex_promotes_mixed(rng):
    """A complex x real pair routes through the pair path (result_type)."""
    A = _rand_mpo(rng, 3, 2, 2, 2)
    B = _rand_mpo(rng, 3, 2, 2, 2)
    Ac = TensorTrain([t.astype(np.complex128) * (1 + 0.5j)
                      for t in A.sitetensors()])
    exact = fulltensor(contract(Ac, B, algorithm="naive"))
    dev = contract(Ac, B, algorithm="naive", jax_native=True)
    assert np.allclose(fulltensor(dev), exact,
                       atol=1e-10 * np.abs(exact).max())


# -- device TCI contraction (product evaluator on device) --------------------


def test_product_evaluator_matches_contraction(rng):
    from tci_tpu.models.contraction import Contraction
    from tci_tpu.models.contraction_device import make_product_evaluator

    import jax.numpy as jnp

    A = _rand_mpo(rng, 5, 4, 3, 3)
    B = _rand_mpo(rng, 5, 5, 3, 2)
    fjax, localdims, dtype, pair = make_product_evaluator(A, B)
    prod = Contraction(A, B)
    assert pair is False
    assert localdims == [6, 6, 6, 6, 6]  # d1_A * d2_B = 3 * 2
    for _ in range(20):
        idx = [int(rng.integers(0, d)) for d in localdims]
        got = float(fjax(jnp.asarray(idx, dtype=jnp.int32)))
        want = float(prod.evaluate_single(idx))
        assert abs(got - want) < 1e-10 * max(1.0, abs(want))


def test_product_evaluator_postmap(rng):
    from tci_tpu.models.contraction import Contraction
    from tci_tpu.models.contraction_device import make_product_evaluator

    import jax.numpy as jnp

    A = _rand_mpo(rng, 4, 3, 2, 2)
    B = _rand_mpo(rng, 4, 3, 2, 2)
    fjax, localdims, _, _ = make_product_evaluator(A, B, f=lambda x: 2.0 * x)
    prod = Contraction(A, B, f=lambda x: 2.0 * x)
    idx = [1, 0, 3, 2]
    got = float(fjax(jnp.asarray(idx, dtype=jnp.int32)))
    assert abs(got - float(prod.evaluate_single(idx))) < 1e-10


def test_device_tci_contraction_matches_host(rng):
    A = _lowrank_mpo(rng, 5, 6, 3, 3, 2)
    B = _lowrank_mpo(rng, 5, 6, 3, 2, 2)
    exact = fulltensor(contract(A, B, algorithm="naive"))
    dev = contract(
        A, B, algorithm="TCI", tolerance=1e-10, jax_native=True,
        rng=np.random.default_rng(7),
    )
    assert np.allclose(fulltensor(dev), exact, atol=1e-7 * np.abs(exact).max())


@pytest.mark.slow
def test_device_tci_contraction_mps(rng):
    B = _lowrank_mpo(rng, 4, 5, 3, 2, 2)
    mps = TensorTrain(
        [
            rng.standard_normal((b1, 2, b2))
            for b1, b2 in zip([1, 3, 3, 3], [3, 3, 3, 1])
        ]
    )
    host = contract(B, mps, algorithm="TCI", tolerance=1e-10,
                    rng=np.random.default_rng(3))
    dev = contract(B, mps, algorithm="TCI", tolerance=1e-10, jax_native=True,
                   rng=np.random.default_rng(3))
    assert all(t.ndim == 3 for t in dev.sitetensors())
    assert np.allclose(fulltensor(host), fulltensor(dev), atol=1e-8)


def test_device_tci_contraction_complex(rng):
    """Complex MPOs flow through the device product evaluator natively on
    complex-capable backends (CPU, GPU); on a complex-free backend
    make_product_evaluator auto-selects the (re, im) pair representation
    instead (next tests)."""
    def cmpo(L, chi, d1, d2):
        b = [1] + [chi] * (L - 1) + [1]
        return TensorTrain(
            [
                rng.standard_normal((b[n], d1, d2, b[n + 1]))
                + 1j * rng.standard_normal((b[n], d1, d2, b[n + 1]))
                for n in range(L)
            ]
        )

    A, B = cmpo(4, 3, 2, 2), cmpo(4, 3, 2, 2)
    exact = fulltensor(contract(A, B, algorithm="naive"))
    dev = fulltensor(
        contract(A, B, algorithm="TCI", tolerance=1e-10, jax_native=True,
                 rng=np.random.default_rng(3))
    )
    assert np.allclose(dev, exact, atol=1e-7 * np.abs(exact).max())


def test_device_naive_complex_pair_matches_exact(rng):
    """Complex naive contraction runs the (re, im) pair merge + pair LU
    compression on device."""
    A = _rand_cmpo(rng, 4, 3, 2, 2)
    B = _rand_cmpo(rng, 4, 3, 2, 2)
    exact = fulltensor(contract(A, B, algorithm="naive"))
    dev = contract(A, B, algorithm="naive", jax_native=True)
    assert np.allclose(fulltensor(dev), exact,
                       atol=1e-10 * np.abs(exact).max())
    devc = contract(A, B, algorithm="naive", tolerance=1e-10, jax_native=True)
    assert np.allclose(fulltensor(devc), exact,
                       atol=1e-7 * np.abs(exact).max())
    devm = contract(A, B, algorithm="naive", tolerance=1e-12, maxbonddim=5,
                    jax_native=True)
    assert max(devm.linkdims()) <= 5


def test_device_naive_rank_deficient_no_nan(rng):
    """Exactly rank-deficient Kronecker merges (duplicated bond channels)
    previously hit a zero pivot in the reltol=abstol=0 exact pass and
    returned all-NaN (round-2 advisor finding)."""
    A = _rand_mpo(rng, 4, 2, 3, 3)
    # duplicate a bond channel so intermediate merges are exactly singular
    site = np.asarray(A.sitetensors()[1])
    site[..., 1] = site[..., 0]
    core = [np.asarray(t) for t in A.sitetensors()]
    core[1] = site
    nxt = np.asarray(core[2])
    nxt[1, ...] = nxt[0, ...]
    core[2] = nxt
    A = TensorTrain(core)
    B = _rand_mpo(rng, 4, 3, 3, 2)
    exact = fulltensor(contract(A, B, algorithm="naive"))
    dev = contract(A, B, algorithm="naive", jax_native=True)
    out = fulltensor(dev)
    assert np.all(np.isfinite(out))
    assert np.allclose(out, exact, atol=1e-8 * max(1.0, np.abs(exact).max()))


def test_product_evaluator_pair_mode(rng):
    """pair=True (what a complex-free backend auto-selects) must equal the
    complex evaluator value-for-value: stack([re, im]) == complex."""
    from tci_tpu.models.contraction_device import make_product_evaluator

    import jax.numpy as jnp

    A = _rand_cmpo(rng, 4, 3, 2, 2)
    B = _rand_cmpo(rng, 4, 4, 2, 3)
    fc, localdims, dtype, pc = make_product_evaluator(A, B)
    fp, localdims_p, dtype_p, pp = make_product_evaluator(A, B, pair=True)
    assert pc is False and pp is True
    assert localdims_p == localdims and dtype_p == dtype
    for _ in range(12):
        idx = jnp.asarray(
            [int(rng.integers(0, d)) for d in localdims], dtype=jnp.int32
        )
        want = complex(fc(idx))
        got = np.asarray(fp(idx))
        assert got.shape == (2,) and got.dtype == np.float64
        assert abs(complex(got[0], got[1]) - want) < 1e-12 * max(
            1.0, abs(want)
        )


def test_product_evaluator_pair_postmap(rng):
    """A pair-mode post-map receives/returns the stacked [re, im] vector;
    here f = multiply by 2j expressed in pair arithmetic."""
    from tci_tpu.models.contraction_device import make_product_evaluator

    import jax.numpy as jnp

    A = _rand_cmpo(rng, 3, 2, 2, 2)
    B = _rand_cmpo(rng, 3, 2, 2, 2)
    fc, localdims, _, _ = make_product_evaluator(A, B, f=lambda z: 2j * z)
    fp, _, _, _ = make_product_evaluator(
        A, B, pair=True,
        f=lambda p: jnp.stack([-2.0 * p[1], 2.0 * p[0]]),
    )
    idx = jnp.asarray([1, 0, 2], dtype=jnp.int32)
    want = complex(fc(idx))
    got = np.asarray(fp(idx))
    assert abs(complex(got[0], got[1]) - want) < 1e-12


@pytest.mark.slow
def test_device_tci_contraction_complex_pair(monkeypatch, rng):
    """End-to-end contract(..., algorithm='TCI', jax_native=True) on a
    complex-free backend: platform_supports_complex is forced False, so the
    product evaluator auto-selects pair mode and TCI2 runs the (re, im)
    pair device tiers. Result must match the exact product."""
    import jax

    import tci_tpu.parallel.batcheval as be

    monkeypatch.setattr(be, "_COMPLEX_SUPPORT_CACHE",
                        {jax.default_backend(): False})
    A = _rand_cmpo(rng, 4, 3, 2, 2)
    B = _rand_cmpo(rng, 4, 3, 2, 2)
    exact = fulltensor(contract(A, B, algorithm="naive"))
    dev = contract(A, B, algorithm="TCI", tolerance=1e-10, jax_native=True,
                   rng=np.random.default_rng(5))
    assert np.allclose(fulltensor(dev), exact,
                       atol=1e-7 * np.abs(exact).max())


def test_product_evaluator_auto_pair_rejects_complex_postmap(monkeypatch, rng):
    """Auto-selected pair mode (complex operands, complex-free backend) with
    a user post-map must raise: a complex-scalar f would silently be applied
    to the stacked [re, im] vector (wrong values, backend-dependent).
    Explicit pair=True asserts the f is pair-aware and stays allowed."""
    import tci_tpu.models.contraction_device as cd
    from tci_tpu.parallel import batcheval

    A = _rand_cmpo(rng, 3, 2, 2, 2)
    B = _rand_cmpo(rng, 3, 2, 2, 2)
    monkeypatch.setattr(batcheval, "platform_supports_complex", lambda: False)
    with pytest.raises(ValueError, match="pair-aware"):
        cd.make_product_evaluator(A, B, f=lambda z: z ** 2)
    # explicit opt-in still works
    fp, localdims, dtype, pair = cd.make_product_evaluator(
        A, B, pair=True, f=lambda p: p
    )
    assert pair is True
