"""MPO × MPO contraction with all three algorithms (contraction.jl).

Builds two random MPOs, contracts them with :naive (exact Kronecker merge
then compression), :zipup (streaming contract+factorize) and :TCI (the
product treated as a lazy function and re-cross-interpolated), and checks
all three against the dense matrix product. jax_native=True moves each
algorithm onto device programs.
"""

import _common  # noqa: F401  (repo root on sys.path)

import numpy as np

import tci_tpu as tci
from tci_tpu.models.tensortrain import TensorTrain, fulltensor

rng = np.random.default_rng(42)
L = 5


def rand_mpo(chi, d1, d2):
    bonds = [1] + [chi] * (L - 1) + [1]
    return TensorTrain([
        rng.standard_normal((bonds[n], d1, d2, bonds[n + 1])) / np.sqrt(chi)
        for n in range(L)
    ])


A = rand_mpo(4, 2, 3)
B = rand_mpo(3, 3, 2)

# dense oracle: flatten the MPOs to matrices and multiply
fA = fulltensor(A).transpose(
    [2 * i for i in range(L)] + [2 * i + 1 for i in range(L)]
).reshape(2**L, 3**L)
fB = fulltensor(B).transpose(
    [2 * i for i in range(L)] + [2 * i + 1 for i in range(L)]
).reshape(3**L, 2**L)
dense = fA @ fB

for algorithm in ("naive", "zipup", "TCI"):
    for jax_native in (False, True):
        C = tci.contract(
            A, B, algorithm=algorithm, tolerance=1e-10, method="LU",
            jax_native=jax_native,
        )
        fC = fulltensor(C).transpose(
            [2 * i for i in range(L)] + [2 * i + 1 for i in range(L)]
        ).reshape(2**L, 2**L)
        err = np.abs(fC - dense).max() / np.abs(dense).max()
        tier = "device" if jax_native else "host"
        print(f"{algorithm:6s} ({tier:6s}): link dims {C.linkdims()}, "
              f"rel err {err:.2e}")
        assert err < 1e-7
print("ok")
