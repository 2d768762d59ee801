"""Checkpoint / resume a TCI2 optimization (utils/checkpoint.py).

The reference keeps its state in the Julia session; here the full TCI2
state (index sets, site tensors, error bookkeeping) serializes to one .npz
and `optimize` on the restored object resumes sweeping — run a coarse pass,
save, reload later, and refine to a tighter tolerance.
"""

import _common  # noqa: F401  (repo root on sys.path)

import os
import tempfile

import numpy as np

import tci_tpu as tci
from tci_tpu.utils.checkpoint import load_tci2, save_tci2

localdims = [6] * 6


def f(v):
    v = np.asarray(v, dtype=float) + 1.0
    return 1.0 / (1.0 + v @ v)


# coarse pass
t, ranks, errors = tci.crossinterpolate2(
    np.float64, f, localdims, tolerance=1e-4
)
print(f"coarse: rank {t.rank()}, error {errors[-1]:.2e}")

path = os.path.join(tempfile.mkdtemp(), "tci2_checkpoint.npz")
save_tci2(path, t)
print(f"saved -> {path} ({os.path.getsize(path):,} bytes)")

# ... later / elsewhere: reload and refine
t2 = load_tci2(path)
assert t2.Iset == t.Iset and t2.Jset == t.Jset
ranks2, errors2 = t2.optimize(f, tolerance=1e-10)
print(f"resumed: rank {t2.rank()}, error {errors2[-1]:.2e}")

pt = (1, 2, 3, 0, 2, 1)
assert abs(t2(pt) - f(pt)) < 1e-9
assert t2.rank() >= t.rank()
print("ok")
