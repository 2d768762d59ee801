"""Headline benchmark: TCI2 of the 8-D Lorentzian (BASELINE.json config 1) on
JAX's default device, then configs 2-5 through benchmarks/bench_*.py.

Config 1 runs crossinterpolate2 on f(v) = 1/(1 + v·v), v ∈ {1..10}^8,
tolerance 1e-8 — the reference README quickstart — with sampling batched
through JaxBatchEvaluator. Metric: f-evaluations/second over a whole
optimization, median of 3 warm runs after one cold run (compile included,
reported as cold_wall_s). vs_baseline compares with the reference-style
scalar sampling loop (one Python call per sample, median of 3).

Every result line names the device (platform, device_kind, count) and the
card (nvidia-smi name and power limit). The full payload goes to
bench_detail.json and an early stdout line; the last line is one compact
JSON object. The script exits non-zero when JAX's default platform is not a
GPU or when any config fails.
"""

import io
import json
import os
import subprocess
import sys
import time
from contextlib import redirect_stdout

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))


def _card():
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60).stdout.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi failed: {e}"


def _capture_json(fn, **kwargs):
    """Run a benchmarks/bench_*.py main() and return its last JSON line.
    An exception marks the config failed."""
    buf = io.StringIO()
    try:
        with redirect_stdout(buf):
            fn(**kwargs)
    except Exception as e:  # noqa: BLE001 - recorded, fails the run
        return {"error": f"{type(e).__name__}: {e}"}
    for line in reversed(buf.getvalue().splitlines()):
        try:
            return json.loads(line)
        except json.JSONDecodeError:
            continue
    return {"error": "no JSON line in output"}


def config1(tci, JaxBatchEvaluator):
    import jax.numpy as jnp

    from tci_tpu.parallel.batcheval import _batchevaluate_dispatch

    localdims = [10] * 8

    def fjax(idx):
        v = idx.astype(jnp.float64) + 1.0
        return 1.0 / (1.0 + jnp.sum(v * v))

    def fpy(x):
        v = np.asarray(x, dtype=float) + 1.0
        return 1.0 / (1.0 + v @ v)

    # baseline: scalar per-call evaluation rate (reference-style loop)
    Iset = [(i % 10, (i // 10) % 10, i % 7) for i in range(40)]
    Jset = [(i % 10, i % 3, i % 5, i % 2) for i in range(50)]
    base_rates = []
    for _ in range(3):
        t0 = time.perf_counter()
        _batchevaluate_dispatch(np.float64, fpy, localdims, Iset, Jset, 1)
        base_rates.append(len(Iset) * 10 * len(Jset)
                          / (time.perf_counter() - t0))
    base_rate = float(np.median(base_rates))

    bf = JaxBatchEvaluator(fjax, localdims, dtype=np.float64)
    kw = dict(tolerance=1e-8)
    t0 = time.perf_counter()
    tci.crossinterpolate2(np.float64, bf, localdims, **kw)
    cold_wall = time.perf_counter() - t0
    walls, nevals = [], []
    for _ in range(3):
        n0 = bf.nevals
        t0 = time.perf_counter()
        tciobj, ranks, errors = tci.crossinterpolate2(
            np.float64, bf, localdims, **kw)
        walls.append(time.perf_counter() - t0)
        nevals.append(bf.nevals - n0)
    rate = float(np.median([n / w for n, w in zip(nevals, walls)]))

    pt = (1, 2, 3, 4, 5, 4, 3, 2)
    pointwise = abs(tciobj(pt) - fpy(pt))
    if not (errors[-1] < 1e-8 and pointwise < 1e-7):
        raise AssertionError(f"config 1 inaccurate: error {errors[-1]}, "
                             f"pointwise {pointwise}")

    rookkw = dict(tolerance=1e-8, pivotsearch="rook")
    tci.crossinterpolate2(np.float64, bf, localdims,
                          rng=np.random.default_rng(0), **rookkw)
    n0 = bf.nevals
    t0 = time.perf_counter()
    rookobj, _, rookerrors = tci.crossinterpolate2(
        np.float64, bf, localdims, rng=np.random.default_rng(0), **rookkw)
    rook_wall = time.perf_counter() - t0
    return {
        "metric": "tci2_8d_lorentzian_fevals_per_sec",
        "value": rate,
        "unit": "evals/s",
        "vs_baseline": rate / base_rate,
        "detail": {
            "baseline_kind": "python-scalar-proxy",
            "baseline_scalar_evals_per_sec": base_rate,
            "rank": int(tciobj.rank()),
            "final_error": float(errors[-1]),
            "wall_s": float(np.median(walls)),
            "wall_s_reps": walls,
            "cold_wall_s": cold_wall,
            "nevals": int(np.median(nevals)),
            "rook": {
                "wall_s": rook_wall,
                "nevals": int(bf.nevals - n0),
                "final_error": float(rookerrors[-1]),
                "rank": int(rookobj.rank()),
            },
        },
    }


def main(argv) -> int:
    import jax

    dev = jax.devices()[0]
    device = {"platform": dev.platform, "kind": dev.device_kind,
              "count": len(jax.devices())}
    if dev.platform != "gpu":
        print(json.dumps({"error": f"default platform is {dev.platform}, "
                                   "not gpu", "device": device}))
        return 1

    sys.path.insert(0, os.path.join(_HERE, "benchmarks"))
    import bench_feynman
    import bench_integration
    import bench_quantics
    import bench_rrlu

    import tci_tpu as tci
    from tci_tpu.parallel.batcheval import JaxBatchEvaluator
    from tci_tpu.utils.compile_cache import setup_compile_cache

    setup_compile_cache()
    card = _card()
    results = {}
    try:
        results["config1_lorentzian_8d"] = config1(tci, JaxBatchEvaluator)
    except Exception as e:  # noqa: BLE001 - recorded, fails the run
        results["config1_lorentzian_8d"] = {"error": f"{type(e).__name__}: "
                                                     f"{e}"}
    if "--config1-only" not in argv:
        for name, fn, kw in (
            ("config3_quantics_r40", bench_quantics.main, {}),
            ("config5_feynman_complex", bench_feynman.main, {}),
            ("config4_integration_10d_device", bench_integration.main,
             {"jax_native": True}),
            ("config2_rrlu_4096", bench_rrlu.main, {}),
        ):
            results[name] = _capture_json(fn, **kw)

    failed = [k for k, v in results.items() if "error" in v]
    head = results["config1_lorentzian_8d"]
    full = {"device": device, "card": card, "results": results,
            "failed": failed}
    with open(os.path.join(_HERE, "bench_detail.json"), "w") as fh:
        json.dump(full, fh, indent=1)
    print(json.dumps(full), flush=True)
    print(json.dumps({
        "metric": head.get("metric"),
        "value": head.get("value"),
        "unit": head.get("unit"),
        "vs_baseline": head.get("vs_baseline"),
        "device": device,
        "card": card,
        "detail": {name: {k: r.get(k) for k in
                          ("metric", "value", "unit", "error") if k in r}
                   for name, r in results.items()},
    }))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
