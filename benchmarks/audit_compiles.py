"""Cold-compile audit: which XLA programs dominate each config's cold wall?

A first-time user pays the compiles of every bucketed program a BASELINE
config needs. This tool counts them:

    python benchmarks/audit_compiles.py <config> [--cpu]

config ∈ {1, 2, 3, 4, 5}. Runs that config ONCE with the persistent
compilation cache disabled and `jax_log_compiles` on, capturing every
"Finished XLA compilation of <name> in <t> sec" record, and prints one
JSON line: {config, total_wall_s, n_programs, compile_s_total, top:
[{name, count, total_s}...]}. Compile names are aggregated by jit-name
(the shape-bucket suffix stripped), so "the while-sweep engine compiled 9
buckets x 4 s" reads directly off the table.
"""

from __future__ import annotations

import json
import logging
import re
import sys
import time
from collections import defaultdict

_FIN = re.compile(
    r"Finished XLA compilation of (.+?) in ([0-9.eE+-]+) sec")


class _Capture(logging.Handler):
    def __init__(self):
        super().__init__(level=logging.DEBUG)
        self.events = []

    def emit(self, record):
        m = _FIN.search(record.getMessage())
        if m:
            self.events.append((m.group(1), float(m.group(2))))


def _run_config(cfg: str):
    if cfg == "1":
        # config-1 optimization loop exactly as bench.py drives it
        import jax.numpy as jnp
        import numpy as np

        import tci_tpu as tci
        from tci_tpu.parallel.batcheval import JaxBatchEvaluator

        localdims = [10] * 8

        def fjax(idx):
            v = idx.astype(jnp.float64) + 1.0
            return 1.0 / (1.0 + jnp.sum(v * v))

        bf = JaxBatchEvaluator(fjax, localdims, dtype=np.float64)
        tci.crossinterpolate2(np.float64, bf, localdims, tolerance=1e-8)
    elif cfg == "2":
        import bench_rrlu

        bench_rrlu.main()
    elif cfg == "3":
        import bench_quantics

        bench_quantics.main()
    elif cfg == "4":
        import bench_integration

        bench_integration.main(jax_native=True)
    elif cfg == "5":
        import bench_feynman

        bench_feynman.main()
    else:
        raise SystemExit(f"unknown config {cfg!r}")


def main():
    import _common  # noqa: F401  (repo root + benchmarks on sys.path)

    cfg = sys.argv[1] if len(sys.argv) > 1 else "1"
    import jax

    if "--cpu" in sys.argv:
        jax.config.update("jax_platforms", "cpu")
    # no persistent cache: this measures the true first-user cold path
    jax.config.update("jax_enable_compilation_cache", False)
    jax.config.update("jax_log_compiles", True)
    cap = _Capture()
    logging.getLogger("jax").addHandler(cap)
    logging.getLogger("jax").setLevel(logging.DEBUG)
    # route jax's own stream noise away from stdout (keep the JSON line
    # machine-readable)
    import contextlib
    import io

    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        _run_config(cfg)
    wall = time.perf_counter() - t0

    agg = defaultdict(lambda: [0, 0.0])
    for name, secs in cap.events:
        # aggregate shape buckets of the same program: strip trailing
        # digit groups jax appends to distinguish re-lowerings
        key = re.sub(r"[0-9]+", "#", name)
        agg[key][0] += 1
        agg[key][1] += secs
    top = sorted(
        ({"name": k, "count": c, "total_s": round(s, 2)}
         for k, (c, s) in agg.items()),
        key=lambda r: -r["total_s"],
    )
    print(json.dumps({
        "config": cfg,
        "platform": str(jax.devices()[0]),
        "cold_wall_s": round(wall, 1),
        "n_compiles": len(cap.events),
        "compile_s_total": round(sum(s for _, s in cap.events), 1),
        "top": top[:12],
    }))


if __name__ == "__main__":
    main()
