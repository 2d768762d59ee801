"""Plain XLA complete-pivot elimination (ops/lu_kernel._rrlu_while) on small
square panels, on JAX's default device and on the host CPU backend.

These are the times a hand-written GPU rrLU would have to beat. Each panel is
a random full-rank edge×edge matrix factorized to all `edge` pivots
(reltol = abstol = 0), in float32 and in float64; each time is the median of
`--reps` warm runs ending in ``block_until_ready``.

    python benchmarks/bench_rrlu_raw.py [--reps 5] [--trace DIR]

``--trace DIR`` also records a ``jax.profiler`` trace of one warm 256² float64
elimination on the default device and prints, from the device's events:
kernels per pivot step, every memcpy event by name with the device-to-host
copies counted apart, the summed kernel time, and the span from the first to
the last device event. Prints one JSON line per (device, dtype, edge) and,
with --trace, one line of trace counts.
"""

import json
import os
import sys
import time

import numpy as np

EDGES = (128, 256, 512)


def _args(A):
    import jax.numpy as jnp

    n = A.shape[0]
    return (A, jnp.int32(n), jnp.int32(n), jnp.int32(n), jnp.float64(0.0),
            jnp.float64(0.0))


def time_elimination(device, dtype, edge, reps):
    import jax

    from tci_tpu.ops.lu_kernel import _rrlu_while

    A = np.random.default_rng(edge).standard_normal((edge, edge))
    with jax.default_device(device):
        args = _args(jax.device_put(A.astype(dtype), device))
        out = jax.block_until_ready(_rrlu_while(*args, leftorthogonal=True))
        walls = []
        for _ in range(reps):
            t0 = time.perf_counter()
            out = jax.block_until_ready(
                _rrlu_while(*args, leftorthogonal=True))
            walls.append(time.perf_counter() - t0)
    return dict(device=device.platform, kind=device.device_kind,
                dtype=np.dtype(dtype).name, edge=edge, npivots=int(out[3]),
                median_s=float(np.median(walls)), min_s=float(min(walls)),
                reps=reps)


def trace_counts(trace_dir, edge=256):
    """Device events of one warm float64 elimination, from its trace."""
    import glob

    import jax

    from tci_tpu.ops.lu_kernel import _rrlu_while

    A = np.random.default_rng(edge).standard_normal((edge, edge))
    args = _args(jax.device_put(A))
    jax.block_until_ready(_rrlu_while(*args, leftorthogonal=True))
    jax.profiler.start_trace(trace_dir)
    jax.block_until_ready(_rrlu_while(*args, leftorthogonal=True))
    jax.profiler.stop_trace()
    path = sorted(glob.glob(os.path.join(trace_dir, "plugins", "profile",
                                         "*", "*.xplane.pb")))[-1]
    data = jax.profiler.ProfileData.from_file(path)
    kernels, copies, busy_ns = {}, {}, 0
    first, last = None, None
    for plane in data.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            for ev in line.events:
                first = ev.start_ns if first is None else min(first,
                                                              ev.start_ns)
                last = ev.end_ns if last is None else max(last, ev.end_ns)
                if "memcpy" in ev.name.lower():
                    copies[ev.name] = copies.get(ev.name, 0) + 1
                elif line.name.startswith("Stream") or "Kernel" in line.name:
                    kernels[ev.name] = kernels.get(ev.name, 0) + 1
                    busy_ns += ev.duration_ns
    d2h = sum(n for name, n in copies.items()
              if any(t in name.lower() for t in ("d2h", "dtoh")))
    nkern = sum(kernels.values())
    span_s = None if first is None else (last - first) * 1e-9
    return dict(trace=path, edge=edge, pivots=edge, kernel_events=nkern,
                kernels_per_pivot=nkern / edge, copies_by_name=copies,
                d2h_copies=d2h, d2h_per_pivot=d2h / edge,
                kernel_busy_s=busy_ns * 1e-9,
                device_span_s=span_s,
                kernel_busy_share=None if not span_s
                else busy_ns * 1e-9 / span_s,
                top_kernels=sorted(kernels.items(),
                                   key=lambda kv: -kv[1])[:8])


def main(argv):
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import jax

    from tci_tpu.utils.compile_cache import setup_compile_cache

    setup_compile_cache()
    reps = int(argv[argv.index("--reps") + 1]) if "--reps" in argv else 5
    devices = [jax.devices()[0]]
    if devices[0].platform != "cpu":
        devices.append(jax.devices("cpu")[0])
    for dev in devices:
        for dtype in (np.float32, np.float64):
            for edge in EDGES:
                print(json.dumps(time_elimination(dev, dtype, edge, reps)),
                      flush=True)
    if "--trace" in argv:
        print(json.dumps(trace_counts(argv[argv.index("--trace") + 1])),
              flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
