"""Smoke check: tci_tpu's device tiers on an NVIDIA GPU, each compared with
the plain host reference.

Run from the repository root on a machine with a GPU:

    python chip_smoke.py           # every phase on one card, BASELINE sizes
    python chip_smoke.py --mesh4   # only the mesh paths, over four cards

Each phase prints one JSON line: where its result arrays live, which tier
crossinterpolate2 took, the cold wall (compile included) and the warm wall
(both end in ``block_until_ready`` or a host fetch of the result), and each
comparison with the reference as value, tolerance and precision. The last
line is ``{"ok": ..., "device": {"platform", "kind", "count"}}``. The script
exits non-zero with ``"ok": false`` when JAX's default platform is not a GPU,
when ``tci_tpu`` cannot be imported, or when any phase fails.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np

# Problem sizes. "full" is what the script runs (BASELINE.json configs 1-5 and
# the graft entry's TT evaluation); "tiny" runs every phase in seconds on the
# CPU for the tests.
SIZES = {
    "full": dict(
        c1_grid=[10] * 8, npoints=1000,
        c2_n=4096, c2_rank=256,
        c3_R=40,
        c4_ndim=10, c4_gk=15,
        c5_ndim=6, c5_gk=15,
        mpo=(10, 32, 4),
        tt=(20, 64, 2, 256),
    ),
    "tiny": dict(
        c1_grid=[4] * 5, npoints=200,
        c2_n=96, c2_rank=8,
        c3_R=12,
        c4_ndim=2, c4_gk=15,
        c5_ndim=3, c5_gk=7,
        mpo=(4, 4, 2),
        tt=(6, 8, 2, 32),
    ),
}


# --------------------------------------------------------------------------
# measurement helpers
# --------------------------------------------------------------------------


def _check(name, value, tol, precision, equal=False):
    """One comparison with the reference: ``value <= tol`` (or ``==``)."""
    if isinstance(value, (np.floating, np.integer)):
        value = value.item()
    ok = value == tol if equal else bool(value <= tol)
    return dict(name=name, value=value, tol=tol, precision=precision,
                ok=bool(ok))


def _cold_warm(run):
    """Run ``run()`` twice: the first wall includes compilation, the second
    reuses the compiled programs. ``run`` ends each call in a host fetch or
    ``block_until_ready``. Returns (last result, cold s, warm s)."""
    t0 = time.perf_counter()
    run()
    cold = time.perf_counter() - t0
    t0 = time.perf_counter()
    out = run()
    return out, cold, time.perf_counter() - t0


def _platforms(tree):
    import jax

    return {d.platform for leaf in jax.tree_util.tree_leaves(tree)
            if isinstance(leaf, jax.Array)
            and not isinstance(leaf, jax.core.Tracer)
            for d in leaf.devices()}


# the whole-sweep engine's programs, widest first: the tier a
# crossinterpolate2 call took is the widest program it dispatched
ENGINE_TIERS = ("whole-optimization loop", "sweep pair", "whole sweep + fill",
                "whole sweep", "whole rook sweep + fill", "whole rook sweep")


def _engine_report(evaluator):
    """(platform, tier, programs) of the device sweep engine programs the
    evaluator dispatched since its ``dispatches`` were last cleared; the
    platform is that of the programs' result arrays."""
    d = evaluator.device_sweep_engine.dispatches
    labels = {label for label, _ in d}
    tier = next((t for t in ENGINE_TIERS if t in labels),
                "per-bond device tiers or host")
    platform = ",".join(sorted({p for _, p in d})) or "host"
    return platform, tier, {f"{label} on {p}": n for (label, p), n in d.items()}


def _max_pointwise_error(tt, pts, exact):
    """max |tt(p) - exact(p)| over a (B, L) batch of points."""
    from tci_tpu import TensorTrain

    vals = TensorTrain(tt.sitetensors()).evaluate_batch(pts)
    return float(np.max(np.abs(vals - exact)))


def _line(phase, platform, tier, cold, warm, checks, **extra):
    return dict(phase=phase, platform=platform, tier=tier, cold_s=cold,
                warm_s=warm, checks=checks,
                ok=all(c["ok"] for c in checks), **extra)


# --------------------------------------------------------------------------
# phases
# --------------------------------------------------------------------------


def _lorentzian_phase(phase, size, pivotsearch):
    """Config 1: crossinterpolate2 of f(v) = 1/(1 + v·v), v ∈ {1..10}^8,
    tolerance 1e-8, through JaxBatchEvaluator, vs the host tier with a plain
    Python f."""
    import jax.numpy as jnp

    import tci_tpu as tci

    grid = SIZES[size]["c1_grid"]
    tol = 1e-8

    def fjax(idx):
        v = idx.astype(jnp.float64) + 1.0
        return 1.0 / (1.0 + jnp.sum(v * v))

    def fpy(x):
        v = np.asarray(x, dtype=float) + 1.0
        return 1.0 / (1.0 + v @ v)

    bf = tci.JaxBatchEvaluator(fjax, grid, dtype=np.float64)

    def run():
        bf.device_sweep_engine.dispatches.clear()
        return tci.crossinterpolate2(np.float64, bf, grid, tolerance=tol,
                                     pivotsearch=pivotsearch,
                                     rng=np.random.default_rng(0))

    (t, ranks, errors), cold, warm = _cold_warm(run)
    platform, tier, programs = _engine_report(bf)

    th, _, errh = tci.crossinterpolate2(np.float64, fpy, grid,
                                        tolerance=tol, pivotsearch="full",
                                        rng=np.random.default_rng(0))
    pts = np.random.default_rng(1).integers(
        0, grid[0], size=(SIZES[size]["npoints"], len(grid)))
    exact = np.array([fpy(p) for p in pts])
    perr = _max_pointwise_error(t, pts, exact)
    checks = [
        _check("final_error", float(errors[-1]), tol, "float64"),
        _check("rank_equals_host_tier", int(t.rank()), int(th.rank()),
               "float64", equal=True),
        # 100x the TCI tolerance times max|f| (~0.1): 1e-7 absolute
        _check(f"max_pointwise_error_{len(pts)}_points", perr, 1e-7,
               "float64"),
    ]
    return _line(phase, platform, tier, cold, warm, checks,
                 rank=int(t.rank()), host_rank=int(th.rank()),
                 host_final_error=float(errh[-1]), nevals=int(bf.nevals),
                 programs=programs)


def phase_config1_full(size="full"):
    return _lorentzian_phase("config1_full_pivot", size, "full")


def phase_config1_rook(size="full"):
    return _lorentzian_phase("config1_rook", size, "rook")


def phase_config2_rrlu(size="full"):
    """Config 2: the rook rrLU of an N×N float64 matrix of numerical rank r
    (mixed and f64) on the device, vs the complete-pivot rrlu, which runs on
    the host CPU (HOST_RRLU_BACKEND="cpu"): its times are host-CPU times.

    The rook runs call rrlu_serving, the device program that
    rrlu(pivotsearch="rook") runs, with the hunt stages rrlu picks for
    this reltol; it returns the factors on the device, so the line can give
    their platform."""
    import jax

    import tci_tpu as tci
    from tci_tpu.ops import lu_kernel

    N, r = SIZES[size]["c2_n"], SIZES[size]["c2_rank"]
    g = np.random.default_rng(0)
    s = np.exp(-np.arange(r) / 16.0)
    A = (g.standard_normal((N, r)) * s) @ g.standard_normal((r, N))
    normA = float(np.linalg.norm(A))
    reltol = 1e-10
    recon_tol = 1e-10

    def relerr(lu):
        LU = np.asarray(lu.left()) @ np.asarray(lu.right())
        return float(np.linalg.norm(A - LU) / normA)

    out = {}
    checks = []
    # rrlu adds a deflated f32 re-hunt when reltol is below 1e-6
    for precision, stages in (("mixed", 2), ("f64", 1)):
        def run():
            lu = tci.rrlu_serving(A, maxrank=r, reltol=reltol,
                                  precision=precision, hunt_stages=stages,
                                  rng=np.random.default_rng(7))
            jax.block_until_ready((lu.left(), lu.right()))
            return lu

        lu, cold, warm = _cold_warm(run)
        out[precision] = dict(
            platform=",".join(sorted(_platforms([lu.left(), lu.right()]))),
            hunt_stages=stages, cold_s=cold, warm_s=warm,
            npivots=int(lu.npivots()))
        checks.append(_check(f"rook_{precision}_relative_reconstruction",
                             relerr(lu), recon_tol, "float64 products"))
        checks.append(_check(f"rook_{precision}_npivots", int(lu.npivots()),
                             r, precision, equal=True))

    assert lu_kernel.HOST_RRLU_BACKEND == "cpu"
    ref, cold, warm = _cold_warm(lambda: tci.rrlu(A, maxrank=r,
                                                  reltol=reltol))
    out["full_pivot_reference"] = dict(
        platform="cpu (host route, HOST_RRLU_BACKEND='cpu')",
        cold_s=cold, warm_s=warm, npivots=int(ref.npivots()))
    checks.append(_check("full_pivot_relative_reconstruction", relerr(ref),
                         recon_tol, "float64"))
    checks.append(_check("full_pivot_npivots", int(ref.npivots()), r,
                         "float64", equal=True))
    return _line("config2_rrlu", out["f64"]["platform"],
                 "rrlu_serving: one device program",
                 out["f64"]["cold_s"], out["f64"]["warm_s"], checks,
                 shape=[N, N], rank=r, runs=out,
                 reconstruction_norm="Frobenius, float64")


def phase_config3_quantics(size="full"):
    """Config 3: quantics TCI of cos(100x)·exp(-x) on a 2^R grid
    (localdims=2, R cores), tolerance 1e-10, vs the host tier."""
    import jax.numpy as jnp

    import tci_tpu as tci

    R = SIZES[size]["c3_R"]
    tol = 1e-10
    w = np.array([2.0 ** -(r + 1) for r in range(R)])
    wj = jnp.asarray(w)

    def fjax(bits):
        x = jnp.sum(bits.astype(jnp.float64) * wj)
        return jnp.cos(100.0 * x) * jnp.exp(-x)

    def fpy(bits):
        x = float(np.dot(np.asarray(bits, dtype=float), w))
        return np.cos(100.0 * x) * np.exp(-x)

    grid = [2] * R
    bf = tci.JaxBatchEvaluator(fjax, grid, dtype=np.float64)

    def run():
        bf.device_sweep_engine.dispatches.clear()
        return tci.crossinterpolate2(np.float64, bf, grid, tolerance=tol,
                                     rng=np.random.default_rng(0))

    (t, _, errors), cold, warm = _cold_warm(run)
    platform, tier, programs = _engine_report(bf)
    th, _, errh = tci.crossinterpolate2(np.float64, fpy, grid, tolerance=tol,
                                        rng=np.random.default_rng(0))
    pts = np.random.default_rng(1).integers(
        0, 2, size=(SIZES[size]["npoints"], R))
    exact = np.array([fpy(p) for p in pts])
    perr = _max_pointwise_error(t, pts, exact)
    checks = [
        _check("final_error", float(errors[-1]), tol, "float64"),
        _check("rank_equals_host_tier", int(t.rank()), int(th.rank()),
               "float64", equal=True),
        # 100x the TCI tolerance times max|f| (= 1)
        _check(f"max_pointwise_error_{len(pts)}_points", perr, 1e-8,
               "float64"),
    ]
    return _line("config3_quantics", platform, tier, cold, warm,
                 checks, R=R, rank=int(t.rank()), host_rank=int(th.rank()),
                 host_final_error=float(errh[-1]), programs=programs)


def phase_config4_integrate(size="full"):
    """Config 4: integrate(GKorder=15, jax_native=True) of the reference's
    10-D integrand (test/test_integration.jl:29-38) vs the reference value
    and the host-tier integrate."""
    import tci_tpu as tci
    from tci_tpu.models.integration import _GK_EVAL_CACHE
    from tci_tpu.parallel.dryrun import CONFIG4_REFERENCE, config4_integrand

    ndim, gk = SIZES[size]["c4_ndim"], SIZES[size]["c4_gk"]
    lo, hi = [-1.0] * ndim, [1.0] * ndim
    kw = dict(GKorder=gk, tolerance=1e-8, maxbonddim=64)
    f = config4_integrand

    def run():
        # the evaluator integrate() built on the first call, reused after
        for bf in _GK_EVAL_CACHE.get(f, {}).values():
            bf.device_sweep_engine.dispatches.clear()
        return tci.integrate(np.float64, f, lo, hi, jax_native=True,
                             rng=np.random.default_rng(0), **kw)

    val, cold, warm = _cold_warm(run)
    (bf,) = _GK_EVAL_CACHE[f].values()
    platform, tier, programs = _engine_report(bf)

    def fvec(X):
        return 1000 * np.cos(10 * np.sum(X ** 2, axis=1)) * np.exp(
            -np.sum(X, axis=1) ** 4 / 1000)

    host = tci.integrate(np.float64, fvec, lo, hi, vectorized=True,
                         rng=np.random.default_rng(0), **kw)
    checks = [
        # Device and host tiers each approximate the same GK sum to a TCI
        # tolerance of 1e-8; 1e-6 of |I| bounds their difference.
        _check("abs_diff_vs_host_integrate", abs(val - host),
               1e-6 * abs(host), "float64"),
    ]
    if ndim == 10:
        checks.append(_check("abs_error_vs_reference_value",
                             abs(val - CONFIG4_REFERENCE), 1e-3, "float64"))
    return _line("config4_integrate", platform, tier, cold, warm, checks,
                 ndim=ndim, GKorder=gk, value=float(val),
                 host_value=float(host), reference=CONFIG4_REFERENCE,
                 programs=programs)


def phase_config5_feynman(size="full"):
    """Config 5: complex Feynman-type integrand (bench_feynman's), TCI2 with
    global pivot search, once in (re, im) pair mode and once in native
    complex128, each vs the host oracle (host tier, vectorized numpy f)."""
    import jax.numpy as jnp

    import tci_tpu as tci
    from tci_tpu.ops.kronrod import kronrod

    N, gk = SIZES[size]["c5_ndim"], SIZES[size]["c5_gk"]
    tol = 1e-7
    nodes1d, weights1d, _ = kronrod(gk // 2)
    nodes_np = (nodes1d + 1) / 2
    weights_np = weights1d / 2
    norm = float(gk) ** N
    nodes, weights = jnp.asarray(nodes_np), jnp.asarray(weights_np)

    def amp_phase(t, w, xp):
        s = 10.0 * xp.sum(t, axis=-1)
        d = t[..., :, None] - t[..., None, :]
        damp = xp.exp(-xp.sum(d ** 2, axis=(-2, -1)))
        return w * damp * norm, s

    def fpair(idx):
        a, s = amp_phase(nodes[idx], jnp.prod(weights[idx]), jnp)
        return jnp.stack([a * jnp.cos(s), a * jnp.sin(s)])

    def fc128(idx):
        a, s = amp_phase(nodes[idx], jnp.prod(weights[idx]), jnp)
        return a * jnp.exp(1j * s)

    def fvec(idx):
        a, s = amp_phase(nodes_np[idx], np.prod(weights_np[idx], axis=1), np)
        return a * np.exp(1j * s)

    grid = [len(nodes1d)] * N
    kw = dict(tolerance=tol, nsearchglobalpivot=10)
    host_ev = tci.VectorizedBatchEvaluator(fvec, grid, dtype=np.complex128)
    th, _, _ = tci.crossinterpolate2(np.complex128, host_ev, grid,
                                     rng=np.random.default_rng(0), **kw)
    ihost = complex(th.sum()) / norm
    pts = np.random.default_rng(1).integers(
        0, grid[0], size=(SIZES[size]["npoints"], N))
    exact = fvec(pts)
    fmax = float(np.max(np.abs(exact)))

    runs, checks = {}, []
    for mode in ("pair", "complex128"):
        if mode == "pair":
            bf = tci.JaxBatchEvaluator(fpair, grid, dtype=np.complex128,
                                       pair_output=True)
        else:
            bf = tci.JaxBatchEvaluator(fc128, grid, dtype=np.complex128)

        def run():
            bf.device_sweep_engine.dispatches.clear()
            return tci.crossinterpolate2(np.complex128, bf, grid,
                                         rng=np.random.default_rng(0), **kw)

        (t, _, errors), cold, warm = _cold_warm(run)
        integral = complex(t.sum()) / norm
        perr = _max_pointwise_error(t, pts, exact)
        platform, tier, programs = _engine_report(bf)
        runs[mode] = dict(
            platform=platform, tier=tier, cold_s=cold, warm_s=warm,
            rank=int(t.rank()), integral=[integral.real, integral.imag],
            final_error=float(errors[-1]), programs=programs)
        checks += [
            _check(f"{mode}_final_error", float(errors[-1]), tol,
                   "complex128" if mode != "pair" else "float64 pairs"),
            # 100x the TCI tolerance times max|f|, as in configs 1 and 3
            _check(f"{mode}_max_pointwise_error_{len(pts)}_points", perr,
                   100 * tol * fmax, "complex128"),
            # both integrals approximate the same GK sum to tolerance 1e-7
            _check(f"{mode}_integral_rel_diff_vs_host",
                   abs(integral - ihost) / abs(ihost), 1e-5, "complex128"),
        ]
    return _line("config5_feynman", runs["complex128"]["platform"],
                 runs["complex128"]["tier"], runs["complex128"]["cold_s"],
                 runs["complex128"]["warm_s"], checks, ndim=N, GKorder=gk,
                 host_integral=[ihost.real, ihost.imag],
                 host_rank=int(th.rank()), runs=runs)


def phase_contraction(size="full"):
    """contract(A, B, algorithm=a, jax_native=True) for zipup, naive and TCI,
    plus compress_device, on two random MPOs (bond dimension chi, numerical
    rank r per bond), vs the host contract and TensorTrain.compress."""
    import jax

    import tci_tpu as tci
    from tci_tpu.models.tensortrain import TensorTrain
    from tci_tpu.parallel.dryrun import (lowrank_mpo, mpo_product_values,
                                         mpo_values)

    L, chi, r = SIZES[size]["mpo"]
    A, B = lowrank_mpo(1, L, chi, r), lowrank_mpo(2, L, chi, r)
    tol = 1e-10
    pts = np.random.default_rng(1).integers(0, 4, size=(1000, L))

    def values(tt):
        return mpo_values(tt, pts)

    exact = mpo_product_values(A, B, pts)
    scale = float(np.max(np.abs(exact)))
    runs, checks = {}, []
    for alg in ("zipup", "naive", "TCI"):
        kw = dict(algorithm=alg, tolerance=tol)
        if alg != "TCI":
            kw["method"] = "LU"
        else:
            kw["rng"] = np.random.default_rng(0)
        host = tci.contract(A, B, **kw)
        if alg == "TCI":
            kw["rng"] = np.random.default_rng(0)
        dev, cold, warm = _cold_warm(
            lambda: tci.contract(A, B, jax_native=True, **kw))
        err = float(np.max(np.abs(values(dev) - exact))) / scale
        herr = float(np.max(np.abs(values(host) - exact))) / scale
        runs[alg] = dict(cold_s=cold, warm_s=warm, linkdims=dev.linkdims(),
                         host_linkdims=host.linkdims(), host_rel_err=herr)
        checks.append(_check(f"{alg}_max_rel_error_1000_points", err, 1e-8,
                             "float64"))
        if alg != "TCI":
            checks.append(_check(f"{alg}_linkdims_equal_host",
                                 dev.linkdims(), host.linkdims(), "float64",
                                 equal=True))
    hc = TensorTrain([T.copy() for T in A.sitetensors()])
    hc.compress("LU", tolerance=tol)
    dc, cold, warm = _cold_warm(lambda: tci.compress_device(A, tolerance=tol))
    cerr = float(np.max(np.abs(values(dc) - values(hc))))
    cerr /= float(np.max(np.abs(values(hc))))
    runs["compress_device"] = dict(cold_s=cold, warm_s=warm,
                                   linkdims=dc.linkdims())
    checks += [
        _check("compress_device_linkdims_equal_host", dc.linkdims(),
               hc.linkdims(), "float64", equal=True),
        _check("compress_device_max_rel_diff_1000_points", cerr, 1e-8,
               "float64"),
    ]
    # the jax_native programs take host arrays, run on JAX's default
    # device and return host cores
    return _line("contraction_compression", jax.devices()[0].platform,
                 "device tiers (jax_native=True)", runs["zipup"]["cold_s"],
                 runs["zipup"]["warm_s"], checks, L=L, bond=chi,
                 numerical_rank=r, runs=runs)


def phase_tt_evaluate(size="full"):
    """tt_evaluate_batched at __graft_entry__.entry()'s shapes, float32 at
    lax.Precision.HIGHEST, vs a float64 host evaluation."""
    import jax
    import jax.numpy as jnp

    from tci_tpu import TensorTrain
    from tci_tpu.models.jaxeval import tt_evaluate_batched_jit

    L, chi, d, B = SIZES[size]["tt"]
    g = np.random.default_rng(0)
    cores64 = g.standard_normal((L, chi, d, chi)) / np.sqrt(chi)
    idx = g.integers(0, d, size=(B, L)).astype(np.int32)
    cores = jnp.asarray(cores64, dtype=jnp.float32)
    jidx = jnp.asarray(idx)

    def run():
        return jax.block_until_ready(tt_evaluate_batched_jit(cores, jidx))

    out, cold, warm = _cold_warm(run)
    # reference: the same float32-rounded cores in float64, boundary bonds
    # cut to the index-0 slot that tt_evaluate_batched embeds them at
    c = list(np.asarray(cores, dtype=np.float64))
    ref = TensorTrain([c[0][:1]] + c[1:-1] + [c[-1][..., :1]]
                      ).evaluate_batch(idx)
    err = float(np.max(np.abs(np.asarray(out, dtype=np.float64) - ref)))
    err /= float(np.max(np.abs(ref)))
    checks = [
        # float32 roundoff over L chained chi-term products: ~1e-6 of
        # max|value|; TF32 (2^-11 per product) would land near 1e-3
        _check("max_rel_error_vs_float64", err, 2e-5,
               "float32, lax.Precision.HIGHEST"),
        _check("shape", list(out.shape), [B], "-", equal=True),
    ]
    return _line("tt_evaluate_batched", ",".join(sorted(_platforms(out))),
                 "jit(tt_evaluate_batched)", cold, warm, checks,
                 shape=[L, chi, d, chi], batch=B)


PHASES = (
    phase_config1_full,
    phase_config1_rook,
    phase_config2_rrlu,
    phase_config3_quantics,
    phase_config4_integrate,
    phase_config5_feynman,
    phase_contraction,
    phase_tt_evaluate,
)


# --------------------------------------------------------------------------
# main
# --------------------------------------------------------------------------


def _emit(obj):
    print(json.dumps(obj, default=str), flush=True)


def _card_report():
    """Each card's name and power limit, one line per card as nvidia-smi
    reports them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60)
        return (out.stdout.strip() or out.stderr.strip()).splitlines()
    except (OSError, subprocess.TimeoutExpired) as e:
        return [f"nvidia-smi failed: {e}"]


def _run_phase(fn):
    try:
        line = fn()
    except Exception as e:  # noqa: BLE001 - every phase reports
        import traceback

        traceback.print_exc()
        line = dict(phase=fn.__name__, ok=False,
                    error=f"{type(e).__name__}: {e}")
    _emit(line)
    return line["ok"]


def _run_mesh4(devices):
    from jax.sharding import Mesh

    from tci_tpu.parallel.dryrun import mesh_checks

    if len(devices) < 4:
        _emit(dict(phase="mesh4", ok=False,
                   error=f"--mesh4 needs 4 GPUs, found {len(devices)}"))
        return False
    mesh = Mesh(np.array(devices[:4]), ("batch",))
    ok = True
    for result in mesh_checks(mesh, "full"):
        _emit(dict(phase="mesh4_" + result["check"], **result))
        ok = ok and result["ok"]
    return ok


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    mesh4 = "--mesh4" in argv
    import jax

    devices = jax.devices()
    dev = devices[0]
    device = dict(platform=dev.platform, kind=dev.device_kind,
                  count=len(devices))
    if dev.platform != "gpu":
        _emit(dict(ok=False, device=device,
                   error=f"JAX's default platform is {dev.platform}, not gpu"))
        return 1
    try:
        import tci_tpu  # noqa: F401
        from tci_tpu.utils.compile_cache import setup_compile_cache
    except ImportError as e:
        _emit(dict(ok=False, device=device, error=f"ImportError: {e}"))
        return 1
    cache = setup_compile_cache()
    card = _card_report()
    _emit(dict(phase="device_report", nvidia_smi=card,
               jax_version=jax.__version__, device_kind=dev.device_kind,
               devices=len(devices), compile_cache=cache,
               memory_stats_before=[d.memory_stats() for d in devices]))

    t0 = time.perf_counter()
    if mesh4:
        ok = _run_mesh4(devices)
    else:
        ok = all([_run_phase(fn) for fn in PHASES])
    _emit(dict(phase="device_report_after", wall_s=time.perf_counter() - t0,
               memory_stats_after=[d.memory_stats() for d in devices]))
    _emit(dict(ok=bool(ok), device=device))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
