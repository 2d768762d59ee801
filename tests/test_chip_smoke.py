"""chip_smoke.py's phases at a tiny size on the CPU, its refusal to run off
the GPU, and the compile-cache helper it shares with the tests and benches."""

import json
import os

import numpy as np
import pytest

import chip_smoke


@pytest.mark.parametrize("phase", chip_smoke.PHASES,
                         ids=lambda fn: fn.__name__)
def test_phase_tiny_matches_reference(phase):
    line = phase("tiny")
    assert line["ok"], json.dumps(line, default=str)
    assert line["checks"] and all(c["ok"] for c in line["checks"])
    assert line["platform"].startswith("cpu")
    assert line["cold_s"] > 0 and line["warm_s"] > 0


@pytest.mark.gpu
@pytest.mark.parametrize("phase", chip_smoke.PHASES,
                         ids=lambda fn: fn.__name__)
def test_phase_tiny_runs_on_gpu(gpu_device, phase):
    line = phase("tiny")
    assert line["ok"], json.dumps(line, default=str)
    assert line["platform"] == "gpu" or line["phase"] == "config2_rrlu"


def test_main_off_gpu_exits_nonzero_with_ok_false(capsys):
    assert chip_smoke.main([]) != 0
    last = capsys.readouterr().out.strip().splitlines()[-1]
    result = json.loads(last)
    assert result["ok"] is False
    assert result["device"]["platform"] == "cpu"


def test_tier_probe_counts_dispatches_not_traces():
    import tci_tpu as tci

    bf = tci.JaxBatchEvaluator(lambda i: 1.0 / (1.0 + (i * i).sum()),
                               [3] * 4, dtype=np.float64)
    tci.crossinterpolate2(np.float64, bf, [3] * 4, tolerance=1e-8,
                          rng=np.random.default_rng(0))
    platform, tier, programs = chip_smoke._engine_report(bf)
    assert tier == "whole-optimization loop"
    assert platform == "cpu"
    # one host dispatch per program: the sweeps traced inside the loop
    # program are not counted on their own
    assert programs["whole-optimization loop on cpu"] >= 1
    assert not any(k.startswith("whole sweep") for k in programs)


def test_compile_cache_uses_checkout_path_without_env(monkeypatch):
    import jax

    from tci_tpu.utils import compile_cache

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    before = jax.config.jax_compilation_cache_dir
    try:
        path = compile_cache.setup_compile_cache(".jax_cache_tests")
        root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        assert path == os.path.join(root, ".jax_cache_tests")
        assert jax.config.jax_compilation_cache_dir == path
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_compile_cache_defers_to_env(monkeypatch, tmp_path):
    import jax

    from tci_tpu.utils import compile_cache

    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert compile_cache.setup_compile_cache() == str(tmp_path)
    # the environment variable is JAX's own setting: nothing set in code
    assert jax.config.jax_compilation_cache_dir == before
