"""Static-quality gates — the role Aqua/JET/ExplicitImports play in the
reference's test suite (SURVEY.md §4): API hygiene, jit-staticness of the
config lattice, and compile-cache behavior."""

import dataclasses

import jax
import jax.numpy as jnp
import pytest

import continuousnormalizingflows_tpu as cnf
from continuousnormalizingflows_tpu.config import ICNFConfig, Mode, SolverConfig


def test_all_exports_resolve():
    for name in cnf.__all__:
        assert hasattr(cnf, name), name


def test_submodule_exports_resolve():
    from continuousnormalizingflows_tpu import models, ops, parallel, utils

    for mod in (models, ops, parallel, utils):
        for name in mod.__all__:
            assert hasattr(mod, name), f"{mod.__name__}.{name}"


def test_configs_are_hashable_and_value_equal():
    """Configs must be valid static jit arguments (the type-parameter
    dispatch analogue)."""
    a = ICNFConfig(nvariables=2)
    b = ICNFConfig(nvariables=2)
    assert a == b and hash(a) == hash(b)
    c = dataclasses.replace(a, lambda_1=0.0)
    assert a != c
    assert hash(SolverConfig()) == hash(SolverConfig())


def test_derived_sizes():
    cfg = ICNFConfig(nvariables=3)  # defaults: naugments=4, non-autonomous
    assert cfg.naugments == 4
    assert cfg.nz == 7
    assert cfg.n_in == 8  # nz + time
    assert cfg.n_out == 7
    assert cfg.state_dim == 10  # nz + dlogp + E + n
    cfg2 = ICNFConfig(nvariables=3, nconditions=2, autonomous=True)
    assert cfg2.n_in == 7 + 2


def test_no_retrace_on_repeat_calls():
    """Second identical call must hit the jit cache (no recompiles in the
    training loop)."""
    from continuousnormalizingflows_tpu.core import _inference_impl

    icnf = cnf.ICNF.create(
        nvariables=1, solver=SolverConfig(method="rk4", gradient="backprop", fixed_steps=8)
    )
    params = icnf.init(jax.random.PRNGKey(0))
    x = jnp.zeros((4, 1))
    cnf.inference(icnf, Mode.TEST, x, params)
    before = _inference_impl._cache_size()
    cnf.inference(icnf, Mode.TEST, x, params, key=jax.random.PRNGKey(1))
    cnf.inference(icnf, Mode.TEST, x, params, key=jax.random.PRNGKey(2))
    assert _inference_impl._cache_size() == before


def test_benchmark_judge_logic(tmp_path):
    """The PR-gate comparator (benchmarks/judge.py, the BenchmarkCI.judge
    analogue) must pass identical runs and fail >threshold regressions."""
    import os
    import subprocess
    import sys

    root = os.path.join(os.path.dirname(__file__), "..")
    base = tmp_path / "base.json"
    cand = tmp_path / "cand.json"
    row = '{"solver":"adjoint","mode":"train","loss_fwd_ms":10.0,"loss_grad_ms":%s}\n'
    base.write_text(row % "20.0")

    cand.write_text(row % "21.0")  # 5% — fine
    r = subprocess.run(
        [sys.executable, os.path.join(root, "benchmarks", "judge.py"),
         str(base), str(cand)], capture_output=True)
    assert r.returncode == 0, r.stdout

    cand.write_text(row % "30.0")  # 50% — regression
    r = subprocess.run(
        [sys.executable, os.path.join(root, "benchmarks", "judge.py"),
         str(base), str(cand)], capture_output=True)
    assert r.returncode == 1, r.stdout


def test_mode_enum_stable():
    assert Mode("test") is Mode.TEST and Mode("train") is Mode.TRAIN


def test_config_validation():
    with pytest.raises(ValueError):
        ICNFConfig(nvariables=0)
    with pytest.raises(ValueError):
        SolverConfig(method="nope")
    with pytest.raises(ValueError):
        SolverConfig(gradient="nope")


def test_bench_helper_functions():
    """The bench aux computations are pure helpers — pin them (a wrong
    spread/MFU silently corrupts the drift decision rule's inputs)."""
    import bench

    assert bench.spread_pct([0.010, 0.011, 0.0105]) == 10.0
    assert bench.spread_pct([2.0, 2.0, 2.0]) == 0.0
    # reference-default 2-D net: widths (6, 24, 24, 5)
    assert bench.mlp_fwd_flops((6, 24, 24, 5)) == 2 * (6*24 + 24*24 + 24*5)
    tf32 = bench.peaks_for("NVIDIA H100 80GB HBM3")["tf32_tflops"]
    tflops, pct = bench.train_mfu(3.4e6, 128, (6, 24, 24, 5), 4, tf32)
    # 3.4e6 * 128 * 2*1680 * 4 / 1e12 = 5.849 TFLOP/s
    assert abs(tflops - 5.849) < 0.01
    assert abs(pct - 100 * tflops / 495.0) < 0.01


def test_bench_peaks_h100_data_sheet():
    import bench

    assert bench.peaks_for("NVIDIA H100 80GB HBM3") == {
        "bf16_tflops": 989.0,
        "tf32_tflops": 495.0,
        "fp32_tflops": 67.0,
        "hbm_tb_per_s": 3.35,
    }


def test_bench_peaks_unknown_device_raises():
    import bench

    with pytest.raises(KeyError, match="no peak rates"):
        bench.peaks_for("cpu")
