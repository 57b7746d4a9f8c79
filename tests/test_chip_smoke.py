"""chip_smoke.py on the CPU: its guards, its output contract, and every phase
at tiny sizes (the card runs the same functions at full size)."""

import json
import os

import jax
import numpy as np
import pytest

import chip_smoke
from continuousnormalizingflows_tpu.utils import compile_cache, profiling


def test_device_check_refuses_cpu(capsys):
    with pytest.raises(chip_smoke.SmokeFailure, match="no GPU"):
        chip_smoke.main([])
    assert '"ok"' not in capsys.readouterr().out


def test_compile_cache_honours_env(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert compile_cache.compile_cache_dir() == str(tmp_path)


def test_compile_cache_fixed_default(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert compile_cache.compile_cache_dir() == os.path.join(root, ".jax_cache")
    with open(os.path.join(root, ".gitignore")) as fh:
        assert ".jax_cache/" in fh.read().split()


def test_result_line_is_exact():
    dev = {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1}
    line = chip_smoke.result_line(dev)
    assert line == ('{"ok": true, "device": {"platform": "gpu", '
                    '"kind": "NVIDIA H100 80GB HBM3", "count": 1}}')
    assert json.loads(line) == {"ok": True, "device": dev}


@pytest.mark.parametrize(
    "line, expected",
    [
        ("NVIDIA H100 80GB HBM3, 700.00 W", ("NVIDIA H100 80GB HBM3", 700.0)),
        ("NVIDIA H100 80GB HBM3, [N/A]", ("NVIDIA H100 80GB HBM3", None)),
    ],
)
def test_parse_smi_line(line, expected):
    assert profiling.parse_smi_line(line) == expected


@pytest.fixture(scope="module")
def flagship():
    return chip_smoke.flagship_phase(batch=128, steps=2, eval_n=64)


def test_flagship_phase(flagship):
    assert flagship["logp_diff"] <= chip_smoke.LOGP_TOL
    assert flagship["nfe"] > 0 and flagship["nfe"] == flagship["nfe_ref"]
    nfe_b, nfe_b_ref = flagship["nfe_bench_row"]
    assert nfe_b > 0 and nfe_b == nfe_b_ref


def test_full_width_phase():
    out = chip_smoke.full_width_phase(side=4, hidden=16, batch=32, steps=2,
                                      eval_n=16)
    assert out["logp_diff"] <= chip_smoke.LOGP_TOL
    assert np.isfinite(out["bits_per_dim"]) and np.isfinite(out["true_bits_per_dim"])
    # on the CPU "default" is full float32, so the two fits agree closely
    assert out["tf32_logp_diff"] < 1e-2


def test_export_phase(flagship):
    out = chip_smoke.export_phase(flagship["icnf"], flagship["params"],
                                  flagship["x_eval"])
    assert out["export_diff"] <= chip_smoke.EXPORT_TOL


def test_four_card_data_parallel_phase():
    out = chip_smoke.data_parallel_phase(jax.devices()[:4], batch=64, steps=1)
    assert out["loss_rel_err"] <= chip_smoke.MESH_RTOL
    assert out["grad_rel_err"] <= chip_smoke.MESH_RTOL


def test_four_card_tensor_parallel_phase():
    out = chip_smoke.tensor_parallel_phase(jax.devices()[:4], side=4, hidden=16,
                                           batch=16)
    assert out["loss_rel_err"] <= chip_smoke.MESH_RTOL
    assert out["grad_rel_err"] <= chip_smoke.MESH_RTOL
