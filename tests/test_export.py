"""Serving export (utils.export): StableHLO artifacts with baked params.

The reference serves via the Julia stack + BSON machines (mlj_ext
MLJBase.save); this is the JAX-native production path beyond it — artifact
round-trips must reproduce the live model bit-for-bit-to-tolerance with no
model code at load time."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import continuousnormalizingflows_tpu as cnf
from continuousnormalizingflows_tpu.config import Mode, SolverConfig
from continuousnormalizingflows_tpu.utils import export as ex

FAST = SolverConfig(method="rk4", gradient="backprop", fixed_steps=16)


def make(nconditions=0, solver=FAST, **kw):
    icnf = cnf.ICNF.create(nvariables=2, nconditions=nconditions,
                           solver=solver, **kw)
    return icnf, icnf.init(jax.random.PRNGKey(0))


def test_logpdf_export_parity_and_batch_polymorphism(tmp_path):
    icnf, params = make()
    exp = ex.export_logpdf(icnf, params)
    for n in (3, 17):  # two batch sizes through ONE artifact
        x = 0.3 * jax.random.normal(jax.random.PRNGKey(n), (n, 2))
        want = cnf.log_prob(icnf, Mode.TEST, x, params)
        np.testing.assert_allclose(np.asarray(exp.call(x)), np.asarray(want),
                                   rtol=1e-6)
    # file round-trip: load and run with NO model objects
    p = str(tmp_path / "logpdf.cnfx")
    ex.save_artifact(p, exp)
    loaded = ex.load_artifact(p)
    x = 0.3 * jax.random.normal(jax.random.PRNGKey(5), (4, 2))
    np.testing.assert_allclose(
        np.asarray(loaded.call(x)),
        np.asarray(cnf.log_prob(icnf, Mode.TEST, x, params)), rtol=1e-6,
    )


def test_conditional_logpdf_export():
    icnf, params = make(nconditions=2)
    exp = ex.export_logpdf(icnf, params)
    x = 0.3 * jax.random.normal(jax.random.PRNGKey(1), (6, 2))
    ys = jnp.tile(jnp.array([[0.5, -0.5]]), (6, 1))
    want = cnf.log_prob(icnf, Mode.TEST, x, params, ys=ys)
    np.testing.assert_allclose(np.asarray(exp.call(x, ys)), np.asarray(want),
                               rtol=1e-6)


def test_sampler_export_parity(tmp_path):
    icnf, params = make()
    exp = ex.export_sampler(icnf, params, 16)
    s = exp.call(jnp.uint32(7))
    want = cnf.generate(icnf, Mode.TEST, params,
                        jax.random.PRNGKey(jnp.uint32(7)), 16, trace_free=True)
    np.testing.assert_allclose(np.asarray(s), np.asarray(want),
                               rtol=1e-4, atol=1e-5)
    assert s.shape == (16, 2)
    p = str(tmp_path / "sampler.cnfx")
    ex.save_artifact(p, exp)
    s2 = ex.load_artifact(p).call(jnp.uint32(7))
    np.testing.assert_array_equal(np.asarray(s), np.asarray(s2))


def test_conditional_sampler_requires_and_bakes_ys():
    icnf, params = make(nconditions=1)
    with pytest.raises(ValueError, match="pass ys"):
        ex.export_sampler(icnf, params, 8)
    exp = ex.export_sampler(icnf, params, 8, ys=jnp.ones((8, 1)))
    s = exp.call(jnp.uint32(3))
    assert s.shape == (8, 2) and bool(jnp.all(jnp.isfinite(s)))


def test_export_with_custom_base_dist():
    """Pluggable base distributions survive export (the logistic closure is
    traced into the artifact)."""
    from continuousnormalizingflows_tpu import distributions as dists

    icnf, params = make(naugments=0, lambda_3=0.0, base_dist=dists.logistic())
    exp = ex.export_logpdf(icnf, params)
    x = 0.3 * jax.random.normal(jax.random.PRNGKey(1), (5, 2))
    np.testing.assert_allclose(
        np.asarray(exp.call(x)),
        np.asarray(cnf.log_prob(icnf, Mode.TEST, x, params)), rtol=1e-6,
    )


def test_adaptive_solver_exports():
    """The adaptive while_loop path (data-dependent trip count) exports under
    shape polymorphism too — serving is not restricted to fixed-step."""
    icnf, params = make(solver=SolverConfig(method="dopri5", rtol=1e-4,
                                            atol=1e-4))
    exp = ex.export_logpdf(icnf, params)
    x = 0.3 * jax.random.normal(jax.random.PRNGKey(1), (9, 2))
    np.testing.assert_allclose(
        np.asarray(exp.call(x)),
        np.asarray(cnf.log_prob(icnf, Mode.TEST, x, params)), rtol=1e-5,
    )


def test_spmd_export_on_mesh():
    """Multi-chip serving: export with mesh= shards the batch over the data
    axis; the deserialized artifact runs on an identically-shaped mesh and
    matches the single-device result (8-device CPU mesh)."""
    from continuousnormalizingflows_tpu.parallel import data_sharding, make_mesh

    icnf, params = make()
    mesh = make_mesh()
    shard = data_sharding(mesh)
    exp = ex.export_logpdf(icnf, params, mesh=mesh)
    assert exp.nr_devices == len(jax.devices())
    loaded = jax.export.deserialize(exp.serialize())
    for n in (16, 40):  # any multiple of the device count
        x = 0.3 * jax.random.normal(jax.random.PRNGKey(n), (n, 2))
        out = jax.jit(loaded.call)(jax.device_put(x, shard))
        want = cnf.log_prob(icnf, Mode.TEST, x, params)
        np.testing.assert_allclose(np.asarray(out), np.asarray(want),
                                   rtol=1e-5)


def test_spmd_export_data_model_mesh():
    """On a data x model mesh the batch divisibility follows the DATA axis
    size, not the whole device count (review finding round 4): a 4x2 mesh
    accepts batches divisible by 4."""
    from continuousnormalizingflows_tpu.parallel import data_sharding, make_mesh

    icnf, params = make()
    mesh = make_mesh(model=2)  # 4 data x 2 model on the 8-device CPU backend
    exp = ex.export_logpdf(icnf, params, mesh=mesh)
    x = 0.3 * jax.random.normal(jax.random.PRNGKey(0), (12, 2))  # 12 % 4 == 0
    out = jax.jit(exp.call)(jax.device_put(x, data_sharding(mesh)))
    want = cnf.log_prob(icnf, Mode.TEST, x, params)
    np.testing.assert_allclose(np.asarray(out), np.asarray(want), rtol=1e-5)
