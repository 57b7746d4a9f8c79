"""Estimator facade + end-to-end regression fit.

The regression test mirrors the reference's only end-to-end accuracy check
(test/ci_tests/regression_tests.jl: 2^10 samples of 1-D Beta(2,4), default
ICNF, full-batch Adam) but — unlike the reference, which only ``@show``s the
metrics — asserts hard thresholds on mean-absolute-deviation and total
variation of the fitted density (SURVEY.md §4 calls this gap out).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import continuousnormalizingflows_tpu as cnf
from continuousnormalizingflows_tpu.config import Mode, SolverConfig
from continuousnormalizingflows_tpu.utils import datasets, load_checkpoint, save_checkpoint

FAST_TRAIN = SolverConfig(method="rk4", gradient="backprop", fixed_steps=24)


@pytest.fixture(scope="module")
def beta_fit():
    """Fit once, reuse across assertions (fitting is the expensive part).

    Uses an *unaugmented* RNODE (naugments=0): with the reference-default
    augmentation the reported density is a joint-density slice at zero padding
    and is not normalized over x — the reference compares it to the true pdf
    anyway but never asserts (regression_tests.jl:25-28); to assert hard
    thresholds the density must be a real density."""
    key = jax.random.PRNGKey(7)
    x = datasets.beta_samples(key, 1024)
    icnf = cnf.ICNF.create(nvariables=1, naugments=0, lambda_3=0.0, solver=FAST_TRAIN)
    # clip_norm guards the fixed-step discretize-then-optimize path against
    # transient stiffness blow-up (measured: the unclipped fit is chaotically
    # marginal at ~iteration 190 on this task)
    model = cnf.ICNFModel(
        icnf,
        optimizer=cnf.default_optimizer(clip_norm=1.0),
        batchsize=0,
        epochs=300,
        key=jax.random.PRNGKey(1),
    )
    result = model.fit(x)
    return icnf, model, result, x


def test_regression_beta(beta_fit):
    icnf, model, result, x = beta_fit
    assert np.isfinite(result.stats["final_loss"])
    # loss must actually decrease
    assert result.history[-1] < result.history[0] - 0.1

    r = jnp.linspace(0.02, 0.98, 128)[:, None]
    est_pdf = np.asarray(model.transform(r, result.params))
    true_pdf = np.asarray(datasets.beta_pdf(r[:, 0]))

    mad = np.mean(np.abs(est_pdf - true_pdf))
    tv = 0.5 * np.mean(np.abs(est_pdf - true_pdf))
    # measured on this config: mad ~0.095, tv ~0.05 (PARITY.md); thresholds
    # leave ~2.5x headroom for seed/backend drift
    assert mad < 0.25, f"meanad too high: {mad}"
    assert tv < 0.15, f"total variation too high: {tv}"


def test_fitresult_stats(beta_fit):
    _icnf, _model, result, _x = beta_fit
    assert result.stats["iterations"] == 300
    assert result.stats["epochs"] == 300
    assert len(result.history) >= 4
    # solver diagnostics of the last step surface in fit stats (reference
    # solver verbosity analogue, icnf.jl:100-101)
    assert result.stats["nfe"] > 0
    assert result.stats["naccept"] > 0
    assert result.stats["nreject"] >= 0
    assert result.stats["dt_final"] != 0.0


def test_checkpoint_roundtrip(tmp_path, beta_fit):
    _icnf, _model, result, _x = beta_fit
    path = str(tmp_path / "ckpt")
    save_checkpoint(path, result.params, opt_state=None, step=300)
    params2, opt2, step = load_checkpoint(path)
    assert step == 300 and opt2 is None
    for a, b in zip(
        jax.tree_util.tree_leaves(result.params), jax.tree_util.tree_leaves(params2)
    ):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_async_checkpointer(tmp_path, beta_fit):
    """AsyncCheckpointer: non-blocking save, durable after wait, load parity;
    worker errors resurface on the caller thread."""
    from continuousnormalizingflows_tpu.utils import AsyncCheckpointer

    _icnf, _model, result, _x = beta_fit
    path = str(tmp_path / "ackpt")
    with AsyncCheckpointer() as ckpt:
        ckpt.save(path, result.params, step=7)
    params2, _opt, step = load_checkpoint(path)
    assert step == 7
    for a, b in zip(
        jax.tree_util.tree_leaves(result.params), jax.tree_util.tree_leaves(params2)
    ):
        assert jnp.array_equal(a, b)

    # a second save overwrites and joins the first
    ckpt2 = AsyncCheckpointer()
    ckpt2.save(path, params2, step=8)
    ckpt2.save(path, params2, step=9)
    ckpt2.wait()
    _p, _o, step = load_checkpoint(path)
    assert step == 9

    # error propagation: unwritable path surfaces at wait()
    bad = AsyncCheckpointer()
    bad.save("/proc/definitely/not/writable", result.params, step=1)
    with pytest.raises(BaseException):
        bad.wait()


def test_warm_start(beta_fit):
    """fit(params=...) resumes from given params instead of re-initializing."""
    icnf, _model, result, x = beta_fit
    model2 = cnf.ICNFModel(icnf, batchsize=0, epochs=1, key=jax.random.PRNGKey(2))
    res2 = model2.fit(x, params=result.params)
    # one extra epoch from a converged fit shouldn't blow up the loss
    assert res2.stats["final_loss"] < result.history[0]


def test_conditional_model_runs():
    icnf = cnf.ICNF.create(nvariables=2, nconditions=1, solver=FAST_TRAIN)
    n = 64
    key = jax.random.PRNGKey(0)
    y = jax.random.bernoulli(key, 0.5, (n, 1)).astype(jnp.float32)
    x = jax.random.normal(jax.random.PRNGKey(1), (n, 2)) + 2.0 * y
    model = cnf.CondICNFModel(icnf, batchsize=32, epochs=2, key=jax.random.PRNGKey(2))
    result = model.fit(x, y)
    assert np.isfinite(result.stats["final_loss"])
    px = model.transform(x[:8], result.params, Y=y[:8])
    assert px.shape == (8,) and bool(jnp.all(px >= 0))


def test_conditional_model_requires_y():
    icnf = cnf.ICNF.create(nvariables=2, nconditions=1, solver=FAST_TRAIN)
    model = cnf.CondICNFModel(icnf, epochs=1)
    with pytest.raises(ValueError):
        model.fit(jnp.zeros((8, 2)))


def test_cond_model_rejects_unconditional_icnf():
    icnf = cnf.ICNF.create(nvariables=2, solver=FAST_TRAIN)
    with pytest.raises(ValueError):
        cnf.CondICNFModel(icnf)


def test_batching_shapes():
    icnf = cnf.ICNF.create(nvariables=1, solver=FAST_TRAIN)
    model = cnf.ICNFModel(icnf, batchsize=32, epochs=1)
    batches = model._batches(jax.random.PRNGKey(0), 100)
    assert batches.shape == (3, 32)  # static shapes, remainder dropped
    full = model._batches(jax.random.PRNGKey(0), 20)
    assert full.shape == (1, 20)  # batchsize > n: whole dataset


def test_table_input_fit():
    """fit() accepts table-style inputs (dict of columns / .to_numpy duck
    type) like the reference MLJ facade's matrix(X) conversion
    (mlj_ext/core_icnf.jl:33)."""
    icnf = cnf.ICNF.create(nvariables=2, solver=FAST_TRAIN)
    model = cnf.ICNFModel(icnf, epochs=1, batchsize=0)
    rng = np.random.default_rng(0)
    cols = {"a": rng.normal(size=16), "b": rng.normal(size=16)}
    res = model.fit(cols)
    assert np.isfinite(res.stats["final_loss"])

    class _Tablish:
        def to_numpy(self):
            return np.stack([cols["a"], cols["b"]], axis=1)

    res2 = model.fit(_Tablish())
    assert np.isfinite(res2.stats["final_loss"])


def test_transform_vector_and_layout_shim(beta_fit):
    """transform() scores a single (d,) sample (reference VectorMode
    scoring = batch of 1) and transposes a features-first (d, n) matrix with
    a one-shot warning (get_logp̂x fallback, mlj_ext/core.jl:45-94)."""
    icnf, model, res, x = beta_fit
    one = np.asarray(model.transform(x[0], res.params))
    assert one.shape == () and np.isfinite(one)

    batch = np.asarray(model.transform(x[:4], res.params))
    np.testing.assert_allclose(one, batch[0], rtol=1e-5)

    # features-first input: (d, n) with n != d triggers the transpose shim
    import continuousnormalizingflows_tpu.dist as dist_mod

    dist_mod._warned_transpose = False
    with pytest.warns(UserWarning, match="features-first"):
        ff = np.asarray(model.transform(np.asarray(x[:4]).T, res.params))
    np.testing.assert_allclose(ff, batch, rtol=1e-5)


def test_opt_state_resume_is_exact(beta_fit):
    """fit(params=, opt_state=, key=) continues the exact optimizer AND
    PRNG trajectory: one 2-epoch run == two chained 1-epoch runs.  Without
    key= the probe stream restarts and the trajectories only agree to
    Hutchinson noise (this bit the original version of this test)."""
    icnf, _m, _r, x = beta_fit
    kw = dict(batchsize=0, key=jax.random.PRNGKey(5))
    p0 = icnf.init(jax.random.PRNGKey(11))

    two = cnf.ICNFModel(icnf, epochs=2, **kw).fit(x, params=p0)
    one = cnf.ICNFModel(icnf, epochs=1, **kw).fit(x, params=p0)
    resumed = cnf.ICNFModel(icnf, epochs=1, **kw).fit(
        x, params=one.params, opt_state=one.opt_state, key=one.key
    )
    # identical data order (batchsize=0 -> single full batch) and identical
    # key stream (one.key is the advanced key), so the second epoch replays
    # the same jitted step on the same inputs
    for a, b in zip(
        jax.tree_util.tree_leaves(two.params),
        jax.tree_util.tree_leaves(resumed.params),
    ):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-6, atol=1e-8)


def test_steps_per_dispatch_bit_parity():
    """A k-steps-per-dispatch fit is bit-identical to the per-step loop: the
    scan body performs the same ``split(key)`` sequence and the same gathers,
    so params, history cadence, and the advanced key all match (the XLA-first
    dispatch-batching must not change training semantics)."""
    icnf = cnf.ICNF.create(nvariables=2, solver=FAST_TRAIN)
    x = datasets.gaussian_mixture(jax.random.PRNGKey(3), 96)
    p0 = icnf.init(jax.random.PRNGKey(4))
    kw = dict(batchsize=32, epochs=3, key=jax.random.PRNGKey(9), log_every=2)

    seen = []
    base = cnf.ICNFModel(icnf, callback=lambda it, l: seen.append(it), **kw).fit(
        x, params=p0
    )
    seen_k = []
    blocked = cnf.ICNFModel(
        icnf, steps_per_dispatch=2, callback=lambda it, l: seen_k.append(it), **kw
    ).fit(x, params=p0)

    for a, b in zip(
        jax.tree_util.tree_leaves(base.params),
        jax.tree_util.tree_leaves(blocked.params),
    ):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    np.testing.assert_array_equal(np.asarray(base.key), np.asarray(blocked.key))
    assert base.history == blocked.history
    assert seen == seen_k
    assert base.stats["iterations"] == blocked.stats["iterations"] == 9
    assert blocked.stats["nfe"] == base.stats["nfe"]


def test_batch_transform_hook():
    """``batch_transform`` applies per-step jitted augmentation with a fresh
    key (the dequantization-noise pattern): it changes training relative to
    the raw data, is itself bit-reproducible, and stays bit-identical across
    ``steps_per_dispatch`` values."""
    from continuousnormalizingflows_tpu.utils import datasets as ds

    icnf = cnf.ICNF.create(nvariables=2, solver=FAST_TRAIN)
    # integer "quantized" data; the transform dequantizes + logit-maps it
    x_int = jnp.asarray(
        np.random.default_rng(0).integers(0, 17, size=(96, 2)), jnp.float32
    )
    p0 = icnf.init(jax.random.PRNGKey(4))
    kw = dict(batchsize=32, epochs=2, key=jax.random.PRNGKey(9))

    def deq(key, xb):
        y, _ldj = ds.dequantize_logit(xb, key, levels=17)
        return 0.25 * y

    raw = cnf.ICNFModel(icnf, **kw).fit(x_int, params=p0)
    aug1 = cnf.ICNFModel(icnf, batch_transform=deq, **kw).fit(x_int, params=p0)
    aug2 = cnf.ICNFModel(icnf, batch_transform=deq, **kw).fit(x_int, params=p0)
    augk = cnf.ICNFModel(
        icnf, batch_transform=deq, steps_per_dispatch=3, **kw
    ).fit(x_int, params=p0)

    la, lr = jax.tree_util.tree_leaves(aug1.params), jax.tree_util.tree_leaves(
        raw.params
    )
    assert any(
        not np.array_equal(np.asarray(a), np.asarray(r)) for a, r in zip(la, lr)
    ), "transform had no effect on training"
    for a, b in zip(la, jax.tree_util.tree_leaves(aug2.params)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    for a, b in zip(la, jax.tree_util.tree_leaves(augk.params)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_batch_transform_conditional():
    """batch_transform augments features only; labels ride through exact —
    and the conditional block path matches the per-step path bit-for-bit."""
    from continuousnormalizingflows_tpu.utils import datasets as ds

    icnf = cnf.ICNF.create(nvariables=2, nconditions=1, solver=FAST_TRAIN)
    rng = np.random.default_rng(0)
    x_int = jnp.asarray(rng.integers(0, 17, size=(64, 2)), jnp.float32)
    y = jnp.asarray(rng.normal(size=(64, 1)), jnp.float32)
    p0 = icnf.init(jax.random.PRNGKey(4))
    kw = dict(batchsize=16, epochs=2, key=jax.random.PRNGKey(9))

    def deq(k, xb):
        yb, _ = ds.dequantize_logit(xb, k, levels=17)
        return 0.25 * yb

    a = cnf.CondICNFModel(icnf, batch_transform=deq, **kw).fit(x_int, y, params=p0)
    b = cnf.CondICNFModel(
        icnf, batch_transform=deq, steps_per_dispatch=4, **kw
    ).fit(x_int, y, params=p0)
    for la, lb in zip(
        jax.tree_util.tree_leaves(a.params), jax.tree_util.tree_leaves(b.params)
    ):
        np.testing.assert_array_equal(np.asarray(la), np.asarray(lb))
    assert np.isfinite(a.stats["final_loss"])


def test_fit_chunks_reuse_compiled_step():
    """Repeated fit() calls (the eval-between-chunks warm-start loop) reuse
    ONE jitted step: _make_step/_make_block_step memoize their closures, so
    jax.jit's identity cache hits instead of retracing per chunk."""
    icnf = cnf.ICNF.create(nvariables=2, solver=FAST_TRAIN)
    m = cnf.ICNFModel(icnf, batchsize=16, epochs=1, key=jax.random.PRNGKey(0))
    assert m._make_step() is m._make_step()
    mb = cnf.ICNFModel(icnf, batchsize=16, epochs=1, steps_per_dispatch=2,
                       key=jax.random.PRNGKey(0))
    assert mb._make_block_step() is mb._make_block_step()

    x = datasets.gaussian_mixture(jax.random.PRNGKey(3), 64)
    r1 = m.fit(x)
    n_traces = m._step_cache["step"]._cache_size()
    r2 = m.fit(x, params=r1.params, opt_state=r1.opt_state, key=r1.key)
    assert m._step_cache["step"]._cache_size() == n_traces, "fit retraced"
    assert np.isfinite(r2.history[-1])


def test_steps_per_dispatch_conditional_and_mesh():
    """Blocked dispatch with a conditional model on an 8-device mesh matches
    the unblocked single-device run (the gather rides GSPMD; loss psum
    semantics unchanged)."""
    from continuousnormalizingflows_tpu.parallel.mesh import make_mesh

    icnf = cnf.ICNF.create(nvariables=2, nconditions=1, solver=FAST_TRAIN)
    key = jax.random.PRNGKey(0)
    x = datasets.gaussian_mixture(jax.random.PRNGKey(3), 64)
    y = jnp.asarray(np.random.default_rng(0).normal(size=(64, 1)), jnp.float32)
    p0 = icnf.init(jax.random.PRNGKey(4))
    kw = dict(batchsize=16, epochs=2, key=key)

    plain = cnf.CondICNFModel(icnf, **kw).fit(x, y, params=p0)
    meshed = cnf.CondICNFModel(
        icnf, mesh=make_mesh(model=1), steps_per_dispatch=3, **kw
    ).fit(x, y, params=p0)
    for a, b in zip(
        jax.tree_util.tree_leaves(plain.params),
        jax.tree_util.tree_leaves(meshed.params),
    ):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=2e-5, atol=1e-7)


def test_config1_ring_reduced_scale():
    """BASELINE config 1 (2-D ring-of-Gaussians RNODE) at reduced scale — the
    quality gate behind the round-4 re-anchored PARITY row (full scale:
    gap 0.0503 nats with the reference-default net at 64k samples /
    300 epochs; benchmarks/cfg1_converge.py).  At this CPU scale (4096
    samples, 150 epochs) the measured gap is ~0.42 nats; 0.6 catches gross
    regressions of the training stack without minutes of runtime."""
    x = datasets.gaussian_mixture(jax.random.PRNGKey(0), 4096)
    xt = datasets.gaussian_mixture(jax.random.PRNGKey(9), 2048)
    icnf = cnf.ICNF.create(
        nvariables=2, naugments=0, lambda_3=0.0,
        solver=SolverConfig(method="rk4", gradient="backprop", fixed_steps=16),
    )
    model = cnf.ICNFModel(icnf, batchsize=512, epochs=150,
                          key=jax.random.PRNGKey(1), steps_per_dispatch=8)
    res = model.fit(x)
    lp, _, _ = cnf.inference(icnf, Mode.TEST, xt, res.params)
    gap = -float(jnp.mean(lp)) + float(
        jnp.mean(datasets.gaussian_mixture_logpdf(xt))
    )
    assert gap < 0.6, gap


def test_load_tabular_real_and_quick_fit():
    """Real UCI tabular loader (round 4): deterministic split, train-stat
    standardization, and a quick fit that must beat the DIAGONAL Gaussian on
    held-out data (the full benchmark protocol with baselines lives in
    benchmarks/tabular_real.py; results in PARITY.md round 4)."""
    from continuousnormalizingflows_tpu.utils.datasets import load_tabular_real

    xtr, xte = load_tabular_real("wine", seed=0)
    xtr2, _ = load_tabular_real("wine", seed=0)
    np.testing.assert_array_equal(np.asarray(xtr), np.asarray(xtr2))
    assert xtr.shape == (142, 13) and xte.shape == (36, 13)
    assert abs(float(jnp.mean(xtr))) < 0.05 and abs(float(jnp.std(xtr)) - 1.0) < 0.05

    import pytest as _pytest

    with _pytest.raises(ValueError, match="unknown tabular dataset"):
        load_tabular_real("nope")

    icnf = cnf.ICNF.create(
        nvariables=13, naugments=0, lambda_3=0.0, steer_rate=0.0,
        solver=SolverConfig(method="rk4", gradient="backprop", fixed_steps=16),
    )
    res = cnf.ICNFModel(icnf, batchsize=0, epochs=150,
                        key=jax.random.PRNGKey(1)).fit(xtr)
    lp, _, _ = cnf.inference(icnf, Mode.TEST, xte, res.params)
    nll_flow = -float(jnp.mean(lp))
    mu, v = jnp.mean(xtr, 0), jnp.var(xtr, 0) + 1e-6
    nll_diag = float(jnp.mean(
        0.5 * jnp.sum(jnp.log(2 * jnp.pi * v) + (xte - mu) ** 2 / v, axis=-1)
    ))
    assert nll_flow < nll_diag, (nll_flow, nll_diag)


def test_validated_fit_tracks_best_and_streams_match():
    """fit(validation_data=...) — validation-based training control as API
    (VERDICT round-4 item 1; beyond the reference's fixed-epochs fit,
    core_icnf.jl:14-30).  Asserts: the val curve is recorded, best-val params
    are tracked by copy, score() agrees with the recorded best, and the
    training PRNG stream is UNCHANGED by validation (a validated run's params
    are bit-equal to an unvalidated run's at the same epoch count)."""
    x = datasets.gaussian_mixture(jax.random.PRNGKey(3), 128)
    xv = datasets.gaussian_mixture(jax.random.PRNGKey(4), 64)
    icnf = cnf.ICNF.create(nvariables=2, solver=FAST_TRAIN)
    p0 = icnf.init(jax.random.PRNGKey(9))
    kw = dict(batchsize=0, epochs=6, key=jax.random.PRNGKey(0))

    m = cnf.ICNFModel(icnf, **kw)
    res = m.fit(x, params=p0, validation_data=xv, eval_every=2)
    assert [e for e, _ in res.val_history] == [2, 4, 6]
    assert res.best_params is not None and res.best_epoch is not None
    assert res.stats["val_evals"] == 3 and not res.stats["stopped_early"]
    assert res.best_val_nll == min(v for _, v in res.val_history)
    assert m.score(xv, res.best_params) == pytest.approx(res.best_val_nll)

    plain = cnf.ICNFModel(icnf, **kw).fit(x, params=p0)
    for a, b in zip(jax.tree_util.tree_leaves(res.params),
                    jax.tree_util.tree_leaves(plain.params)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

    # conditional models validate with (Xval, Yval); a bare Xval is rejected
    icnf_c = cnf.ICNF.create(nvariables=2, nconditions=1, solver=FAST_TRAIN)
    mc = cnf.CondICNFModel(icnf_c, batchsize=0, epochs=2,
                           key=jax.random.PRNGKey(0))
    y = jnp.zeros((128, 1)); yv = jnp.zeros((64, 1))
    with pytest.raises(ValueError, match="validation_data"):
        mc.fit(x, y, validation_data=xv)
    resc = mc.fit(x, y, validation_data=(xv, yv), eval_every=1)
    assert len(resc.val_history) == 2
    with pytest.raises(ValueError, match="requires Y"):
        mc.score(xv, resc.params)


def test_validated_fit_wine_memorization_repro():
    """The measured-necessary pattern (PARITY round 4: wine memorizes by
    ~3000 full-batch steps, test NLL 16.4 -> 827) is now one keyword away:
    at reduced scale (48 train rows) the validated fit must stop early and
    its best-val params must beat the overfit final params on held-out test
    data."""
    from continuousnormalizingflows_tpu.utils.datasets import load_tabular_real

    xtr_all, xte = load_tabular_real("wine", seed=0)
    xval, xtr = xtr_all[:24], xtr_all[24:72]
    icnf = cnf.ICNF.create(
        nvariables=13, naugments=0, lambda_3=0.0, steer_rate=0.0,
        solver=FAST_TRAIN,
    )
    m = cnf.ICNFModel(icnf, batchsize=0, epochs=800,
                      key=jax.random.PRNGKey(1), steps_per_dispatch=8)
    res = m.fit(xtr, validation_data=xval, eval_every=10, patience=4)
    assert res.stats["stopped_early"], res.stats
    assert res.stats["epochs_run"] < 400  # stops long before the budget
    nll_best = m.score(xte, res.best_params)
    nll_final = m.score(xte, res.params)
    assert nll_best < nll_final, (nll_best, nll_final)


def test_eval_icnf_scores_with_adaptive_solver():
    """score()/validation on the eval_icnf twin: a fixed-step-trained model
    evaluated at the reference's adaptive tolerances (the pairing the
    real-data benchmarks measured as correct)."""
    import dataclasses as dc

    icnf = cnf.ICNF.create(nvariables=2, solver=FAST_TRAIN)
    icnf_eval = cnf.ICNF(
        config=dc.replace(icnf.config,
                          solver=SolverConfig(method="dopri5", rtol=1e-4,
                                              atol=1e-4)),
        net=icnf.net,
    )
    x = datasets.gaussian_mixture(jax.random.PRNGKey(3), 64)
    m = cnf.ICNFModel(icnf, eval_icnf=icnf_eval, batchsize=0, epochs=2,
                      key=jax.random.PRNGKey(0))
    res = m.fit(x, validation_data=x, eval_every=1)
    lp, _, _ = cnf.inference(icnf_eval, Mode.TEST, x, res.params)
    assert m.score(x, res.params) == pytest.approx(-float(jnp.mean(lp)))
    with pytest.raises(ValueError, match="eval_icnf"):
        cnf.ICNFModel(icnf, eval_icnf=cnf.ICNF.create(nvariables=3))


def test_step_cache_cleared_on_traced_attr_mutation():
    """The compiled-step memo is invalidated when any attribute the step
    closes over is mutated (VERDICT round-4 Weak #3: a post-fit
    ``model.optimizer = ...`` silently baked the OLD optimizer into the
    cached program).  Mutation => retrace with the new value, asserted by
    divergent training results."""
    x = datasets.gaussian_mixture(jax.random.PRNGKey(3), 64)
    icnf = cnf.ICNF.create(nvariables=2, solver=FAST_TRAIN)
    p0 = icnf.init(jax.random.PRNGKey(9))

    m = cnf.ICNFModel(icnf, batchsize=0, epochs=2, key=jax.random.PRNGKey(0))
    r1 = m.fit(x, params=p0)
    assert m._step_cache
    m.optimizer = cnf.default_optimizer(learning_rate=1e-6)
    assert not m._step_cache, "mutating optimizer must clear the step memo"
    r2 = m.fit(x, params=p0)
    # the new optimizer is actually in effect (lr 1e-3 vs 1e-6 diverge)
    a = jax.tree_util.tree_leaves(r1.params)[0]
    b = jax.tree_util.tree_leaves(r2.params)[0]
    assert not np.allclose(np.asarray(a), np.asarray(b))

    # batch_transform and icnf mutations clear too (mesh follows same path)
    m.fit(x, params=p0)
    m.batch_transform = lambda k, xb: xb
    assert not m._step_cache
    m.fit(x, params=p0)
    m.icnf = cnf.ICNF.create(nvariables=2, nconditions=1, solver=FAST_TRAIN)
    assert not m._step_cache and m._conditional  # _conditional refreshed


def test_diabetes_validated_fit_beats_full_gaussian():
    """Third real table (diabetes: 442 patients x 9 raw clinical
    measurements, binary sex column dropped — see utils.datasets) through the
    validated-fit API at reduced scale: the flow must beat the
    FULL-covariance Gaussian on held-out data (full protocol + measured
    numbers: benchmarks/tabular_real.py, PARITY round 5)."""
    import dataclasses as dc

    from continuousnormalizingflows_tpu.utils.datasets import load_tabular_real

    xtr_all, xte = load_tabular_real("diabetes", seed=0)
    assert xtr_all.shape[1] == 9  # sex dropped from the 10 raw columns
    n_val = int(0.2 * xtr_all.shape[0])
    xval, xtr = xtr_all[:n_val], xtr_all[n_val:]
    icnf = cnf.ICNF.create(
        nvariables=9, naugments=0, lambda_3=0.0, steer_rate=0.0,
        solver=FAST_TRAIN,
    )
    icnf_eval = cnf.ICNF(
        config=dc.replace(icnf.config,
                          solver=SolverConfig(method="dopri5", rtol=1e-4,
                                              atol=1e-4)),
        net=icnf.net,
    )
    m = cnf.ICNFModel(icnf, eval_icnf=icnf_eval, batchsize=0, epochs=300,
                      key=jax.random.PRNGKey(1), steps_per_dispatch=10)
    res = m.fit(xtr, validation_data=xval, eval_every=50, patience=3)
    nll_flow = m.score(xte, res.best_params)

    xtr_n, xte_n = np.asarray(xtr), np.asarray(xte)
    mu = xtr_n.mean(0)
    cov = np.cov(xtr_n, rowvar=False) + 1e-4 * np.eye(9)
    _, logdet = np.linalg.slogdet(cov)
    sol = np.linalg.solve(cov, (xte_n - mu).T).T
    nll_full = float(np.mean(
        0.5 * (9 * np.log(2 * np.pi) + logdet + ((xte_n - mu) * sol).sum(-1))
    ))
    assert nll_flow < nll_full, (nll_flow, nll_full)


def test_dt0_carry_training():
    """``SolverConfig(dt0="carry")`` (round 5): each train step's adaptive
    solve warm-starts from the previous step's accepted dt — the per-solve
    controller ramp disappears (adaptive train NFE 19 → 7 near init in
    bench.py on an H100).  Asserts: the final step's
    NFE beats the fixed-ramp twin's, the fitted loss agrees (solution-level
    equivalence to solver tolerance), and steps_per_dispatch bit-parity
    holds with the carried scalar in the scan state."""
    x = datasets.gaussian_mixture(jax.random.PRNGKey(3), 256)
    mk = lambda dt0: cnf.ICNF.create(
        nvariables=2,
        solver=SolverConfig(method="dopri5", rtol=1e-4, atol=1e-4,
                            gradient="adjoint", dt0=dt0),
    )
    icnf_c, icnf_f = mk("carry"), mk(0.01)
    p0 = icnf_c.init(jax.random.PRNGKey(9))
    # batch/epochs chosen where BOTH twins train stably on CPU: the
    # adaptive-adjoint toy fit is chaotically marginal on some
    # batch/seed combinations with or without carry (verified against the
    # pre-carry code at HEAD — a known pre-existing trait of loose-tolerance
    # adjoint training, same class as the round-1 clip_norm note)
    kw = dict(batchsize=128, epochs=4, key=jax.random.PRNGKey(0),
              optimizer=cnf.default_optimizer(clip_norm=1.0))

    r_c = cnf.ICNFModel(icnf_c, **kw).fit(x, params=p0)
    r_f = cnf.ICNFModel(icnf_f, **kw).fit(x, params=p0)
    assert r_c.stats["nfe"] < r_f.stats["nfe"], (r_c.stats, r_f.stats)
    assert abs(r_c.stats["final_loss"] - r_f.stats["final_loss"]) < 5e-2

    r_blk = cnf.ICNFModel(icnf_c, steps_per_dispatch=4, **kw).fit(x, params=p0)
    for a, b in zip(jax.tree_util.tree_leaves(r_c.params),
                    jax.tree_util.tree_leaves(r_blk.params)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

    # a bare (non-training) solve under dt0="carry" has no carried value and
    # must fall back to the HNW auto start — same behavior as dt0="auto"
    icnf_a = mk("auto")
    lp_c, _, s_c = cnf.inference(icnf_c, Mode.TEST, x[:32], p0)
    lp_a, _, s_a = cnf.inference(icnf_a, Mode.TEST, x[:32], p0)
    np.testing.assert_array_equal(np.asarray(lp_c), np.asarray(lp_a))
    assert int(s_c.nfe) == int(s_a.nfe)
