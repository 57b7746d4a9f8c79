"""Core API smoke sweep + analytic correctness anchors.

Modeled on the reference's cartesian smoke sweep (test/ci_tests/smoke_tests.jl)
but with *numeric* assertions instead of `!isnothing` existence checks, plus a
closed-form linear-flow check the reference does not have.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import continuousnormalizingflows_tpu as cnf
from continuousnormalizingflows_tpu.config import Mode, SolverConfig, TraceEstimator
from continuousnormalizingflows_tpu.models.nets import MLP, Planar

# fast solver configs for the sweep
FAST_ADAPTIVE = SolverConfig(method="dopri5", rtol=1e-3, atol=1e-3, max_steps=512)
FAST_FIXED = SolverConfig(method="rk4", gradient="backprop", fixed_steps=16)


def make(nvariables=2, planar=False, **kw):
    kw.setdefault("solver", FAST_FIXED)
    if planar:
        from continuousnormalizingflows_tpu.config import ICNFConfig

        cfg = cnf.ICNFConfig(nvariables=nvariables, solver=kw["solver"], **{
            k: v for k, v in kw.items() if k != "solver"
        })
        net = Planar(cfg.n_in, cfg.n_out)
        return cnf.ICNF(config=cfg, net=net)
    return cnf.ICNF.create(nvariables=nvariables, **kw)


@pytest.mark.parametrize("mode", [Mode.TRAIN, Mode.TEST])
@pytest.mark.parametrize("trace", [TraceEstimator.HUTCH_VJP, TraceEstimator.HUTCH_JVP])
@pytest.mark.parametrize("conditioned", [False, True])
@pytest.mark.parametrize("planar", [False, True])
def test_smoke_sweep(mode, trace, conditioned, planar):
    """inference / generate / loss / grads across the variant lattice
    (reference smoke_tests.jl:2-8 sweep, 4 samples x 2 dims)."""
    ncond = 2 if conditioned else 0
    icnf = make(nvariables=2, planar=planar, trace=trace, nconditions=ncond)
    key = jax.random.PRNGKey(0)
    params = icnf.init(key)
    x = 0.5 * jax.random.normal(jax.random.PRNGKey(1), (4, 2))
    ys = jnp.ones((4, ncond)) if conditioned else None

    lp, (e, n, a), nfe = cnf.inference(icnf, mode, x, params, key=key, ys=ys)
    assert lp.shape == (4,) and jnp.all(jnp.isfinite(lp))
    for acc in (e, n, a):
        assert acc.shape == (4,) and jnp.all(jnp.isfinite(acc))
    if mode is Mode.TEST:
        assert jnp.all(e == 0) and jnp.all(n == 0) and jnp.all(a == 0)

    gen_ys = ys[:3] if conditioned else None
    samples = cnf.generate(icnf, mode, params, jax.random.PRNGKey(2), 3, ys=gen_ys)
    assert samples.shape == (3, 2) and jnp.all(jnp.isfinite(samples))

    l = cnf.loss(icnf, mode, x, params, key=key, ys=ys)
    assert jnp.isfinite(l)

    # gradients w.r.t. params AND inputs (reference smoke_tests.jl:68-133)
    gp = jax.grad(lambda p: cnf.loss(icnf, mode, x, p, key=key, ys=ys))(params)
    gsum = sum(jnp.sum(jnp.abs(leaf)) for leaf in jax.tree_util.tree_leaves(gp))
    assert jnp.isfinite(gsum) and gsum > 0
    gx = jax.grad(lambda xx: cnf.loss(icnf, mode, xx, params, key=key, ys=ys))(x)
    assert gx.shape == x.shape and jnp.all(jnp.isfinite(gx))


@pytest.mark.parametrize("mode", [Mode.TRAIN, Mode.TEST])
@pytest.mark.parametrize("trace", [TraceEstimator.HUTCH_VJP, TraceEstimator.HUTCH_JVP])
@pytest.mark.parametrize("conditioned", [False, True])
@pytest.mark.parametrize("planar", [False, True])
def test_feature_first_layout_parity(mode, trace, conditioned, planar):
    """layout='feature_first' (batch minor-most) must be numerically
    equivalent to the default batch-first path: same probes/steer keys →
    same loss, matching gradients, same generate() samples."""
    ncond = 2 if conditioned else 0
    key = jax.random.PRNGKey(3)
    x = 0.5 * jax.random.normal(jax.random.PRNGKey(1), (8, 2))
    ys = jnp.ones((8, ncond)) if conditioned else None

    out = {}
    for layout in ("batch_first", "feature_first"):
        icnf = make(nvariables=2, planar=planar, trace=trace,
                    nconditions=ncond, layout=layout)
        params = icnf.init(jax.random.PRNGKey(7))
        l = cnf.loss(icnf, mode, x, params, key=key, ys=ys)
        g = jax.grad(lambda p: cnf.loss(icnf, mode, x, p, key=key, ys=ys))(params)
        gen_ys = ys[:4] if conditioned else None
        s = cnf.generate(icnf, mode, params, jax.random.PRNGKey(2), 4, ys=gen_ys)
        out[layout] = (l, jax.tree_util.tree_leaves(g), s)

    l_a, g_a, s_a = out["batch_first"]
    l_b, g_b, s_b = out["feature_first"]
    assert abs(float(l_a) - float(l_b)) < 1e-4
    for a, b in zip(g_a, g_b):
        assert jnp.max(jnp.abs(a - b)) < 1e-3
    assert jnp.max(jnp.abs(s_a - s_b)) < 1e-4


def test_quadrature_gradient_full_model():
    """gradient='quadrature' (interpolation adjoint, the QuadratureAdjoint
    analogue) must produce loss gradients matching backprop on the full ICNF
    train path — probes, steering off for determinism."""
    solver_q = SolverConfig(method="dopri5", rtol=1e-6, atol=1e-6,
                            gradient="quadrature")
    solver_bp = SolverConfig(method="rk4", gradient="backprop", fixed_steps=64)
    key = jax.random.PRNGKey(0)
    x = 0.5 * jax.random.normal(jax.random.PRNGKey(1), (8, 2))

    grads = {}
    params0 = None
    for name, solver in (("q", solver_q), ("bp", solver_bp)):
        icnf = make(nvariables=2, solver=solver, steer_rate=0.0)
        params = icnf.init(jax.random.PRNGKey(7))
        if params0 is None:
            params0 = params
        g = jax.grad(lambda p: cnf.loss(icnf, Mode.TRAIN, x, p, key=key))(params)
        grads[name] = jax.tree_util.tree_leaves(g)

    for a, b in zip(grads["q"], grads["bp"]):
        assert jnp.max(jnp.abs(a - b)) < 2e-3, (a, b)


def test_trace_free_sampling_matches_full_path():
    """generate(trace_free=True) integrates the bare field; with the same key
    the base draw and steer are identical, so samples must match the
    augmented-system path to solver tolerance — in TestMode (exact trace
    skipped), TrainMode (probe VJP skipped, steer active), and conditional."""
    solver = SolverConfig(method="dopri5", rtol=1e-6, atol=1e-6)
    key = jax.random.PRNGKey(5)

    # TestMode, unconditional
    icnf = make(nvariables=2, solver=solver)
    params = icnf.init(jax.random.PRNGKey(7))
    s_full = cnf.generate(icnf, Mode.TEST, params, key, 16)
    s_fast = cnf.generate(icnf, Mode.TEST, params, key, 16, trace_free=True)
    assert s_fast.shape == s_full.shape == (16, 2)
    assert jnp.max(jnp.abs(s_fast - s_full)) < 1e-4

    # TrainMode (stochastic probe skipped, steer draw must still agree)
    s_full_tr = cnf.generate(icnf, Mode.TRAIN, params, key, 16)
    s_fast_tr = cnf.generate(icnf, Mode.TRAIN, params, key, 16, trace_free=True)
    assert jnp.max(jnp.abs(s_fast_tr - s_full_tr)) < 1e-4

    # conditional
    icnf_c = make(nvariables=2, nconditions=2, solver=solver)
    params_c = icnf_c.init(jax.random.PRNGKey(8))
    ys = jnp.tile(jnp.array([[1.0, -1.0]]), (8, 1))
    s_full_c = cnf.generate(icnf_c, Mode.TEST, params_c, key, 8, ys=ys)
    s_fast_c = cnf.generate(icnf_c, Mode.TEST, params_c, key, 8, ys=ys,
                            trace_free=True)
    assert jnp.max(jnp.abs(s_fast_c - s_full_c)) < 1e-4

    # ICNFDist front-end passthrough
    d = cnf.ICNFDist(icnf, params)
    s_d = d.sample(key, 16, trace_free=True)
    assert jnp.max(jnp.abs(s_d - s_full)) < 1e-4


def test_generate_with_logp_matches_inference():
    """(samples, logp) from one backward solve: logp must equal a separate
    forward inference solve on those samples (sign/orientation check of the
    accumulator read-off).  naugments=0 so the density is normalized over x
    (with augmentation the augmented coords at t0 are path-dependent and a
    zero-padded inference solve is a different point)."""
    solver = SolverConfig(method="dopri5", rtol=1e-6, atol=1e-6)
    icnf = make(nvariables=2, naugments=0, lambda_3=0.0, solver=solver)
    params = icnf.init(jax.random.PRNGKey(7))
    key = jax.random.PRNGKey(5)

    s, lp = cnf.generate_with_logp(icnf, Mode.TEST, params, key, 16)
    assert s.shape == (16, 2) and lp.shape == (16,)
    # same key → identical samples as plain generate
    s_plain = cnf.generate(icnf, Mode.TEST, params, key, 16)
    assert jnp.max(jnp.abs(s - s_plain)) < 1e-6
    lp_inf, _, _ = cnf.inference(icnf, Mode.TEST, s, params)
    assert jnp.max(jnp.abs(lp - lp_inf)) < 1e-3, (lp, lp_inf)

    # dist facade
    d = cnf.ICNFDist(icnf, params)
    s_d, lp_d = d.sample_with_logpdf(key, 16)
    assert jnp.max(jnp.abs(lp_d - lp)) < 1e-6


def test_abm_quadrature_full_model():
    """method='abm' + gradient='quadrature' — the solver-class-for-solver-class
    mirror of the reference's DEFAULT sensitivity stack (VCABM forward +
    QuadratureAdjoint backward, icnf.jl:89-99) — must match backprop loss
    gradients on the full ICNF train path."""
    solver_q = SolverConfig(method="abm", rtol=1e-6, atol=1e-6,
                            gradient="quadrature", abm_order=6)
    solver_bp = SolverConfig(method="rk4", gradient="backprop", fixed_steps=64)
    key = jax.random.PRNGKey(0)
    x = 0.5 * jax.random.normal(jax.random.PRNGKey(1), (8, 2))

    grads = {}
    for name, solver in (("q", solver_q), ("bp", solver_bp)):
        icnf = make(nvariables=2, solver=solver, steer_rate=0.0)
        params = icnf.init(jax.random.PRNGKey(7))
        g = jax.grad(lambda p: cnf.loss(icnf, Mode.TRAIN, x, p, key=key))(params)
        grads[name] = jax.tree_util.tree_leaves(g)

    for a, b in zip(grads["q"], grads["bp"]):
        assert jnp.max(jnp.abs(a - b)) < 2e-3, (a, b)


def test_adjoint_slim_args_gradient_parity():
    """The backsolve adjoint excludes the probe from its quadrature states
    (round-1 Weak #2): param gradients must still match discretize-then-
    optimize to tight tolerance, and the probe cotangent is a structural
    zero on the adjoint path."""
    solver_adj = SolverConfig(method="dopri5", rtol=1e-6, atol=1e-6,
                              gradient="adjoint")
    solver_bp = SolverConfig(method="rk4", gradient="backprop", fixed_steps=64)
    key = jax.random.PRNGKey(0)
    x = 0.5 * jax.random.normal(jax.random.PRNGKey(1), (8, 2))

    icnf_a = make(nvariables=2, solver=solver_adj, steer_rate=0.0)
    icnf_b = make(nvariables=2, solver=solver_bp, steer_rate=0.0)
    params = icnf_a.init(jax.random.PRNGKey(7))

    g_a = jax.grad(lambda p: cnf.loss(icnf_a, Mode.TRAIN, x, p, key=key))(params)
    g_b = jax.grad(lambda p: cnf.loss(icnf_b, Mode.TRAIN, x, p, key=key))(params)
    for a, b in zip(jax.tree_util.tree_leaves(g_a), jax.tree_util.tree_leaves(g_b)):
        assert jnp.max(jnp.abs(a - b)) < 2e-3

    # probe cotangent: structural zero under the adjoint, by contract
    from continuousnormalizingflows_tpu.ops.adjoint import odeint_diff

    def run(eps):
        args = {"params": jnp.float32(0.3), "eps": eps}

        def f(t, y, a):
            return a["params"] * y + jnp.mean(a["eps"]) * 0.0

        y1, _ = odeint_diff(f, jnp.ones((2,)), 0.0, 1.0, args, solver_adj)
        return jnp.sum(y1)

    g_eps = jax.grad(run)(jnp.ones((3, 2)))
    np.testing.assert_allclose(np.asarray(g_eps), 0.0)


def test_trajectory_dense_path():
    """cnf.trajectory: z(t) at arbitrary times via the dense interpolant —
    endpoints must match the direct solve; path must be continuous."""
    icnf = make(nvariables=2, solver=SolverConfig(rtol=1e-5, atol=1e-5))
    params = icnf.init(jax.random.PRNGKey(0))
    x = 0.5 * jax.random.normal(jax.random.PRNGKey(1), (6, 2))
    ts = jnp.linspace(0.0, 1.0, 9)

    path, nfe = cnf.trajectory(icnf, x, params, ts)
    assert path.shape == (9, 6, icnf.config.nz)
    assert int(nfe) > 6
    # t=0 snapshot is the (augmented-padded) input
    np.testing.assert_allclose(
        np.asarray(path[0, :, :2]), np.asarray(x), rtol=1e-5, atol=1e-5
    )
    np.testing.assert_allclose(
        np.asarray(path[0, :, 2:]), 0.0, atol=1e-6
    )
    # the flow map is deterministic: the t=1 snapshot must be consistent
    # with an independent trajectory call evaluated only at t=1
    path2, _ = cnf.trajectory(icnf, x, params, jnp.array([1.0]))
    np.testing.assert_allclose(
        np.asarray(path[-1]), np.asarray(path2[0]), rtol=1e-5, atol=1e-5
    )
    # continuity: adjacent snapshots differ boundedly
    deltas = np.asarray(jnp.max(jnp.abs(path[1:] - path[:-1])))
    assert deltas.max() < 5.0


def test_trajectory_feature_first_layout():
    """trajectory() must work (and agree with batch-first) when the model is
    configured with layout='feature_first' — it always builds batch-first
    state, forcing the batch-first dynamics internally."""
    solver = SolverConfig(rtol=1e-5, atol=1e-5)
    ts = jnp.linspace(0.0, 1.0, 5)
    icnf_bf = make(nvariables=2, solver=solver, layout="batch_first")
    params = icnf_bf.init(jax.random.PRNGKey(0))
    # batch != state_dim so a layout mix-up cannot silently broadcast
    x = 0.5 * jax.random.normal(jax.random.PRNGKey(1), (6, 2))
    path_bf, _ = cnf.trajectory(icnf_bf, x, params, ts)

    icnf_ff = make(nvariables=2, solver=solver, layout="feature_first")
    path_ff, _ = cnf.trajectory(icnf_ff, x, params, ts)
    np.testing.assert_allclose(
        np.asarray(path_ff), np.asarray(path_bf), rtol=1e-5, atol=1e-6
    )


def test_abm_solver_full_model_parity():
    """method='abm' (the reference's VCABM solver class) must reproduce the
    dopri5 log-densities within the shared tolerance class, at lower NFE."""
    # same fixed start for both: the solver-CLASS NFE comparison must not be
    # confounded by the HNW auto start (which dopri5 uses and abm does not)
    icnf_dp = make(nvariables=2, solver=SolverConfig(method="dopri5", dt0=0.01))
    icnf_abm = make(nvariables=2, solver=SolverConfig(method="abm", dt0=0.01))
    params = icnf_dp.init(jax.random.PRNGKey(0))
    x = 0.5 * jax.random.normal(jax.random.PRNGKey(1), (16, 2))
    lp_dp, _, st_dp = cnf.inference(icnf_dp, Mode.TEST, x, params)
    lp_abm, _, st_abm = cnf.inference(icnf_abm, Mode.TEST, x, params)
    np.testing.assert_allclose(np.asarray(lp_abm), np.asarray(lp_dp),
                               rtol=2e-3, atol=2e-3)
    assert int(st_abm.nfe) < int(st_dp.nfe), (int(st_abm.nfe), int(st_dp.nfe))


def test_vector_mode_single_sample():
    """A 1-D input behaves as the reference's VectorMode: scalar outputs."""
    icnf = make(nvariables=2)
    params = icnf.init(jax.random.PRNGKey(0))
    x = jnp.array([0.1, -0.2])
    lp, (e, n, a), _ = cnf.inference(icnf, Mode.TRAIN, x, params, key=jax.random.PRNGKey(1))
    assert lp.shape == () and e.shape == ()


def test_train_requires_key():
    icnf = make()
    params = icnf.init(jax.random.PRNGKey(0))
    with pytest.raises(ValueError):
        cnf.inference(icnf, Mode.TRAIN, jnp.zeros((2, 2)), params)


def test_test_mode_deterministic():
    icnf = make()
    params = icnf.init(jax.random.PRNGKey(0))
    x = jnp.ones((3, 2)) * 0.3
    lp1, _, _ = cnf.inference(icnf, Mode.TEST, x, params)
    lp2, _, _ = cnf.inference(icnf, Mode.TEST, x, params, key=jax.random.PRNGKey(42))
    np.testing.assert_allclose(np.asarray(lp1), np.asarray(lp2))


def test_steer_changes_t1():
    """STEER randomizes the end time in train mode only (base_icnf.jl:23-39)."""
    icnf = make(steer_rate=0.3, lambda_1=0.0, lambda_2=0.0, lambda_3=0.0)
    params = icnf.init(jax.random.PRNGKey(0))
    x = jnp.ones((4, 2)) * 0.2
    lps = [
        float(cnf.loss(icnf, Mode.TRAIN, x, params, key=jax.random.PRNGKey(s)))
        for s in range(3)
    ]
    assert len(set(lps)) > 1  # different steered spans -> different losses


class TestAnalyticLinearFlow:
    """For linear dynamics dz/dt = A z (autonomous, unaugmented, exact trace):
    z(1) = e^A z(0) and logp(x) = logN(e^A x) + tr(A) — closed form."""

    def _model(self, A):
        d = A.shape[0]
        net = MLP((d, d))
        icnf = cnf.ICNF(
            config=cnf.ICNFConfig(
                nvariables=d,
                naugments=0,
                autonomous=True,
                lambda_1=0.0,
                lambda_2=0.0,
                lambda_3=0.0,
                steer_rate=0.0,
                solver=SolverConfig(rtol=1e-6, atol=1e-6),
            ),
            net=net,
        )
        params = [{"w": A.T, "b": jnp.zeros((d,))}]  # x @ A.T = A x
        return icnf, params

    def test_logpdf_matches_closed_form(self):
        A = jnp.array([[0.3, 0.1], [-0.2, 0.4]])
        icnf, params = self._model(A)
        x = jax.random.normal(jax.random.PRNGKey(0), (6, 2))

        lp, _, _ = cnf.inference(icnf, Mode.TEST, x, params)

        import scipy.linalg

        eA = jnp.asarray(scipy.linalg.expm(np.asarray(A)))
        z1 = x @ eA.T
        expected = -0.5 * (2 * np.log(2 * np.pi) + jnp.sum(z1**2, -1)) + jnp.trace(A)
        np.testing.assert_allclose(np.asarray(lp), np.asarray(expected), rtol=1e-4, atol=1e-4)

    def test_generate_roundtrip_density(self):
        """generate() then inference(): samples from base pushed backward
        land where the model assigns mass."""
        A = 0.2 * jnp.eye(2)
        icnf, params = self._model(A)
        samples = cnf.generate(icnf, Mode.TEST, params, jax.random.PRNGKey(1), 512)
        # backward map is x = e^{-A} z, z ~ N(0, I) => x ~ N(0, e^{-2*0.2} I)
        var = np.var(np.asarray(samples))
        assert abs(var - np.exp(-0.4)) < 0.1


def test_exact_vs_hutchinson_consistency():
    """TEST-mode exact logpx ≈ TRAIN-mode Hutchinson logpx with many probes
    (no regularization, no steer) — the BASELINE.json config-2 parity check."""
    icnf_t = cnf.ICNF.create(
        nvariables=2,
        lambda_1=0.0,
        lambda_2=0.0,
        lambda_3=0.0,
        steer_rate=0.0,
        nprobes=512,
        solver=SolverConfig(rtol=1e-5, atol=1e-5),
    )
    params = icnf_t.init(jax.random.PRNGKey(0))
    x = 0.5 * jax.random.normal(jax.random.PRNGKey(1), (8, 2))
    lp_exact, _, _ = cnf.inference(icnf_t, Mode.TEST, x, params)
    lp_hutch, _, _ = cnf.inference(icnf_t, Mode.TRAIN, x, params, key=jax.random.PRNGKey(2))
    np.testing.assert_allclose(np.asarray(lp_exact), np.asarray(lp_hutch), rtol=0.05, atol=0.1)


def test_train_noreg_mode():
    """Mode.TRAIN_NOREG (reference TrainMode{false}): stochastic trace with
    zero regularization accumulators even when lambdas are set."""
    icnf = make(nvariables=2)  # default lambdas 0.01
    params = icnf.init(jax.random.PRNGKey(0))
    x = 0.3 * jax.random.normal(jax.random.PRNGKey(1), (4, 2))
    key = jax.random.PRNGKey(2)
    lp, (e, n, a), _ = cnf.inference(icnf, Mode.TRAIN_NOREG, x, params, key=key)
    assert jnp.all(e == 0) and jnp.all(n == 0) and jnp.all(a == 0)
    lp_r, (e_r, n_r, _), _ = cnf.inference(icnf, Mode.TRAIN, x, params, key=key)
    assert jnp.any(e_r != 0) and jnp.any(n_r != 0)
    # STEER applies only in regularized train mode; with steer off the logpx
    # from the same key/probe must agree
    icnf_ns = make(nvariables=2, steer_rate=0.0)
    p2 = icnf_ns.init(jax.random.PRNGKey(0))
    lp1, _, _ = cnf.inference(icnf_ns, Mode.TRAIN_NOREG, x, p2, key=key)
    lp2, _, _ = cnf.inference(icnf_ns, Mode.TRAIN, x, p2, key=key)
    np.testing.assert_allclose(np.asarray(lp1), np.asarray(lp2), rtol=2e-4, atol=1e-5)


def test_float64_support():
    """Reference supports data_type=Float64; verify the x64 path end-to-end."""
    jax.config.update("jax_enable_x64", True)
    try:
        icnf = cnf.ICNF.create(
            nvariables=2, dtype=jnp.float64,
            solver=SolverConfig(method="rk4", gradient="backprop", fixed_steps=8),
        )
        params = icnf.init(jax.random.PRNGKey(0))
        x = 0.3 * jax.random.normal(jax.random.PRNGKey(1), (4, 2), jnp.float64)
        lp, _, _ = cnf.inference(icnf, Mode.TEST, x, params)
        assert lp.dtype == jnp.float64 and bool(jnp.all(jnp.isfinite(lp)))
    finally:
        jax.config.update("jax_enable_x64", False)


def test_steer_dist_pluggable():
    """``steerdist`` as a first-class constructor field (icnf.jl:49, default
    Uniform at icnf.jl:104, drawn at base_icnf.jl:36): a constant custom
    steering distribution must reproduce BIT-EXACTLY the unsteered model
    integrated over the equivalently extended span (same key => same probe;
    only t1 differs, and it differs deterministically)."""
    from continuousnormalizingflows_tpu.distributions import CustomDist

    const_quarter = CustomDist(
        None, lambda key, shape, dtype: jnp.full(shape, 0.25, dtype), "const"
    )
    kw = dict(lambda_1=0.01, lambda_2=0.01, lambda_3=0.0)
    steered = make(steer_rate=0.0, steer_dist=const_quarter, **kw)
    assert steered.config.steered  # a steer_dist activates STEER on its own
    stretched = cnf.ICNF(
        config=cnf.ICNFConfig(
            nvariables=2, tspan=(0.0, 1.25), steer_rate=0.0,
            solver=FAST_FIXED, **kw,
        ),
        net=steered.net,
    )
    params = steered.init(jax.random.PRNGKey(0))
    x = jnp.asarray(np.random.default_rng(0).normal(size=(8, 2)), jnp.float32)
    key = jax.random.PRNGKey(5)
    l_steer = float(cnf.loss(steered, Mode.TRAIN, x, params, key=key))
    l_stretch = float(cnf.loss(stretched, Mode.TRAIN, x, params, key=key))
    assert l_steer == l_stretch, (l_steer, l_stretch)

    # the distribution is actually consulted: a different constant moves t1
    const_zero = CustomDist(
        None, lambda key, shape, dtype: jnp.zeros(shape, dtype), "zero"
    )
    plain = make(steer_rate=0.0, steer_dist=const_zero, **kw)
    l_zero = float(cnf.loss(plain, Mode.TRAIN, x, params, key=key))
    assert l_zero != l_steer

    # TEST mode ignores steering (steer_tspan dispatches on TrainMode{true})
    lp_s, _, _ = cnf.inference(steered, Mode.TEST, x, params)
    lp_z, _, _ = cnf.inference(plain, Mode.TEST, x, params)
    np.testing.assert_array_equal(np.asarray(lp_s), np.asarray(lp_z))

    # validation: a steer_dist without a sampler is rejected loudly
    with pytest.raises(ValueError, match="steer_dist needs"):
        make(steer_dist=CustomDist(lambda z: z, None))

    # end-to-end: a short TRAIN-mode fit through the estimator runs and is
    # finite with a non-uniform steering distribution
    from continuousnormalizingflows_tpu.distributions import uniform_probe

    icnf_fit = make(steer_rate=0.0, steer_dist=uniform_probe(), **kw)
    res = cnf.ICNFModel(icnf_fit, batchsize=0, epochs=3,
                        key=jax.random.PRNGKey(1)).fit(x)
    assert np.isfinite(res.stats["final_loss"])


def test_carry_dt0_gradient_parity_full_model():
    """Warm-started solves (dt0= override, fwd AND backward via
    adjoint._bwd_dt0) must return the same gradients as the fixed-ramp path
    to solver tolerance, on both continuous-adjoint modes (the correctness
    contract behind the measured 2.37x carry win, PARITY round 5)."""
    x = jnp.asarray(np.random.default_rng(0).normal(size=(32, 2)), jnp.float32)
    p0 = cnf.ICNF.create(nvariables=2).init(jax.random.PRNGKey(9))
    key = jax.random.PRNGKey(0)
    for grad_mode in ("adjoint", "quadrature"):
        mk = lambda dt0: cnf.ICNF.create(
            nvariables=2,
            solver=SolverConfig(method="dopri5", rtol=1e-5, atol=1e-5,
                                gradient=grad_mode, dt0=dt0),
        )
        g_c = jax.grad(lambda p: cnf.loss(mk("carry"), Mode.TRAIN, x, p,
                                          key=key, dt0=jnp.float32(0.4)))(p0)
        g_f = jax.grad(lambda p: cnf.loss(mk(0.01), Mode.TRAIN, x, p,
                                          key=key))(p0)
        d = max(float(jnp.max(jnp.abs(a - b))) for a, b in zip(
            jax.tree_util.tree_leaves(g_c), jax.tree_util.tree_leaves(g_f)))
        assert d < 5e-4, (grad_mode, d)
