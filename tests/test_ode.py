"""Integrator correctness: accuracy, reverse spans, pytree states, gradients.

All solves run under ``jax.jit`` — eager ``lax.while_loop`` dispatches op-by-op
and is orders of magnitude slower; jit-first is also how the library invokes
the integrators (core.py jits at the API boundary).
"""

import functools

import jax
import jax.numpy as jnp
import pytest

from continuousnormalizingflows_tpu.config import SolverConfig
from continuousnormalizingflows_tpu.ops.adjoint import odeint_diff
from continuousnormalizingflows_tpu.ops.ode import (
    eval_dense,
    odeint_abm_dense,
    odeint,
    odeint_dopri5,
    odeint_dopri5_dense,
    odeint_fixed,
)


def f_decay(t, y, args):
    return -y


def f_linear(t, y, args):
    return args * y


@functools.partial(jax.jit, static_argnums=(0, 5))
def jsolve(f, y0, t0, t1, args, cfg):
    return odeint(f, y0, t0, t1, args, cfg)


class TestAccuracy:
    def test_dopri5_exponential(self):
        y0 = jnp.ones((4, 3))
        y1, nfe = jsolve(f_decay, y0, 0.0, 1.0, None, SolverConfig())
        assert jnp.max(jnp.abs(y1 - jnp.exp(-1.0))) < 1e-4
        assert int(nfe) > 6

    def test_solver_stats_diagnostics(self):
        """SolverStats bookkeeping: trials = accepted + rejected, NFE follows
        the per-trial eval count, dt_final is a sane controller state.

        The init-eval count depends on dt0: the default ``dt0="auto"`` runs
        the HNW starting-step algorithm, which costs one Euler-probe f eval on
        top of the FSAL init eval (ops.ode._initial_dt); a float dt0 skips it.
        """
        for dt0, n_init in (("auto", 2), (0.01, 1)):
            cfg = SolverConfig(dt0=dt0)
            stats = jsolve(f_decay, jnp.ones((4, 3)), 0.0, 1.0, None, cfg)[1]
            na, nr, nfe = int(stats.naccept), int(stats.nreject), int(stats.nfe)
            assert na > 0 and nr >= 0
            # FSAL: init eval(s) + 6 per trial
            assert nfe == n_init + 6 * (na + nr), (dt0, nfe, na, nr)
            assert float(stats.dt_final) > 0.0

        # a tight-tolerance solve of a curvy problem must report rejections
        def f_osc(t, y, args):
            return jnp.stack([y[1], -40.0 * y[0]])

        cfg = SolverConfig(rtol=1e-7, atol=1e-7, dt0=0.5, max_factor=100.0)
        stats2 = jsolve(f_osc, jnp.array([1.0, 0.0]), 0.0, 3.0, None, cfg)[1]
        assert int(stats2.nreject) > 0

        # fixed-step path: naccept = steps, nreject = 0
        cfgf = SolverConfig(method="rk4", gradient="backprop", fixed_steps=16)
        statsf = jsolve(f_decay, jnp.ones((2,)), 0.0, 1.0, None, cfgf)[1]
        assert int(statsf.naccept) == 16 and int(statsf.nreject) == 0
        assert abs(float(statsf.dt_final) - 1.0 / 16) < 1e-7

    def test_abm_exponential(self):
        """Variable-step Adams-Bashforth-Moulton PECE (the reference's VCABM
        solver class, icnf.jl:89): accuracy within tolerance class at ~2
        f-evals/step."""
        y0 = jnp.ones((4, 3))
        cfg = SolverConfig(method="abm")
        y1, stats = jsolve(f_decay, y0, 0.0, 1.0, None, cfg)
        assert jnp.max(jnp.abs(y1 - jnp.exp(-1.0))) < 5e-4
        # multistep efficiency: 2 evals per trial + 1 init
        assert int(stats.nfe) == 1 + 2 * (int(stats.naccept) + int(stats.nreject))

    def test_abm_tightens_with_tolerance(self):
        y0 = jnp.array([1.0, 0.5])

        def f_osc(t, y, args):
            return jnp.stack([y[1], -y[0]])

        sol = lambda t: jnp.array([jnp.cos(t) + 0.5 * jnp.sin(t),
                                   -jnp.sin(t) + 0.5 * jnp.cos(t)])
        errs = []
        for tol in (1e-3, 1e-5):
            cfg = SolverConfig(method="abm", rtol=tol, atol=tol)
            y1, _ = jsolve(f_osc, y0, 0.0, 3.0, None, cfg)
            errs.append(float(jnp.max(jnp.abs(y1 - sol(3.0)))))
        assert errs[1] < errs[0] / 10, errs
        # global error tracks ~10x the local tolerance (standard for local
        # error control over a 3-unit span)
        assert errs[1] < 2e-4, errs

    def test_abm_reverse_span(self):
        cfg = SolverConfig(method="abm", rtol=1e-6, atol=1e-6)
        y0 = jnp.array([[1.0, 2.0]])
        y1, _ = jsolve(f_decay, y0, 0.0, 1.0, None, cfg)
        y0_rec, _ = jsolve(f_decay, y1, 1.0, 0.0, None, cfg)
        assert jnp.max(jnp.abs(y0_rec - y0)) < 1e-4

    def test_abm_adjoint_gradients(self):
        cfg = SolverConfig(method="abm", gradient="adjoint", rtol=1e-6, atol=1e-6)

        @jax.jit
        def grads(a, y0):
            def run(a_, y0_):
                y1, _ = odeint_diff(f_linear, y0_, 0.0, 1.0, a_, cfg)
                return jnp.sum(y1)

            return jax.grad(run, argnums=(0, 1))(a, y0)

        ga, gy0 = grads(jnp.float32(0.3), jnp.array([1.0, 2.0]))
        assert abs(float(ga) - 3 * jnp.exp(0.3)) < 1e-3
        assert jnp.max(jnp.abs(gy0 - jnp.exp(0.3))) < 1e-3

    @pytest.mark.parametrize("order", [2, 3, 5, 6, 8])
    @pytest.mark.parametrize("direction", ["fwd", "rev"])
    def test_abm_order_sweep_matches_dopri5(self, order, direction):
        """Property check across the order-adaptation range (incl. the mid
        orders whose Milne factors the round-3 review corrected): every
        abm_order cap, in both time directions, must agree with a
        tight-tolerance dopri5 reference on a random smooth field."""
        key = jax.random.PRNGKey(order)
        w = 0.6 * jax.random.normal(key, (6, 6))

        def f_rand(t, y, args):
            return jnp.tanh(y @ w.T) - 0.3 * y + 0.2 * jnp.cos(2 * t)

        y0 = jnp.linspace(-1.0, 1.0, 6)[None, :]
        t0, t1 = (0.0, 2.0) if direction == "fwd" else (2.0, 0.0)
        ref, _ = jsolve(f_rand, y0, t0, t1, None,
                        SolverConfig(method="dopri5", rtol=1e-9, atol=1e-9))
        cfg = SolverConfig(method="abm", rtol=1e-5, atol=1e-5, abm_order=order)
        y1, stats = jsolve(f_rand, y0, t0, t1, None, cfg)
        assert float(jnp.max(jnp.abs(y1 - ref))) < 1e-3, (order, direction)
        # PECE economy invariant holds at every order
        assert int(stats.nfe) == 1 + 2 * (int(stats.naccept) + int(stats.nreject))

    def test_abm_budget_exhaustion_is_loud(self):
        cfg = SolverConfig(method="abm", max_steps=3)
        y1, _ = jsolve(f_decay, jnp.ones((2,)), 0.0, 1.0, None, cfg)
        assert jnp.all(jnp.isnan(y1))

    @pytest.mark.parametrize("method,tol", [("rk4", 1e-5), ("euler", 5e-2)])
    def test_fixed_exponential(self, method, tol):
        cfg = SolverConfig(method=method, gradient="backprop", fixed_steps=64)
        y0 = jnp.ones((2, 2))
        y1, _ = jsolve(f_decay, y0, 0.0, 1.0, None, cfg)
        assert jnp.max(jnp.abs(y1 - jnp.exp(-1.0))) < tol

    def test_reverse_span(self):
        """Integrating backward must invert the forward map."""
        cfg = SolverConfig(rtol=1e-6, atol=1e-6)
        y0 = jnp.array([[1.0, 2.0]])
        y1, _ = jsolve(f_decay, y0, 0.0, 1.0, None, cfg)
        y0_rec, _ = jsolve(f_decay, y1, 1.0, 0.0, None, cfg)
        assert jnp.max(jnp.abs(y0_rec - y0)) < 1e-4

    def test_pytree_state(self):
        def f(t, y, args):
            return {"a": -y["a"], "b": 2.0 * y["b"]}

        y0 = {"a": jnp.ones((3,)), "b": jnp.ones((2, 2))}
        y1, _ = jsolve(f, y0, 0.0, 1.0, None, SolverConfig())
        assert jnp.max(jnp.abs(y1["a"] - jnp.exp(-1.0))) < 1e-4
        assert jnp.max(jnp.abs(y1["b"] - jnp.exp(2.0))) < 1e-2

    def test_max_steps_exhaustion_poisons_result(self):
        """Hitting the step budget must fail loudly (NaN), never silently
        return a truncated trajectory — the reference never truncates
        (maxiters = typemax, icnf.jl:86)."""
        cfg = SolverConfig(rtol=1e-9, atol=1e-9, max_steps=3)
        y1, _ = jsolve(f_decay, jnp.ones((2, 2)), 0.0, 10.0, None, cfg)
        assert jnp.all(jnp.isnan(y1))
        # ... while a budget that suffices stays finite
        cfg_ok = SolverConfig(rtol=1e-4, atol=1e-4, max_steps=1000)
        y1, _ = jsolve(f_decay, jnp.ones((2, 2)), 0.0, 10.0, None, cfg_ok)
        assert jnp.all(jnp.isfinite(y1))

    def test_traced_endpoint(self):
        """t1 may be a traced scalar (STEER) — must work under jit."""

        @jax.jit
        def run(t1):
            y1, _ = odeint_dopri5(f_decay, jnp.ones((2,)), 0.0, t1, None, SolverConfig())
            return y1

        out = run(jnp.float32(0.5))
        assert jnp.max(jnp.abs(out - jnp.exp(-0.5))) < 1e-4


class TestTsit5:
    def test_accuracy_and_order(self):
        """Tsit5 must meet the adaptive error control, and its fixed-step
        Richardson convergence order must be ~5 — this pins the tableau
        coefficients (a wrong entry collapses the observed order).  Measured
        note (PARITY.md): its leading error constant is slightly *larger* than
        DP5's on CNF-like fields, so dopri5 remains the default; tsit5 exists
        for parity with the reference's pluggable `sol_kwargs.alg`."""
        y0 = jnp.ones((4, 3))

        def f(t, y, args):
            return -y + 0.3 * jnp.sin(3.0 * t)

        cfg = SolverConfig(method="tsit5", rtol=1e-6, atol=1e-6)
        y1, nfe = jsolve(f, y0, 0.0, 2.0, None, cfg)
        # analytic: linear ODE y' = -y + 0.3 sin(3t)
        c = 0.3 / 10.0  # 1/(1+9)
        part = c * (jnp.sin(3 * 2.0) - 3 * jnp.cos(3 * 2.0))
        hom = (1.0 - c * (0.0 - 3.0)) * jnp.exp(-2.0)
        ref = hom + part
        assert jnp.max(jnp.abs(y1 - ref)) < 1e-5
        assert int(nfe) > 6

        # Richardson order check of the raw tableau
        import math

        from continuousnormalizingflows_tpu.ops.ode import TSIT5, _erk_step

        def g(t, y, args):
            return jnp.cos(10.0 * t) * y

        def fixed_solve(n):
            dt = jnp.float32(2.0) / n
            ts = jnp.arange(n, dtype=jnp.float32) * dt

            def body(carry, t):
                y, k1 = carry
                y2, _e, k2 = _erk_step(TSIT5, g, t, y, dt, k1, None)
                return (y2, k2), None

            y00 = jnp.array([1.0])
            (y, _k), _ = jax.lax.scan(body, (y00, g(0.0, y00, None)), ts)
            return y

        d1 = float(jnp.abs(fixed_solve(16) - fixed_solve(32))[0])
        d2 = float(jnp.abs(fixed_solve(32) - fixed_solve(64))[0])
        order = math.log2(d1 / d2)
        assert order > 4.5, (order, d1, d2)

    def test_gradients_and_quadrature(self):
        cfg = SolverConfig(method="tsit5", gradient="quadrature", rtol=1e-6, atol=1e-6)

        @jax.jit
        def grads(a, y0):
            def run(a_, y0_):
                y1, _ = odeint_diff(f_linear, y0_, 0.0, 1.0, a_, cfg)
                return jnp.sum(y1)

            return jax.grad(run, argnums=(0, 1))(a, y0)

        ga, gy0 = grads(jnp.float32(0.3), jnp.array([1.0, 2.0]))
        assert abs(float(ga) - 3 * jnp.exp(0.3)) < 1e-3
        assert jnp.max(jnp.abs(gy0 - jnp.exp(0.3))) < 1e-3


class TestDenseOutput:
    def test_interpolant_accuracy(self):
        """Dense cubic-Hermite evaluation vs the analytic trajectory at many
        off-node times."""
        cfg = SolverConfig(rtol=1e-6, atol=1e-6)
        y0 = jnp.array([1.0, 2.0])

        @jax.jit
        def solve(y0_):
            return odeint_dopri5_dense(f_decay, y0_, 0.0, 1.0, None, cfg)

        y1, nfe, dense = solve(y0)
        assert int(dense.n) >= 2
        ts = jnp.linspace(0.0, 1.0, 23)
        for t in ts:
            y_t = eval_dense(dense, t)
            ref = y0 * jnp.exp(-t)
            assert jnp.max(jnp.abs(y_t - ref)) < 1e-4, float(t)

    def test_interpolant_reverse(self):
        cfg = SolverConfig(rtol=1e-6, atol=1e-6)
        y1 = jnp.array([0.5])

        @jax.jit
        def solve(y1_):
            return odeint_dopri5_dense(f_decay, y1_, 1.0, 0.0, None, cfg)

        _y0, _nfe, dense = solve(y1)
        y_mid = eval_dense(dense, jnp.float32(0.5))
        # trajectory through (t=1, 0.5): y(t) = 0.5 e^{1-t}
        assert jnp.max(jnp.abs(y_mid - 0.5 * jnp.exp(0.5))) < 1e-4

    def test_node_buffer_overflow_is_loud(self):
        """A solve accepting more steps than dense_max_nodes must NaN-poison
        the result and the interpolant — never silently degrade (the overflow
        regime, many accepted steps, is exactly when the quadrature adjoint is
        chosen for its interpolation accuracy)."""

        def f_osc(t, y, args):
            return jnp.stack([y[1], -y[0]])

        y0 = jnp.array([1.0, 0.0])

        @functools.partial(jax.jit, static_argnums=(1,))
        def solve(y0_, cfg):
            return odeint_dopri5_dense(f_osc, y0_, 0.0, 20.0, None, cfg)

        # control: ample buffer — finite result, many accepted nodes
        big = SolverConfig(rtol=1e-6, atol=1e-6, dense_max_nodes=512)
        y1, _nfe, dense = solve(y0, big)
        assert jnp.all(jnp.isfinite(y1))
        assert int(dense.n) > 8

        # overflow: tiny buffer — everything poisoned
        small = SolverConfig(rtol=1e-6, atol=1e-6, dense_max_nodes=8)
        y1_bad, _nfe, dense_bad = solve(y0, small)
        assert jnp.all(jnp.isnan(y1_bad))
        assert jnp.all(jnp.isnan(eval_dense(dense_bad, jnp.float32(0.5))))

    def test_quadrature_gradient_overflow_is_loud(self):
        """Quadrature-adjoint gradients through an overflowed dense buffer
        must surface as NaN, not as a silently wrong value."""

        def f_osc(t, y, args):
            return jnp.stack([args * y[1], -args * y[0]])

        cfg = SolverConfig(
            rtol=1e-6, atol=1e-6, gradient="quadrature", dense_max_nodes=8
        )

        @jax.jit
        def grad_a(a):
            def run(a_):
                y1, _ = odeint_diff(f_osc, jnp.array([1.0, 0.0]), 0.0, 20.0, a_, cfg)
                return jnp.sum(y1)

            return jax.grad(run)(a)

        assert jnp.isnan(grad_a(jnp.float32(1.0)))

    def test_abm_interpolant_accuracy(self):
        """ABM dense output (nodes = PECE corrector states + second-evaluate
        derivatives) vs the analytic trajectory — pairs ``method="abm"`` with
        the quadrature adjoint, mirroring the reference's default
        VCABM + QuadratureAdjoint stack (icnf.jl:89-99)."""
        cfg = SolverConfig(method="abm", rtol=1e-6, atol=1e-6, abm_order=6)
        y0 = jnp.array([1.0, 2.0])

        @jax.jit
        def solve(y0_):
            return odeint_abm_dense(f_decay, y0_, 0.0, 1.0, None, cfg)

        y1, stats, dense = solve(y0)
        assert int(dense.n) == int(stats.naccept) + 1
        for t in jnp.linspace(0.0, 1.0, 23):
            y_t = eval_dense(dense, t)
            assert jnp.max(jnp.abs(y_t - y0 * jnp.exp(-t))) < 1e-4, float(t)

    def test_abm_node_buffer_overflow_is_loud(self):
        def f_osc(t, y, args):
            return jnp.stack([y[1], -y[0]])

        y0 = jnp.array([1.0, 0.0])

        @functools.partial(jax.jit, static_argnums=(1,))
        def solve(y0_, cfg):
            return odeint_abm_dense(f_osc, y0_, 0.0, 20.0, None, cfg)

        big = SolverConfig(method="abm", rtol=1e-6, atol=1e-6,
                           dense_max_nodes=1024)
        y1, _stats, dense = solve(y0, big)
        assert jnp.all(jnp.isfinite(y1))
        assert int(dense.n) > 8

        small = SolverConfig(method="abm", rtol=1e-6, atol=1e-6,
                             dense_max_nodes=8)
        y1_bad, _stats, dense_bad = solve(y0, small)
        assert jnp.all(jnp.isnan(y1_bad))
        assert jnp.all(jnp.isnan(eval_dense(dense_bad, jnp.float32(0.5))))

    def test_abm_quadrature_gradients(self):
        """The reference's default sensitivity stack, solver-class for
        solver-class: ABM (VCABM-class) forward with a dense interpolant +
        interpolation-adjoint backward.  Gradients must match both the ABM
        backsolve adjoint and the dopri5 quadrature path."""
        W = jnp.array([[0.3, -0.2], [0.1, 0.25]])
        y0 = jnp.array([[1.0, -0.5], [0.2, 0.8], [-1.1, 0.4]])

        def nf(t, y, args):
            return jnp.tanh(y @ args["W"]) + 0.1 * jnp.sin(t)

        def gradW(cfg):
            @jax.jit
            def g(W_):
                def run(W__):
                    y1, _ = odeint_diff(
                        nf, y0, 0.0, 1.0, {"W": W__, "eps": None}, cfg
                    )
                    return jnp.sum(y1**2)

                return jax.grad(run)(W_)

            return g(W)

        g_abm_quad = gradW(
            SolverConfig(method="abm", rtol=1e-6, atol=1e-6,
                         gradient="quadrature")
        )
        g_abm_adj = gradW(
            SolverConfig(method="abm", rtol=1e-6, atol=1e-6,
                         gradient="adjoint")
        )
        g_dp_quad = gradW(
            SolverConfig(method="dopri5", rtol=1e-6, atol=1e-6,
                         gradient="quadrature")
        )
        assert jnp.max(jnp.abs(g_abm_quad - g_abm_adj)) < 1e-3
        assert jnp.max(jnp.abs(g_abm_quad - g_dp_quad)) < 1e-3


class TestAutoDt0:
    def test_validation(self):
        import pytest

        with pytest.raises(ValueError):
            SolverConfig(dt0="bogus")
        with pytest.raises(ValueError):
            SolverConfig(dt0=0.0)
        SolverConfig(dt0="auto")
        SolverConfig(dt0=0.25)

    def test_auto_start_saves_ramp_steps(self):
        """The HNW starting-step algorithm (dt0="auto", the default — also the
        reference's SciML behavior when no dt is given) must not cost NFE vs
        the fixed 0.01 start, and must produce the same solution within
        tolerance.  On smooth problems the fixed start pays 1-3 ramp steps."""
        y0 = jnp.array([1.0, 2.0])

        def run(dt0, rtol):
            cfg = SolverConfig(method="dopri5", rtol=rtol, atol=rtol, dt0=dt0)

            @jax.jit
            def solve(y0_):
                return odeint(f_decay, y0_, 0.0, 1.0, None, cfg)

            return solve(y0)

        # default tolerance: auto must strictly not cost NFE (this is where
        # the measured 25→20 win lives)
        y_auto, st_auto = run("auto", 1e-4)
        y_fix, st_fix = run(0.01, 1e-4)
        assert jnp.max(jnp.abs(y_auto - y_fix)) < 1e-4
        assert int(st_auto.nfe) <= int(st_fix.nfe), (
            int(st_auto.nfe), int(st_fix.nfe)
        )
        # tight tolerance: the HNW estimate may cost one rejected trial; it
        # must stay within one trial step of the fixed ramp
        _, st_auto6 = run("auto", 1e-6)
        _, st_fix6 = run(0.01, 1e-6)
        assert int(st_auto6.nfe) <= int(st_fix6.nfe) + 7, (
            int(st_auto6.nfe), int(st_fix6.nfe)
        )

    def test_auto_reverse_span_and_abm_fallback(self):
        y0 = jnp.array([0.5])
        cfg = SolverConfig(method="tsit5", rtol=1e-6, atol=1e-6, dt0="auto")
        y_b, _ = jax.jit(lambda y: odeint(f_decay, y, 1.0, 0.0, None, cfg))(y0)
        assert jnp.max(jnp.abs(y_b - 0.5 * jnp.exp(1.0))) < 1e-4
        # abm ignores "auto" (order-1 ramp) — must behave exactly as fixed
        ca = SolverConfig(method="abm", rtol=1e-6, atol=1e-6, dt0="auto")
        cf = SolverConfig(method="abm", rtol=1e-6, atol=1e-6, dt0=0.01)
        ya, sa = jax.jit(lambda y: odeint(f_decay, y, 0.0, 1.0, None, ca))(y0)
        yf, sf = jax.jit(lambda y: odeint(f_decay, y, 0.0, 1.0, None, cf))(y0)
        assert int(sa.nfe) == int(sf.nfe)
        assert jnp.max(jnp.abs(ya - yf)) == 0.0


class TestGradients:
    def test_backprop_through_scan(self):
        cfg = SolverConfig(method="rk4", gradient="backprop", fixed_steps=32)

        @jax.jit
        def grad_a(a):
            def run(a_):
                y1, _ = odeint_diff(f_linear, jnp.ones((2,)), 0.0, 1.0, a_, cfg)
                return jnp.sum(y1)

            return jax.grad(run)(a)

        g = grad_a(jnp.float32(0.3))
        # d/da sum(e^a * 1) over 2 elements = 2 e^a
        assert abs(float(g) - 2 * jnp.exp(0.3)) < 1e-3

    def test_adjoint_matches_analytic(self):
        cfg = SolverConfig(method="dopri5", gradient="adjoint", rtol=1e-6, atol=1e-6)

        @jax.jit
        def grads(a, y0):
            def run(a_, y0_):
                y1, _ = odeint_diff(f_linear, y0_, 0.0, 1.0, a_, cfg)
                return jnp.sum(y1)

            return jax.grad(run, argnums=(0, 1))(a, y0)

        ga, gy0 = grads(jnp.float32(0.3), jnp.array([1.0, 2.0]))
        assert abs(float(ga) - 3 * jnp.exp(0.3)) < 1e-3  # sum(y0) * e^a
        assert jnp.max(jnp.abs(gy0 - jnp.exp(0.3))) < 1e-3  # e^a per element

    def test_quadrature_adjoint_matches_analytic(self):
        cfg = SolverConfig(method="dopri5", gradient="quadrature", rtol=1e-6, atol=1e-6)

        @jax.jit
        def grads(a, y0):
            def run(a_, y0_):
                y1, _ = odeint_diff(f_linear, y0_, 0.0, 1.0, a_, cfg)
                return jnp.sum(y1)

            return jax.grad(run, argnums=(0, 1))(a, y0)

        ga, gy0 = grads(jnp.float32(0.3), jnp.array([1.0, 2.0]))
        assert abs(float(ga) - 3 * jnp.exp(0.3)) < 1e-3
        assert jnp.max(jnp.abs(gy0 - jnp.exp(0.3))) < 1e-3

    def test_quadrature_matches_backprop(self):
        """Interpolation (quadrature) adjoint vs exact discrete gradients."""

        def f(t, y, args):
            return jnp.tanh(y @ args["w"]) + 0.1 * t * y

        w = 0.3 * jax.random.normal(jax.random.PRNGKey(0), (3, 3))
        y0 = jax.random.normal(jax.random.PRNGKey(1), (4, 3))

        cfg_bp = SolverConfig(method="rk4", gradient="backprop", fixed_steps=64)
        cfg_q = SolverConfig(
            method="dopri5", gradient="quadrature", rtol=1e-7, atol=1e-7
        )

        def make_grads(cfg):
            @jax.jit
            def grads(w_, y0_):
                def run(w__, y0__):
                    y1, _ = odeint_diff(f, y0__, 0.0, 1.0, {"w": w__}, cfg)
                    return jnp.sum(jnp.square(y1))

                return jax.grad(run, argnums=(0, 1))(w_, y0_)

            return grads

        g_bp = make_grads(cfg_bp)(w, y0)
        g_q = make_grads(cfg_q)(w, y0)
        for a, b in zip(g_bp, g_q):
            assert jnp.max(jnp.abs(a - b)) < 1e-3

    def test_quadrature_reverse_span(self):
        """generate() differentiates through a t1→t0 solve — the dense
        interpolant must handle decreasing time spans."""
        cfg = SolverConfig(method="dopri5", gradient="quadrature", rtol=1e-6, atol=1e-6)

        @jax.jit
        def grad_y1(y1):
            def run(y1_):
                y0, _ = odeint_diff(f_decay, y1_, 1.0, 0.0, None, cfg)
                return jnp.sum(y0)

            return jax.grad(run)(y1)

        g = grad_y1(jnp.array([1.0, 2.0]))
        # y0 = y1 * e^{+1} (integrating dy/dt=-y backward) → dy0/dy1 = e
        assert jnp.max(jnp.abs(g - jnp.exp(1.0))) < 1e-3

    def test_adjoint_matches_backprop(self):
        """Continuous adjoint and discretize-then-optimize must agree on a
        smooth problem within tolerance."""

        def f(t, y, args):
            return jnp.tanh(y @ args["w"])

        w = 0.3 * jax.random.normal(jax.random.PRNGKey(0), (3, 3))
        y0 = jax.random.normal(jax.random.PRNGKey(1), (4, 3))

        cfg_bp = SolverConfig(method="rk4", gradient="backprop", fixed_steps=64)
        cfg_adj = SolverConfig(method="dopri5", gradient="adjoint", rtol=1e-7, atol=1e-7)

        def make_grads(cfg):
            @jax.jit
            def grads(w_, y0_):
                def run(w__, y0__):
                    y1, _ = odeint_diff(f, y0__, 0.0, 1.0, {"w": w__}, cfg)
                    return jnp.sum(jnp.square(y1))

                return jax.grad(run, argnums=(0, 1))(w_, y0_)

            return grads

        g_bp = make_grads(cfg_bp)(w, y0)
        g_adj = make_grads(cfg_adj)(w, y0)
        for a, b in zip(g_bp, g_adj):
            assert jnp.max(jnp.abs(a - b)) < 1e-3


class TestSeminorm:
    def test_error_weight_excludes_leaves(self):
        """A stiff pure-quadrature component inflates NFE under the full norm
        but not under the seminorm (PAPERS.md: Faster ODE Adjoints via
        Seminorms)."""

        def f(t, y, args):
            main, quad = y
            return (-main, 100.0 * jnp.cos(100.0 * t) * jnp.ones_like(quad))

        y0 = (jnp.ones((4,)), jnp.zeros((8,)))
        cfg = SolverConfig(rtol=1e-5, atol=1e-5)

        @functools.partial(jax.jit, static_argnums=())
        def full(y0):
            return odeint(f, y0, 0.0, 1.0, None, cfg)

        @jax.jit
        def semi(y0):
            w = (True, False)
            from continuousnormalizingflows_tpu.ops.ode import odeint_dopri5

            return odeint_dopri5(f, y0, 0.0, 1.0, None, cfg, error_weight=w)

        (y_full, nfe_full) = full(y0)
        (y_semi, nfe_semi) = semi(y0)
        # main component accuracy unaffected
        assert jnp.max(jnp.abs(y_semi[0] - jnp.exp(-1.0))) < 1e-4
        assert int(nfe_semi) < int(nfe_full), (int(nfe_semi), int(nfe_full))

    def test_adjoint_seminorm_grads_match(self):
        """Seminorm on/off: gradients agree (quadrature accuracy follows the
        controlled components on smooth problems)."""

        def f(t, y, args):
            return jnp.tanh(y @ args["w"])

        w = 0.3 * jax.random.normal(jax.random.PRNGKey(0), (3, 3))
        y0 = jax.random.normal(jax.random.PRNGKey(1), (4, 3))

        def grads(seminorm):
            cfg = SolverConfig(method="dopri5", gradient="adjoint",
                               rtol=1e-6, atol=1e-6, adjoint_seminorm=seminorm)

            @jax.jit
            def run(w_, y0_):
                def loss(w__, y0__):
                    y1, _ = odeint_diff(f, y0__, 0.0, 1.0, {"w": w__}, cfg)
                    return jnp.sum(jnp.square(y1))

                return jax.grad(loss, argnums=(0, 1))(w_, y0_)

            return run(w, y0)

        g_on = grads(True)
        g_off = grads(False)
        for a, b in zip(jax.tree_util.tree_leaves(g_on), jax.tree_util.tree_leaves(g_off)):
            assert jnp.max(jnp.abs(a - b)) < 1e-3


class TestNonFiniteRobustness:
    """A non-finite trial step (overflowed f eval) must be rejected-and-shrunk,
    and a genuinely non-finite field (e.g. NaN params mid-training) must exit
    via the give-up path with the loud NaN poison after a BOUNDED number of
    iterations — not burn the whole 16k step budget (the pre-fix NaN-dt
    spiral ran until the device's watchdog faulted it)."""

    @pytest.mark.parametrize("method", ["dopri5", "tsit5", "abm"])
    def test_nan_field_gives_up_quickly(self, method):
        def f(t, y, args):
            return jnp.full_like(y, jnp.nan)

        cfg = SolverConfig(method=method, rtol=1e-4, atol=1e-4, max_steps=16384)
        y1, stats = jax.jit(
            lambda y0: odeint(f, y0, 0.0, 1.0, None, cfg), backend="cpu"
        )(jnp.ones((4,)))
        assert bool(jnp.all(jnp.isnan(y1)))  # loud poison
        # give-up: ~log(1e-6)/log(min_factor) rejections, not the full budget
        assert int(stats.naccept) + int(stats.nreject) < 100, (
            int(stats.naccept), int(stats.nreject))

    def test_controller_factor_nonfinite_safe(self):
        from continuousnormalizingflows_tpu.ops.ode import _controller_factor

        for bad in (jnp.float32(jnp.nan), jnp.float32(jnp.inf)):
            finite, factor = _controller_factor(
                bad, 0.2, 0.9, 0.2, 10.0, jnp.float32
            )
            assert not bool(finite)
            assert abs(float(factor) - 0.2) < 1e-6  # maximal shrink, never NaN
        finite, factor = _controller_factor(
            jnp.float32(1e6), 0.2, 0.9, 0.2, 10.0, jnp.float32
        )
        assert bool(finite) and abs(float(factor) - 0.2) < 1e-6

    def test_transient_overflow_recovers(self):
        """A field with an Inf wall above the solution's range: a too-large
        trial step overshoots into the wall (stage 4 of the first dt=2 trial
        reaches y=2.58 > 1.1), the solve must reject-and-shrink and still
        deliver the correct finite answer (pre-fix: NaN dt spiral)."""

        def f(t, y, args):
            return jnp.where(y > 1.1, jnp.inf, y)

        cfg = SolverConfig(method="dopri5", rtol=1e-6, atol=1e-6, dt0=2.0)
        y1, stats = jax.jit(
            lambda y0: odeint(f, y0, 0.0, 0.7, None, cfg), backend="cpu"
        )(jnp.full((2,), 0.5))
        assert int(stats.nreject) >= 1  # the overshooting trial was rejected
        assert bool(jnp.all(jnp.isfinite(y1)))
        import numpy as np

        np.testing.assert_allclose(
            np.asarray(y1), 0.5 * np.exp(0.7), rtol=1e-4
        )


@pytest.mark.parametrize("method", ["dopri5", "tsit5", "abm"])
@pytest.mark.parametrize("dt0", ["auto", 0.01])
def test_odeint_and_dense_primal_identical(method, dt0):
    """The quadrature custom_vjp assumes its un-differentiated primal
    (``odeint``) and its fwd-rule solve (``odeint_dense``) are BITWISE
    identical in (y1, stats) — otherwise values under value_and_grad would
    diverge from plain calls (ops/adjoint.py ``_odeint_quadrature``).  Pin
    the invariant across every dense-capable method and both dt0 settings
    (ADVICE round 4)."""
    import numpy as np

    from continuousnormalizingflows_tpu.ops.ode import odeint, odeint_dense

    if method == "abm" and dt0 == "auto":
        pytest.skip("abm always uses the fixed-fraction start (ops.ode)")
    cfg = SolverConfig(method=method, rtol=1e-5, atol=1e-5, dt0=dt0,
                       gradient="quadrature")

    def f(t, y, args):
        return jnp.sin(3.0 * y) * args["a"] - 0.5 * y * t

    y0 = jnp.asarray(np.random.default_rng(0).normal(size=(4, 3)), jnp.float32)
    args = {"a": jnp.float32(0.8)}

    @jax.jit
    def both(y0, args):
        y_plain, s_plain = odeint(f, y0, 0.0, 1.0, args, cfg)
        y_dense, s_dense, _nodes = odeint_dense(f, y0, 0.0, 1.0, args, cfg)
        return y_plain, s_plain, y_dense, s_dense

    y_plain, s_plain, y_dense, s_dense = both(y0, args)
    np.testing.assert_array_equal(np.asarray(y_plain), np.asarray(y_dense))
    for a, b in zip(s_plain, s_dense):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_dt0_runtime_override_channel():
    """The reserved ``args["dt0"]`` starting-step override (the carried warm
    start behind ``SolverConfig.dt0 == "carry"``, round 5): respected by the
    adaptive RK solvers, ignored by fixed-step solves, and non-finite
    overrides fall back to the fixed ramp instead of wedging the solve."""
    import numpy as np

    def f(t, y, args):
        return jnp.cos(3.0 * t) * y * args["a"]

    y0 = jnp.ones((4, 3), jnp.float32)
    args = {"a": jnp.float32(0.7)}
    cfg = SolverConfig(method="dopri5", rtol=1e-4, atol=1e-4, dt0=0.01)

    @jax.jit
    def solve(extra):
        return odeint(f, y0, 0.0, 1.0, {**args, **extra}, cfg)

    y_ramp, s_ramp = solve({})
    y_warm, s_warm = solve({"dt0": jnp.abs(s_ramp.dt_final)})
    assert int(s_warm.nfe) < int(s_ramp.nfe), (int(s_warm.nfe), int(s_ramp.nfe))
    np.testing.assert_allclose(np.asarray(y_warm), np.asarray(y_ramp),
                               rtol=2e-4, atol=1e-5)

    # a poisoned carried dt (NaN / +inf / 0) must reproduce the fixed ramp
    # exactly (+inf guards the clamp order: min(inf, span) is finite, so the
    # finiteness gate must run BEFORE the span clamp)
    for bad in (jnp.float32(jnp.nan), jnp.float32(jnp.inf), jnp.float32(0.0)):
        y_bad, s_bad = solve({"dt0": bad})
        np.testing.assert_array_equal(np.asarray(y_bad), np.asarray(y_ramp))
        assert int(s_bad.nfe) == int(s_ramp.nfe)

    # fixed-step solves ignore the channel entirely
    cfg_fix = SolverConfig(method="rk4", gradient="backprop", fixed_steps=16)

    @jax.jit
    def solve_fix(extra):
        return odeint(f, y0, 0.0, 1.0, {**args, **extra}, cfg_fix)

    y_a, _ = solve_fix({})
    y_b, _ = solve_fix({"dt0": jnp.float32(0.5)})
    np.testing.assert_array_equal(np.asarray(y_a), np.asarray(y_b))

    # gradient paths: value under value_and_grad matches the plain call with
    # the same override (custom_vjp primal/fwd consistency includes dt0)
    for grad_mode in ("adjoint", "quadrature"):
        cfg_g = SolverConfig(method="dopri5", rtol=1e-4, atol=1e-4,
                             gradient=grad_mode, dt0=0.01)

        @jax.jit
        def loss_of(a, dt):
            y, _ = odeint_diff(f, y0, 0.0, 1.0,
                               {"a": a, "dt0": dt}, cfg_g)
            return jnp.sum(y * y)

        dt = jnp.float32(0.37)
        v_plain = loss_of(args["a"], dt)
        v_grad, g = jax.value_and_grad(loss_of)(args["a"], dt)
        np.testing.assert_array_equal(np.asarray(v_plain), np.asarray(v_grad))
        assert np.isfinite(float(g))
