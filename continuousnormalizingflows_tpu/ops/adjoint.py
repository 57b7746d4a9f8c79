"""Gradients through the ODE solve.

Two paths, mirroring the two classical strategies (SURVEY.md §7 item 4):

* ``gradient="backprop"`` — discretize-then-optimize: reverse-mode AD straight
  through the fixed-step ``lax.scan`` integrator (with per-step remat).  Exact
  gradients of the discrete program; memory O(steps).
* ``gradient="adjoint"`` — optimize-then-discretize: a ``jax.custom_vjp`` whose
  backward pass integrates the continuous adjoint ODE from ``t1`` back to
  ``t0`` with the same adaptive solver.  O(1) memory in trajectory length; the
  JAX-native analogue of the reference's ``SciMLSensitivity.QuadratureAdjoint``
  with ``ZygoteVJP`` (reference ``src/core/icnf.jl:90-99``).  Parameter
  gradients are accumulated *inside* the backward solve as extra quadrature
  states (``dgrad/dt = -a^T ∂f/∂θ``), so one VJP per backward step yields the
  state adjoint and the parameter quadrature together.

Backward augmented system, integrated t1 → t0 with initial state
``(y1, g, 0)``::

    d/dt (y, a, q) = (f(t, y, θ), -a^T ∂f/∂y, -a^T ∂f/∂θ)

giving ``a(t0) = dL/dy0`` and ``q(t0) = dL/dθ``.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Tuple

import jax
import jax.numpy as jnp

from ..config import DEFAULT_FIXED_DT0, SolverConfig
from .ode import eval_dense, odeint, odeint_dense

__all__ = ["odeint_diff"]

Pytree = Any


def _bwd_cfg(cfg: SolverConfig) -> SolverConfig:
    """Solver config for the backward (adjoint) solve.

    ``dt0="auto"`` (the HNW starting-step estimate) is tuned for primal
    ODEs; the backward state mixes the adjoint with zero-initialized
    parameter-quadrature blocks whose atol-dominated weighted norms skew the
    d0/d1 curvature probe, and its extra probe evaluation bought no NFE on
    the backward solve.  The backward solve keeps the fixed-fraction ramp (same spirit as excluding
    q from the backward error norm via the seminorm)."""
    if isinstance(cfg.dt0, str):
        return dataclasses.replace(cfg, dt0=DEFAULT_FIXED_DT0)
    return cfg


def _bwd_dt0(args_nd: Pytree):
    """Carried starting step for the BACKWARD solve, from the forward's
    carry channel (``args_nd["dt0"]``, ops.ode._pop_dt0).

    Under ``dt0="carry"`` the backward solve dominates the train step (the
    forward collapses to ~1 accepted step while the backward still pays its
    own fixed ramp), so the carry warms the backward solve too, as a float
    ``dt0`` does through _bwd_cfg.  The carried dt is the same field one step
    earlier, so it sizes the backward (adjoint) steps as well; the
    controller's reject-and-shrink recovers cheaply if it overshoots, and a
    poisoned value falls back to the fixed ramp inside ``_initial_dt``.
    Returns ``None`` when no carry channel is present (the measured-default
    fixed backward ramp)."""
    if isinstance(args_nd, dict):
        return args_nd.get("dt0")
    return None


def _tree_vdot(a: Pytree, b: Pytree) -> jax.Array:
    leaves_a = jax.tree_util.tree_leaves(a)
    leaves_b = jax.tree_util.tree_leaves(b)
    return sum(
        jnp.vdot(x, y, precision="highest") for x, y in zip(leaves_a, leaves_b)
    )


# args entries that never receive useful cotangents on the continuous-adjoint
# paths: the Hutchinson probe, and the carried starting-step override
# (ode._pop_dt0 — a pure solver-control scalar; its "gradient" is the
# derivative of the solution w.r.t. the discretization, which the continuous
# adjoint deliberately ignores).  Splitting them out of the differentiable
# args keeps probe-sized (P x B x nz) quadrature accumulators out of the
# backward ODE state — they are as large as the flow state itself and every
# caller discards the probe cotangent (the trace estimate's derivative
# w.r.t. its own probe is statistically meaningless for training).
# Conditions ("ys") stay differentiable: their quadrature is
# (B x ncond)-small and condition gradients are legitimately consumed
# (e.g. conditional sampling guidance).
_NONDIFF_ARG_KEYS = ("eps", "dt0")


def _split_args(args: Pytree) -> Tuple[Pytree, Pytree]:
    """Partition a dict-style args tree into (differentiable, nondiff)."""
    if isinstance(args, dict) and any(k in args for k in _NONDIFF_ARG_KEYS):
        nd = {k: v for k, v in args.items() if k in _NONDIFF_ARG_KEYS}
        d = {k: v for k, v in args.items() if k not in _NONDIFF_ARG_KEYS}
        return d, nd
    return args, None


def _merge_args(args_d: Pytree, args_nd: Pytree) -> Pytree:
    if args_nd is None:
        return args_d
    return {**args_d, **args_nd}


@functools.partial(jax.custom_vjp, nondiff_argnums=(0, 1))
def _odeint_adjoint(f, cfg: SolverConfig, y0: Pytree, t0, t1, args_d: Pytree,
                    args_nd: Pytree):
    return odeint(f, y0, t0, t1, _merge_args(args_d, args_nd), cfg)


def _adjoint_fwd(f, cfg, y0, t0, t1, args_d, args_nd):
    y1, nfe = odeint(f, y0, t0, t1, _merge_args(args_d, args_nd), cfg)
    return (y1, nfe), (y1, t0, t1, args_d, args_nd)


def _adjoint_bwd(f, cfg, residuals, cotangents):
    y1, t0, t1, args_d, args_nd = residuals
    g_y1, _g_nfe = cotangents

    t0 = jnp.asarray(t0, jnp.result_type(float, t0))
    t1 = jnp.asarray(t1, jnp.result_type(float, t1))

    def aug_dyn(t, state, aug_args):
        y, a, _q = state
        # VJP w.r.t. the differentiable args only — nondiff args (the probe)
        # are closed over, so the backward state carries no probe-sized
        # quadrature accumulators.
        dy, vjp_fn = jax.vjp(
            lambda y_, ad_: f(t, y_, _merge_args(ad_, args_nd)), y, aug_args
        )
        a_y, a_args = vjp_fn(a)
        neg = lambda x: -x
        return (dy, jax.tree_util.tree_map(neg, a_y), jax.tree_util.tree_map(neg, a_args))

    q0 = jax.tree_util.tree_map(jnp.zeros_like, args_d)
    state1 = (y1, g_y1, q0)
    # Seminorm (PAPERS.md, Kidger et al. 2021): the parameter-quadrature
    # block q is excluded from the backward error norm when enabled — q never
    # feeds back into the dynamics, so error-controlling it only forces
    # pointlessly small steps.
    error_weight = None
    if cfg.adjoint_seminorm and cfg.method in ("dopri5", "tsit5", "abm"):
        error_weight = (
            jax.tree_util.tree_map(lambda _: True, y1),
            jax.tree_util.tree_map(lambda _: True, g_y1),
            jax.tree_util.tree_map(lambda _: False, q0),
        )
    (y0_rec, a0, q), _nfe_b = odeint(
        aug_dyn, state1, t1, t0, args_d, _bwd_cfg(cfg), error_weight,
        dt0_override=_bwd_dt0(args_nd),
    )

    full_args = _merge_args(args_d, args_nd)
    # dL/dt1 = <g, f(t1, y1)> ; dL/dt0 = -<a(t0), f(t0, y0)>
    t1_bar = _tree_vdot(g_y1, f(t1, y1, full_args)).real.astype(t1.dtype)
    t0_bar = (-_tree_vdot(a0, f(t0, y0_rec, full_args))).real.astype(t0.dtype)
    nd_bar = (
        None if args_nd is None else jax.tree_util.tree_map(jnp.zeros_like, args_nd)
    )
    return (a0, t0_bar, t1_bar, q, nd_bar)


_odeint_adjoint.defvjp(_adjoint_fwd, _adjoint_bwd)


# ---------------------------------------------------------------------------
# interpolation ("quadrature") adjoint — reference QuadratureAdjoint analogue
# ---------------------------------------------------------------------------


@functools.partial(jax.custom_vjp, nondiff_argnums=(0, 1))
def _odeint_quadrature(f, cfg: SolverConfig, y0, t0, t1, args_d, args_nd):
    # Un-differentiated calls take the plain solve: odeint and odeint_dense
    # are bitwise-identical in (y1, stats) (verified across methods/dt0),
    # and the dense (dense_max_nodes, batch, state) node buffers exist only
    # for the VJP — carrying them through an inference-only solve would be
    # hundreds of MB of dead while-loop carry at image-scale batches.
    return odeint(f, y0, t0, t1, _merge_args(args_d, args_nd), cfg)


def _quadrature_fwd(f, cfg, y0, t0, t1, args_d, args_nd):
    y1, nfe, dense = odeint_dense(
        f, y0, t0, t1, _merge_args(args_d, args_nd), cfg
    )
    return (y1, nfe), (y1, dense, t0, t1, args_d, args_nd)


def _quadrature_bwd(f, cfg, residuals, cotangents):
    """Backward solve of the adjoint + parameter-quadrature states only.

    Unlike the backsolve adjoint (above), the primal state is *not*
    re-integrated backward — it is read from the dense forward interpolant, so
    a diverging reverse-time primal cannot corrupt the adjoint (the stability
    property QuadratureAdjoint is chosen for in the reference, icnf.jl:90-99).
    The backward state is ``(a, q)``::

        d/dt (a, q) = (-a^T ∂f/∂y|_{y(t)}, -a^T ∂f/∂θ|_{y(t)})
    """
    y1, dense, t0, t1, args_d, args_nd = residuals
    g_y1, _g_nfe = cotangents

    t0 = jnp.asarray(t0, jnp.result_type(float, t0))
    t1 = jnp.asarray(t1, jnp.result_type(float, t1))

    def adj_dyn(t, state, aug_args):
        a, _q = state
        y = eval_dense(dense, t)
        _dy, vjp_fn = jax.vjp(
            lambda y_, ad_: f(t, y_, _merge_args(ad_, args_nd)), y, aug_args
        )
        a_y, a_args = vjp_fn(a)
        neg = lambda x: -x
        return (
            jax.tree_util.tree_map(neg, a_y),
            jax.tree_util.tree_map(neg, a_args),
        )

    q0 = jax.tree_util.tree_map(jnp.zeros_like, args_d)
    state1 = (g_y1, q0)
    error_weight = None
    if cfg.adjoint_seminorm:
        error_weight = (
            jax.tree_util.tree_map(lambda _: True, g_y1),
            jax.tree_util.tree_map(lambda _: False, q0),
        )
    (a0, q), _nfe_b = odeint(
        adj_dyn, state1, t1, t0, args_d, _bwd_cfg(cfg), error_weight,
        dt0_override=_bwd_dt0(args_nd),
    )

    full_args = _merge_args(args_d, args_nd)
    y0_rec = eval_dense(dense, t0)
    t1_bar = _tree_vdot(g_y1, f(t1, y1, full_args)).real.astype(t1.dtype)
    t0_bar = (-_tree_vdot(a0, f(t0, y0_rec, full_args))).real.astype(t0.dtype)
    nd_bar = (
        None if args_nd is None else jax.tree_util.tree_map(jnp.zeros_like, args_nd)
    )
    return (a0, t0_bar, t1_bar, q, nd_bar)


_odeint_quadrature.defvjp(_quadrature_fwd, _quadrature_bwd)


def odeint_diff(
    f: Callable[[jax.Array, Pytree, Pytree], Pytree],
    y0: Pytree,
    t0,
    t1,
    args: Pytree,
    cfg: SolverConfig,
) -> Tuple[Pytree, jax.Array]:
    """Differentiable ODE solve dispatching on ``cfg.gradient``.

    ``backprop`` requires a fixed-step method (enforced by
    :class:`~continuousnormalizingflows_tpu.config.SolverConfig`);
    ``quadrature`` (interpolation adjoint — the closest analogue of the
    reference's ``QuadratureAdjoint``, icnf.jl:90-99) requires an adaptive
    dense-output method (dopri5/tsit5/abm — ``abm`` + ``quadrature`` is the
    solver-class-for-solver-class mirror of the reference's default
    VCABM + QuadratureAdjoint stack);
    ``adjoint`` (backsolve) works with any method and is the default.

    On the two continuous-adjoint paths, a dict-style ``args`` containing an
    ``"eps"`` entry (the Hutchinson probe) gets a *structural-zero* probe
    cotangent: the backward ODE carries quadrature states only for the
    remaining args (params, conditions), which keeps probe-sized accumulators
    out of the backward state.  Use ``backprop`` if you genuinely need
    d/d(probe).
    """
    if cfg.gradient == "backprop":
        return odeint(f, y0, t0, t1, args, cfg)
    args_d, args_nd = _split_args(args)
    if cfg.gradient == "quadrature":
        return _odeint_quadrature(f, cfg, y0, t0, t1, args_d, args_nd)
    return _odeint_adjoint(f, cfg, y0, t0, t1, args_d, args_nd)
