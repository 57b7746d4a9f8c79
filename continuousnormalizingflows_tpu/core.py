"""Functional core: ``inference``, ``generate``, ``loss``.

JAX-native re-design of the reference's problem-assembly + solve + extraction
pipeline (``src/core/base_icnf.jl``): there is no ODEProblem object — each
entry point pads the state, samples the Hutchinson probe, (optionally) steers
the end time, runs the differentiable integrator, and splits the terminal
state.  Everything is a pure function of ``(model, params, data, key)`` so it
composes with ``jit`` / ``grad`` / ``vmap`` / ``pjit``.

State layout per sample (batch-first): ``[z (nz), Δlogp, E, n]`` — see
:mod:`continuousnormalizingflows_tpu.ops.dynamics`.

Semantics matched to the reference:

* initial state ``[x; 0_aug; 0; 0; 0]`` (``inference_prob``, base_icnf.jl:196-296)
* fresh probe ``ε ~ epsdist`` per solve (base_icnf.jl:207-208)
* steered end time in train mode: ``t1' = t1 + |t1 - t0| * U(-r, r)``
  (``steer_tspan``, base_icnf.jl:23-39)
* ``logp̂x = logpdf(basedist, z(t1)) - Δlogp`` (``inference_sol``,
  base_icnf.jl:142-172)
* ``generate``: ``z ~ basedist``, integrate the *reversed* span, keep the
  first ``nvariables`` columns (``generate_prob``/``generate_sol``,
  base_icnf.jl:298-404)
* ``loss = mean(-logp̂x + λ1*E + λ2*n + λ3*A)`` with the terminal
  augmented-norm penalty ``A`` (icnf.jl:605-649, ``reg_z_aug``
  base_icnf.jl:80-132)
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Optional, Tuple

import jax
import jax.numpy as jnp

from .config import LOG_2PI as _LOG_2PI
from .config import ICNFConfig, Mode, ProbeDist
from .models.icnf import ICNF
from .ops.adjoint import odeint_diff
from .ops.dynamics import make_augmented_dynamics
from .ops.ode import SolverStats

__all__ = [
    "base_logpdf",
    "sample_base",
    "sample_probe",
    "steer_t1",
    "inference",
    "generate",
    "generate_with_logp",
    "loss",
    "loss_with_stats",
    "log_prob",
    "trajectory",
]

Pytree = Any


def base_logpdf(cfg: ICNFConfig, z: jax.Array) -> jax.Array:
    """Base log-density over the augmented dimension ``nz`` — the reference's
    ``logpdf(basedist, z)`` (inference_sol, base_icnf.jl:158-172).  Default
    (``cfg.base_dist is None``) is the standard normal
    (``basedist = MvNormal(0, I)``, icnf.jl:76-79) on a closed-form fast
    path; otherwise the config's pluggable distribution is consulted
    (:mod:`continuousnormalizingflows_tpu.distributions`)."""
    if cfg.base_dist is not None:
        return cfg.base_dist.logpdf_fn(z)
    return -0.5 * (cfg.nz * _LOG_2PI + jnp.sum(jnp.square(z), axis=-1))


def sample_base(cfg: ICNFConfig, key: jax.Array, n: int) -> jax.Array:
    """Draw ``(n, nz)`` base samples for the generate path (the reference's
    ``rand(rng, basedist)``, base_icnf.jl:298-340)."""
    if cfg.base_dist is not None:
        return cfg.base_dist.sample_fn(key, (n, cfg.nz), cfg.dtype)
    return jax.random.normal(key, (n, cfg.nz), cfg.dtype)


def sample_probe(cfg: ICNFConfig, key: jax.Array, batch: int) -> jax.Array:
    """Fresh Hutchinson probes, shape ``(nprobes, batch, nz)``.  The probe
    width is ``nvariables + n_aug_input == nz`` (base_icnf.jl:207-208).
    ``cfg.probe_dist`` may be a ProbeDist enum value or any custom
    distribution with a ``sample_fn`` (the reference's pluggable
    ``epsdist``, icnf.jl:80-83)."""
    shape = (cfg.nprobes, batch, cfg.nz)
    if not isinstance(cfg.probe_dist, ProbeDist):
        eps = cfg.probe_dist.sample_fn(key, shape, cfg.dtype)
    elif cfg.probe_dist is ProbeDist.RADEMACHER:
        eps = jax.random.rademacher(key, shape, cfg.dtype)
    else:
        eps = jax.random.normal(key, shape, cfg.dtype)
    if cfg.probe_axis is not None and cfg.nprobes > 1:
        # shard the probe ensemble over the named mesh axis (needs an
        # enclosing jax.set_mesh); the batch axis inherits its sharding from
        # the solve state via GSPMD propagation
        eps = jax.lax.with_sharding_constraint(
            eps, jax.sharding.PartitionSpec(cfg.probe_axis)
        )
    return eps


def steer_t1(cfg: ICNFConfig, key: jax.Array) -> jax.Array:
    """STEER: randomized end time, train mode only (base_icnf.jl:23-39):
    ``t1' = t1 + |t1 - t0| * r`` with ``r ~ steerdist`` (the draw at
    base_icnf.jl:36).  ``cfg.steer_dist`` is the reference's pluggable
    ``steerdist`` field (icnf.jl:49); the default ``None`` is its
    ``Uniform(-steer_rate, steer_rate)`` (icnf.jl:104)."""
    t0, t1 = cfg.tspan
    if cfg.steer_dist is not None:
        r = cfg.steer_dist.sample_fn(key, (), cfg.dtype)
    else:
        r = jax.random.uniform(
            key, (), cfg.dtype, minval=-cfg.steer_rate, maxval=cfg.steer_rate
        )
    return jnp.asarray(t1, cfg.dtype) + abs(t1 - t0) * r


def _solve(
    icnf: ICNF,
    mode: Mode,
    u0: jax.Array,
    t0,
    t1,
    params: Pytree,
    eps: Optional[jax.Array],
    ys: Optional[jax.Array],
    dt0: Optional[jax.Array] = None,
) -> Tuple[jax.Array, jax.Array]:
    """``dt0``: optional traced starting-step override (the carried warm
    start, ``SolverConfig.dt0 == "carry"``) — consumed by the adaptive RK
    solvers via the reserved ``args["dt0"]`` channel (ops.ode._pop_dt0);
    ignored by fixed-step/ABM solves."""
    cfg = icnf.config
    f_aug = make_augmented_dynamics(cfg, icnf.net, mode)
    extra = {} if dt0 is None else {"dt0": dt0}
    if cfg.layout == "feature_first":
        # batch moves to the minor-most dimension for the whole solve;
        # one transpose in, one out — not per step (ICNFConfig.layout).
        args = {
            "params": params,
            "eps": None if eps is None else jnp.swapaxes(eps, 1, 2),
            "ys": None if ys is None else ys.T,
            **extra,
        }
        u1_t, nfe = odeint_diff(f_aug, u0.T, t0, t1, args, cfg.solver)
        return u1_t.T, nfe
    args = {"params": params, "eps": eps, "ys": ys, **extra}
    return odeint_diff(f_aug, u0, t0, t1, args, cfg.solver)


# ---------------------------------------------------------------------------
# jitted implementations — (icnf, mode) are static, so each model/mode pair
# compiles once per shape signature and is cached thereafter (the JAX analogue
# of Julia method specialization on the ICNF type parameters).
# ---------------------------------------------------------------------------


@functools.partial(jax.jit, static_argnums=(0, 1))
def _inference_impl(icnf: ICNF, mode: Mode, xs, params, key, ys, dt0=None):
    cfg = icnf.config
    batch = xs.shape[0]
    k_eps, k_steer = jax.random.split(key)

    pad = jnp.zeros((batch, cfg.n_aug_input + 3), cfg.dtype)
    u0 = jnp.concatenate([xs, pad], axis=-1)

    eps = sample_probe(cfg, k_eps, batch) if mode.stochastic else None
    t0, t1 = cfg.tspan
    # STEER applies in regularized train mode only (reference steer_tspan
    # dispatches on TrainMode{true}, base_icnf.jl:23-39)
    t1 = steer_t1(cfg, k_steer) if (mode.regularized and cfg.steered) else t1

    u1, stats = _solve(icnf, mode, u0, t0, t1, params, eps, ys, dt0)
    logpx, augs = _split_terminal(cfg, mode, u1)
    return logpx, augs, stats


@functools.partial(jax.jit, static_argnums=(0, 1, 4))
def _generate_logp_impl(icnf: ICNF, mode: Mode, params, key, n: int, ys):
    """Backward (generating) solve, returning ``(samples, logp̂x)``.  The
    plain ``generate`` path shares THIS implementation and discards the
    log-density output (one compiled program instead of two near-identical
    bodies that must keep their key-split/pad/steer preambles in lockstep —
    the logp read-off is one ``base_logpdf`` + add on an accumulator the
    solve integrates anyway).  Also returns the exact log-density of
    each sample, read off the SAME solve: the backward integration already
    accumulates ``dlogp_b = ∫_{t1}^{t0} -tr(J) dt = -Δlogp_forward``, so
    ``logp(x) = logpdf_base(z1) + dlogp_b`` — no second (inference) solve.
    The reference discards the accumulator when sampling (``generate_sol``
    strips it, base_icnf.jl:174-194) and needs a separate ``logpdf`` call per
    sample batch; this returns the pair in one solve.  With augmentation on,
    the density is over the full ``nz``-dim augmented state — the same
    convention as ``inference`` (``_split_terminal``)."""
    cfg = icnf.config
    k_base, k_eps, k_steer = jax.random.split(key, 3)

    z1 = sample_base(cfg, k_base, n)
    u0 = jnp.concatenate([z1, jnp.zeros((n, 3), cfg.dtype)], axis=-1)

    eps = sample_probe(cfg, k_eps, n) if mode.stochastic else None
    t0, t1 = cfg.tspan
    t1 = steer_t1(cfg, k_steer) if (mode.regularized and cfg.steered) else t1

    u_final, _stats = _solve(icnf, mode, u0, t1, t0, params, eps, ys)
    logpx = base_logpdf(cfg, z1) + u_final[..., cfg.nz]
    return u_final[..., : cfg.nvariables], logpx


@functools.partial(jax.jit, static_argnums=(0, 1, 4))
def _generate_tracefree_impl(icnf: ICNF, mode: Mode, params, key, n: int, ys):
    """Trace-free sampling fast path: the flow map ``z(t1) → z(t0)`` does not
    depend on the accumulator states (Δlogp, E, n never feed back into
    ``dz/dt = f(z, t)``), so sampling integrates the bare field — no
    per-step trace estimate (Hutchinson VJP ≈3x the matmuls of one field
    eval; generic-net exact trace O(nz) sweeps).  The reference's
    ``generate_prob`` always integrates the full augmented system
    (base_icnf.jl:298-404) — this path is a XLA-first capability beyond it.

    Keys are split exactly as in :func:`_generate_logp_impl` (base/probe/steer),
    so for the same ``key`` the base draw and steered end time are
    *identical* to the full path; samples agree to solver tolerance (the
    adaptive error norm no longer sees the accumulator components).
    """
    from .ops.dynamics import make_field

    cfg = icnf.config
    k_base, _k_eps, k_steer = jax.random.split(key, 3)

    z1 = sample_base(cfg, k_base, n)
    t0, t1 = cfg.tspan
    t1 = steer_t1(cfg, k_steer) if (mode.regularized and cfg.steered) else t1

    # batch-first field regardless of cfg.layout (same forcing as
    # trajectory(); the (n, nz) state here is built batch-first)
    field = make_field(cfg, icnf.net)

    def f(t, z, args):
        return field(t, z, args["params"], args["ys"])

    solver = cfg.solver
    if solver.gradient == "quadrature":
        # the z-only state needs no dense interpolant; backsolve is exact
        # for sampling (the backward pass re-integrates the bare field)
        solver = dataclasses.replace(solver, gradient="adjoint")
    z0, _stats = odeint_diff(f, z1, t1, t0, {"params": params, "ys": ys}, solver)
    return z0[..., : cfg.nvariables]


def _split_terminal(cfg: ICNFConfig, mode: Mode, u1: jax.Array):
    nz = cfg.nz
    z = u1[..., :nz]
    dlogp = u1[..., nz]
    e_acc = u1[..., nz + 1]
    n_acc = u1[..., nz + 2]
    logpx = base_logpdf(cfg, z) - dlogp
    if cfg.augmented and cfg.norm_z_aug and mode is Mode.TRAIN:
        z_aug = z[..., cfg.nvariables :]
        a_term = jnp.sqrt(jnp.sum(jnp.square(z_aug), axis=-1))
    else:
        a_term = jnp.zeros_like(dlogp)
    return logpx, (e_acc, n_acc, a_term)


def _as_batch(x: jax.Array) -> Tuple[jax.Array, bool]:
    if x.ndim == 1:
        return x[None, :], True
    return x, False


def inference(
    icnf: ICNF,
    mode: Mode,
    xs: jax.Array,
    params: Pytree,
    key: Optional[jax.Array] = None,
    ys: Optional[jax.Array] = None,
    dt0: Optional[jax.Array] = None,
):
    """Forward solve x → z; returns ``(logp̂x, (E, n, A), nfe)``.

    ``xs``: ``(batch, nvariables)`` or a single ``(nvariables,)`` sample (the
    reference's VectorMode — handled here by a transparent batch-of-1).
    The extra third output is a :class:`~continuousnormalizingflows_tpu.ops.ode.SolverStats`
    (NFE, accepted/rejected step counts, final dt) — the solver observability
    the reference gets from SciML ``sol.stats`` / ``verbose`` (icnf.jl:100-101,
    SURVEY.md §5); ``int(stats)`` is the NFE.

    ``dt0``: optional traced starting-step override for the adaptive RK
    solvers (the carried warm start — pass the previous solve's
    ``stats.dt_final``; see ``SolverConfig.dt0 == "carry"``).  ``None``
    follows the config policy.
    """
    cfg = icnf.config
    xs = jnp.asarray(xs, cfg.dtype)
    xs, single = _as_batch(xs)
    if ys is not None:
        ys = jnp.asarray(ys, cfg.dtype)
        ys, _ = _as_batch(ys)
    if key is None:
        if mode.stochastic:
            raise ValueError("train mode needs a PRNG key (probe + steer sampling)")
        key = jax.random.PRNGKey(0)

    logpx, augs, stats = _inference_impl(icnf, mode, xs, params, key, ys, dt0)
    if single:
        logpx = logpx[0]
        augs = tuple(a[0] for a in augs)
    return logpx, augs, stats


def generate(
    icnf: ICNF,
    mode: Mode,
    params: Pytree,
    key: jax.Array,
    n: int,
    ys: Optional[jax.Array] = None,
    trace_free: bool = False,
) -> jax.Array:
    """Sample ``n`` points by integrating the flow backward t1 → t0
    (``generate_prob``, base_icnf.jl:298-404).

    ``trace_free=True`` integrates the bare field ``dz/dt = f(z, t)`` instead
    of the full augmented system — the sample distribution is identical (the
    accumulator states never feed back into the flow), the per-step cost
    drops by the whole trace estimate, and the same ``key`` yields the same
    base draw/steer (samples match the default path to solver tolerance).
    Default off for step-for-step reference parity (the reference always
    integrates the augmented system when sampling)."""
    cfg = icnf.config
    if ys is not None:
        ys = jnp.asarray(ys, cfg.dtype)
        ys, _ = _as_batch(ys)
    if trace_free:
        return _generate_tracefree_impl(icnf, mode, params, key, int(n), ys)
    return _generate_logp_impl(icnf, mode, params, key, int(n), ys)[0]


def generate_with_logp(
    icnf: ICNF,
    mode: Mode,
    params: Pytree,
    key: jax.Array,
    n: int,
    ys: Optional[jax.Array] = None,
) -> Tuple[jax.Array, jax.Array]:
    """``(samples, logp̂x)`` in ONE solve — the backward integration already
    carries the log-density accumulator, so sample log-probabilities are free
    (importance sampling / ELBO workflows otherwise pay a second full
    inference solve per sample batch).  In ``Mode.TEST`` (exact trace, no
    steer) ``logp̂x`` matches ``inference(icnf, mode, samples, ...)`` to
    solver tolerance.  In the stochastic modes it is a Hutchinson ESTIMATE
    whose probe (and, with steering, end time) is drawn independently of
    what a separate ``inference`` call would draw — the two agree only in
    expectation, so use TestMode for importance weights."""
    cfg = icnf.config
    if ys is not None:
        ys = jnp.asarray(ys, cfg.dtype)
        ys, _ = _as_batch(ys)
    return _generate_logp_impl(icnf, mode, params, key, int(n), ys)


def loss(
    icnf: ICNF,
    mode: Mode,
    xs: jax.Array,
    params: Pytree,
    key: Optional[jax.Array] = None,
    ys: Optional[jax.Array] = None,
    dt0: Optional[jax.Array] = None,
) -> jax.Array:
    """Regularized negative log-likelihood
    ``mean(-logp̂x + λ1*E + λ2*n + λ3*A)`` (icnf.jl:605-649)."""
    return loss_with_stats(icnf, mode, xs, params, key, ys, dt0)[0]


def loss_with_stats(
    icnf: ICNF,
    mode: Mode,
    xs: jax.Array,
    params: Pytree,
    key: Optional[jax.Array] = None,
    ys: Optional[jax.Array] = None,
    dt0: Optional[jax.Array] = None,
) -> Tuple[jax.Array, "SolverStats"]:
    """``(loss, solver stats)`` — the stats ride along as an aux output so the
    training loop can surface NFE / rejected steps / final dt per step
    (reference solver verbosity, icnf.jl:100-101).  ``dt0`` is the carried
    starting-step channel: feed the previous step's ``stats.dt_final`` back
    in to eliminate the per-solve controller ramp (``SolverConfig.dt0 ==
    "carry"``; ICNFModel does this automatically)."""
    cfg = icnf.config
    logpx, (e_acc, n_acc, a_term), stats = inference(
        icnf, mode, xs, params, key, ys, dt0
    )
    l = jnp.mean(
        -logpx
        + cfg.lambda_1 * e_acc
        + cfg.lambda_2 * n_acc
        + cfg.lambda_3 * a_term
    )
    return l, stats


def log_prob(
    icnf: ICNF,
    mode: Mode,
    xs: jax.Array,
    params: Pytree,
    key: Optional[jax.Array] = None,
    ys: Optional[jax.Array] = None,
) -> jax.Array:
    """Convenience: just ``logp̂x`` — the reference's functor call
    (base_icnf.jl:509-523)."""
    return inference(icnf, mode, xs, params, key, ys)[0]


@functools.partial(jax.jit, static_argnums=(0,))
def _trajectory_impl(icnf: ICNF, xs, params, ts, ys):
    from .ops.ode import eval_dense, odeint_dense

    cfg = icnf.config
    batch = xs.shape[0]
    pad = jnp.zeros((batch, cfg.n_aug_input + 3), cfg.dtype)
    u0 = jnp.concatenate([xs, pad], axis=-1)
    # trajectory() always builds batch-first state, so force the batch-first
    # dynamics regardless of cfg.layout (the feature-first twin expects
    # (state_dim, batch) and would mis-broadcast here).
    if cfg.layout != "batch_first":
        cfg = dataclasses.replace(cfg, layout="batch_first")
    f_aug = make_augmented_dynamics(cfg, icnf.net, Mode.TEST)
    args = {"params": params, "eps": None, "ys": ys}
    t0, t1 = cfg.tspan
    solver = cfg.solver
    if solver.method not in ("dopri5", "tsit5", "abm"):
        solver = dataclasses.replace(solver, method="dopri5", gradient="adjoint")
    _u1, stats, dense = odeint_dense(f_aug, u0, t0, t1, args, solver)
    path = jax.vmap(lambda t: eval_dense(dense, t))(ts)  # (T, batch, state)
    return path[..., : cfg.nz], stats


def trajectory(
    icnf: ICNF,
    xs: jax.Array,
    params: Pytree,
    ts,
    ys: Optional[jax.Array] = None,
):
    """Flow trajectory ``z(t)`` at arbitrary times — dense-output analogue of
    the SciML solution object's interpolation (the reference solves with
    ``save_everystep = false`` for training, base_icnf.jl:134-140, but SciML
    users read dense trajectories off ``solve``; this is that capability).

    Deterministic exact-trace (TestMode) dynamics; ``ts`` may be any times in
    ``tspan`` (clamped).  Returns ``(path, nfe)`` with ``path`` of shape
    ``(len(ts), batch, nz)``.
    """
    cfg = icnf.config
    xs = jnp.asarray(xs, cfg.dtype)
    xs, _single = _as_batch(xs)
    if ys is not None:
        ys = jnp.asarray(ys, cfg.dtype)
        ys, _ = _as_batch(ys)
    ts = jnp.asarray(ts, cfg.dtype)
    return _trajectory_impl(icnf, xs, params, ts, ys)
