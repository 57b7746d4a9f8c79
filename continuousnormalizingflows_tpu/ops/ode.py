"""JAX/XLA-native ODE integrators over arbitrary pytree states.

The reference outsources integration to SciML's VCABM (adaptive-order
Adams-Bashforth-Moulton, reference ``src/core/icnf.jl:84-89``) with host-side
step control.  A multistep state machine maps poorly onto XLA, so the
JAX-native design uses:

* ``dopri5`` — embedded Dormand-Prince 5(4) with FSAL and a PI step-size
  controller, driven by a single ``lax.while_loop`` whose whole body is traced
  once: no host round-trips, static shapes, the accept/reject decision is a
  scalar ``lax.select``.  Error control (``rtol = atol = 1e-4`` by default)
  matches the reference's tolerances.  Under ``pjit`` with a sharded batch the
  error norm is a *global* reduction, so every device takes identical steps —
  the collective-consistent adaptivity required for SPMD (SURVEY.md §5).
* ``rk4`` / ``euler`` — fixed-step ``lax.scan`` paths: reverse-differentiable
  (discretize-then-optimize) with optional per-step rematerialization
  (``jax.checkpoint``) to trade FLOPs for device memory.

All integrators share the signature ``odeint(f, y0, t0, t1, args, cfg)`` with
``f(t, y, args) -> dy`` over pytrees and return ``(y1, stats)`` with
``stats`` a :class:`SolverStats` — only the final
state is kept (reference ``save_everystep = false``, ``base_icnf.jl:134-140``).
"""

from __future__ import annotations

import functools
from typing import Any, Callable, NamedTuple, Tuple

import jax
import jax.numpy as jnp
from jax import lax

from ..config import ABM_MAX_ORDER, DEFAULT_FIXED_DT0, SolverConfig

__all__ = [
    "odeint",
    "odeint_fixed",
    "odeint_dopri5",
    "odeint_abm",
    "odeint_dopri5_dense",
    "odeint_abm_dense",
    "odeint_dense",
    "DenseSolution",
    "SolverStats",
    "eval_dense",
]

Pytree = Any
ODEFunc = Callable[[jax.Array, Pytree, Pytree], Pytree]


class SolverStats(NamedTuple):
    """Per-solve diagnostics — the analogue of the solver observability the
    reference gets from SciML (``sol.stats``, ``verbose =
    SciMLLogging.Detailed()``, reference ``src/core/icnf.jl:100-101``): enough
    to debug a stalling adaptive solve (many rejections / tiny final dt)
    without host round-trips.

    ``int(stats)`` returns the NFE for drop-in use where a bare eval count is
    expected.  Fixed-step methods report ``naccept = steps, nreject = 0``.
    """

    nfe: jax.Array  # int32 — dynamics evaluations
    naccept: jax.Array  # int32 — accepted steps
    nreject: jax.Array  # int32 — rejected trial steps
    dt_final: jax.Array  # controller's step size at exit (signed, time dtype)

    def __int__(self) -> int:
        return int(self.nfe)

# ---------------------------------------------------------------------------
# pytree helpers
# ---------------------------------------------------------------------------


def _tree_add_scaled(y: Pytree, dt: jax.Array, *terms: Tuple[float, Pytree]) -> Pytree:
    """y + dt * sum_i c_i * k_i  (skipping zero coefficients)."""
    coeffs = [c for c, _ in terms if c != 0.0]
    ks = [k for c, k in terms if c != 0.0]

    def combine(y_leaf, *k_leaves):
        acc = y_leaf
        for c, k in zip(coeffs, k_leaves):
            acc = acc + dt * c * k
        return acc

    return jax.tree_util.tree_map(combine, y, *ks)


def _tree_scaled_sum(dt: jax.Array, *terms: Tuple[float, Pytree]) -> Pytree:
    coeffs = [c for c, _ in terms if c != 0.0]
    ks = [k for c, k in terms if c != 0.0]

    def combine(*k_leaves):
        acc = dt * coeffs[0] * k_leaves[0]
        for c, k in zip(coeffs[1:], k_leaves[1:]):
            acc = acc + dt * c * k
        return acc

    return jax.tree_util.tree_map(combine, *ks)


def _rms_error_ratio(
    err: Pytree, y0: Pytree, y1: Pytree, rtol: float, atol: float,
    error_weight: Pytree = None,
) -> jax.Array:
    """RMS of err / (atol + rtol * max(|y0|, |y1|)) over every state element.

    One scalar for the whole (possibly sharded) batch — the reference likewise
    runs one adaptive solve over the full d x n matrix state, sharing step
    sizes across samples (SURVEY.md §2.9).

    ``error_weight`` (optional, same tree structure with boolean leaves)
    selects which leaves participate — the *seminorm* of "Hey, that's not an
    ODE: Faster ODE Adjoints via Seminorms" (PAPERS.md): pure-quadrature
    states (parameter gradients in the adjoint solve) don't feed back into
    the dynamics, so error-controlling them only shrinks steps pointlessly.
    """
    leaves_e = jax.tree_util.tree_leaves(err)
    leaves_a = jax.tree_util.tree_leaves(y0)
    leaves_b = jax.tree_util.tree_leaves(y1)
    weights = (
        jax.tree_util.tree_leaves(error_weight)
        if error_weight is not None
        else [True] * len(leaves_e)
    )
    sq_sum = 0.0
    count = 0.0
    for e, a, b, w in zip(leaves_e, leaves_a, leaves_b, weights):
        if not w:
            continue
        scale = atol + rtol * jnp.maximum(jnp.abs(a), jnp.abs(b))
        r = (e / scale).astype(jnp.float32)
        sq_sum = sq_sum + jnp.sum(r * r)
        count = count + r.size
    return jnp.sqrt(sq_sum / count)


def _time_dtype(y0: Pytree):
    leaves = jax.tree_util.tree_leaves(y0)
    dt = leaves[0].dtype if leaves else jnp.float32
    return dt if jnp.issubdtype(dt, jnp.floating) else jnp.float32


def _controller_factor(ratio, inv_order, safety, min_factor, max_factor, tdt):
    """Step-size factor, non-finite-safe.

    A trial step whose error ratio is NaN/Inf (an overflowed f eval — e.g. a
    too-large dt pushing softplus/exp past the float range) must be treated as
    a hard reject with maximal shrink, NOT fed to ``power`` (NaN factor ⇒ NaN
    dt ⇒ the loop spins its whole step budget before poisoning — observed as
    a 16k-iteration stall).  Shrinking re-enters the finite region;
    genuine divergence (NaN params) is caught by the caller's give-up test.

    Returns ``(finite, factor)``."""
    finite = jnp.isfinite(ratio)
    safe_ratio = jnp.where(finite, jnp.maximum(ratio, 1e-10), 1.0)
    factor = jnp.clip(
        safety * jnp.power(safe_ratio, -inv_order), min_factor, max_factor
    )
    return finite, jnp.where(finite, factor, min_factor).astype(tdt)


# give-up threshold: a non-finite trial at |dt| below this fraction of the
# span means the field itself is non-finite (shrinking cannot help) — exit
# and NaN-poison instead of burning the remaining step budget
_DT_GIVE_UP = 1e-6


def _pop_dt0(args):
    """Split the reserved runtime starting-step override out of a dict-style
    ``args``: returns ``(args_without_dt0, dt0_override_or_None)``.

    ``args["dt0"]`` is the carried-step-size channel (``SolverConfig.dt0 ==
    "carry"``): a traced positive scalar — typically the previous solve's
    accepted ``SolverStats.dt_final`` — used as this solve's starting step
    instead of the fixed-fraction ramp or the HNW probe.  Riding in ``args``
    (rather than a new positional parameter) keeps the custom_vjp adjoint
    signatures unchanged; the adjoint paths route it through the nondiff
    args split (zero cotangent) and ALSO warm-start their backward solves
    from it via an explicit ``dt0_override`` (``adjoint._bwd_dt0`` — the
    backward solve pays its own controller ramp otherwise)."""
    if isinstance(args, dict) and "dt0" in args:
        args = dict(args)
        return args, args.pop("dt0")
    return args, None


def _initial_dt(f, t0, y0, f0, args, cfg, span, direction, err_order, tdt,
                override=None):
    """Starting step size: ``(dt_init, extra_nfe)``.

    ``override`` (a traced positive scalar, from :func:`_pop_dt0`) wins over
    every config policy: the carried warm start.  Non-finite or non-positive
    overrides fall back to the fixed ramp (loud failures stay upstream — a
    poisoned dt_final from a failed previous solve must not wedge this one).

    ``cfg.dt0 == "auto"`` runs the classic Hairer-Nørsett-Wanner starting-step
    algorithm (Solving ODEs I, §II.4) — what the reference's SciML ``solve``
    does when no ``dt`` is given (OrdinaryDiffEq's automatic init-dt), so
    "auto" is the parity behavior AND measurably cheaper than a fixed guess:
    a fixed ``dt0 = 0.01`` spends ~1-3 accepted steps ramping dt up through
    the controller on every solve.  Measured on a trained 2-D CNF field at
    rtol 1e-4 (PARITY.md, read before the move to the GPU): dopri5 TRAIN
    NFE 25 → 20, TEST 37 → 32; tsit5 25 → 20 both modes.  Costs one extra f eval (f0 is already paid); the
    weighted norms are global reductions, so SPMD collective consistency is
    preserved.  A float ``dt0`` keeps the fixed span-fraction start.  ABM
    ignores "auto" (see odeint_abm: its order-1 ramp needs the small start).

    ``err_order`` is the local-error order p+1 of the one-step family (6 for
    the 5th-order embedded RKs).
    """
    if override is not None:
        raw = jnp.abs(jnp.asarray(override, tdt))
        # finiteness gate BEFORE the span clamp: min(+inf, span) is finite,
        # which would turn a poisoned +inf carry into a full-span trial step
        # instead of the documented fixed-ramp fallback
        dt = jnp.where(
            jnp.logical_and(jnp.isfinite(raw), raw > 0),
            jnp.minimum(raw, jnp.abs(span)),
            DEFAULT_FIXED_DT0 * jnp.abs(span),
        )
        return direction * dt, 0
    if not isinstance(cfg.dt0, str):
        return span * jnp.asarray(cfg.dt0, tdt), 0

    def wnorm(x, yref):
        # same atol/rtol weighting as the step-error norm above
        s, c = 0.0, 0.0
        for xe, ye in zip(jax.tree_util.tree_leaves(x),
                          jax.tree_util.tree_leaves(yref)):
            sc = cfg.atol + cfg.rtol * jnp.abs(ye)
            r = (xe / sc).astype(jnp.float32)
            s = s + jnp.sum(r * r)
            c = c + r.size
        return jnp.sqrt(s / c)

    tiny = jnp.asarray(1e-6, tdt)
    d0 = wnorm(y0, y0)
    d1 = wnorm(f0, y0)
    h0 = jnp.where(
        jnp.minimum(d0, d1) < 1e-5, tiny, 0.01 * d0 / jnp.maximum(d1, 1e-12)
    ).astype(tdt)
    h0 = jnp.minimum(h0, jnp.abs(span))
    # one explicit Euler probe to estimate the second derivative scale
    y1 = jax.tree_util.tree_map(lambda a, b: a + direction * h0 * b, y0, f0)
    f1 = f(t0 + direction * h0, y1, args)
    d2 = wnorm(jax.tree_util.tree_map(lambda a, b: a - b, f1, f0), y0) / h0
    dmax = jnp.maximum(d1, d2)
    h1 = jnp.where(
        dmax <= 1e-15,
        jnp.maximum(tiny, h0 * 1e-3),
        jnp.power(jnp.maximum(0.01 / jnp.maximum(dmax, 1e-12), 1e-12),
                  1.0 / err_order),
    ).astype(tdt)
    dt = jnp.minimum(jnp.minimum(100.0 * h0, h1), jnp.abs(span))
    # non-finite fallback (e.g. an overflowing Euler probe): the controller's
    # reject-and-shrink path recovers from a plain fixed start
    dt = jnp.where(jnp.isfinite(dt), dt, DEFAULT_FIXED_DT0 * jnp.abs(span))
    return direction * dt, 1


# ---------------------------------------------------------------------------
# embedded explicit-RK tableaus (FSAL: last row of A equals B, so the final
# stage of an accepted step seeds the next step's first stage)
# ---------------------------------------------------------------------------


class _Tableau(NamedTuple):
    name: str
    C: tuple
    A: tuple  # rows 1..s-1 (row i has i entries); final combination is B
    B: tuple  # solution weights (== last A row for FSAL schemes)
    BERR: tuple  # B - B̂ (error-estimate weights, length s+1 incl. FSAL stage)
    order: int


# Dormand-Prince 5(4) — the classic
_DP_B = (35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84)
_DP_B4 = (5179 / 57600, 0.0, 7571 / 16695, 393 / 640, -92097 / 339200, 187 / 2100, 1 / 40)
DOPRI5 = _Tableau(
    name="dopri5",
    C=(0.0, 1 / 5, 3 / 10, 4 / 5, 8 / 9, 1.0),
    A=(
        (1 / 5,),
        (3 / 40, 9 / 40),
        (44 / 45, -56 / 15, 32 / 9),
        (19372 / 6561, -25360 / 2187, 64448 / 6561, -212 / 729),
        (9017 / 3168, -355 / 33, 46732 / 5247, 49 / 176, -5103 / 18656),
    ),
    B=_DP_B,
    BERR=tuple(b - b4 for b, b4 in zip(_DP_B + (0.0,), _DP_B4)),
    order=5,
)

# Tsitouras 5(4) (Tsit5, 2011) — same order/stage count as DP5 with smaller
# error constants: ~10-25% fewer steps at equal tolerance on smooth problems
# (SciML's default recommendation; the closest fixed-order analogue of
# "reference VCABM efficiency" for non-stiff flows).
_TS_B = (
    0.09646076681806523,
    0.01,
    0.4798896504144996,
    1.379008574103742,
    -3.290069515436081,
    2.324710524099774,
)
# B - B̂ from the published btilde coefficients (OrdinaryDiffEq Tsit5 constants)
_TS_BERR = (
    -0.00178001105222577714,
    -0.0008164344596567469,
    0.007880878010261995,
    -0.1447110071732629,
    0.5823571654525552,
    -0.45808210592918697,
    0.015151515151515152,
)
TSIT5 = _Tableau(
    name="tsit5",
    C=(0.0, 0.161, 0.327, 0.9, 0.9800255409045097, 1.0),
    A=(
        (0.161,),
        (-0.008480655492356989, 0.335480655492357),
        (2.8971530571054935, -6.359448489975075, 4.3622954328695815),
        (5.325864828439257, -11.748883564062828, 7.4955393428898365,
         -0.09249506636175525),
        (5.86145544294642, -12.92096931784711, 8.159367898576159,
         -0.071584973281401, -0.028269050394068383),
    ),
    B=_TS_B,
    BERR=_TS_BERR,
    order=5,
)

_TABLEAUS = {"dopri5": DOPRI5, "tsit5": TSIT5}


def _erk_step(tab: _Tableau, f: ODEFunc, t: jax.Array, y: Pytree, dt: jax.Array,
              k1: Pytree, args: Pytree):
    """One embedded trial step. ``k1 = f(t, y, args)`` is supplied (FSAL).
    Returns ``(y_new, err, k_last)`` where ``k_last = f(t + dt, y_new, args)``
    seeds the next step."""
    ks = [k1]
    for i, row in enumerate(tab.A):
        yi = _tree_add_scaled(y, dt, *zip(row, ks))
        ks.append(f(t + tab.C[i + 1] * dt, yi, args))
    y_new = _tree_add_scaled(y, dt, *zip(tab.B, ks))
    k_last = f(t + dt, y_new, args)
    ks.append(k_last)
    err = _tree_scaled_sum(dt, *zip(tab.BERR, ks))
    return y_new, err, k_last


def _dopri5_step(f: ODEFunc, t: jax.Array, y: Pytree, dt: jax.Array, k1: Pytree, args: Pytree):
    return _erk_step(DOPRI5, f, t, y, dt, k1, args)


def odeint_dopri5(
    f: ODEFunc,
    y0: Pytree,
    t0: jax.Array,
    t1: jax.Array,
    args: Pytree,
    cfg: SolverConfig,
    error_weight: Pytree = None,
    dt0_override=None,
) -> Tuple[Pytree, SolverStats]:
    """Adaptive embedded Runge-Kutta under ``lax.while_loop`` — the tableau
    (Dormand-Prince 5(4) or Tsitouras 5(4)) is picked from ``cfg.method``.
    Not reverse-differentiable directly — wrap with the continuous adjoint
    (:mod:`continuousnormalizingflows_tpu.ops.adjoint`) for gradients."""
    tab = _TABLEAUS.get(cfg.method, DOPRI5)
    n_evals = len(tab.A) + 1  # new f evals per trial step (FSAL)
    args, popped_dt0 = _pop_dt0(args)
    if dt0_override is None:
        dt0_override = popped_dt0
    tdt = _time_dtype(y0)
    t0 = jnp.asarray(t0, tdt)
    t1 = jnp.asarray(t1, tdt)
    span = t1 - t0
    direction = jnp.sign(span)
    tiny = jnp.asarray(1e-12, tdt)

    k1 = f(t0, y0, args)
    dt_init, nfe_init = _initial_dt(
        f, t0, y0, k1, args, cfg, span, direction, tab.order + 1, tdt,
        dt0_override,
    )

    inv_order = 1.0 / tab.order

    def cond(state):
        t, _y, _dt, _k1, nfe, steps, nacc, done, fail = state
        return jnp.logical_and(
            jnp.logical_not(jnp.logical_or(done, fail)), steps < cfg.max_steps
        )

    def body(state):
        t, y, dt, k1, nfe, steps, nacc, _done, _fail = state
        remaining = t1 - t
        # clamp the trial step so we can land exactly on t1
        dt_c = direction * jnp.minimum(jnp.abs(dt), jnp.abs(remaining))
        y5, err, k7 = _erk_step(tab, f, t, y, dt_c, k1, args)
        ratio = _rms_error_ratio(err, y, y5, cfg.rtol, cfg.atol, error_weight)
        finite, factor = _controller_factor(
            ratio, inv_order, cfg.safety, cfg.min_factor, cfg.max_factor, tdt
        )
        accept = jnp.logical_and(finite, ratio <= 1.0)
        dt_next = dt_c * factor

        t_new = jnp.where(accept, t + dt_c, t)
        y_new = jax.tree_util.tree_map(
            lambda a, b: jnp.where(accept, a, b), y5, y
        )
        k_new = jax.tree_util.tree_map(
            lambda a, b: jnp.where(accept, a, b), k7, k1
        )
        done = jnp.logical_and(accept, jnp.abs(t1 - t_new) <= tiny * jnp.maximum(jnp.abs(t1), 1.0))
        fail = jnp.logical_and(
            jnp.logical_not(finite),
            jnp.abs(dt_c) <= _DT_GIVE_UP * jnp.abs(span),
        )
        nacc_new = nacc + accept.astype(jnp.int32)
        return (t_new, y_new, dt_next, k_new, nfe + n_evals, steps + 1,
                nacc_new, done, fail)

    state0 = (t0, y0, dt_init, k1, jnp.int32(1 + nfe_init), jnp.int32(0),
              jnp.int32(0), jnp.asarray(False), jnp.asarray(False))
    (_t, y1, dt_f, _k, nfe, steps, nacc, done, _fail) = lax.while_loop(
        cond, body, state0
    )
    # Loud failure on step-budget exhaustion: the reference never truncates
    # (maxiters = typemax, icnf.jl:86) — silently returning the state at
    # max_steps would be a *wrong answer*, so poison it with NaN instead
    # (surfaces immediately in loss/logpdf checks).
    y1 = jax.tree_util.tree_map(
        lambda l: jnp.where(done, l, jnp.full_like(l, jnp.nan)), y1
    )
    return y1, SolverStats(nfe, nacc, steps - nacc, dt_f)


# ---------------------------------------------------------------------------
# variable-step Adams-Bashforth-Moulton PECE (the reference's solver class)
# ---------------------------------------------------------------------------

# 7-point Gauss-Legendre on [-1, 1]: exact for polynomials to degree 13, which
# covers every Lagrange basis polynomial used below (degree <= _ABM_MAX - 1 =
# 11 at the VCABM-parity order cap of 12)
_GL7 = (
    (-0.9491079123427585, 0.1294849661688706),
    (-0.7415311855993945, 0.2797053914892766),
    (-0.4058451513773972, 0.3818300505051183),
    (0.0, 0.4179591836734690),
    (0.4058451513773972, 0.3818300505051183),
    (0.7415311855993945, 0.2797053914892766),
    (0.9491079123427585, 0.1294849661688706),
)

# Milne error factors |C_AM / (C_AB - C_AM)| for the k-step pair on a uniform
# grid.  Closed form from the Adams-Bashforth gamma recurrence
# (sum_{j<=m} gamma_j/(m+1-j) = 1, gamma*_k = gamma_k - gamma_{k-1}):
# factor_k = |gamma*_k| / (gamma_k + |gamma*_k|) = 1 - gamma_k/gamma_{k-1};
# true values for k = 1..8: 1/2, 1/6, 1/10, 19/270, 27/502, 863/19950,
# 1375/38174, 33953/1103970 — doubled for conservatism: on variable-step
# grids the uniform-grid constants under-estimate (measured: global error
# tracked ~20x tol on an oscillator; with the 2x margin it tracks ~5-8x,
# matching what dopri5-class local error control delivers).  (Round-3 review
# found orders 5-8 accidentally carried a 4x margin — the tuple held
# already-doubled values that were doubled again — biasing order selection
# against promotion past 4 and shrinking high-order steps ~12%.)
_MILNE = (1.0, 1 / 3, 0.2, 19 / 135, 27 / 251, 863 / 9975,
          1375 / 19087, 33953 / 551985,
          57281 / 1070017, 3250433 / 68730849,
          1135053 / 26842253, 13695779093 / 358650016725)

_ABM_MAX = ABM_MAX_ORDER  # hard cap on the history ring (single source: config)
assert len(_MILNE) == _ABM_MAX


def _lagrange_quad_weights(taus: list, a, b) -> list:
    """``w_j = ∫_a^b l_j(s) ds`` for the Lagrange basis on nodes ``taus``
    (python list of traced scalars; static count).  Via GL7 — exact.

    Vectorized over (GL points x basis x nodes) as one (7, k, k) tensor
    contraction rather than unrolled scalar loops: the unrolled form traced
    O(k^2 * 7) scalar ops per order, which across the order-selection
    ``lax.switch`` (K branches x 3 candidate orders) made compile time the
    dominant cost of ``abm_order = 12`` solves (~2.5 min CPU compiles;
    vectorized: seconds).

    Division is guarded against coincident nodes: during order buildup the
    ring's stale slots duplicate ``t0``; weights built from them are garbage
    but must be *finite* garbage (they are masked by the caller's validity
    flags — an Inf/NaN would leak through ``where``)."""
    k = len(taus)
    t = jnp.stack([jnp.asarray(tj) for tj in taus])  # (k,)
    wdt = t.dtype
    mid, half = 0.5 * (a + b), 0.5 * (b - a)
    xi = jnp.asarray([x for x, _ in _GL7], wdt)
    om = jnp.asarray([w for _, w in _GL7], wdt)
    s = mid + half * xi  # (7,)
    num = s[:, None] - t[None, :]  # (7, m): s - t_m
    diff = t[:, None] - t[None, :]  # (j, m): t_j - t_m
    diff = jnp.where(diff == 0, jnp.ones_like(diff), diff)
    ratio = num[:, None, :] / diff[None, :, :]  # (7, j, m)
    mask = jnp.eye(k, dtype=bool)[None, :, :]  # m == j factor excluded
    basis = jnp.prod(jnp.where(mask, jnp.ones_like(ratio), ratio), axis=-1)
    ws = half * jnp.sum(om[:, None] * basis, axis=0)  # (k,)
    return [ws[j] for j in range(k)]


def _abm_weights_order(k: int, K: int, ts_h, t_new):
    """Padded (pred (K,), corr_new scalar, corr_hist (K,), milne scalar) for a
    *static* order ``k``.  Predictor: k history nodes (order k); corrector:
    the new node + the k-1 (k>1: order k) most recent.  Weights carry the
    time dtype (f64 solves need f64 quadrature weights)."""
    wdt = ts_h.dtype
    t = ts_h[0]
    taus = [ts_h[i] for i in range(k)]
    w_pred = _lagrange_quad_weights(taus, t, t_new)
    kc = max(k - 1, 1)
    corr_nodes = [t_new] + taus[:kc]
    w_corr = _lagrange_quad_weights(corr_nodes, t, t_new)

    pad = lambda ws: jnp.stack(
        [jnp.asarray(ws[i], wdt) if i < len(ws) else jnp.zeros((), wdt)
         for i in range(K)]
    )
    return (
        pad(w_pred),
        jnp.asarray(w_corr[0], wdt),
        pad(w_corr[1:]),
        jnp.asarray(_MILNE[k - 1], wdt),
    )


def _abm_weights_branch3(k: int, K: int, ts_h, t_new):
    """Weights for the three candidate orders ``{k-1, k, k+1}`` (clipped to
    [1, K]) as stacked (3, ...) arrays plus a (3,) validity mask — the
    variable-coefficient analogue of VCABM's order-selection triple."""
    outs = []
    for j in (k - 1, k, k + 1):
        wdt = ts_h.dtype
        if 1 <= j <= K:
            wp, wcn, wch, mil = _abm_weights_order(j, K, ts_h, t_new)
            outs.append((wp, wcn, wch, mil, jnp.ones((), wdt)))
        else:
            outs.append((
                jnp.zeros((K,), wdt), jnp.zeros((), wdt),
                jnp.zeros((K,), wdt), jnp.ones((), wdt),
                jnp.zeros((), wdt),
            ))
    stack = lambda i: jnp.stack([o[i] for o in outs])
    return stack(0), stack(1), stack(2), stack(3), stack(4)


def _hist_dot(ws: jax.Array, f_hist: Pytree) -> Pytree:
    """``Σ_j ws[j] * f_hist[j]`` over the leading history axis."""
    return jax.tree_util.tree_map(
        lambda leaf: jnp.tensordot(
            ws.astype(leaf.dtype), leaf, axes=((0,), (0,)), precision="highest"
        ),
        f_hist,
    )


def odeint_abm(
    f: ODEFunc,
    y0: Pytree,
    t0: jax.Array,
    t1: jax.Array,
    args: Pytree,
    cfg: SolverConfig,
    error_weight: Pytree = None,
    with_dense: bool = False,
):
    """Variable-step, variable-ORDER Adams-Bashforth-Moulton PECE — the
    reference's solver class (VCABM, adaptive order *and* step, reference
    ``src/core/icnf.jl:89``) at ~2 new f-evals per step vs 6 per dopri5 trial.

    JAX-native design (static shapes; no VCABM divided-difference state
    machine):

    * history = ring of the last ``K = cfg.abm_order`` ``(t, f)`` pairs;
    * integration weights recomputed each step from the actual node times via
      Lagrange-basis GL7 quadrature (the variable-coefficient part of VCABM)
      — a handful of scalar ops, negligible next to one dynamics eval;
    * PECE: predict (Adams-Bashforth over history), evaluate, correct
      (Adams-Moulton incl. the new node), evaluate — the 2nd eval seeds the
      history, so the method pays exactly 2 f-evals per trial step;
    * **order adaptation**: each step also forms the order k-1 and k+1
      predictor/corrector pairs from the same history and the shared
      ``f_pred`` (no extra f-evals — only K-length reductions) and their
      Milne error estimates; on accept, the order moves to whichever of
      {k-1, k, k+1} has the smallest error ratio (Shampine-style selection;
      decrease is preferred on ties, matching VCABM's bias toward stability),
      never exceeding the available history length;
    * Milne device for the error estimate (predictor-corrector difference),
      same controller family and loud NaN-poison policy as dopri5 above, with
      the exponent ``1/(order+1)`` of the *selected* order; growth is clamped
      to 2x per step (multistep stability needs bounded step ratios, unlike
      one-step RK).

    On smooth trained CNF fields this trades more (cheaper) steps for a lower
    NFE than dopri5; the high orders pay off at tight tolerances where a
    fixed order-4 method's step count blows up — measured A/B at rtol
    {1e-4, 1e-6} in benchmarks/abm_ab.py / PARITY.md.

    ``with_dense=True`` (static) additionally records the accepted nodes
    ``(t, y_corr, f_corr)`` into a :class:`DenseSolution` and returns
    ``(y1, stats, dense)`` — the PECE second evaluate *is* the node
    derivative, so dense output costs no extra f-evals (same economy as the
    dopri5 FSAL stage).  This is what pairs ``method="abm"`` with
    ``gradient="quadrature"``: the reference's DEFAULT solve+sensitivity
    combination (VCABM + QuadratureAdjoint, icnf.jl:89-99).
    """
    K = int(getattr(cfg, "abm_order", 4))
    assert 1 <= K <= _ABM_MAX
    # the carried-dt override is popped and IGNORED here: a carried one-step
    # dt is as wrong for the order-1 multistep ramp as the HNW start below
    # (the ramp needs small early steps to build history)
    args, _dt0_ignored = _pop_dt0(args)
    tdt = _time_dtype(y0)
    t0 = jnp.asarray(t0, tdt)
    t1 = jnp.asarray(t1, tdt)
    span = t1 - t0
    direction = jnp.sign(span)
    tiny = jnp.asarray(1e-12, tdt)
    inf = jnp.float32(jnp.inf)

    f0 = f(t0, y0, args)
    # the HNW starting-step estimate sizes the first step for a one-step
    # method; the multistep ramp starts at order 1 with a 2x growth clamp, so
    # an Euler-accurate first step is too large for the Milne pair and costs
    # rejections (TRAIN NFE 25 -> 32, read before the move to the GPU) — the
    # fixed-fraction ramp is the right start for ABM
    dt_init, nfe_init = (
        span * jnp.asarray(
            DEFAULT_FIXED_DT0 if isinstance(cfg.dt0, str) else cfg.dt0, tdt
        ),
        0,
    )

    ts_h0 = jnp.full((K,), t0, tdt)
    fs_h0 = jax.tree_util.tree_map(
        lambda l: jnp.zeros((K,) + l.shape, l.dtype).at[0].set(l), f0
    )

    if with_dense:
        max_nodes = int(cfg.dense_max_nodes)

        def write_node(bufs, idx, t, y, k):
            b_s, b_y, b_f = bufs
            idx = jnp.minimum(idx, max_nodes - 1)
            s = ((t - t0) / span).astype(tdt)
            b_s = b_s.at[idx].set(s)
            b_y = jax.tree_util.tree_map(
                lambda buf, l: lax.dynamic_update_index_in_dim(buf, l, idx, 0),
                b_y, y,
            )
            b_f = jax.tree_util.tree_map(
                lambda buf, l: lax.dynamic_update_index_in_dim(buf, l, idx, 0),
                b_f, k,
            )
            return (b_s, b_y, b_f)

        bufs0 = write_node(
            (
                jnp.full((max_nodes,), jnp.inf, tdt),
                jax.tree_util.tree_map(
                    lambda l: jnp.zeros((max_nodes,) + l.shape, l.dtype), y0
                ),
                jax.tree_util.tree_map(
                    lambda l: jnp.zeros((max_nodes,) + l.shape, l.dtype), f0
                ),
            ),
            jnp.int32(0), t0, y0, f0,
        )
        dense_tail = (bufs0, jnp.int32(1))
    else:
        dense_tail = ()

    def cond(state):
        (t, _y, _dt, _ts, _fs, _nh, _ord, nfe, steps, nacc, done,
         fail) = state[:12]
        return jnp.logical_and(
            jnp.logical_not(jnp.logical_or(done, fail)), steps < cfg.max_steps
        )

    def body(state):
        (t, y, dt, ts_h, fs_h, n_h, order, nfe, steps, nacc, _done,
         _fail) = state[:12]
        remaining = t1 - t
        dt_c = direction * jnp.minimum(jnp.abs(dt), jnp.abs(remaining))
        t_new = t + dt_c

        w_pred3, wc_new3, wc_hist3, milne3, valid3 = lax.switch(
            jnp.clip(order - 1, 0, K - 1),
            [functools.partial(_abm_weights_branch3, k, K)
             for k in range(1, K + 1)],
            ts_h,
            t_new,
        )

        # predictor at the CURRENT order; its f-eval is shared by all three
        # candidate orders (the standard ODE113/VCABM economy)
        y_pred_mid = jax.tree_util.tree_map(
            lambda a, b: a + b, y, _hist_dot(w_pred3[1], fs_h)
        )
        f_pred = f(t_new, y_pred_mid, args)

        def pc_ratio(i, y_pred):
            corr_inc = _hist_dot(wc_hist3[i], fs_h)
            y_corr = jax.tree_util.tree_map(
                lambda yl, fl, cl: yl + wc_new3[i].astype(fl.dtype) * fl + cl,
                y, f_pred, corr_inc,
            )
            err = jax.tree_util.tree_map(
                lambda a, b: milne3[i].astype(a.dtype) * (a - b), y_corr, y_pred
            )
            r = _rms_error_ratio(err, y, y_corr, cfg.rtol, cfg.atol,
                                 error_weight)
            return y_corr, r

        y_pred_lo = jax.tree_util.tree_map(
            lambda a, b: a + b, y, _hist_dot(w_pred3[0], fs_h)
        )
        y_pred_hi = jax.tree_util.tree_map(
            lambda a, b: a + b, y, _hist_dot(w_pred3[2], fs_h)
        )
        _c_lo, r_lo = pc_ratio(0, y_pred_lo)
        y_corr, ratio = pc_ratio(1, y_pred_mid)
        _c_hi, r_hi = pc_ratio(2, y_pred_hi)
        # invalid candidates never win: order-0 doesn't exist; order k+1
        # needs k+1 *distinct* history nodes before its weights mean anything
        r_lo = jnp.where(valid3[0] > 0, r_lo, inf)
        r_hi = jnp.where(
            jnp.logical_and(valid3[2] > 0, n_h >= order + 1), r_hi, inf
        )
        finite = jnp.isfinite(ratio)
        accept = jnp.logical_and(finite, ratio <= 1.0)

        # PECE second evaluate: the stored history derivative is f at the
        # *corrected* solution
        f_corr = f(t_new, y_corr, args)

        # order selection (applied on accept only)
        dec = r_lo <= ratio
        inc = jnp.logical_and(r_hi < ratio, jnp.logical_not(dec))
        nh_acc = jnp.minimum(n_h + 1, K)
        ord_acc = jnp.clip(
            order - dec.astype(jnp.int32) + inc.astype(jnp.int32), 1, nh_acc
        )
        ord_next = jnp.where(accept, ord_acc, order)
        ratio_sel = jnp.where(
            accept, jnp.where(dec, r_lo, jnp.where(inc, r_hi, ratio)), ratio
        )

        inv_ord = 1.0 / (ord_next.astype(jnp.float32) + 1.0)
        # 2.0 growth cap: multistep stability needs bounded step ratios
        _fin, factor = _controller_factor(
            ratio_sel, inv_ord, cfg.safety, cfg.min_factor, 2.0, tdt
        )
        dt_next = dt_c * factor

        # shifted history (applied only on accept)
        ts_acc = jnp.roll(ts_h, 1).at[0].set(t_new)
        fs_acc = jax.tree_util.tree_map(
            lambda buf, l: jnp.roll(buf, 1, axis=0).at[0].set(l), fs_h, f_corr
        )

        t_out = jnp.where(accept, t_new, t)
        y_out = jax.tree_util.tree_map(lambda a, b: jnp.where(accept, a, b), y_corr, y)
        ts_out = jnp.where(accept, ts_acc, ts_h)
        fs_out = jax.tree_util.tree_map(
            lambda a, b: jnp.where(accept, a, b), fs_acc, fs_h
        )
        nh_out = jnp.where(accept, nh_acc, n_h)
        done = jnp.logical_and(
            accept, jnp.abs(t1 - t_out) <= tiny * jnp.maximum(jnp.abs(t1), 1.0)
        )
        fail = jnp.logical_and(
            jnp.logical_not(finite),
            jnp.abs(dt_c) <= _DT_GIVE_UP * jnp.abs(span),
        )
        if with_dense:
            bufs, n = state[12:]
            # node derivative = f at the corrected solution (the PECE second
            # evaluate — already computed, zero extra cost)
            bufs_acc = write_node(bufs, n, t_new, y_corr, f_corr)
            bufs_new = jax.tree_util.tree_map(
                lambda a, b: jnp.where(accept, a, b), bufs_acc, bufs
            )
            tail = (bufs_new, jnp.where(accept, n + 1, n))
        else:
            tail = ()
        return (t_out, y_out, dt_next, ts_out, fs_out, nh_out, ord_next,
                nfe + 2, steps + 1, nacc + accept.astype(jnp.int32), done,
                fail) + tail

    state0 = (t0, y0, dt_init, ts_h0, fs_h0, jnp.int32(1), jnp.int32(1),
              jnp.int32(1 + nfe_init), jnp.int32(0), jnp.int32(0),
              jnp.asarray(False), jnp.asarray(False)) + dense_tail
    out = lax.while_loop(cond, body, state0)
    (_t, y1, dt_f, _ts, _fs, _nh, _ord, nfe, steps, nacc, done,
     _fail) = out[:12]
    if not with_dense:
        y1 = jax.tree_util.tree_map(
            lambda l: jnp.where(done, l, jnp.full_like(l, jnp.nan)), y1
        )
        return y1, SolverStats(nfe, nacc, steps - nacc, dt_f)
    # Same loud-failure policy as odeint_dopri5_dense: buffer overflow means
    # the interpolant tail was clobbered — poison result AND interpolant.
    (b_s, b_y, b_f), n = out[12:]
    ok = jnp.logical_and(done, n <= max_nodes)
    poison = lambda l: jnp.where(ok, l, jnp.full_like(l, jnp.nan))
    y1 = jax.tree_util.tree_map(poison, y1)
    b_y = jax.tree_util.tree_map(poison, b_y)
    b_f = jax.tree_util.tree_map(poison, b_f)
    dense = DenseSolution(
        s=b_s, ys=b_y, fs=b_f, n=jnp.minimum(n, max_nodes), t0=t0, t1=t1
    )
    return y1, SolverStats(nfe, nacc, steps - nacc, dt_f), dense


def odeint_abm_dense(
    f: ODEFunc,
    y0: Pytree,
    t0: jax.Array,
    t1: jax.Array,
    args: Pytree,
    cfg: SolverConfig,
) -> Tuple[Pytree, "SolverStats", "DenseSolution"]:
    """:func:`odeint_abm` with a :class:`DenseSolution` over the accepted
    nodes — see ``with_dense`` there.  Together with the backward ABM solve in
    ``ops.adjoint`` this reproduces the reference's default sensitivity stack
    (VCABM forward + QuadratureAdjoint backward, icnf.jl:89-99) solver-class
    for solver-class."""
    return odeint_abm(f, y0, t0, t1, args, cfg, None, with_dense=True)


# ---------------------------------------------------------------------------
# dense output (for the interpolation/quadrature adjoint)
# ---------------------------------------------------------------------------


class DenseSolution(NamedTuple):
    """Piecewise cubic-Hermite interpolant of an adaptive solve.

    Nodes are the *accepted* step endpoints ``(t_j, y_j, f_j)`` stored in solve
    order; time is normalized to ``s = (t - t0) / (t1 - t0) ∈ [0, 1]`` so the
    node array is monotone increasing regardless of integration direction
    (``generate`` solves t1 → t0, base_icnf.jl:318).  Unused buffer slots hold
    ``s = +inf`` so ``searchsorted`` never selects them.

    This is the JAX-native analogue of the dense forward solution the
    reference's ``QuadratureAdjoint`` interpolates (SciMLSensitivity;
    reference sol_kwargs icnf.jl:90-99): cubic Hermite on (y, f) node pairs is
    the classic O(h^4) interpolant — one order below the DP5 solution but
    evaluated *between error-controlled nodes*, and it needs no extra stage
    storage (f_j is the FSAL stage, already computed).
    """

    s: jax.Array  # (max_nodes,) normalized node times, +inf padded
    ys: Any  # pytree, leaves (max_nodes, ...)
    fs: Any  # pytree, leaves (max_nodes, ...)
    n: jax.Array  # int32 — number of valid nodes
    t0: jax.Array
    t1: jax.Array


def eval_dense(dense: DenseSolution, t: jax.Array) -> Pytree:
    """Evaluate the interpolant at scalar time ``t`` (clamped to the span)."""
    span = dense.t1 - dense.t0
    s = jnp.clip((t - dense.t0) / span, 0.0, 1.0)
    # segment index: nodes i, i+1 bracket s
    i = jnp.clip(jnp.searchsorted(dense.s, s, side="right") - 1, 0, dense.n - 2)
    s_a = dense.s[i]
    s_b = dense.s[i + 1]
    h_s = s_b - s_a
    theta = jnp.clip((s - s_a) / jnp.where(h_s == 0, 1.0, h_s), 0.0, 1.0)
    h_t = h_s * span  # segment length in *real* time units (f is dy/dt)

    def interp(y_nodes, f_nodes):
        ya = y_nodes[i]
        yb = y_nodes[i + 1]
        fa = f_nodes[i]
        fb = f_nodes[i + 1]
        dy = yb - ya
        th = theta.astype(ya.dtype)
        ht = h_t.astype(ya.dtype)
        # standard cubic Hermite in Horner-ish form
        a = ya
        b = fa * ht
        c = 3.0 * dy - (2.0 * fa + fb) * ht
        d = -2.0 * dy + (fa + fb) * ht
        return a + th * (b + th * (c + th * d))

    return jax.tree_util.tree_map(interp, dense.ys, dense.fs)


def odeint_dopri5_dense(
    f: ODEFunc,
    y0: Pytree,
    t0: jax.Array,
    t1: jax.Array,
    args: Pytree,
    cfg: SolverConfig,
) -> Tuple[Pytree, SolverStats, DenseSolution]:
    """Adaptive Dormand-Prince 5(4) that also returns a :class:`DenseSolution`.

    Buffer capacity is ``cfg.dense_max_nodes`` (shapes must be static under
    jit).  If a solve accepts more steps than the buffer holds — far beyond
    the ~4-40 typical at rtol 1e-4, i.e. exactly the stiff/long-flow regime
    where interpolation accuracy matters most — the result and the dense
    buffers are **NaN-poisoned** (the same loud-failure policy as step-budget
    exhaustion above): a silently degraded interpolant would feed silently
    wrong quadrature-adjoint gradients.  Fix by raising
    ``SolverConfig.dense_max_nodes`` to at least (expected accepted steps + 1).
    """
    tab = _TABLEAUS.get(cfg.method, DOPRI5)
    n_evals = len(tab.A) + 1
    args, dt0_override = _pop_dt0(args)
    tdt = _time_dtype(y0)
    t0 = jnp.asarray(t0, tdt)
    t1 = jnp.asarray(t1, tdt)
    span = t1 - t0
    direction = jnp.sign(span)
    tiny = jnp.asarray(1e-12, tdt)
    max_nodes = int(cfg.dense_max_nodes)

    k1 = f(t0, y0, args)
    dt_init, nfe_init = _initial_dt(
        f, t0, y0, k1, args, cfg, span, direction, tab.order + 1, tdt,
        dt0_override,
    )
    inv_order = 1.0 / tab.order

    buf_s = jnp.full((max_nodes,), jnp.inf, tdt)
    buf_y = jax.tree_util.tree_map(
        lambda l: jnp.zeros((max_nodes,) + l.shape, l.dtype), y0
    )
    buf_f = jax.tree_util.tree_map(
        lambda l: jnp.zeros((max_nodes,) + l.shape, l.dtype), k1
    )

    def write_node(bufs, idx, t, y, k):
        b_s, b_y, b_f = bufs
        idx = jnp.minimum(idx, max_nodes - 1)
        s = ((t - t0) / span).astype(tdt)
        b_s = b_s.at[idx].set(s)
        b_y = jax.tree_util.tree_map(
            lambda buf, l: lax.dynamic_update_index_in_dim(buf, l, idx, 0), b_y, y
        )
        b_f = jax.tree_util.tree_map(
            lambda buf, l: lax.dynamic_update_index_in_dim(buf, l, idx, 0), b_f, k
        )
        return (b_s, b_y, b_f)

    bufs0 = write_node((buf_s, buf_y, buf_f), jnp.int32(0), t0, y0, k1)

    def cond(state):
        (_t, _y, _dt, _k1, _nfe, steps, done, fail, _bufs, _n) = state
        return jnp.logical_and(
            jnp.logical_not(jnp.logical_or(done, fail)), steps < cfg.max_steps
        )

    def body(state):
        (t, y, dt, k1, nfe, steps, _done, _fail, bufs, n) = state
        remaining = t1 - t
        dt_c = direction * jnp.minimum(jnp.abs(dt), jnp.abs(remaining))
        y5, err, k7 = _erk_step(tab, f, t, y, dt_c, k1, args)
        ratio = _rms_error_ratio(err, y, y5, cfg.rtol, cfg.atol)
        finite, factor = _controller_factor(
            ratio, inv_order, cfg.safety, cfg.min_factor, cfg.max_factor, tdt
        )
        accept = jnp.logical_and(finite, ratio <= 1.0)
        dt_next = dt_c * factor

        t_new = jnp.where(accept, t + dt_c, t)
        y_new = jax.tree_util.tree_map(lambda a, b: jnp.where(accept, a, b), y5, y)
        k_new = jax.tree_util.tree_map(lambda a, b: jnp.where(accept, a, b), k7, k1)

        # on accept, store the new endpoint (t_new, y_new, f(t_new) = k7 FSAL)
        bufs_acc = write_node(bufs, n, t_new, y_new, k_new)
        bufs_new = jax.tree_util.tree_map(
            lambda a, b: jnp.where(accept, a, b), bufs_acc, bufs
        )
        n_new = jnp.where(accept, n + 1, n)

        done = jnp.logical_and(
            accept, jnp.abs(t1 - t_new) <= tiny * jnp.maximum(jnp.abs(t1), 1.0)
        )
        fail = jnp.logical_and(
            jnp.logical_not(finite),
            jnp.abs(dt_c) <= _DT_GIVE_UP * jnp.abs(span),
        )
        return (t_new, y_new, dt_next, k_new, nfe + n_evals, steps + 1, done,
                fail, bufs_new, n_new)

    state0 = (
        t0, y0, dt_init, k1, jnp.int32(1 + nfe_init), jnp.int32(0),
        jnp.asarray(False), jnp.asarray(False), bufs0, jnp.int32(1),
    )
    (_t, y1, dt_f, _k, nfe, steps, done, _fail, bufs, n) = lax.while_loop(
        cond, body, state0
    )
    # Loud failure on both budget exhaustion AND dense-buffer overflow: once
    # n > max_nodes a node has clobbered the last slot and the tail of the
    # interpolant is wrong, which would silently corrupt quadrature-adjoint
    # gradients / trajectory() output — poison everything instead.
    ok = jnp.logical_and(done, n <= max_nodes)
    y1 = jax.tree_util.tree_map(
        lambda l: jnp.where(ok, l, jnp.full_like(l, jnp.nan)), y1
    )
    b_s, b_y, b_f = bufs
    poison = lambda l: jnp.where(ok, l, jnp.full_like(l, jnp.nan))
    b_y = jax.tree_util.tree_map(poison, b_y)
    b_f = jax.tree_util.tree_map(poison, b_f)
    dense = DenseSolution(s=b_s, ys=b_y, fs=b_f, n=jnp.minimum(n, max_nodes), t0=t0, t1=t1)
    nacc = n - 1
    return y1, SolverStats(nfe, nacc, steps - nacc, dt_f), dense


# ---------------------------------------------------------------------------
# fixed-step methods (lax.scan; reverse-differentiable)
# ---------------------------------------------------------------------------


def _rk4_step(f: ODEFunc, t: jax.Array, y: Pytree, dt: jax.Array, args: Pytree) -> Pytree:
    k1 = f(t, y, args)
    k2 = f(t + 0.5 * dt, _tree_add_scaled(y, dt, (0.5, k1)), args)
    k3 = f(t + 0.5 * dt, _tree_add_scaled(y, dt, (0.5, k2)), args)
    k4 = f(t + dt, _tree_add_scaled(y, dt, (1.0, k3)), args)
    return _tree_add_scaled(y, dt, (1 / 6, k1), (1 / 3, k2), (1 / 3, k3), (1 / 6, k4))


def _euler_step(f: ODEFunc, t: jax.Array, y: Pytree, dt: jax.Array, args: Pytree) -> Pytree:
    return _tree_add_scaled(y, dt, (1.0, f(t, y, args)))


def odeint_fixed(
    f: ODEFunc,
    y0: Pytree,
    t0: jax.Array,
    t1: jax.Array,
    args: Pytree,
    cfg: SolverConfig,
) -> Tuple[Pytree, SolverStats]:
    """Fixed-step integration via ``lax.scan`` — static step count, so XLA sees
    a bounded unrolled-in-time program it can pipeline, and reverse-mode AD
    (discretize-then-optimize) works out of the box.  ``cfg.remat`` wraps each
    step in ``jax.checkpoint`` so backprop memory is O(steps) small residuals
    instead of the full RK stage tree."""
    tdt = _time_dtype(y0)
    t0 = jnp.asarray(t0, tdt)
    t1 = jnp.asarray(t1, tdt)
    n = int(cfg.fixed_steps)
    args, _dt0_ignored = _pop_dt0(args)  # fixed-step: no starting-step choice
    dt = (t1 - t0) / n
    step = {"rk4": _rk4_step, "euler": _euler_step}[cfg.method]
    evals = {"rk4": 4, "euler": 1}[cfg.method]

    def body(y, i):
        t = t0 + i.astype(tdt) * dt
        return step(f, t, y, dt, args), None

    if cfg.remat:
        body = jax.checkpoint(body)

    y1, _ = lax.scan(body, y0, jnp.arange(n))
    return y1, SolverStats(jnp.int32(evals * n), jnp.int32(n), jnp.int32(0), dt)


def odeint(
    f: ODEFunc,
    y0: Pytree,
    t0: jax.Array,
    t1: jax.Array,
    args: Pytree,
    cfg: SolverConfig,
    error_weight: Pytree = None,
    dt0_override=None,
) -> Tuple[Pytree, SolverStats]:
    """Dispatch on ``cfg.method``. Gradient handling lives one level up
    (``ops.adjoint.odeint_diff``). ``error_weight`` marks which state leaves
    enter the adaptive error norm (seminorm support; ignored by fixed-step
    methods).  ``dt0_override``: explicit traced starting-step (internal
    callers, e.g. the backward adjoint solve); the ``args["dt0"]`` channel is
    the equivalent for calls that cross a custom_vjp boundary — an explicit
    override wins over the channel."""
    if cfg.method in _TABLEAUS:
        return odeint_dopri5(f, y0, t0, t1, args, cfg, error_weight,
                             dt0_override)
    if cfg.method == "abm":
        return odeint_abm(f, y0, t0, t1, args, cfg, error_weight)
    return odeint_fixed(f, y0, t0, t1, args, cfg)


def odeint_dense(
    f: ODEFunc,
    y0: Pytree,
    t0: jax.Array,
    t1: jax.Array,
    args: Pytree,
    cfg: SolverConfig,
) -> Tuple[Pytree, SolverStats, DenseSolution]:
    """Dense-output dispatch on ``cfg.method`` — every adaptive method
    (dopri5/tsit5/abm) can return a :class:`DenseSolution`; used by the
    interpolation (quadrature) adjoint and ``trajectory()``."""
    if cfg.method in _TABLEAUS:
        return odeint_dopri5_dense(f, y0, t0, t1, args, cfg)
    if cfg.method == "abm":
        return odeint_abm_dense(f, y0, t0, t1, args, cfg)
    raise ValueError(
        f"dense output needs an adaptive method (dopri5/tsit5/abm), got "
        f"{cfg.method!r}"
    )
