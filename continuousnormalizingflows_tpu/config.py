"""Static configuration for the ICNF framework.

The reference library (impICNF/ContinuousNormalizingFlows.jl) encodes behavior
variants as Julia compile-time type parameters on one unified ``ICNF`` struct
(reference ``src/core/types.jl:1-45`` and ``src/core/icnf.jl:16-141``).  The
JAX equivalent is a frozen, hashable dataclass that is passed to
``jax.jit`` as a *static* argument: every boolean/enum below is resolved at
trace time, so variant selection costs zero at runtime — the same property the
reference gets from dispatch.

Variant mapping (reference ``src/core/icnf.jl:1-15`` docstring):

* FFJORD        — ``lambda_1 = lambda_2 = lambda_3 = 0``, ``naugments = 0``
* RNODE         — ``lambda_1 != 0`` (kinetic) and/or ``lambda_2 != 0``
                  (Jacobian-Frobenius), integrated as extra ODE states
* ANODE         — ``naugments != 0`` (input zero-padded), ``lambda_3 != 0``
                  penalizes the terminal augmented-state norm
* STEER         — ``steer_rate != 0`` randomizes the end time in train mode
* Cond*         — ``nconditions != 0``; conditions concatenated to the net input
* non-autonomous— ``autonomous = False`` (default, as in the reference)
  concatenates scalar ``t`` to the net input.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Any, Tuple

import jax.numpy as jnp

# log(2*pi) — the one shared copy (normal log-densities in core,
# distributions, and utils.datasets all import it from here)
LOG_2PI = 1.8378770664093453

# The fixed-fraction starting step used wherever dt0="auto" does not apply:
# the backward adjoint solve, the ABM order-1 ramp, and the HNW non-finite
# fallback (one shared constant — retuning it must move all three in
# lockstep; rationales in ops/ode.py and ops/adjoint.py docstrings).
DEFAULT_FIXED_DT0 = 0.01

__all__ = [
    "LOG_2PI",
    "Mode",
    "TraceEstimator",
    "ProbeDist",
    "SolverConfig",
    "ICNFConfig",
]


class Mode(enum.Enum):
    """Evaluation mode — reference ``TestMode`` / ``TrainMode{REG}`` (types.jl:1-7).

    ``TEST``        — exact trace (full Jacobian diagonal), no regularization.
    ``TRAIN``       — stochastic (Hutchinson) trace; regularization states are
                      integrated when the corresponding ``lambda_*`` is nonzero
                      (reference ``TrainMode{true}``).
    ``TRAIN_NOREG`` — stochastic trace with regularization accumulators forced
                      to zero regardless of the lambdas (reference
                      ``TrainMode{false}``).
    """

    TEST = "test"
    TRAIN = "train"
    TRAIN_NOREG = "train_noreg"

    @property
    def stochastic(self) -> bool:
        return self is not Mode.TEST

    @property
    def regularized(self) -> bool:
        return self is Mode.TRAIN


class TraceEstimator(str, enum.Enum):
    """Collapse of the reference's 8 ``ComputeMode`` types (types.jl:9-35).

    ``vmap`` subsumes the vector/matrix split, JAX's single AD system subsumes
    the DI-vs-Lux and Zygote/ForwardDiff/Enzyme split; what remains semantic is
    *reverse* (VJP) vs *forward* (JVP) probe contraction.
    """

    HUTCH_VJP = "hutch_vjp"  # eps^T J via reverse-mode (default; LuxVecJacMatrixMode)
    HUTCH_JVP = "hutch_jvp"  # J eps via forward-mode (LuxJacVecMatrixMode)
    EXACT = "exact"  # full Jacobian diagonal — forced in Mode.TEST


class ProbeDist(str, enum.Enum):
    """Hutchinson probe distribution (reference ``epsdist``, icnf.jl:80-83)."""

    GAUSSIAN = "gaussian"  # reference default: MvNormal(0, I)
    RADEMACHER = "rademacher"  # lower-variance alternative for the trace


# Hard cap on the multistep history ring; the single source of truth for the
# config bound AND ops.ode's _ABM_MAX/_MILNE table length.  12 matches the
# reference VCABM's full order range (icnf.jl:89 / OrdinaryDiffEq VCABM).
ABM_MAX_ORDER = 12


@dataclasses.dataclass(frozen=True)
class SolverConfig:
    """ODE solve + gradient configuration.

    Mirrors the reference ``sol_kwargs`` (icnf.jl:84-102): adaptive solver with
    ``reltol = abstol = 1e-4`` and a continuous-adjoint gradient
    (``QuadratureAdjoint``).  XLA-first choices: the adaptive method is an
    embedded Runge-Kutta (Dormand-Prince 5(4)) driven by ``lax.while_loop``
    (multistep VCABM state machines map poorly onto XLA), and a fixed-step
    ``lax.scan`` path (``method="rk4"``) supports discretize-then-optimize
    backprop with static shapes and rematerialization.
    """

    # "dopri5" | "tsit5" (adaptive embedded RK) | "abm" (variable-step
    # Adams-Bashforth-Moulton PECE, the reference's VCABM solver class at
    # ~2 f-evals/step) | "rk4" | "euler" (fixed-step scan)
    method: str = "dopri5"
    rtol: float = 1.0e-4
    atol: float = 1.0e-4
    max_steps: int = 16_384  # adaptive-path bound (reference uses typemax(Int))
    fixed_steps: int = 64  # step count for fixed-step methods
    # "adjoint"    — backsolve continuous adjoint (state reconstructed backward)
    # "quadrature" — interpolation adjoint: dense forward interpolant + backward
    #                solve of (a, q) only — the closest analogue of the
    #                reference's QuadratureAdjoint (icnf.jl:90-99); stabler on
    #                stiff/long flows (no y-reconstruction error), costs
    #                O(dense_max_nodes) forward-state memory.  Pair
    #                method="abm" with this (the multistep backsolve
    #                re-integrates the primal backward), as the reference's
    #                default stack does (VCABM + QuadratureAdjoint)
    # "backprop"   — discretize-then-optimize (fixed-step methods only)
    gradient: str = "adjoint"
    remat: bool = True  # checkpoint each scan step in backprop mode
    # Initial trial step for the adaptive RK methods: "auto" (default) = the
    # Hairer-Nørsett-Wanner starting-step algorithm (one extra f eval) — what
    # the reference's SciML solve does with no dt given, and measurably
    # cheaper than any fixed guess on trained CNF fields (dopri5 NFE 25→20
    # TRAIN / 37→32 TEST, tsit5 25→20 at rtol 1e-4; PARITY.md, read before
    # the move to the GPU).  A float
    # fixes the start to that fraction of the span (the pre-round-3
    # behavior was 0.01).  "carry" (round 5) = warm-start each TRAINING
    # step's solve — forward AND backward-adjoint — with the previous
    # step's accepted dt (SolverStats.dt_final, threaded by ICNFModel/the
    # loss dt0= argument): parameters move slowly between optimizer steps,
    # so the last accepted dt is a near-optimal start and the per-solve
    # controller ramps disappear (adaptive train NFE 19 → 7 near init,
    # bench.py on an H100; gradients matching to 1e-6, PARITY round 5).  Solves with no carried value fall
    # back to "auto".  ABM always uses the fixed-fraction start (its
    # order-1 ramp needs small early steps; measured in ops.ode).
    dt0: Any = "auto"
    # node-buffer capacity for the dense forward interpolant ("quadrature"
    # gradients and trajectory()); each node stores (y, f).  Sizing rule:
    # must be >= accepted steps + 1.  At rtol 1e-4 CNF solves accept ~4-40
    # steps; raise this for stiff/long flows.  Overflow is NaN-poisoned
    # (loud), never silently degraded — see ops.ode.odeint_dopri5_dense.
    dense_max_nodes: int = 128
    # Exclude the parameter-quadrature states from the backward (adjoint)
    # error norm — the seminorm trick ("Hey, that's not an ODE", PAPERS.md);
    # cuts backward NFE without changing which quantities are error-controlled
    # in a way that matters (quadrature states never feed back).
    adjoint_seminorm: bool = True
    safety: float = 0.9
    max_factor: float = 10.0
    min_factor: float = 0.2
    # Maximum multistep order for method="abm" (the history-ring length).
    # The solver adapts order 1..abm_order per step, VCABM-style (reference
    # VCABM adapts 1-12, icnf.jl:89).  Measured (PARITY.md): at the reference
    # tolerance 1e-4 order 4 suffices; at rtol <= 1e-6 a capped order-4
    # method's step count blows up — raise toward ABM_MAX_ORDER (12) for
    # tight tolerances (orders >= 9 need float64 state: their Milne error
    # estimates sit below float32 resolution).
    abm_order: int = 4

    def __post_init__(self) -> None:
        adaptive = ("dopri5", "tsit5", "abm")
        if self.method not in adaptive + ("rk4", "euler"):
            raise ValueError(f"unknown ODE method {self.method!r}")
        if not 1 <= self.abm_order <= ABM_MAX_ORDER:
            raise ValueError(
                f"abm_order must be in [1, {ABM_MAX_ORDER}], got {self.abm_order}"
            )
        if self.gradient not in ("adjoint", "quadrature", "backprop"):
            raise ValueError(f"unknown gradient mode {self.gradient!r}")
        if isinstance(self.dt0, str):
            if self.dt0 not in ("auto", "carry"):
                raise ValueError(
                    f'dt0 must be a float, "auto", or "carry", got {self.dt0!r}'
                )
        elif not float(self.dt0) > 0.0:
            # > 1 is legal: a deliberate overshoot start exercises the
            # controller's reject-and-shrink path (tests/test_ode.py)
            raise ValueError(f"dt0 must be positive, got {self.dt0!r}")
        if self.gradient == "backprop" and self.method in adaptive:
            raise ValueError(
                "backprop gradients require a fixed-step method (rk4/euler); "
                "use gradient='adjoint' with an adaptive method"
            )
        if self.gradient == "quadrature" and self.method not in adaptive:
            raise ValueError(
                "the interpolation (quadrature) adjoint needs an adaptive "
                "dense-output solver (dopri5/tsit5/abm); fixed-step methods "
                "support gradient='backprop'"
            )


def _as_float(x: Any) -> float:
    return float(x)


@dataclasses.dataclass(frozen=True)
class ICNFConfig:
    """Hyperparameters of one ICNF — reference ``ICNF`` fields (icnf.jl:37-50).

    Defaults match the reference constructor (icnf.jl:53-103): augmentation ON
    (``naugments = nvariables + 1``), non-autonomous, ``tspan = (0, 1)``,
    ``lambda_1 = lambda_2 = lambda_3 = 0.01``, ``steer_rate = 0.1``, float32,
    standard-normal base and probe distributions over the augmented dimension.
    """

    nvariables: int = 1
    naugments: int = -1  # -1 ⇒ reference default nvariables + 1
    nconditions: int = 0
    autonomous: bool = False
    tspan: Tuple[float, float] = (0.0, 1.0)
    trace: TraceEstimator = TraceEstimator.HUTCH_VJP
    # Probe distribution (reference ``epsdist``, icnf.jl:80-83): a ProbeDist
    # enum value, or any object with a ``sample_fn(key, shape, dtype)`` —
    # see distributions.CustomDist (e.g. distributions.uniform_probe()).
    # Unit variance is the estimator's only requirement (E[εεᵀ] = I).
    probe_dist: Any = ProbeDist.GAUSSIAN
    # Base distribution over the nz-dim terminal state (reference
    # ``basedist``, icnf.jl:76-79; consumed at base_icnf.jl:158-172 and the
    # generate-path draw).  None = standard normal (the reference default,
    # on a fast built-in path); otherwise a distributions.CustomDist-like
    # object with ``logpdf_fn((..., nz)) -> (...,)`` and
    # ``sample_fn(key, shape, dtype)``.  Static at trace time — create the
    # object ONCE and reuse it (identity hashing; the distributions-module
    # factories are lru_cached for exactly this reason).
    base_dist: Any = None
    nprobes: int = 1  # reference uses a single fresh probe per solve
    # Mesh axis name to shard the probe ensemble over (SURVEY §2.9 "probe"
    # axis): with nprobes > 1 each rank of the axis computes its own probes'
    # VJP sweeps and the trace mean becomes a psum — variance-reduction
    # parallelism.  Requires an enclosing `jax.set_mesh(mesh)` whose mesh has
    # this axis (parallel.make_mesh's "model" axis works).  None = replicated.
    probe_axis: Any = None
    # Exact-trace sweep controls for nets WITHOUT an analytic trace (deep /
    # from_flax dynamics; the reference's icnf_jacobian covers any nn,
    # utils.jl:12-88, at O(nz) AD sweeps):
    #   exact_chunk — accumulate the Jacobian diagonal in blocks of this many
    #     sweeps (peak memory (chunk, batch, nz) instead of (nz, batch, nz);
    #     mandatory at image scale).  0 = unchunked full sweep stack.
    #   sweep_axis — mesh axis name to shard the sweep ensemble over (the
    #     EXACT analogue of probe_axis): each rank runs nz/ranks sweeps,
    #     GSPMD inserts the trace psum.  Requires an enclosing jax.set_mesh.
    exact_chunk: int = 0
    sweep_axis: Any = None
    steer_rate: float = 0.1
    # Steering distribution (reference ``steerdist``, icnf.jl:49; defaulted
    # to ``Uniform(-steer_rate, steer_rate)`` at icnf.jl:104 and drawn as
    # ``rand(rng, steerdist)`` in steer_tspan, base_icnf.jl:36):  ``None``
    # keeps the uniform default parameterized by ``steer_rate``; otherwise a
    # sampling-capable distribution (``sample_fn(key, shape, dtype)`` — see
    # distributions.CustomDist; logpdf never needed) drawing the multiplier
    # ``r`` in ``t1' = t1 + |t1 - t0| * r``.  Static at trace time — create
    # the object once and reuse it (identity hashing).
    steer_dist: Any = None
    lambda_1: float = 0.01  # kinetic-energy weight (RNODE)
    lambda_2: float = 0.01  # Jacobian-Frobenius weight (RNODE)
    lambda_3: float = 0.01  # terminal augmented-norm weight (ANODE)
    dtype: Any = jnp.float32
    solver: SolverConfig = dataclasses.field(default_factory=SolverConfig)
    # Array layout *inside the ODE solve*:
    #   "batch_first"   — (batch, features): natural NumPy layout; features
    #                     are the minor-most (contiguous) dimension.
    #   "feature_first" — (features, batch): batch is minor-most (the
    #                     analogue of the reference's d×n samples-last layout,
    #                     mlj_ext/core_icnf.jl:33), so tiny feature widths do
    #                     not set the contiguous extent of every operand.
    # The public API stays batch-first either way — transposes happen once per
    # solve, not per step.
    layout: str = "batch_first"

    def __post_init__(self) -> None:
        if self.naugments < 0:
            object.__setattr__(self, "naugments", self.nvariables + 1)
        if self.nvariables < 1:
            raise ValueError("nvariables must be >= 1")
        if not isinstance(self.trace, TraceEstimator):
            object.__setattr__(self, "trace", TraceEstimator(self.trace))
        if not isinstance(self.probe_dist, ProbeDist):
            if getattr(self.probe_dist, "sample_fn", None) is not None:
                pass  # custom probe: duck-typed (logpdf never needed)
            elif hasattr(self.probe_dist, "sample_fn") or not isinstance(
                self.probe_dist, str
            ):
                # a CustomDist-like object that is missing its sampler (or any
                # non-enum-coercible value): name the actual problem instead of
                # falling through to an opaque "not a valid ProbeDist"
                raise ValueError(
                    "probe_dist must be a ProbeDist enum value or a "
                    "distribution with a non-None sample_fn(key, shape, dtype) "
                    f"(see distributions.CustomDist); got {self.probe_dist!r} "
                    "with sample_fn=None"
                )
            else:
                object.__setattr__(self, "probe_dist", ProbeDist(self.probe_dist))
        if self.steer_dist is not None and (
            getattr(self.steer_dist, "sample_fn", None) is None
        ):
            raise ValueError(
                "steer_dist needs a non-None sample_fn(key, shape, dtype) "
                "(see distributions.CustomDist); None selects "
                "Uniform(-steer_rate, steer_rate)"
            )
        if self.base_dist is not None and (
            getattr(self.base_dist, "logpdf_fn", None) is None
            or getattr(self.base_dist, "sample_fn", None) is None
        ):
            raise ValueError(
                "base_dist needs both logpdf_fn and sample_fn (see "
                "distributions.CustomDist); None selects the standard normal"
            )
        if self.layout not in ("batch_first", "feature_first"):
            raise ValueError(f"unknown layout {self.layout!r}")
        if self.exact_chunk < 0:
            raise ValueError(
                f"exact_chunk must be >= 0 (0 = unchunked), got {self.exact_chunk}"
            )
        object.__setattr__(self, "tspan", (float(self.tspan[0]), float(self.tspan[1])))

    # ---- derived sizes (reference icnf.jl:62-66, base_icnf.jl:13-21) ----

    @property
    def augmented(self) -> bool:
        return self.naugments != 0

    @property
    def conditioned(self) -> bool:
        return self.nconditions != 0

    @property
    def steered(self) -> bool:
        # a custom steer_dist activates steering regardless of steer_rate
        # (the rate only parameterizes the uniform default, icnf.jl:104)
        return self.steer_rate != 0.0 or self.steer_dist is not None

    @property
    def nz(self) -> int:
        """Flow-state dimension = nvariables + naugments."""
        return self.nvariables + self.naugments

    @property
    def n_aug_input(self) -> int:
        """Zero-padding width of the input (reference ``n_augments_input``)."""
        return self.naugments if self.augmented else 0

    @property
    def state_dim(self) -> int:
        """Augmented ODE state width: [z, dlogp, E, n] — the two regularization
        accumulators are always carried (reference ``n_augments == 2``,
        icnf.jl:143-145)."""
        return self.nz + 3

    @property
    def n_in(self) -> int:
        return self.nz + (0 if self.autonomous else 1) + self.nconditions

    @property
    def n_out(self) -> int:
        return self.nz

    @property
    def norm_z(self) -> bool:
        return self.lambda_1 != 0.0

    @property
    def norm_j(self) -> bool:
        return self.lambda_2 != 0.0

    @property
    def norm_z_aug(self) -> bool:
        return self.lambda_3 != 0.0

    def trace_for(self, mode: Mode) -> TraceEstimator:
        """TEST mode always uses the exact trace (reference types.jl:1-7)."""
        return TraceEstimator.EXACT if mode is Mode.TEST else self.trace
