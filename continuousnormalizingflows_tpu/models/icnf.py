"""The ICNF model object: static config + dynamics network.

Plays the role of the reference's ``ICNF`` struct + constructor
(``src/core/icnf.jl:16-141``).  The object is immutable and hashed by
identity, so it can be passed to ``jax.jit`` as a static argument — the JAX
analogue of the reference resolving all variant flags at compile time through
type parameters.  Parameters live *outside* the model (a pytree returned by
:meth:`ICNF.init`), the standard JAX functional split (reference equivalent:
``LuxCore.setup`` returning ``(ps, st)``, SURVEY.md §3.4).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import jax

from ..config import ICNFConfig, ProbeDist, SolverConfig, TraceEstimator
from .nets import MLP, DynamicsNet

__all__ = ["ICNF", "default_net"]


def default_net(cfg: ICNFConfig, precision: str = "highest") -> MLP:
    """Reference default dynamics net (icnf.jl:62-71):
    ``Dense(n_in -> 4*n_in, softplus) -> Dense(softplus) -> Dense(-> n_out)``.

    ``precision``: matmul precision — "highest" (float32-accurate, required
    for adaptive 1e-4 error control and density parity) or "default" (the
    backend's fast float32 matmul: TF32 tensor-core passes on NVIDIA GPUs,
    about 10 mantissa bits — for fixed-step solvers where Monte-Carlo trace
    noise dominates)."""
    h = 4 * cfg.n_in
    return MLP((cfg.n_in, h, h, cfg.n_out), dtype=cfg.dtype, precision=precision)


@dataclasses.dataclass(frozen=True, eq=False)
class ICNF:
    """An infinitesimal continuous normalizing flow.

    Build with :meth:`ICNF.create` for reference-matching defaults, or
    directly from an :class:`ICNFConfig` and any
    :class:`~continuousnormalizingflows_tpu.models.nets.DynamicsNet` whose
    ``n_in``/``n_out`` match the config (the reference accepts any Lux layer
    as ``nn``; e.g. pass a ``Planar`` net for planar-flow dynamics).
    """

    config: ICNFConfig
    net: DynamicsNet

    def __post_init__(self) -> None:
        if self.net.n_in != self.config.n_in or self.net.n_out != self.config.n_out:
            raise ValueError(
                f"net widths ({self.net.n_in}->{self.net.n_out}) do not match "
                f"config ({self.config.n_in}->{self.config.n_out}); remember the "
                f"net input carries [z({self.config.nz}), t(. if non-autonomous), "
                f"ys({self.config.nconditions})]"
            )

    @classmethod
    def create(
        cls,
        nvariables: int = 1,
        naugments: int = -1,
        nconditions: int = 0,
        autonomous: bool = False,
        tspan=(0.0, 1.0),
        trace: TraceEstimator = TraceEstimator.HUTCH_VJP,
        probe_dist=ProbeDist.GAUSSIAN,
        base_dist=None,
        nprobes: int = 1,
        probe_axis=None,
        exact_chunk: int = 0,
        sweep_axis=None,
        steer_rate: float = 0.1,
        steer_dist=None,
        lambda_1: float = 0.01,
        lambda_2: float = 0.01,
        lambda_3: float = 0.01,
        dtype=None,
        solver: Optional[SolverConfig] = None,
        net: Optional[DynamicsNet] = None,
        precision: str = "highest",
        layout: str = "batch_first",
    ) -> "ICNF":
        """Build an ICNF with reference-matching defaults (icnf.jl:53-103).

        ``base_dist`` / ``probe_dist`` / ``steer_dist``: pluggable base,
        Hutchinson-probe, and steering distributions (the reference's
        ``basedist``/``epsdist``/``steerdist`` constructor arguments,
        icnf.jl:76-83 and icnf.jl:49,104) — see
        :mod:`continuousnormalizingflows_tpu.distributions`; the defaults are
        the reference's standard normal for base/probe and
        ``Uniform(-steer_rate, steer_rate)`` for the steering multiplier.

        ``nprobes``: Hutchinson probes per solve.  The reference fixes 1
        (base_icnf.jl:207-208); this is a capability beyond it: the trace
        estimator's variance falls as 1/nprobes while the probe VJPs batch
        into one matmul chain.  Use 1 for strict reference parity, more when
        estimator variance matters; with a mesh, ``probe_axis`` shards the
        ensemble.
        """
        import jax.numpy as jnp

        cfg = ICNFConfig(
            layout=layout,
            nvariables=nvariables,
            naugments=naugments,
            nconditions=nconditions,
            autonomous=autonomous,
            tspan=tuple(tspan),
            trace=trace,
            probe_dist=probe_dist,
            base_dist=base_dist,
            nprobes=nprobes,
            probe_axis=probe_axis,
            exact_chunk=exact_chunk,
            sweep_axis=sweep_axis,
            steer_rate=steer_rate,
            steer_dist=steer_dist,
            lambda_1=lambda_1,
            lambda_2=lambda_2,
            lambda_3=lambda_3,
            dtype=dtype if dtype is not None else jnp.float32,
            solver=solver if solver is not None else SolverConfig(),
        )
        return cls(config=cfg, net=net if net is not None else default_net(cfg, precision))

    def init(self, key: jax.Array):
        """Initialize dynamics-net parameters (reference ``LuxCore.setup``)."""
        return self.net.init(key)
