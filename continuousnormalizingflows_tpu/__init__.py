"""Continuous normalizing flows in JAX.

A from-scratch JAX/XLA framework with the capabilities of
impICNF/ContinuousNormalizingFlows.jl (FFJORD / RNODE / ANODE / STEER /
conditional and planar variants; exact and Hutchinson trace estimators;
adaptive and fixed-step ODE solves; continuous-adjoint and
discretize-then-optimize gradients; estimator and distribution facades;
mesh-sharded multi-device training).

Quick start::

    import jax
    import continuousnormalizingflows_tpu as cnf

    icnf = cnf.ICNF.create(nvariables=2)
    params = icnf.init(jax.random.PRNGKey(0))
    lp, (E, n, A), stats = cnf.inference(icnf, cnf.Mode.TRAIN, x, params,
                                         key=jax.random.PRNGKey(1))
    # stats: SolverStats(nfe, naccept, nreject, dt_final); int(stats) == NFE
"""

from . import distributions
from .config import ICNFConfig, Mode, ProbeDist, SolverConfig, TraceEstimator
from .core import (base_logpdf, generate, generate_with_logp, inference,
                   log_prob, loss, loss_with_stats, trajectory)
from .dist import CondICNFDist, ICNFDist
from .distributions import CustomDist
from .models.icnf import ICNF, default_net
from .models.nets import MLP, CondLayer, DynamicsNet, Planar, from_flax, planar_h
from .train import CondICNFModel, FitResult, ICNFModel, default_optimizer

__version__ = "0.1.0"

__all__ = [
    "ICNF",
    "ICNFConfig",
    "Mode",
    "ProbeDist",
    "CustomDist",
    "distributions",
    "SolverConfig",
    "TraceEstimator",
    "MLP",
    "Planar",
    "CondLayer",
    "DynamicsNet",
    "default_net",
    "from_flax",
    "planar_h",
    "inference",
    "loss_with_stats",
    "generate",
    "generate_with_logp",
    "loss",
    "log_prob",
    "trajectory",
    "base_logpdf",
    "ICNFModel",
    "CondICNFModel",
    "FitResult",
    "default_optimizer",
    "ICNFDist",
    "CondICNFDist",
    "__version__",
]
