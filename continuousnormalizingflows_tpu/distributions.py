"""Pluggable base and probe distributions.

The reference constructor accepts arbitrary ``basedist::Distributions.
Distribution`` and ``epsdist`` fields (``/root/reference/src/core/icnf.jl:
76-83``), consumed at exactly two points: ``logpdf(basedist, z)`` in
``inference_sol`` (``base_icnf.jl:158-172``) and the probe draw
``rand(rng, epsdist)`` (``base_icnf.jl:207-208``).  The JAX-native analogue
is a static ``(logpdf_fn, sample_fn)`` pair carried on the frozen config —
the callables are resolved at trace time, so a custom base costs nothing at
runtime (same property the reference gets from dispatch on the distribution
type).

Usage::

    from continuousnormalizingflows_tpu import distributions as dists
    icnf = cnf.ICNF.create(nvariables=2, base_dist=dists.logistic())
    icnf = cnf.ICNF.create(nvariables=2, probe_dist=dists.uniform_probe())

Probe-variance contract: a ``probe_dist`` MUST have unit variance per
component — the Hutchinson estimator needs ``E[εεᵀ] = I``, and a
non-unit-variance probe silently scales every estimated divergence (e.g. a
raw Student-t probe with df=7 inflates tr(J) estimates by df/(df−2) = 1.4x).
The factories here are base distributions; only :func:`uniform_probe` (and
the Gaussian/Rademacher enums) are probe-ready as-is — standardize anything
else (scale a Student-t by ``sqrt((df−2)/df)``) before using it as a probe.

Hashability contract (the same identity-hashing convention as ``ICNF`` /
``DynamicsNet``, CLAUDE.md): a :class:`CustomDist` compares by its function
objects, so **create the distribution once and reuse it** — the factory
functions below are ``lru_cache``'d, making repeated calls with equal
arguments return the *same* object (no accidental jit retraces).

All distributions here are iid across the ``nz`` flow dimensions, matching
the reference's default product structure (``MvNormal(0, I)``); a fully
custom correlated base is a :class:`CustomDist` away.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Callable, Tuple

import jax
import jax.numpy as jnp

from .config import LOG_2PI as _LOG_2PI

__all__ = [
    "CustomDist",
    "standard_normal",
    "diag_normal",
    "logistic",
    "student_t",
    "normal_mixture",
    "uniform_probe",
]


@dataclasses.dataclass(frozen=True)
class CustomDist:
    """A distribution as a static ``(logpdf, sample)`` callable pair.

    ``logpdf_fn(z)``: ``(..., nz) -> (...,)`` joint log-density over the last
    axis.  ``sample_fn(key, shape, dtype)``: draw an array of ``shape``
    (the last axis is the event dimension ``nz``).

    Used as ``ICNFConfig.base_dist`` (needs both callables) or as
    ``ICNFConfig.probe_dist`` (only ``sample_fn`` is called; pass
    ``logpdf_fn=None`` for sampling-only probe distributions — probe
    densities never enter the Hutchinson estimate, which only needs
    ``E[εεᵀ] = I``).
    """

    logpdf_fn: Any
    sample_fn: Any
    name: str = "custom"

    def logpdf(self, z: jax.Array) -> jax.Array:
        return self.logpdf_fn(z)

    def sample(self, key: jax.Array, shape: Tuple[int, ...], dtype) -> jax.Array:
        return self.sample_fn(key, shape, dtype)


def _iid(name: str, logpdf1: Callable, sampler: Callable) -> CustomDist:
    """Lift a per-dimension scalar log-density + sampler to an iid joint."""

    def logpdf_fn(z):
        return jnp.sum(logpdf1(z), axis=-1)

    return CustomDist(logpdf_fn, sampler, name)


@functools.lru_cache(maxsize=None)
def standard_normal() -> CustomDist:
    """The reference default base, ``MvNormal(0, I)`` (icnf.jl:76-79) — equal
    to the built-in fast path (``ICNFConfig.base_dist = None``); exists so a
    custom-dist pipeline has an explicit identity element."""
    return _iid(
        "standard_normal",
        lambda z: -0.5 * (_LOG_2PI + jnp.square(z)),
        lambda key, shape, dtype: jax.random.normal(key, shape, dtype),
    )


@functools.lru_cache(maxsize=None)
def diag_normal(locs: Tuple[float, ...], scales: Tuple[float, ...]) -> CustomDist:
    """Independent normal per dimension with the given means/scales (tuples of
    floats, length ``nz`` — tuples keep the object hashable for jit)."""
    if len(locs) != len(scales):
        raise ValueError(f"locs/scales length mismatch: {len(locs)} vs {len(scales)}")
    if not all(s > 0.0 for s in scales):
        raise ValueError(f"scales must be positive, got {scales}")

    def logpdf_fn(z):
        mu = jnp.asarray(locs, z.dtype)
        sig = jnp.asarray(scales, z.dtype)
        r = (z - mu) / sig
        return jnp.sum(-0.5 * (_LOG_2PI + r * r) - jnp.log(sig), axis=-1)

    def sample_fn(key, shape, dtype):
        if shape[-1] != len(locs):
            raise ValueError(
                f"diag_normal built for {len(locs)} dims, asked for {shape[-1]} "
                f"(nz must match the distribution width)"
            )
        mu = jnp.asarray(locs, dtype)
        sig = jnp.asarray(scales, dtype)
        return mu + sig * jax.random.normal(key, shape, dtype)

    return CustomDist(logpdf_fn, sample_fn, "diag_normal")


@functools.lru_cache(maxsize=None)
def logistic() -> CustomDist:
    """iid standard logistic — a heavier-tailed base (kurtosis 4.2); the
    classic non-Gaussian choice for flows over heavy-tailed data."""

    def logpdf1(z):
        # log f(z) = -z - 2*log(1 + e^{-z}) = -z - 2*softplus(-z)
        return -z - 2.0 * jax.nn.softplus(-z)

    return _iid(
        "logistic",
        logpdf1,
        lambda key, shape, dtype: jax.random.logistic(key, shape, dtype),
    )


@functools.lru_cache(maxsize=None)
def student_t(df: float) -> CustomDist:
    """iid Student-t with ``df`` degrees of freedom (power-law tails; df→∞
    recovers the normal)."""
    if not df > 0.0:
        raise ValueError(f"df must be positive, got {df}")
    c = float(
        math.lgamma((df + 1.0) / 2.0)
        - math.lgamma(df / 2.0)
        - 0.5 * math.log(df * math.pi)
    )

    def logpdf1(z):
        return c - 0.5 * (df + 1.0) * jnp.log1p(jnp.square(z) / df)

    return _iid(
        f"student_t({df})",
        logpdf1,
        lambda key, shape, dtype: jax.random.t(key, df, shape, dtype),
    )


@functools.lru_cache(maxsize=None)
def normal_mixture(
    locs: Tuple[float, ...],
    scales: Tuple[float, ...],
    weights: Tuple[float, ...],
) -> CustomDist:
    """iid per-dimension K-component normal mixture (multimodal base).
    ``locs``/``scales``/``weights`` are length-K float tuples; weights are
    normalized internally."""
    k = len(locs)
    if len(scales) != k or len(weights) != k:
        raise ValueError("locs/scales/weights must have equal length")
    if not all(s > 0.0 for s in scales):
        raise ValueError(f"scales must be positive, got {scales}")
    if not all(w > 0.0 for w in weights):
        raise ValueError(f"weights must be positive, got {weights}")
    wsum = float(sum(weights))
    logw = tuple(math.log(w / wsum) for w in weights)

    def logpdf_fn(z):
        mu = jnp.asarray(locs, z.dtype)  # (K,)
        sig = jnp.asarray(scales, z.dtype)
        lw = jnp.asarray(logw, z.dtype)
        r = (z[..., None] - mu) / sig  # (..., nz, K)
        comp = -0.5 * (_LOG_2PI + r * r) - jnp.log(sig) + lw
        return jnp.sum(jax.scipy.special.logsumexp(comp, axis=-1), axis=-1)

    def sample_fn(key, shape, dtype):
        k_comp, k_norm = jax.random.split(key)
        idx = jax.random.categorical(
            k_comp, jnp.asarray(logw, jnp.float32), shape=shape
        )
        mu = jnp.asarray(locs, dtype)[idx]
        sig = jnp.asarray(scales, dtype)[idx]
        return mu + sig * jax.random.normal(k_norm, shape, dtype)

    return CustomDist(logpdf_fn, sample_fn, "normal_mixture")


@functools.lru_cache(maxsize=None)
def uniform_probe() -> CustomDist:
    """Sampling-only probe distribution: uniform on ``[-√3, √3]`` (unit
    variance, so the Hutchinson estimator stays unbiased — it only needs
    ``E[εεᵀ] = I``).  Bounded support caps the per-probe estimate range;
    variance sits between Gaussian and Rademacher probes."""
    s = math.sqrt(3.0)
    return CustomDist(
        None,
        lambda key, shape, dtype: jax.random.uniform(
            key, shape, dtype, minval=-s, maxval=s
        ),
        "uniform_probe",
    )
