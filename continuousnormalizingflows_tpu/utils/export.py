"""Serving export: a fitted flow as a standalone StableHLO artifact.

Production deployment path the reference does not have: the reference serves
a model by loading the Julia stack + BSON machine (``MLJBase.save``,
``/root/reference/src/exts/mlj_ext/core_icnf.jl`` via MLJ machinery); here a
fitted ICNF is exported with :mod:`jax.export` to a *self-contained*
serialized computation (StableHLO + fitted params baked in as constants)
that a serving process can run with only ``jax.export.deserialize`` — no
model code, config objects, or parameter files.  Artifacts are
shape-polymorphic in the batch dimension (one artifact serves any batch
size) and can be lowered for several platforms at once
(``platforms=("cuda", "cpu")``).

What is exported is the deterministic TestMode surface — exactly what a
density-serving endpoint needs:

* :func:`export_logpdf` — ``x (b, nvariables) [, ys (b, nconditions)]
  -> logp (b,)`` (exact-trace log-density; the reference's functor call)
* :func:`export_sampler` — ``seed (uint32 scalar) -> samples (n, nvariables)``
  (the generate path; ``n`` fixed at export time — serving batches requests)

The stochastic TRAIN surface is intentionally not exported: serving a
Hutchinson *estimate* is a training-diagnostics concern, and the probe would
make artifacts nondeterministic.

Round-trip + parity covered in ``tests/test_export.py``.
"""

from __future__ import annotations

import functools
from typing import Any, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp

from ..config import Mode

__all__ = [
    "export_logpdf",
    "export_sampler",
    "save_artifact",
    "load_artifact",
]

Pytree = Any


def _specs_batch_poly(icnf, conditioned: bool, sharding=None, n_dev: int = 1):
    """ShapeDtypeStructs with a symbolic batch dim (``n_dev*b`` when sharded,
    so any served batch is divisible across the mesh)."""
    cfg = icnf.config
    scope = jax.export.SymbolicScope()
    dim = "b" if n_dev == 1 else f"{n_dev}*b"
    (b,) = jax.export.symbolic_shape(dim, scope=scope)
    kw = {} if sharding is None else {"sharding": sharding}
    x_spec = jax.ShapeDtypeStruct((b, cfg.nvariables), cfg.dtype, **kw)
    if not conditioned:
        return (x_spec,)
    ys_spec = jax.ShapeDtypeStruct((b, cfg.nconditions), cfg.dtype, **kw)
    return (x_spec, ys_spec)


def export_logpdf(
    icnf,
    params: Pytree,
    platforms: Optional[Sequence[str]] = None,
    mesh=None,
) -> "jax.export.Exported":
    """Export the exact (TestMode) log-density with ``params`` baked in.

    Returns a :class:`jax.export.Exported`; call it directly
    (``exp.call(x)``), or ``save_artifact``/``serialize`` it for a serving
    process.  The batch dimension is symbolic — one artifact serves any
    batch size.  For a conditional model the exported callable is
    ``(x, ys) -> logp``.

    ``platforms``: e.g. ``("cuda", "cpu")`` to lower for both (default: the
    current backend only).

    ``mesh``: a :class:`jax.sharding.Mesh` for **multi-chip serving** — the
    artifact is exported SPMD with the batch sharded over the mesh's
    ``data`` axis (``parallel.data_sharding``); the serving process loads it
    onto an identically-shaped mesh and passes batch-sharded arrays (batch
    divisible by the DATA-axis size — the symbolic batch is ``n_data*b``).
    Validated mesh-parity in tests/test_export.py on the 8-device CPU mesh.
    """
    from ..core import log_prob

    cfg = icnf.config
    sharding = None
    n_dev = 1
    if mesh is not None:
        from ..parallel.mesh import data_sharding

        sharding = data_sharding(mesh)
        # divisibility requirement follows the axis the batch is SHARDED
        # over (the 'data' axis), not the whole mesh — a data x model mesh
        # only needs batches divisible by the data-axis size
        n_dev = int(mesh.shape.get("data", mesh.devices.size))

    if cfg.conditioned:

        def f(x, ys):
            if sharding is not None:
                x = jax.lax.with_sharding_constraint(x, sharding)
                ys = jax.lax.with_sharding_constraint(ys, sharding)
            return log_prob(icnf, Mode.TEST, x, params, ys=ys)

    else:

        def f(x):
            if sharding is not None:
                x = jax.lax.with_sharding_constraint(x, sharding)
            return log_prob(icnf, Mode.TEST, x, params)

    kw = {}
    if platforms is not None:
        kw["platforms"] = tuple(platforms)
    return jax.export.export(jax.jit(f), **kw)(
        *_specs_batch_poly(icnf, cfg.conditioned, sharding, n_dev)
    )


def export_sampler(
    icnf,
    params: Pytree,
    n: int,
    ys=None,
    trace_free: bool = True,
    platforms: Optional[Sequence[str]] = None,
) -> "jax.export.Exported":
    """Export the sampling path: ``seed (uint32 scalar) -> (n, nvariables)``.

    ``n`` is fixed at export time (the base draw's shape); a serving process
    batches requests to the exported size.  ``trace_free=True`` (default)
    integrates the bare field — the sampling fast path (no per-step trace
    estimate); the sample distribution is identical.  Conditions, if any, are baked in
    from ``ys`` (export one artifact per served condition, or bake a batch
    of per-sample conditions of length ``n``).
    """
    from ..core import generate

    cfg = icnf.config
    if cfg.conditioned and ys is None:
        raise ValueError("conditional model: pass ys to bake into the sampler")
    ys = None if ys is None else jnp.asarray(ys, cfg.dtype)

    def f(seed):
        key = jax.random.PRNGKey(seed)
        return generate(icnf, Mode.TEST, params, key, n, ys=ys,
                        trace_free=trace_free)

    seed_spec = jax.ShapeDtypeStruct((), jnp.uint32)
    kw = {}
    if platforms is not None:
        kw["platforms"] = tuple(platforms)
    return jax.export.export(jax.jit(f), **kw)(seed_spec)


def save_artifact(path: str, exported: "jax.export.Exported") -> None:
    """Write a serialized export artifact (StableHLO + baked constants)."""
    with open(path, "wb") as fh:
        fh.write(exported.serialize())


def load_artifact(path: str) -> "jax.export.Exported":
    """Load an artifact; ``.call(...)`` runs it (no model code needed)."""
    with open(path, "rb") as fh:
        return jax.export.deserialize(fh.read())
