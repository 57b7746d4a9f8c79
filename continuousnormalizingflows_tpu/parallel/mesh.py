"""Device mesh, shardings, and the SPMD train step.

The reference is single-process/single-device — its only parallelism is
intra-device "matrix mode" batching (SURVEY.md §2.9).  This module is the
JAX-native scaling layer that replaces it:

* a named :class:`jax.sharding.Mesh` with a ``data`` axis (batch +
  per-sample Hutchinson probes are sharded along it) and an optional
  ``model`` axis reserved for tensor-parallel wide dynamics nets;
* ``jax.jit`` with ``in_shardings``/``out_shardings`` (pjit): XLA inserts the
  ``psum`` collectives for the loss mean and the gradient all-reduce — there
  is no hand-written NCCL/MPI analogue to port;
* **collective-consistent adaptivity**: because the whole train step is one
  SPMD program and the Dopri5 error norm is a global reduction over the
  sharded state (ops/ode.py:_rms_error_ratio), every device computes the same
  accept/reject decision and step size by construction — the hard requirement
  called out in SURVEY.md §5;
* ``initialize_distributed`` wires multi-host runs
  (``jax.distributed.initialize``).  XLA hands the collectives to the
  backend's library (NCCL on NVIDIA GPUs).

Randomness: probe/steer keys are ordinary jit inputs; under pjit the sampled
probe array inherits the batch sharding, so each device holds independent
probe rows without explicit key folding.
"""

from __future__ import annotations

from typing import Any, Callable, Optional, Sequence, Tuple

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

__all__ = [
    "make_mesh",
    "data_sharding",
    "replicated",
    "shard_batch_arrays",
    "shard_train_step",
    "shard_mlp_params",
    "initialize_distributed",
]

Pytree = Any


def initialize_distributed(**kwargs) -> None:
    """Multi-host bring-up (``jax.distributed.initialize``).  No-op when the
    runtime is already initialized or single-process."""
    try:
        jax.distributed.initialize(**kwargs)
    except (RuntimeError, ValueError):
        pass  # already initialized or single-process


def make_mesh(
    devices: Optional[Sequence[jax.Device]] = None,
    data: Optional[int] = None,
    model: int = 1,
    axis_names: Tuple[str, ...] = ("data", "model"),
) -> Mesh:
    """Build a ``data x model`` mesh.  ``data`` defaults to
    ``len(devices) // model`` — pure data parallelism.

    The shape follows the algorithm, not the interconnect: the cards of one
    host are joined all to all (NVLink), so every device order costs the
    same."""
    devices = list(devices) if devices is not None else list(jax.devices())
    if data is None:
        data = len(devices) // model
    grid = np.asarray(devices[: data * model]).reshape(data, model)
    return Mesh(grid, axis_names)


def data_sharding(mesh: Mesh) -> NamedSharding:
    """Batch-major arrays: rows split along the ``data`` axis."""
    return NamedSharding(mesh, P("data"))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def shard_batch_arrays(mesh: Mesh, xs: jax.Array, ys: Optional[jax.Array] = None):
    """Place the dataset with rows sharded over the ``data`` axis (the
    host-to-mesh boundary; reference analogue: the one device move at
    mlj_ext/core_icnf.jl:37-39)."""
    sh = data_sharding(mesh)
    xs = jax.device_put(xs, sh)
    if ys is not None:
        ys = jax.device_put(ys, sh)
    return xs, ys


def shard_mlp_params(mesh: Mesh, params: Pytree) -> Pytree:
    """Tensor parallelism for the dynamics MLP over the ``model`` axis —
    the SURVEY §2.9 "TP" entry (no reference counterpart; the reference is
    single-device).

    Megatron-style scheme for the 3-layer reference-default net: layer-0
    weights column-parallel (hidden dim sharded → activations sharded on
    ``model``), layer-1 weights row-parallel (contraction over the sharded
    hidden dim; GSPMD inserts the all-reduce), later layers replicated (the
    output width is tiny).  Params are placed with ``device_put``, so
    optimizer states built from them (``optax .init`` uses ``zeros_like``)
    inherit the shardings and the jitted train step needs no explicit
    ``in_shardings`` for them.
    """
    if mesh.shape.get("model", 1) == 1:
        return jax.device_put(params, replicated(mesh))

    def spec(i: int, name: str, leaf) -> NamedSharding:
        if i == 0:
            p = P(None, "model") if name == "w" else P("model")
        elif i == 1:
            p = P("model", None) if name == "w" else P()
        else:
            p = P()
        return NamedSharding(mesh, p)

    return [
        {name: jax.device_put(leaf, spec(i, name, leaf)) for name, leaf in layer.items()}
        for i, layer in enumerate(params)
    ]


def host_local_batch(mesh: Mesh, local_xs: jax.Array) -> jax.Array:
    """Assemble a *global* batch-sharded array from per-process local shards —
    multi-host data loading (SURVEY §2.9 comm row: each host loads its own
    rows; no host ever materializes the global batch).  ``local_xs`` is this
    process's rows; the returned global array has
    ``num_processes * local_rows`` rows sharded over ``data``.  Single-process
    it reduces to ``device_put`` with the data sharding."""
    return jax.make_array_from_process_local_data(data_sharding(mesh), local_xs)


def shard_train_step(
    step: Callable[..., Tuple[Pytree, Pytree, jax.Array]],
    mesh: Mesh,
    conditional: bool = False,
    tensor_parallel: bool = False,
    n_extra_repl: int = 0,
):
    """jit the train step over the mesh: batch sharded on ``data``, params/
    opt-state replicated — or, with ``tensor_parallel=True``, carrying
    whatever shardings the caller committed them with (see
    :func:`shard_mlp_params`).  XLA turns the global loss mean + ``jax.grad``
    into per-device compute with one gradient ``psum`` (plus the
    row-parallel activation all-reduce in the TP case).

    ``n_extra_repl`` appends that many replicated trailing arguments to the
    step signature (e.g. the carried starting-step scalar of
    ``SolverConfig.dt0 == "carry"``)."""
    repl = replicated(mesh)
    batch_sh = data_sharding(mesh)
    ys_sh = batch_sh if conditional else None
    extra = (repl,) * n_extra_repl
    if tensor_parallel:
        # params/opt-state shardings come from the committed inputs
        return jax.jit(
            step,
            in_shardings=(None, None, repl, batch_sh, ys_sh) + extra,
            donate_argnums=(0, 1),
        )
    # a single sharding is a valid pytree prefix for the whole output, so the
    # step may return any structure (params, opt_state, loss[, stats, ...])
    return jax.jit(
        step,
        in_shardings=(repl, repl, repl, batch_sh, ys_sh) + extra,
        out_shardings=repl,
        donate_argnums=(0, 1),
    )
