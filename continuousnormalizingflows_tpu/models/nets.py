"""Dynamics networks (the ``nn`` of an ICNF).

The reference builds its default dynamics with Lux
(``Dense(softplus) -> Dense(softplus) -> Dense``, reference
``src/core/icnf.jl:67-71``) and also ships a planar-flow layer
(``src/layers/planar_layer.jl``).  Here a dynamics network is a plain pair of
pure functions — ``init(key) -> params`` and ``apply(params, x) -> y`` — over
pytrees, which is the idiomatic JAX shape: no module system is required for
``jit``/``vmap``/``grad`` to compose, and any Flax module can be adapted.

``apply`` must accept arbitrary leading batch dimensions on ``x`` (shape
``(..., n_in) -> (..., n_out)``); every built-in here is matmul-based so this
holds automatically, and it is what lets one code path serve the reference's
VectorMode (no batch), MatrixMode (batch) and the exact-trace per-sample
Jacobian (vmapped single samples).
"""

from __future__ import annotations

from typing import Any, Callable, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp

__all__ = ["DynamicsNet", "MLP", "Planar", "CondLayer", "planar_h", "from_flax"]

Params = Any


class DynamicsNet:
    """Minimal dynamics-network interface.

    Subclasses/instances expose ``init(key) -> params`` and
    ``apply(params, x) -> y``.  Instances are compared by identity, which makes
    them valid static arguments to ``jax.jit``.
    """

    n_in: int
    n_out: int

    def init(self, key: jax.Array) -> Params:  # pragma: no cover - interface
        raise NotImplementedError

    def apply(self, params: Params, x: jax.Array) -> jax.Array:  # pragma: no cover
        raise NotImplementedError

    def apply_t(self, params: Params, x: jax.Array) -> jax.Array:
        """Feature-first apply: ``x`` is ``(n_in, batch)`` → ``(n_out, batch)``.

        Used by the ``layout="feature_first"`` solve path, which keeps the
        batch in the minor-most dimension.  Default falls back to the
        batch-first ``apply`` via transposes; built-ins override with native
        transposed chains."""
        return jnp.swapaxes(self.apply(params, jnp.swapaxes(x, 0, -1)), 0, -1)


def _glorot_uniform(key: jax.Array, shape: Tuple[int, int], dtype) -> jax.Array:
    """Lux's Dense default weight init (glorot uniform) so statistical behavior
    at init matches the reference (Lux.Dense defaults, used at icnf.jl:67-71)."""
    fan_in, fan_out = shape[0], shape[1]
    limit = jnp.sqrt(6.0 / (fan_in + fan_out)).astype(dtype)
    return jax.random.uniform(key, shape, dtype, minval=-limit, maxval=limit)


class MLP(DynamicsNet):
    """Softplus MLP matching the reference default dynamics net.

    ``widths = (n_in, h, h, n_out)`` with softplus on all but the last layer
    (reference icnf.jl:67-71; ``h = 4 * n_in`` by default there — callers pick
    widths via :func:`continuousnormalizingflows_tpu.models.icnf.default_net`).

    Weights are stored transposed relative to Lux (``(in, out)``) so the
    forward pass is ``x @ W + b`` in the row-major batch-first layout.
    """

    def __init__(
        self,
        widths: Sequence[int],
        activation: Callable[[jax.Array], jax.Array] = jax.nn.softplus,
        dtype=jnp.float32,
        precision: str = "highest",
    ) -> None:
        if len(widths) < 2:
            raise ValueError("MLP needs at least an input and an output width")
        self.widths = tuple(int(w) for w in widths)
        self.activation = activation
        self.dtype = dtype
        # "default" lets XLA run float32 matmuls in its fast mode: TF32 on
        # NVIDIA GPUs (about 10 mantissa bits, ~1e-3 relative error), far
        # coarser than the adaptive solver's 1e-4 error control, which it
        # would stall.  "highest" keeps float32-accurate products; "default"
        # suits fixed-step solvers where Monte-Carlo trace noise dominates.
        self.precision = precision
        self.n_in = self.widths[0]
        self.n_out = self.widths[-1]

    def init(self, key: jax.Array) -> Params:
        params = []
        for w_in, w_out in zip(self.widths[:-1], self.widths[1:]):
            key, sub = jax.random.split(key)
            params.append(
                {
                    "w": _glorot_uniform(sub, (w_in, w_out), self.dtype),
                    "b": jnp.zeros((w_out,), self.dtype),
                }
            )
        return params

    def apply(self, params: Params, x: jax.Array) -> jax.Array:
        h = x
        last = len(params) - 1
        for i, layer in enumerate(params):
            h = jnp.matmul(h, layer["w"], precision=self.precision) + layer["b"]
            if i != last:
                h = self.activation(h)
        return h

    def apply_t(self, params: Params, x: jax.Array) -> jax.Array:
        """Feature-first chain ``Wᵀ h + b`` — same params, batch minor-most."""
        h = x
        last = len(params) - 1
        for i, layer in enumerate(params):
            h = jnp.matmul(layer["w"].T, h, precision=self.precision) + layer["b"][:, None]
            if i != last:
                h = self.activation(h)
        return h


class Planar(DynamicsNet):
    """Planar-flow dynamics ``u * act(w . z + b)``.

    Re-design of the reference ``PlanarLayer`` (src/layers/planar_layer.jl:1-97):
    params ``u in R^out``, ``w in R^in``, scalar ``b`` (when ``use_bias``).
    Batched forward: ``act(x @ w + b)[..., None] * u``.
    """

    def __init__(
        self,
        n_in: int,
        n_out: Optional[int] = None,
        activation: Callable[[jax.Array], jax.Array] = jnp.tanh,
        use_bias: bool = True,
        dtype=jnp.float32,
    ) -> None:
        self.n_in = int(n_in)
        self.n_out = int(n_out) if n_out is not None else int(n_in)
        self.activation = activation
        self.use_bias = use_bias
        self.dtype = dtype

    def init(self, key: jax.Array) -> Params:
        ku, kw = jax.random.split(key)
        params = {
            "u": _glorot_uniform(ku, (1, self.n_out), self.dtype)[0],
            "w": _glorot_uniform(kw, (self.n_in, 1), self.dtype)[:, 0],
        }
        if self.use_bias:
            params["b"] = jnp.zeros((), self.dtype)
        return params

    def _pre(self, params: Params, x: jax.Array) -> jax.Array:
        h = jnp.matmul(x, params["w"][:, None], precision="highest")[..., 0]
        if self.use_bias:
            h = h + params["b"]
        return h

    def apply(self, params: Params, x: jax.Array) -> jax.Array:
        return self.activation(self._pre(params, x))[..., None] * params["u"]

    def _pre_t(self, params: Params, x: jax.Array) -> jax.Array:
        h = jnp.matmul(params["w"][None, :], x, precision="highest")[0]
        if self.use_bias:
            h = h + params["b"]
        return h

    def apply_t(self, params: Params, x: jax.Array) -> jax.Array:
        return params["u"][:, None] * self.activation(self._pre_t(params, x))[None, :]


def planar_h(net: Planar, params: Params, x: jax.Array) -> jax.Array:
    """The pre-``u`` scalar activation ``h(z) = act(w . z + b)`` — reference
    ``pl_h`` helper (planar_layer.jl:79-97), exposed for analytic-trace use."""
    return net.activation(net._pre(params, x))


class CondLayer(DynamicsNet):
    """Wrapper appending a constant conditioning array to the net input —
    the reference ``CondLayer`` (src/layers/cond_layer.jl:1-31).

    Inside this framework conditioning is injected automatically by the
    dynamics factory (pass ``ys=`` to inference/loss), so this class exists
    for API parity and for building custom conditioning schemes: the wrapped
    net sees ``concat([x, ys], -1)``; a scalar ``ys`` broadcasts to one
    column (the reference's time-injection case, cond_layer.jl:23-31)."""

    def __init__(self, net: DynamicsNet, ys: jax.Array) -> None:
        ys = jnp.asarray(ys)
        if ys.ndim == 0:
            ys = ys.reshape(1, 1)
        elif ys.ndim == 1:
            ys = ys[None, :]
        self.net = net
        self.ys = ys
        self.n_in = net.n_in - ys.shape[-1]
        self.n_out = net.n_out
        if self.n_in <= 0:
            raise ValueError("conditioning width must be smaller than net input")

    def init(self, key: jax.Array) -> Params:
        return self.net.init(key)

    def apply(self, params: Params, x: jax.Array) -> jax.Array:
        ys = jnp.broadcast_to(self.ys, x.shape[:-1] + (self.ys.shape[-1],)).astype(x.dtype)
        return self.net.apply(params, jnp.concatenate([x, ys], axis=-1))


class _FlaxNet(DynamicsNet):
    def __init__(self, module, n_in: int, n_out: int, dtype=jnp.float32) -> None:
        self.module = module
        self.n_in = int(n_in)
        self.n_out = int(n_out)
        self.dtype = dtype

    def init(self, key: jax.Array) -> Params:
        dummy = jnp.zeros((1, self.n_in), self.dtype)
        return self.module.init(key, dummy)

    def apply(self, params: Params, x: jax.Array) -> jax.Array:
        return self.module.apply(params, x)


def from_flax(module, n_in: int, n_out: int, dtype=jnp.float32) -> DynamicsNet:
    """Wrap a ``flax.linen`` module (``__call__(x: (..., n_in)) -> (..., n_out)``)
    as a dynamics net, so users can supply arbitrary architectures the way the
    reference accepts any Lux layer as ``nn``."""
    return _FlaxNet(module, n_in, n_out, dtype)
