"""Augmented ODE dynamics — the computational heart of the framework.

The reference implements this as 16 ``augmented_f`` methods spanning
{exact, Hutchinson} x {vector, matrix} x {in/out-of-place} x {VJP, JVP} x
{DI, Lux} (reference ``src/core/icnf.jl:253-603``).  In JAX the whole matrix
collapses to one function factory: ``vmap`` subsumes vector-vs-matrix,
out-of-place is the only style, and ``jax.vjp`` / ``jax.linearize`` are the one
AD system.  What survives as a static switch is the *estimator*
(exact | vjp-probe | jvp-probe) — see
:class:`continuousnormalizingflows_tpu.config.TraceEstimator`.

State layout (batch-first, row-major; the reference uses column-major d x n): ``u[:, :nz]`` is the flow state ``z`` (data +
augmented dims), followed by 3 scalar accumulators per sample:
``u[:, nz]`` = Δlogp, ``u[:, nz + 1]`` = kinetic energy ∫‖ż‖ dt,
``u[:, nz + 2]`` = ∫‖εᵀJ‖ dt.  The two regularization accumulators are always
carried, zero when unused (reference ``n_augments == 2``, icnf.jl:143-145).

Derivative written per sample (reference icnf.jl:517-559 for the default
Lux VecJac matrix mode):

    du = [ż, −tr(J)-estimate, ‖ż‖, ‖εᵀJ‖]
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import jax
import jax.numpy as jnp

from ..config import ICNFConfig, Mode, TraceEstimator
from ..models.nets import MLP as _MLP
from ..models.nets import DynamicsNet
from ..models.nets import Planar as _Planar

__all__ = ["make_augmented_dynamics", "make_field"]

Pytree = Any


def _act_and_deriv(act, z):
    """Elementwise activation value and derivative in one pass (exact for any
    elementwise activation via jvp with a ones tangent)."""
    if act is jax.nn.softplus:
        return jax.nn.softplus(z), jax.nn.sigmoid(z)  # d softplus = sigmoid
    h, dh = jax.jvp(act, (z,), (jnp.ones_like(z),))
    return h, dh


def _mlp_exact_trace(net: _MLP, params, x_full: jax.Array, nz: int,
                     feature_first: bool = False):
    """Analytic ``(dz, tr(J_z))`` for 1- and 2-hidden-layer MLP dynamics.

    The reference computes the exact TestMode trace with O(d) AD sweeps per
    step (per-sample Jacobian stacks, reference ``src/core/utils.jl:12-88``) —
    the dominant inference cost at tabular/image dimension (SURVEY.md §7
    "hard parts").  For an MLP ``y = W3 act(W2 act(W1 x))`` the z-block
    Jacobian is ``J = W1ᵀ[:nz] D1 W2 D2 W3[:, :nz]`` with diagonal
    ``D_i = diag(act'(z_i))``, so

        tr(J) = Σ_{k,l} s1[k] G[k,l] s2[l],   G = W2 ∘ (W1[:nz,:]ᵀ W3[:,:nz]ᵀ)

    i.e. one batch-independent Hadamard-masked matmul (``G``) plus ONE extra
    ``(B, h1) x (h1, h2)`` matmul per dynamics eval — O(1) in ``nz`` instead
    of O(nz) sweeps.  Exact (not an estimate): matches ``jacfwd`` to float
    precision.  Single-hidden-layer nets use the degenerate form
    ``tr(J) = s1 . g`` with ``g[k] = Σ_i W1[i,k] W2[k,i]``.
    """
    prec = getattr(net, "precision", "highest")
    if feature_first:
        # x_full: (n_in, batch); same math with transposed chains
        if len(params) == 2:
            (l1, l2) = params
            z1 = jnp.matmul(l1["w"].T, x_full, precision=prec) + l1["b"][:, None]
            h1, s1 = _act_and_deriv(net.activation, z1)
            dz = jnp.matmul(l2["w"].T, h1, precision=prec) + l2["b"][:, None]
            g = jnp.sum(l1["w"][:nz, :] * l2["w"][:, :nz].T, axis=0)  # (h,)
            div = jnp.einsum("k,kb->b", g, s1, precision=prec)
            return dz, div
        (l1, l2, l3) = params
        z1 = jnp.matmul(l1["w"].T, x_full, precision=prec) + l1["b"][:, None]
        h1, s1 = _act_and_deriv(net.activation, z1)
        z2 = jnp.matmul(l2["w"].T, h1, precision=prec) + l2["b"][:, None]
        h2, s2 = _act_and_deriv(net.activation, z2)
        dz = jnp.matmul(l3["w"].T, h2, precision=prec) + l3["b"][:, None]
        m = jnp.matmul(l1["w"][:nz, :].T, l3["w"][:, :nz].T, precision=prec)
        g_mat = l2["w"] * m  # (h1, h2)
        div = jnp.sum(jnp.matmul(g_mat.T, s1, precision=prec) * s2, axis=0)
        return dz, div
    if len(params) == 2:
        (l1, l2) = params
        z1 = jnp.matmul(x_full, l1["w"], precision=prec) + l1["b"]
        h1, s1 = _act_and_deriv(net.activation, z1)
        dz = jnp.matmul(h1, l2["w"], precision=prec) + l2["b"]
        g = jnp.sum(l1["w"][:nz, :] * l2["w"][:, :nz].T, axis=0)  # (h,)
        div = jnp.einsum("bk,k->b", s1, g, precision=prec)
        return dz, div
    (l1, l2, l3) = params
    z1 = jnp.matmul(x_full, l1["w"], precision=prec) + l1["b"]
    h1, s1 = _act_and_deriv(net.activation, z1)
    z2 = jnp.matmul(h1, l2["w"], precision=prec) + l2["b"]
    h2, s2 = _act_and_deriv(net.activation, z2)
    dz = jnp.matmul(h2, l3["w"], precision=prec) + l3["b"]
    m = jnp.matmul(l1["w"][:nz, :].T, l3["w"][:, :nz].T, precision=prec)  # (h1, h2)
    g_mat = l2["w"] * m
    div = jnp.sum(jnp.matmul(s1, g_mat, precision=prec) * s2, axis=-1)
    return dz, div


def _mlp_exact_applicable(net) -> bool:
    return isinstance(net, _MLP) and len(net.widths) in (3, 4)


def make_field(
    cfg: ICNFConfig, net: DynamicsNet
) -> Callable[[jax.Array, jax.Array, Pytree, Optional[jax.Array]], jax.Array]:
    """The raw vector field ``f(t, z, params, ys) -> dz`` of shape
    ``(batch, nz) -> (batch, nz)``.

    Condition / time injection is a plain concatenation onto the net input —
    the functional equivalent of the reference's ``CondLayer`` wrapping
    (``add_conditions_nn`` base_icnf.jl:49-60, ``add_time_nn`` icnf.jl:147-161,
    ``cond_layer.jl:7-31``).
    """

    def field(t: jax.Array, z: jax.Array, params: Pytree, ys: Optional[jax.Array]) -> jax.Array:
        cols = [z]
        if not cfg.autonomous:
            tcol = jnp.broadcast_to(
                jnp.asarray(t, z.dtype).reshape((1,) * z.ndim), z.shape[:-1] + (1,)
            )
            cols.append(tcol)
        if cfg.conditioned:
            if ys is None:
                raise ValueError("conditioned ICNF requires ys")
            cols.append(jnp.broadcast_to(ys, z.shape[:-1] + (ys.shape[-1],)).astype(z.dtype))
        return net.apply(params, jnp.concatenate(cols, axis=-1))

    return field


def _row_norm(x: jax.Array) -> jax.Array:
    """Per-sample Euclidean norm over the last axis (LinearAlgebra.norm of
    eachcol in the reference, e.g. icnf.jl:163-251).

    The 1e-20 floor keeps the gradient finite at x == 0 (d‖x‖/dx = x/‖x‖ is
    NaN exactly at zero, which would poison the whole backward pass through
    the regularization accumulators)."""
    return jnp.sqrt(jnp.sum(jnp.square(x), axis=-1) + 1e-20)


def make_field_t(
    cfg: ICNFConfig, net: DynamicsNet
) -> Callable[[jax.Array, jax.Array, Pytree, Optional[jax.Array]], jax.Array]:
    """Feature-first variant of :func:`make_field`: ``z`` is ``(nz, batch)``,
    conditions ``(nconditions, batch)``; concatenation on axis 0."""

    def field(t: jax.Array, z: jax.Array, params: Pytree, ys: Optional[jax.Array]) -> jax.Array:
        rows = [z]
        if not cfg.autonomous:
            rows.append(jnp.full((1, z.shape[1]), t, z.dtype))
        if cfg.conditioned:
            if ys is None:
                raise ValueError("conditioned ICNF requires ys")
            rows.append(jnp.broadcast_to(ys, (ys.shape[0], z.shape[1])).astype(z.dtype))
        return net.apply_t(params, jnp.concatenate(rows, axis=0))

    return field


def _make_augmented_dynamics_t(
    cfg: ICNFConfig, net: DynamicsNet, mode: Mode
) -> Callable[[jax.Array, jax.Array, Pytree], jax.Array]:
    """Feature-first twin of the factory below: state ``u`` is
    ``(state_dim, batch)``, probes ``(P, nz, batch)``, conditions
    ``(nconditions, batch)`` — batch is the minor-most dimension (see
    ``ICNFConfig.layout``).  Same math, reductions over axis 0."""
    nz = cfg.nz
    estimator = cfg.trace_for(mode)
    compute_reg_z = mode.regularized and cfg.norm_z
    compute_reg_j = mode.regularized and cfg.norm_j
    field = make_field_t(cfg, net)

    def col_norm(x: jax.Array, axis: int = 0) -> jax.Array:
        return jnp.sqrt(jnp.sum(jnp.square(x), axis=axis) + 1e-20)

    def f_aug_t(t: jax.Array, u: jax.Array, args: Pytree) -> jax.Array:
        params = args["params"]
        eps = args.get("eps")
        ys = args.get("ys")
        z = u[:nz]
        batch = z.shape[1]

        g = lambda zz: field(t, zz, params, ys)

        if estimator is TraceEstimator.EXACT and isinstance(net, _Planar):
            rows = [z]
            if not cfg.autonomous:
                rows.append(jnp.full((1, batch), t, z.dtype))
            if cfg.conditioned:
                rows.append(jnp.broadcast_to(ys, (ys.shape[0], batch)).astype(z.dtype))
            x_full = jnp.concatenate(rows, axis=0)
            pre = net._pre_t(params, x_full)  # (batch,)
            act_grad = jax.vmap(jax.grad(lambda s: net.activation(s)))(pre)
            dz = params["u"][:, None] * net.activation(pre)[None, :]
            uw = jnp.sum(params["u"][:nz] * params["w"][:nz])
            div = uw * act_grad
            if compute_reg_j:
                reg_j = (
                    jnp.abs(act_grad)
                    * jnp.linalg.norm(params["u"][:nz])
                    * jnp.linalg.norm(params["w"][:nz])
                )
            else:
                reg_j = jnp.zeros((batch,), u.dtype)
        elif (
            estimator is TraceEstimator.EXACT
            and _mlp_exact_applicable(net)
            and not compute_reg_j
        ):
            rows = [z]
            if not cfg.autonomous:
                rows.append(jnp.full((1, batch), t, z.dtype))
            if cfg.conditioned:
                rows.append(jnp.broadcast_to(ys, (ys.shape[0], batch)).astype(z.dtype))
            x_full = jnp.concatenate(rows, axis=0)
            dz, div = _mlp_exact_trace(net, params, x_full, nz, feature_first=True)
            reg_j = jnp.zeros((batch,), u.dtype)
        elif estimator is TraceEstimator.EXACT:
            dz, lin = jax.linearize(g, z)
            basis = jnp.eye(nz, dtype=z.dtype)
            jcols = jax.vmap(lambda e: lin(jnp.broadcast_to(e[:, None], z.shape)))(basis)
            # jcols[i, j, b] = ∂g_j/∂z_i ; divergence = Σ_i J[i, i, b]
            div = jnp.einsum("iib->b", jcols)
            if compute_reg_j:
                reg_j = jnp.sqrt(jnp.sum(jnp.square(jcols), axis=(0, 1)))
            else:
                reg_j = jnp.zeros((batch,), u.dtype)
        elif estimator is TraceEstimator.HUTCH_VJP:
            dz, vjp_fn = jax.vjp(g, z)
            eps_j = jax.vmap(lambda e: vjp_fn(e)[0])(eps)  # (P, nz, batch)
            div = jnp.mean(jnp.sum(eps_j * eps, axis=1), axis=0)
            reg_j = (
                jnp.mean(col_norm(eps_j, axis=1), axis=0)
                if compute_reg_j
                else jnp.zeros((batch,), u.dtype)
            )
        elif estimator is TraceEstimator.HUTCH_JVP:
            dz, lin = jax.linearize(g, z)
            j_eps = jax.vmap(lin)(eps)  # (P, nz, batch)
            div = jnp.mean(jnp.sum(eps * j_eps, axis=1), axis=0)
            reg_j = (
                jnp.mean(col_norm(j_eps, axis=1), axis=0)
                if compute_reg_j
                else jnp.zeros((batch,), u.dtype)
            )
        else:  # pragma: no cover
            raise ValueError(f"unknown estimator {estimator}")

        reg_z = col_norm(dz) if compute_reg_z else jnp.zeros((batch,), u.dtype)

        return jnp.concatenate(
            [dz, -div[None, :], reg_z[None, :], reg_j[None, :]], axis=0
        )

    return f_aug_t


def make_augmented_dynamics(
    cfg: ICNFConfig, net: DynamicsNet, mode: Mode
) -> Callable[[jax.Array, jax.Array, Pytree], jax.Array]:
    """Build ``f_aug(t, u, args) -> du`` for :func:`ops.ode.odeint`.

    ``args`` is the pytree ``{"params": ..., "eps": (P, batch, nz) | None,
    "ys": (batch, nconditions) | None}`` — keeping the probe and conditions in
    ``args`` (rather than closed over) lets the continuous adjoint compute
    cotangents for all of them in one VJP sweep.

    With ``cfg.layout == "feature_first"`` the returned function instead takes
    ``u`` as ``(state_dim, batch)`` with probes ``(P, nz, batch)`` and
    conditions ``(nconditions, batch)`` (see :func:`_make_augmented_dynamics_t`);
    the transposition happens once per solve in ``core._solve``.
    """
    if cfg.layout == "feature_first":
        return _make_augmented_dynamics_t(cfg, net, mode)
    nz = cfg.nz
    estimator = cfg.trace_for(mode)
    compute_reg_z = mode.regularized and cfg.norm_z
    compute_reg_j = mode.regularized and cfg.norm_j
    field = make_field(cfg, net)
    prec = getattr(net, "precision", "highest")

    def f_aug(t: jax.Array, u: jax.Array, args: Pytree) -> jax.Array:
        params = args["params"]
        eps = args.get("eps")
        ys = args.get("ys")
        z = u[..., :nz]
        batch = z.shape[0]

        g = lambda zz: field(t, zz, params, ys)

        if estimator is TraceEstimator.EXACT and isinstance(net, _Planar):
            # Analytic planar trace: for f(z) = u * act(w . x_full + b),
            # div_z f = (u[:nz] . w[:nz]) * act'(pre) — exact in O(1) instead
            # of nz linearization sweeps.  (The reference ships the ``pl_h``
            # helper for this trick, planar_layer.jl:79-97, but never wires
            # it; here it is the EXACT-mode fast path for planar dynamics.)
            params_p = params
            cols = [z]
            if not cfg.autonomous:
                cols.append(
                    jnp.broadcast_to(
                        jnp.asarray(t, z.dtype).reshape((1,) * z.ndim),
                        z.shape[:-1] + (1,),
                    )
                )
            if cfg.conditioned:
                cols.append(
                    jnp.broadcast_to(ys, z.shape[:-1] + (ys.shape[-1],)).astype(z.dtype)
                )
            x_full = jnp.concatenate(cols, axis=-1)
            pre = net._pre(params_p, x_full)  # (batch,)
            act_grad = jax.vmap(jax.grad(lambda s: net.activation(s)))(pre)
            dz = net.activation(pre)[..., None] * params_p["u"]
            uw = jnp.sum(params_p["u"][:nz] * params_p["w"][:nz])
            div = uw * act_grad
            if compute_reg_j:
                # exact Frobenius norm of the rank-1 z-block Jacobian:
                # J_z = act' * u[:nz] w[:nz]^T  =>  ||J_z||_F = |act'| ||u|| ||w||
                reg_j = (
                    jnp.abs(act_grad)
                    * jnp.linalg.norm(params_p["u"][:nz])
                    * jnp.linalg.norm(params_p["w"][:nz])
                )
            else:
                reg_j = jnp.zeros((batch,), u.dtype)
        elif (
            estimator is TraceEstimator.EXACT
            and _mlp_exact_applicable(net)
            and not compute_reg_j
        ):
            # Analytic exact trace for shallow-MLP dynamics (the reference
            # default architecture, icnf.jl:67-71): one extra matmul instead
            # of nz linearize sweeps — see _mlp_exact_trace.  (The Frobenius
            # regularizer has no O(1) closed form, so reg_j configs fall
            # through to the sweep below.)
            cols = [z]
            if not cfg.autonomous:
                cols.append(
                    jnp.broadcast_to(
                        jnp.asarray(t, z.dtype).reshape((1,) * z.ndim),
                        z.shape[:-1] + (1,),
                    )
                )
            if cfg.conditioned:
                cols.append(
                    jnp.broadcast_to(ys, z.shape[:-1] + (ys.shape[-1],)).astype(z.dtype)
                )
            x_full = jnp.concatenate(cols, axis=-1)
            dz, div = _mlp_exact_trace(net, params, x_full, nz)
            reg_j = jnp.zeros((batch,), u.dtype)
        elif estimator is TraceEstimator.EXACT:
            # Exact trace via nz forward sweeps of the batched linearization —
            # each sweep is one full-batch matmul chain (vs the reference's
            # per-sample Jacobian stacks, utils.jl:12-88).
            dz, lin = jax.linearize(g, z)
            if cfg.exact_chunk == 0 and cfg.sweep_axis is None:
                basis = jnp.eye(nz, dtype=z.dtype)
                jcols = jax.vmap(lambda e: lin(jnp.broadcast_to(e, z.shape)))(basis)
                # jcols[i, b, j] = ∂g_j/∂z_i ; divergence = Σ_i J[b, i, i]
                div = jnp.einsum("ibi->b", jcols)
                if compute_reg_j:
                    # exact Frobenius norm — available for free in exact mode
                    reg_j = jnp.sqrt(jnp.sum(jnp.square(jcols), axis=(0, 2)))
                else:
                    reg_j = jnp.zeros((batch,), u.dtype)
            else:
                # Chunked/sharded sweep for nets without an analytic trace at
                # scale: accumulate the diagonal (and Frobenius sum) block by
                # block so peak memory is (chunk, batch, nz), not
                # (nz, batch, nz) — at d = 784 the full stack is the
                # difference between 51 MB and 10 GB per dynamics eval.  With
                # ``cfg.sweep_axis`` the basis block is sharded over the named
                # mesh axis (the EXACT analogue of ``probe_axis``): each rank
                # runs its share of the sweeps, GSPMD inserts the psum.
                chunk = cfg.exact_chunk if cfg.exact_chunk > 0 else nz
                chunk = min(chunk, nz)
                nblocks = -(-nz // chunk)
                iota = jnp.arange(nz)

                def sweep_block(carry, o):
                    div_acc, fro_acc = carry
                    idx = o + jnp.arange(chunk)
                    valid = (idx < nz).astype(z.dtype)
                    idx_c = jnp.minimum(idx, nz - 1)
                    basis = (idx_c[:, None] == iota[None, :]).astype(z.dtype)
                    basis = basis * valid[:, None]  # overrun rows contribute 0
                    if cfg.sweep_axis is not None:
                        basis = jax.lax.with_sharding_constraint(
                            basis, jax.sharding.PartitionSpec(cfg.sweep_axis)
                        )
                    jrows = jax.vmap(
                        lambda e: lin(jnp.broadcast_to(e, z.shape))
                    )(basis)  # (chunk, batch, nz): row c = J^T e_{idx_c}
                    # diagonal entries via the same one-hot rows (fuses into
                    # the producing matmul; no dynamic gather)
                    div_acc = div_acc + jnp.einsum(
                        "cbj,cj->b", jrows, basis, precision=prec
                    )
                    if compute_reg_j:
                        fro_acc = fro_acc + jnp.sum(
                            jnp.square(jrows), axis=(0, 2)
                        )
                    return (div_acc, fro_acc), None

                zero = jnp.zeros((batch,), u.dtype)
                (div, fro), _ = jax.lax.scan(
                    sweep_block, (zero, zero),
                    jnp.arange(nblocks, dtype=jnp.int32) * chunk,
                )
                reg_j = jnp.sqrt(fro) if compute_reg_j else zero
        elif estimator is TraceEstimator.HUTCH_VJP:
            # Hutchinson with reverse-mode probe: ε^T J via one shared forward
            # + one VJP per probe (reference default LuxVecJacMatrixMode,
            # utils.jl:150-159).
            dz, vjp_fn = jax.vjp(g, z)
            eps_j = jax.vmap(lambda e: vjp_fn(e)[0])(eps)  # (P, batch, nz)
            div = jnp.mean(jnp.sum(eps_j * eps, axis=-1), axis=0)
            reg_j = (
                jnp.mean(_row_norm(eps_j), axis=0)
                if compute_reg_j
                else jnp.zeros((batch,), u.dtype)
            )
        elif estimator is TraceEstimator.HUTCH_JVP:
            # forward-mode probe: J ε (reference LuxJacVecMatrixMode,
            # utils.jl:160-170).
            dz, lin = jax.linearize(g, z)
            j_eps = jax.vmap(lin)(eps)  # (P, batch, nz)
            div = jnp.mean(jnp.sum(eps * j_eps, axis=-1), axis=0)
            reg_j = (
                jnp.mean(_row_norm(j_eps), axis=0)
                if compute_reg_j
                else jnp.zeros((batch,), u.dtype)
            )
        else:  # pragma: no cover
            raise ValueError(f"unknown estimator {estimator}")

        reg_z = _row_norm(dz) if compute_reg_z else jnp.zeros((batch,), u.dtype)

        return jnp.concatenate(
            [dz, -div[..., None], reg_z[..., None], reg_j[..., None]], axis=-1
        )

    return f_aug
