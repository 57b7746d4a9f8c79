"""Training front-end: the sklearn/MLJ-style estimator facade.

JAX-native re-design of the reference MLJ extension
(``src/exts/mlj_ext/core_icnf.jl`` / ``core_cond_icnf.jl``): ``ICNFModel``
wraps an :class:`~continuousnormalizingflows_tpu.models.icnf.ICNF` with an
optax optimizer and exposes ``fit(X[, Y]) -> FitResult`` and
``transform(X) -> densities``.

Reference-matching defaults: ``batchsize = 1024``, ``epochs = 300``, optimizer
= weight-decay(1e-4) chained into Adam(1e-3, β=(0.9, 0.999), ε=1e-8)
(reference ``core_icnf.jl:9-30``: ``OptimiserChain(WeightDecay, Adam)``),
shuffled minibatches each epoch, loss logging every 64 steps
(``make_opt_callback``, ``mlj_ext/core.jl:96-105``).

XLA-first deviations (documented, deliberate):

* batches are **static-shaped**: each epoch draws a fresh permutation and
  takes ``floor(n / batchsize)`` full batches (remainders rotate in via the
  per-epoch shuffle) instead of a ragged final partial batch, which would
  force an XLA recompile per shape.  ``batchsize = 0`` (or >= n) uses the
  whole dataset as one batch, matching the reference's semantics.
* one fused, jitted, donated train step (loss + grad + optimizer update);
  optional mesh sharding comes from
  :mod:`continuousnormalizingflows_tpu.parallel`.
* ``steps_per_dispatch = k`` scans ``k`` optimizer steps inside ONE jitted
  dispatch (the dataset stays device-resident; each scan step gathers its
  minibatch by permutation indices).  On dispatch-latency-bound hosts this is
  the difference between loop-timed and device-limited throughput.  The per-step
  PRNG stream is *identical* for every ``k`` — a ``k = 8`` run is bit-equal
  to a ``k = 1`` run — so exact resume keeps working.  The reference's whole
  training loop is a single ``solve`` dispatch (mlj_ext/core_icnf.jl:51);
  this is the XLA-first equivalent at controllable granularity.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, List, Optional

import jax
import jax.numpy as jnp
import numpy as np
import optax

from .config import Mode
from .core import inference, loss_with_stats
from .models.icnf import ICNF

__all__ = ["default_optimizer", "FitResult", "ICNFModel", "CondICNFModel"]

Pytree = Any

_UNSET = object()  # sentinel for __setattr__'s first-assignment detection


def default_optimizer(
    learning_rate: float = 1e-3,
    weight_decay: float = 1e-4,
    clip_norm: Optional[float] = None,
) -> optax.GradientTransformation:
    """``OptimiserChain(WeightDecay(1e-4), Adam(1e-3))`` equivalent
    (reference core_icnf.jl:17-24): decoupled weight decay applied to the
    gradient before Adam's moment accumulation.

    ``clip_norm`` prepends global-norm gradient clipping (no reference
    counterpart — the reference's adaptive solver absorbs stiffness by
    shrinking steps, while a fixed-step discretize-then-optimize run can spiral
    on a transiently stiff learned field; clipping is the standard guard)."""
    steps = []
    if clip_norm is not None:
        steps.append(optax.clip_by_global_norm(clip_norm))
    steps += [
        optax.add_decayed_weights(weight_decay),
        optax.adam(learning_rate, b1=0.9, b2=0.999, eps=1e-8),
    ]
    return optax.chain(*steps)


def _table_to_matrix(X) -> np.ndarray:
    """Accept table-style inputs the way the reference MLJ facade does
    (``permutedims(MMI.matrix(X))``, mlj_ext/core_icnf.jl:33): anything with
    ``to_numpy`` (pandas/polars DataFrames) or a dict of columns converts to
    an (n, d) matrix; arrays pass through."""
    if hasattr(X, "to_numpy"):
        return np.asarray(X.to_numpy())
    if isinstance(X, dict):
        return np.stack([np.asarray(col) for col in X.values()], axis=1)
    return X


@dataclasses.dataclass
class FitResult:
    """The reference's ``fitresult = (ps, st)`` + ``report`` (core_icnf.jl:52-57).

    ``opt_state`` is the final optimizer state and ``key`` the advanced PRNG
    key — feed both back to ``fit(params=..., opt_state=..., key=...)`` for an
    *exact* mid-training resume (same probe/shuffle stream the longer run
    would have drawn).

    With ``validation_data`` the validated-fit fields are populated:
    ``val_history`` is ``[(epoch, val_nll), ...]``, ``best_params`` the
    parameters at the best validation NLL (``None`` if every evaluation was
    non-finite — a diverged fit), ``best_val_nll``/``best_epoch`` its value
    and epoch.  ``params`` stays the FINAL parameters (they pair with
    ``opt_state``/``key`` for exact resume); score/serve with
    ``best_params``."""

    params: Pytree
    history: List[float]
    stats: dict
    opt_state: Pytree = None
    key: Optional[jax.Array] = None
    val_history: List[tuple] = dataclasses.field(default_factory=list)
    best_params: Pytree = None
    best_val_nll: Optional[float] = None
    best_epoch: Optional[int] = None


class ICNFModel:
    """Unconditional density estimator (reference ``ICNFModel``)."""

    def __init__(
        self,
        icnf: ICNF,
        optimizer: Optional[optax.GradientTransformation] = None,
        batchsize: int = 1024,
        epochs: int = 300,
        key: Optional[jax.Array] = None,
        log_every: int = 64,
        callback: Optional[Callable[[int, float], None]] = None,
        val_callback: Optional[Callable[[int, float], None]] = None,
        mesh=None,
        steps_per_dispatch: int = 1,
        batch_transform: Optional[Callable[[jax.Array, jax.Array], jax.Array]] = None,
        eval_icnf: Optional[ICNF] = None,
    ) -> None:
        self.icnf = icnf
        self.optimizer = optimizer if optimizer is not None else default_optimizer()
        self.batchsize = int(batchsize)
        self.epochs = int(epochs)
        self.key = key if key is not None else jax.random.PRNGKey(0)
        self.log_every = log_every
        self.callback = callback
        # called as val_callback(epoch, val_nll) after each validation
        # evaluation (the monitoring hook for validated fits — benchmarks
        # print their progress lines here instead of hand-rolling the loop)
        self.val_callback = val_callback
        self.mesh = mesh
        self.steps_per_dispatch = int(steps_per_dispatch)
        # per-step jitted data augmentation: ``xb = batch_transform(key, xb)``
        # on every minibatch with a fresh key (e.g. uniform dequantization
        # noise for quantized images — itself a regularizer; the reference
        # leaves this to user-side preprocessing outside the train loop,
        # mlj_ext/core.jl:24-43, which cannot re-sample noise per step).
        # When None, the PRNG stream is unchanged (exact-resume compatible).
        self.batch_transform = batch_transform
        # TestMode model for score()/validation (e.g. an adaptive-solver twin
        # of a fixed-step training config — the measured-best pairing for the
        # real-data benchmarks); None evaluates with the training icnf.
        # Must share the training net (same params pytree).
        if eval_icnf is not None and (
            eval_icnf.config.nvariables != icnf.config.nvariables
            or eval_icnf.config.nconditions != icnf.config.nconditions
        ):
            raise ValueError(
                "eval_icnf must match the training icnf's nvariables/"
                "nconditions (it evaluates the same params)"
            )
        self.eval_icnf = eval_icnf
        self._conditional = icnf.config.conditioned
        # jitted-step memo: repeated fit() calls (the eval-between-chunks
        # warm-start pattern) must reuse one compiled program, not retrace —
        # jax.jit caches by function identity, and _make_step builds a fresh
        # closure per call.  Mutating any attribute the compiled step closes
        # over clears it (see __setattr__) — retrace, never silent reuse.
        self._step_cache: dict = {}

    # Attributes the compiled train step closes over at trace time.  Mutating
    # one after a fit() would otherwise leave the OLD value silently baked
    # into the cached program (e.g. ``model.optimizer = ...`` between
    # warm-restart chunks) — a silent-wrong-answer path; clearing the memo
    # forces a retrace with the new value (VERDICT round-4 Weak #3).
    _TRACED_ATTRS = ("icnf", "optimizer", "batch_transform", "mesh")

    def __setattr__(self, name: str, value) -> None:
        if (
            name in self._TRACED_ATTRS
            and "_step_cache" in self.__dict__
            # no-op reassignment of the identical object keeps the memo — a
            # spurious clear costs a full recompile
            and value is not getattr(self, name, _UNSET)
        ):
            self._step_cache.clear()
        super().__setattr__(name, value)
        if name == "icnf" and "_step_cache" in self.__dict__:
            super().__setattr__("_conditional", value.config.conditioned)

    # -- internals ---------------------------------------------------------

    def _apply_transform(self, k_step, xb):
        """Split the step key and augment the minibatch when a
        ``batch_transform`` is set; identity (stream-preserving) otherwise."""
        if self.batch_transform is None:
            return k_step, xb
        k_loss, k_aug = jax.random.split(k_step)
        return k_loss, self.batch_transform(k_aug, xb)

    @property
    def _carry_dt(self) -> bool:
        """dt0="carry": warm-start each step's adaptive solve with the
        previous step's accepted dt (SolverStats.dt_final).  Only the
        embedded-RK methods consume the override (ABM keeps its order-ramp
        start, fixed-step solves have no starting-step choice)."""
        s = self.icnf.config.solver
        return s.dt0 == "carry" and s.method in ("dopri5", "tsit5")

    def _make_step(self):
        if "step" in self._step_cache:
            return self._step_cache["step"]
        icnf, optimizer = self.icnf, self.optimizer
        conditional = self._conditional
        carry_dt = self._carry_dt

        def step(params, opt_state, key, xs, ys, dt_prev=None):
            key, xs = self._apply_transform(key, xs)

            def loss_fn(p):
                return loss_with_stats(
                    icnf, Mode.TRAIN, xs, p, key=key,
                    ys=ys if conditional else None,
                    dt0=dt_prev if carry_dt else None,
                )

            (l, stats), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
            updates, opt_state = optimizer.update(grads, opt_state, params)
            params = optax.apply_updates(params, updates)
            return params, opt_state, l, stats

        if self.mesh is not None:
            from .parallel.mesh import shard_train_step

            fn = shard_train_step(step, self.mesh, conditional,
                                  n_extra_repl=1 if carry_dt else 0)
        else:
            fn = jax.jit(step, donate_argnums=(0, 1))
        self._step_cache["step"] = fn
        return fn

    def _make_block_step(self):
        """k-steps-per-dispatch train block (``steps_per_dispatch > 1``).

        ``lax.scan`` over a ``(k, batchsize)`` index block; the dataset rides
        in as a jit argument (device-resident across dispatches, never a baked
        constant).  The per-step ``key, k_step = split(key)`` happens inside
        the scan in the same order as the per-step loop, so the probe/steer
        stream — and therefore the trained parameters — are bit-identical for
        every ``k`` (asserted in tests/test_train.py)."""
        if "block" in self._step_cache:
            return self._step_cache["block"]
        icnf, optimizer = self.icnf, self.optimizer
        conditional = self._conditional
        carry_dt = self._carry_dt

        def block(params, opt_state, key, xs_all, ys_all, idx_block, dt_prev):
            def body(carry, idx):
                params, opt_state, key, dt_c = carry
                key, k_step = jax.random.split(key)
                xb = jnp.take(xs_all, idx, axis=0)
                yb = jnp.take(ys_all, idx, axis=0) if conditional else None
                k_step, xb = self._apply_transform(k_step, xb)

                def loss_fn(p):
                    return loss_with_stats(
                        icnf, Mode.TRAIN, xb, p, key=k_step, ys=yb,
                        dt0=dt_c if carry_dt else None,
                    )

                (l, stats), grads = jax.value_and_grad(loss_fn, has_aux=True)(
                    params
                )
                updates, opt_state = optimizer.update(grads, opt_state, params)
                params = optax.apply_updates(params, updates)
                dt_c = jnp.abs(stats.dt_final) if carry_dt else dt_c
                return (params, opt_state, key, dt_c), (l, stats)

            (params, opt_state, key, dt_prev), (losses, stats) = jax.lax.scan(
                body, (params, opt_state, key, dt_prev), idx_block
            )
            last_stats = jax.tree_util.tree_map(lambda a: a[-1], stats)
            return params, opt_state, key, losses, last_stats, dt_prev

        if self.mesh is not None:
            from .parallel.mesh import data_sharding, replicated

            repl = replicated(self.mesh)
            dsh = data_sharding(self.mesh)
            fn = jax.jit(
                block,
                in_shardings=(repl, repl, repl, dsh,
                              dsh if conditional else None, repl, repl),
                out_shardings=repl,
                donate_argnums=(0, 1),
            )
        else:
            fn = jax.jit(block, donate_argnums=(0, 1))
        self._step_cache["block"] = fn
        return fn

    def _batches(self, key: jax.Array, n: int) -> np.ndarray:
        bs = self.batchsize
        if bs <= 0 or bs >= n:
            return np.arange(n)[None, :]
        perm = np.asarray(jax.random.permutation(key, n))
        nb = n // bs
        return perm[: nb * bs].reshape(nb, bs)

    # -- public API --------------------------------------------------------

    def fit(
        self,
        X,
        Y=None,
        params: Optional[Pytree] = None,
        opt_state: Optional[Pytree] = None,
        key: Optional[jax.Array] = None,
        validation_data=None,
        eval_every: int = 1,
        patience: Optional[int] = None,
    ) -> FitResult:
        """Run the epochs x minibatch MLE loop (reference fit,
        core_icnf.jl:32-58).  ``X``: (n, nvariables); ``Y``: (n, nconditions)
        for conditional models.  Pass ``params`` (and optionally the saved
        ``opt_state`` and the returned ``key``) to warm-start — exact
        mid-training resume pairs with ``utils.checkpoint`` (save/load both);
        without ``key=`` the resume restarts the probe/shuffle stream from the
        constructor key (still valid training, just not bit-identical to the
        uninterrupted run).

        Validation-based training control (beyond the reference's fixed-epochs
        fit, core_icnf.jl:14-30 — for measured cause: at n ~ 10² rows a flow
        memorizes in thousands of full-batch steps, e.g. wine test-NLL 16.4 at
        400 epochs but 827 at 3000, PARITY round 4):

        * ``validation_data`` — held-out ``Xval`` (or ``(Xval, Yval)`` for
          conditional models).  Every ``eval_every`` epochs the validation
          mean NLL is computed with ONE reused compiled TestMode evaluation
          (:meth:`score`, on ``eval_icnf`` if set); the best-NLL parameters
          are tracked in ``FitResult.best_params`` and the curve in
          ``FitResult.val_history``.
        * ``patience`` — stop after this many consecutive evaluations without
          a validation improvement (early stopping).  ``None`` evaluates and
          tracks the best but never stops early.  A non-finite validation NLL
          counts as no improvement (a diverged fit therefore stops after
          ``patience`` evals instead of burning the full budget).

        The PRNG stream is UNCHANGED by validation (evaluation is
        deterministic TestMode) — a validated run's training trajectory is
        bit-identical to an unvalidated one up to the stopping epoch."""
        icnf = self.icnf
        xs_all = jnp.asarray(_table_to_matrix(X), icnf.config.dtype)
        if xs_all.ndim != 2 or xs_all.shape[1] != icnf.config.nvariables:
            raise ValueError(
                f"X must be (n, {icnf.config.nvariables}), got {xs_all.shape}"
            )
        ys_all = None
        if self._conditional:
            if Y is None:
                raise ValueError("conditional model requires Y")
            ys_all = jnp.asarray(Y, icnf.config.dtype)
            if ys_all.shape != (xs_all.shape[0], icnf.config.nconditions):
                raise ValueError(
                    f"Y must be (n, {icnf.config.nconditions}), got {ys_all.shape}"
                )
        n = xs_all.shape[0]

        val_active = validation_data is not None
        xval = yval = None
        if val_active:
            if int(eval_every) < 1:
                raise ValueError(f"eval_every must be >= 1, got {eval_every}")
            if isinstance(validation_data, (tuple, list)):
                xval, yval = validation_data
            else:
                xval = validation_data
            if self._conditional and yval is None:
                raise ValueError(
                    "conditional model requires validation_data=(Xval, Yval)"
                )
        val_history: List[tuple] = []
        best_params: Pytree = None
        best_val = float("inf")
        best_epoch: Optional[int] = None
        stale = 0

        def _epoch_end(epoch_done: int, params) -> bool:
            """Validation hook at an epoch boundary; True = stop early.

            Best-val params are snapshotted by copy: the next jitted step
            DONATES its params input, so holding a bare reference would alias
            a buffer about to be invalidated."""
            nonlocal best_params, best_val, best_epoch, stale
            if not val_active:
                return False
            if epoch_done % eval_every != 0 and epoch_done != self.epochs:
                return False
            vnll = self.score(xval, params, Y=yval)
            val_history.append((epoch_done, vnll))
            if self.val_callback is not None:
                self.val_callback(epoch_done, vnll)
            if vnll < best_val:  # NaN compares False: counts as stale below
                best_val, best_epoch, stale = vnll, epoch_done, 0
                best_params = jax.tree_util.tree_map(
                    lambda a: jnp.array(a, copy=True), params
                )
                return False
            stale += 1
            return patience is not None and stale >= patience

        key = key if key is not None else self.key
        if params is None:
            key, k_init = jax.random.split(key)
            params = icnf.init(k_init)
        else:
            # the jitted step donates its params input (buffer reuse); a
            # warm start must not invalidate the *caller's* arrays
            params = jax.tree_util.tree_map(lambda a: jnp.array(a, copy=True), params)
        if opt_state is None:
            opt_state = self.optimizer.init(params)
        else:
            opt_state = jax.tree_util.tree_map(
                lambda a: jnp.array(a, copy=True) if hasattr(a, "shape") else a,
                opt_state,
            )
        history: List[float] = []
        it = 0
        epochs_run = 0
        t_start = time.perf_counter()
        last_loss = float("nan")
        spd = self.steps_per_dispatch
        # carried starting step (dt0="carry"): 0 makes the FIRST solve take
        # the fixed-fraction ramp (the override's documented fallback); each
        # later solve warm-starts from the previous accepted dt.  Reset per
        # fit() — a warm-started fit pays one ramp solve, nothing else.
        # dtype MUST match stats.dt_final (the solver's time dtype, which
        # follows the state dtype): a float32 init against a float64 model
        # is a scan-carry type error in the block path and a silent
        # signature change (recompile) in the per-step path.
        tdt = (icnf.config.dtype
               if jnp.issubdtype(icnf.config.dtype, jnp.floating)
               else jnp.float32)
        dt_prev = jnp.zeros((), tdt)
        if spd > 1:
            block_fn = self._make_block_step()
            if self.mesh is not None:
                from .parallel.mesh import shard_batch_arrays

                xs_all, ys_all = shard_batch_arrays(self.mesh, xs_all, ys_all)
            ys_arg = ys_all if self._conditional else jnp.zeros(
                (n, 0), xs_all.dtype
            )
            for _epoch in range(self.epochs):
                key, k_perm = jax.random.split(key)
                batches = self._batches(k_perm, n)
                for blk in range(0, batches.shape[0], spd):
                    idx_block = jnp.asarray(batches[blk : blk + spd])
                    params, opt_state, key, losses, sol_stats, dt_prev = block_fn(
                        params, opt_state, key, xs_all, ys_arg, idx_block,
                        dt_prev,
                    )
                    k_done = idx_block.shape[0]
                    logged = [
                        j for j in range(k_done)
                        if (it + j) % self.log_every == 0
                    ]
                    if logged:
                        losses_h = np.asarray(losses)
                        for j in logged:
                            last_loss = float(losses_h[j])
                            history.append(last_loss)
                            if self.callback is not None:
                                self.callback(it + j, last_loss)
                    it += k_done
                epochs_run = _epoch + 1
                if _epoch_end(epochs_run, params):
                    break
            if it:
                last_loss = float(losses[-1])
        else:
            step_fn = self._make_step()
            batch_sharding = None
            if self.mesh is not None:
                from .parallel.mesh import data_sharding

                # batches are gathered on host then placed with the data-axis
                # sharding — indexing a pre-sharded dataset with a permutation
                # would produce gather-dependent shardings that clash with the
                # pjit signature
                batch_sharding = data_sharding(self.mesh)
            for _epoch in range(self.epochs):
                key, k_perm = jax.random.split(key)
                for idx in self._batches(k_perm, n):
                    key, k_step = jax.random.split(key)
                    xb = xs_all[idx]
                    yb = ys_all[idx] if ys_all is not None else None
                    if batch_sharding is not None:
                        xb = jax.device_put(xb, batch_sharding)
                        if yb is not None:
                            yb = jax.device_put(yb, batch_sharding)
                    if self._carry_dt:
                        params, opt_state, l, sol_stats = step_fn(
                            params, opt_state, k_step, xb, yb, dt_prev
                        )
                        dt_prev = jnp.abs(sol_stats.dt_final)
                    else:
                        params, opt_state, l, sol_stats = step_fn(
                            params, opt_state, k_step, xb, yb
                        )
                    if it % self.log_every == 0:
                        last_loss = float(l)
                        history.append(last_loss)
                        if self.callback is not None:
                            self.callback(it, last_loss)
                    it += 1
                epochs_run = _epoch + 1
                if _epoch_end(epochs_run, params):
                    break
            if it:
                last_loss = float(l)
        stats = {
            "iterations": it,
            "epochs": self.epochs,
            "epochs_run": epochs_run,
            "wall_time_s": time.perf_counter() - t_start,
            "final_loss": last_loss,
        }
        if val_active:
            stats.update(
                best_val_nll=best_val if best_epoch is not None else float("nan"),
                best_epoch=best_epoch,
                stopped_early=epochs_run < self.epochs,
                val_evals=len(val_history),
            )
        if it:
            # per-solve diagnostics of the last train step (reference solver
            # verbosity analogue, icnf.jl:100-101): NFE, accepted/rejected
            # adaptive steps, controller step size at exit
            stats.update(
                nfe=int(sol_stats.nfe),
                naccept=int(sol_stats.naccept),
                nreject=int(sol_stats.nreject),
                dt_final=float(sol_stats.dt_final),
            )
        return FitResult(
            params=params, history=history, stats=stats, opt_state=opt_state,
            key=key, val_history=val_history, best_params=best_params,
            best_val_nll=(best_val if best_epoch is not None else None),
            best_epoch=best_epoch,
        )

    def transform(self, X, params: Pytree, Y=None) -> jax.Array:
        """TestMode densities ``exp(logp̂x)`` (reference transform,
        core_icnf.jl:60-68).  Accepts a table (like fit), an ``(n, d)``
        matrix, a single ``(d,)`` sample (the reference's VectorMode scoring
        is a batch of 1 here), or a features-first ``(d, n)`` matrix — the
        latter is transposed with a one-shot warning, the analogue of the
        reference's per-column ``get_logp̂x`` fallback (``@warn maxlog=1``,
        mlj_ext/core.jl:45-94)."""
        from .dist import _shim_layout

        ys = Y if self._conditional else None
        xs = jnp.asarray(_table_to_matrix(X), self.icnf.config.dtype)
        if xs.ndim == 2:
            xs = _shim_layout(xs, self.icnf.config.nvariables)
        logpx, _augs, _nfe = inference(self.icnf, Mode.TEST, xs, params, ys=ys)
        return jnp.exp(logpx)

    def score(self, X, params: Pytree, Y=None) -> float:
        """Mean negative log-likelihood (nats, lower is better) under the
        deterministic TestMode exact trace — the quantity every
        density-estimation benchmark reports, as a one-call helper (the
        reference exposes only per-sample densities via transform,
        core_icnf.jl:60-68).  Evaluates with ``eval_icnf`` when set (e.g. an
        adaptive reference-tolerance solver for a fixed-step-trained model —
        the pairing the real-data benchmarks measured as correct); one
        compiled program is reused across calls with the same data shape."""
        icnf_eval = self.eval_icnf if self.eval_icnf is not None else self.icnf
        if self._conditional and Y is None:
            raise ValueError("conditional model requires Y to score")
        ys = Y if self._conditional else None
        xs = jnp.asarray(_table_to_matrix(X), icnf_eval.config.dtype)
        logpx, _augs, _stats = inference(icnf_eval, Mode.TEST, xs, params, ys=ys)
        return -float(jnp.mean(logpx))

    # -- persistence (reference MLJBase.save / machine(file),
    #    examples/usage.jl:79-103) ---------------------------------------

    def save(self, path: str, result: FitResult) -> None:
        from .utils.checkpoint import save_checkpoint

        save_checkpoint(path, result.params, step=result.stats.get("iterations", 0))

    def load(self, path: str) -> Pytree:
        from .utils.checkpoint import load_checkpoint

        params, _opt, _step = load_checkpoint(path)
        return params


class CondICNFModel(ICNFModel):
    """Conditional variant (reference ``CondICNFModel``,
    core_cond_icnf.jl:1-100): identical loop, ``(X, Y)`` data."""

    def __init__(self, icnf: ICNF, **kwargs) -> None:
        if not icnf.config.conditioned:
            raise ValueError("CondICNFModel requires nconditions > 0")
        super().__init__(icnf, **kwargs)
