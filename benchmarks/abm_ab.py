"""A/B the adaptive solvers on a *trained* CNF field: dopri5 vs tsit5 vs abm.

The reference's default solver is VCABM — adaptive multistep Adams (reference
src/core/icnf.jl:89) at ~2 new f-evals per step vs 6 per dopri5 trial.  This
measures whether the XLA-native fixed-max-order variable-step ABM
(ops/ode.py:odeint_abm) actually beats the embedded-RK pair on the fields
that matter: a trained (smooth, regularized) CNF, not a toy linear ODE.

Reports, per method, on TRAIN-mode forward loss + TEST-mode inference +
adjoint gradient: NFE, accepted/rejected steps, ms/solve.  Run on a GPU:

    python benchmarks/abm_ab.py [--batch 4096] [--train-iters 300]
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax
import jax.numpy as jnp
import optax

import continuousnormalizingflows_tpu as cnf
from continuousnormalizingflows_tpu.config import Mode, SolverConfig
from continuousnormalizingflows_tpu.utils import datasets

REPS = 10


def _data(key, n, nvariables):
    """2-D ring mixture in the first two dims, correlated noise in the rest
    (keeps higher-d fields nontrivial without a bespoke dataset)."""
    k1, k2 = jax.random.split(key)
    x2 = datasets.gaussian_mixture(k1, n)
    if nvariables == 2:
        return x2
    rest = 0.5 * jax.random.normal(k2, (n, nvariables - 2))
    rest = rest + 0.3 * x2[:, :1]
    return jnp.concatenate([x2, rest], axis=1)


def train_field(nvariables, train_iters, batch):
    """Quick rk4-backprop fit so the measured fields are post-training
    (regularization straightens trajectories -> the solver-efficiency regime
    users actually run in)."""
    icnf = cnf.ICNF.create(
        nvariables=nvariables,
        solver=SolverConfig(method="rk4", gradient="backprop", fixed_steps=32),
    )
    params = icnf.init(jax.random.PRNGKey(0))
    x = _data(jax.random.PRNGKey(1), batch, nvariables)
    opt = optax.adam(1e-3)
    opt_state = opt.init(params)

    @jax.jit
    def run(params, opt_state, key):
        def step(carry, i):
            params, opt_state, key = carry
            key, k = jax.random.split(key)
            l, g = jax.value_and_grad(
                lambda p: cnf.loss(icnf, Mode.TRAIN, x, p, key=k)
            )(params)
            updates, opt_state = opt.update(g, opt_state)
            return (optax.apply_updates(params, updates), opt_state, key), l

        (params, opt_state, _), ls = jax.lax.scan(
            step, (params, opt_state, key), jnp.arange(train_iters)
        )
        return params, ls[-1]

    params, l = run(params, opt_state, jax.random.PRNGKey(7))
    jax.block_until_ready(l)
    print(f"trained field: loss {float(l):.4f} after {train_iters} iters", flush=True)
    return params, x


def timeit(run, *args):
    out = run(*args)
    jax.block_until_ready(jax.tree_util.tree_leaves(out)[0])
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        out = run(*args)
        jax.block_until_ready(jax.tree_util.tree_leaves(out)[0])
        best = min(best, (time.perf_counter() - t0) / REPS)
    return best, out


def bench_method(method, params, x, nvariables):
    solver = SolverConfig(method=method, rtol=1e-4, atol=1e-4, gradient="adjoint")
    icnf = cnf.ICNF.create(nvariables=nvariables, solver=solver)
    key = jax.random.PRNGKey(3)

    @jax.jit
    def fwd_train(params):
        def body(c, i):
            l, stats = cnf.loss_with_stats(
                icnf, Mode.TRAIN, x, params, key=jax.random.fold_in(key, i)
            )
            return c, (l, stats)

        _, (ls, st) = jax.lax.scan(body, 0, jnp.arange(REPS))
        return ls[-1], jax.tree_util.tree_map(lambda a: a[-1], st)

    @jax.jit
    def fwd_test(params):
        def body(c, i):
            lp, _a, stats = cnf.inference(icnf, Mode.TEST, x, params)
            return c, (lp[0], stats)

        _, (lps, st) = jax.lax.scan(body, 0, jnp.arange(REPS))
        return lps[-1], jax.tree_util.tree_map(lambda a: a[-1], st)

    @jax.jit
    def grad_step(params):
        def body(c, i):
            l, g = jax.value_and_grad(
                lambda p: cnf.loss(icnf, Mode.TRAIN, x, p,
                                   key=jax.random.fold_in(key, i))
            )(params)
            return c, l

        _, ls = jax.lax.scan(body, 0, jnp.arange(REPS))
        return ls[-1]

    t_tr, (l_tr, st_tr) = timeit(fwd_train, params)
    t_te, (lp_te, st_te) = timeit(fwd_test, params)
    t_g, l_g = timeit(grad_step, params)

    row = {
        "method": method,
        "train_fwd_ms": t_tr * 1e3,
        "train_nfe": int(st_tr.nfe),
        "train_acc/rej": f"{int(st_tr.naccept)}/{int(st_tr.nreject)}",
        "test_fwd_ms": t_te * 1e3,
        "test_nfe": int(st_te.nfe),
        "grad_ms": t_g * 1e3,
        "loss": float(l_tr),
        "logp0": float(lp_te),
    }
    print(
        f"  {method:>7}: train {row['train_fwd_ms']:8.2f} ms (NFE {row['train_nfe']:4d},"
        f" {row['train_acc/rej']:>7}) | test {row['test_fwd_ms']:8.2f} ms"
        f" (NFE {row['test_nfe']:4d}) | grad {row['grad_ms']:8.2f} ms"
        f" | loss {row['loss']:.4f} logp {row['logp0']:.4f}",
        flush=True,
    )
    return row


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=4096)
    ap.add_argument("--nvariables", type=int, default=2)
    ap.add_argument("--train-iters", type=int, default=300)
    args = ap.parse_args()
    print("device:", jax.devices()[0], flush=True)

    params, x = train_field(args.nvariables, args.train_iters, args.batch)
    rows = [bench_method(m, params, x, args.nvariables)
            for m in ("dopri5", "tsit5", "abm")]

    base = rows[0]
    abm = rows[2]
    print(
        f"\nABM vs dopri5 on the trained field: train NFE "
        f"{abm['train_nfe']}/{base['train_nfe']} "
        f"({base['train_nfe']/max(abm['train_nfe'],1):.2f}x fewer), "
        f"train fwd {base['train_fwd_ms']/abm['train_fwd_ms']:.2f}x, "
        f"grad {base['grad_ms']/abm['grad_ms']:.2f}x",
        flush=True,
    )


if __name__ == "__main__":
    main()
