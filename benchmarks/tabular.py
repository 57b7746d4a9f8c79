"""Tabular MLE with sharded large-batch Hutchinson probes — BASELINE config 4.

POWER-scale (6-d) or MINIBOONE-scale (43-d) synthetic tabular density
estimation with FFJORD/RNODE: large batch + ``nprobes`` Hutchinson probes per
sample, all sharded over the ``data`` mesh axis (probes are sampled inside
the jitted step, so they inherit the batch sharding — no explicit key
folding needed).

Run: JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
       python benchmarks/tabular.py --dims 6 --steps 5 --batch 1024
     python benchmarks/tabular.py --dims 43 --batch 8192          (GPU)
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
from continuousnormalizingflows_tpu.parallel import data_sharding, make_mesh, shard_train_step


def synthetic_tabular(key, n, d):
    """Correlated non-Gaussian tabular data: random linear mix of squared /
    tanh'd latents (heavier tails + curvature than a Gaussian)."""
    k1, k2 = jax.random.split(key)
    z = jax.random.normal(k1, (n, d))
    mix = jax.random.orthogonal(k2, d)
    feats = jnp.concatenate(
        [z[:, : d // 2], jnp.tanh(z[:, d // 2 :]) + 0.1 * z[:, d // 2 :] ** 2], axis=1
    )
    return feats @ mix


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--dims", type=int, default=6)
    ap.add_argument("--batch", type=int, default=4096)
    ap.add_argument("--nprobes", type=int, default=4)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--fixed-steps", type=int, default=32)
    ap.add_argument("--precision", type=str, default="default")
    args = ap.parse_args()

    d = args.dims
    icnf = cnf.ICNF.create(
        nvariables=d,
        naugments=0,
        lambda_3=0.0,
        nprobes=args.nprobes,
        solver=SolverConfig(method="rk4", gradient="backprop",
                            fixed_steps=args.fixed_steps),
        precision=args.precision,
    )
    mesh = make_mesh()
    n_dev = mesh.devices.size
    x_all = synthetic_tabular(jax.random.PRNGKey(0), args.batch * 4, d)
    params = icnf.init(jax.random.PRNGKey(1))
    opt = cnf.default_optimizer(clip_norm=1.0)
    opt_state = opt.init(params)

    def step(params, opt_state, key, xs, ys):
        l, grads = jax.value_and_grad(
            lambda p: cnf.loss(icnf, Mode.TRAIN, xs, p, key=key)
        )(params)
        updates, opt_state = opt.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, l

    fn = shard_train_step(step, mesh, conditional=False)
    sh = data_sharding(mesh)
    key = jax.random.PRNGKey(2)
    n = x_all.shape[0]
    for i in range(args.steps):
        key, kb, ks = jax.random.split(key, 3)
        idx = jax.random.randint(kb, (args.batch,), 0, n)
        xb = jax.device_put(x_all[idx], sh)
        params, opt_state, l = fn(params, opt_state, ks, xb, None)
        if i == 0:
            jax.block_until_ready(l)
            t0 = time.perf_counter()
    jax.block_until_ready(l)
    dt = (time.perf_counter() - t0) / max(args.steps - 1, 1)
    print(
        f"d={d} nprobes={args.nprobes} mesh={n_dev}: loss={float(l):.3f}  "
        f"{dt*1e3:.1f} ms/step  {args.batch/dt:.0f} samples/s "
        f"({args.batch*args.nprobes/dt:.0f} probe-evals/s)"
    )


if __name__ == "__main__":
    main()
