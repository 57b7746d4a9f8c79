"""Image-scale FFJORD across hosts — BASELINE.md config 5.

784-dim FFJORD (MNIST scale) trained data-parallel over every available
device/host: batch + Hutchinson probes sharded over the ``data`` mesh axis,
gradient all-reduce via the pjit-inserted psum, collective-consistent
fixed-step integration.

Multi-host: launch one process per host with the standard JAX distributed
env (or pass --coordinator); `initialize_distributed()` wires the runtime.
Data is synthetic by default (this environment has no egress); pass
``--mnist path/to/mnist.npz`` to use real MNIST images (shape (n, 784),
dequantized + logit-transformed as in the FFJORD paper).

Single-process examples:
  JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
      python benchmarks/mnist_multihost.py --steps 5 --batch 256
  python benchmarks/mnist_multihost.py --steps 50            # GPU
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax
import jax.numpy as jnp
import numpy as np
import optax

import continuousnormalizingflows_tpu as cnf
from continuousnormalizingflows_tpu.config import Mode, SolverConfig
from continuousnormalizingflows_tpu.parallel import (
    data_sharding,
    initialize_distributed,
    make_mesh,
    shard_train_step,
)

D = 784


def load_data(args, key):
    if args.mnist:
        with np.load(args.mnist) as z:
            imgs = z[z.files[0]].reshape(-1, D).astype(np.float32) / 256.0
        # dequantize + logit (FFJORD image preprocessing)
        rng = np.random.default_rng(0)
        x = imgs + rng.uniform(0, 1 / 256.0, imgs.shape).astype(np.float32)
        x = np.clip(x, 1e-5, 1 - 1e-5)
        return jnp.asarray(np.log(x) - np.log1p(-x))
    # synthetic: mixture of two anisotropic Gaussians in 784-d
    k1, k2 = jax.random.split(key)
    n = args.batch * 8
    comp = jax.random.bernoulli(k1, 0.5, (n, 1)).astype(jnp.float32)
    return jax.random.normal(k2, (n, D)) * 0.5 + comp * 1.5


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=512)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--hidden", type=int, default=1024)
    ap.add_argument("--fixed-steps", type=int, default=16)
    ap.add_argument("--nprobes", type=int, default=1)
    ap.add_argument("--mnist", type=str, default=None)
    ap.add_argument("--coordinator", type=str, default=None)
    args = ap.parse_args()

    if args.coordinator:
        initialize_distributed(coordinator_address=args.coordinator)

    # FFJORD: no augmentation, no regularization; Hutchinson-VJP trace
    net = cnf.MLP((D + 1, args.hidden, args.hidden, D))
    icnf = cnf.ICNF(
        config=cnf.ICNFConfig(
            nvariables=D,
            naugments=0,
            lambda_1=0.0,
            lambda_2=0.0,
            lambda_3=0.0,
            steer_rate=0.0,
            nprobes=args.nprobes,
            solver=SolverConfig(
                method="rk4", gradient="backprop", fixed_steps=args.fixed_steps
            ),
        ),
        net=net,
    )

    mesh = make_mesh()
    n_dev = mesh.devices.size
    print(f"process {jax.process_index()}/{jax.process_count()}, mesh: {n_dev} devices")

    x_all = load_data(args, jax.random.PRNGKey(0))
    params = icnf.init(jax.random.PRNGKey(1))
    opt = optax.adamw(1e-3, weight_decay=1e-4)
    opt_state = opt.init(params)

    def step(params, opt_state, key, xs, ys):
        l, grads = jax.value_and_grad(
            lambda p: cnf.loss(icnf, Mode.TRAIN, xs, p, key=key)
        )(params)
        updates, opt_state = opt.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, l

    sharded = shard_train_step(step, mesh, conditional=False)
    sh = data_sharding(mesh)

    key = jax.random.PRNGKey(jax.process_index())
    n = x_all.shape[0]
    t_first = t0 = None
    for i in range(args.steps):
        key, k_batch, k_step = jax.random.split(key, 3)
        idx = jax.random.randint(k_batch, (args.batch,), 0, n)
        xb = jax.device_put(x_all[idx], sh)
        params, opt_state, l = sharded(params, opt_state, k_step, xb, None)
        if i == 0:
            jax.block_until_ready(l)
            t0 = time.perf_counter()
    jax.block_until_ready(l)
    dt = (time.perf_counter() - t0) / max(args.steps - 1, 1)
    sps = args.batch / dt
    print(
        f"loss={float(l):.3f}  {dt*1e3:.1f} ms/step  "
        f"{sps:.0f} samples/s total, {sps / n_dev:.0f} samples/s/chip"
    )


if __name__ == "__main__":
    main()
