"""Weak-scaling harness — measures samples/s at growing mesh sizes.

Target (BASELINE.md): >=80% weak-scaling efficiency.  The harness measures
whatever devices exist (`--devices 1 2 4 8`); on the CPU backend with
``--xla_force_host_platform_device_count=8`` it validates the *mechanism*
(per-device batch constant, psum gradient all-reduce, identical step
sequences) rather than interconnect bandwidth.

Run: python benchmarks/scaling.py --cpu --per-device-batch 512 --steps 10
(--cpu forces the 8-virtual-device CPU backend in-process)
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

if "--cpu" in sys.argv:  # must precede backend init
    sys.argv.remove("--cpu")
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_num_cpu_devices", 8)
import jax
import jax.numpy as jnp
import optax

import continuousnormalizingflows_tpu as cnf
from continuousnormalizingflows_tpu.config import Mode, SolverConfig
from continuousnormalizingflows_tpu.parallel import data_sharding, make_mesh, shard_train_step


def bench_mesh(n_dev: int, per_device_batch: int, steps: int) -> float:
    devices = jax.devices()[:n_dev]
    mesh = make_mesh(devices=devices)
    batch = per_device_batch * n_dev

    icnf = cnf.ICNF.create(
        nvariables=2,
        solver=SolverConfig(method="rk4", gradient="backprop", fixed_steps=32),
    )
    params = icnf.init(jax.random.PRNGKey(0))
    opt = optax.adam(1e-3)
    opt_state = opt.init(params)
    x = jax.device_put(
        jax.random.normal(jax.random.PRNGKey(1), (batch, 2)), data_sharding(mesh)
    )

    def step(params, opt_state, key, xs, ys):
        l, grads = jax.value_and_grad(
            lambda p: cnf.loss(icnf, Mode.TRAIN, xs, p, key=key)
        )(params)
        updates, opt_state = opt.update(grads, opt_state)
        return optax.apply_updates(params, updates), opt_state, l

    fn = shard_train_step(step, mesh, conditional=False)
    p, o, l = fn(params, opt_state, jax.random.PRNGKey(0), x, None)
    jax.block_until_ready(l)
    t0 = time.perf_counter()
    for i in range(steps):
        p, o, l = fn(p, o, jax.random.PRNGKey(i), x, None)
    jax.block_until_ready(l)
    dt = (time.perf_counter() - t0) / steps
    return batch / dt


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--per-device-batch", type=int, default=512)
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--devices", type=int, nargs="*", default=None)
    args = ap.parse_args()

    avail = len(jax.devices())
    sizes = args.devices or [n for n in (1, 2, 4, 8) if n <= avail]
    base = None
    print(f"{'devices':>8} {'samples/s':>12} {'efficiency':>11}")
    for n in sizes:
        sps = bench_mesh(n, args.per_device_batch, args.steps)
        if base is None:
            base = sps
        eff = sps / (base * n)
        print(f"{n:>8} {sps:>12.0f} {eff:>10.1%}")


if __name__ == "__main__":
    main()
