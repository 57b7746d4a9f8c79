"""A/B the solve-internal array layout on the flagship bench config.

Hypothesis: the reference-default dynamics net is 5-24 features wide, so in
batch-first ``(B, d)`` arrays the contiguous dimension is tiny on every
elementwise op / memory access inside the step loop;
``layout="feature_first"`` makes the batch the contiguous dimension.  Run on a GPU:

    python benchmarks/layout_ab.py
"""

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

BATCH = 65536
STEPS = 20


def bench_layout(layout: str, precision: str) -> float:
    icnf = cnf.ICNF.create(
        nvariables=2,
        solver=SolverConfig(method="rk4", gradient="backprop", fixed_steps=32),
        precision=precision,
        layout=layout,
    )
    params = icnf.init(jax.random.PRNGKey(0))
    x = datasets.gaussian_mixture(jax.random.PRNGKey(1), BATCH)
    opt = optax.adam(1e-3)
    opt_state = opt.init(params)

    def step(carry, _):
        params, opt_state, key = carry
        key, k = jax.random.split(key)
        l, grads = jax.value_and_grad(
            lambda p: cnf.loss(icnf, Mode.TRAIN, x, p, key=k)
        )(params)
        updates, opt_state = opt.update(grads, opt_state)
        return (optax.apply_updates(params, updates), opt_state, key), l

    @jax.jit
    def run(params, opt_state, key):
        (params, opt_state, _), losses = jax.lax.scan(
            step, (params, opt_state, key), jnp.arange(STEPS)
        )
        return params, opt_state, losses[-1]

    t_c = time.perf_counter()
    _p, _o, l = run(params, opt_state, jax.random.PRNGKey(0))
    jax.block_until_ready(l)
    print(f"  [{layout}/{precision}] compile+first: {time.perf_counter()-t_c:.1f}s "
          f"loss={float(l):.4f}", flush=True)
    best = float("inf")
    for rep in range(3):
        t0 = time.perf_counter()
        _p, _o, l = run(params, opt_state, jax.random.PRNGKey(rep))
        jax.block_until_ready(l)
        best = min(best, (time.perf_counter() - t0) / STEPS)
    sps = BATCH / best
    print(f"  [{layout}/{precision}] {best*1e3:.2f} ms/step  {sps/1e6:.3f} M samples/s",
          flush=True)
    return sps


def main():
    print("device:", jax.devices()[0], flush=True)
    results = {}
    for precision in ("default", "highest"):
        for layout in ("batch_first", "feature_first"):
            results[(layout, precision)] = bench_layout(layout, precision)
    for k, v in results.items():
        print(k, f"{v/1e6:.3f} M samples/s", flush=True)


if __name__ == "__main__":
    main()
