"""A/B the two continuous-adjoint gradient paths on the reference-default
solver config (dopri5 rtol=atol=1e-4, icnf.jl:84-102):

* ``gradient="adjoint"``     — backsolve: backward state (y, a, q)
* ``gradient="quadrature"``  — interpolation adjoint: dense forward nodes,
                               backward state (a, q) only

Measures full loss+grad wall time (scan of STEPS as one dispatch, best of 3)
and gradient agreement between the two.  Run on a GPU:

    python benchmarks/adjoint_ab.py [--batch 4096]
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax
import jax.numpy as jnp

import continuousnormalizingflows_tpu as cnf
from continuousnormalizingflows_tpu.config import Mode, SolverConfig
from continuousnormalizingflows_tpu.utils import datasets

STEPS = 10


def bench(gradient: str, batch: int, seminorm: bool = True,
          method: str = "dopri5"):
    icnf = cnf.ICNF.create(
        nvariables=2,
        solver=SolverConfig(
            method=method, rtol=1e-4, atol=1e-4, gradient=gradient,
            adjoint_seminorm=seminorm,
        ),
    )
    params = icnf.init(jax.random.PRNGKey(0))
    x = datasets.gaussian_mixture(jax.random.PRNGKey(1), batch)

    def one(key):
        return jax.value_and_grad(
            lambda p: cnf.loss(icnf, Mode.TRAIN, x, p, key=key)
        )(params)

    @jax.jit
    def run(key):
        def body(carry, i):
            l, g = one(jax.random.fold_in(key, i))
            return carry, (l, g)

        _, (ls, gs) = jax.lax.scan(body, 0, jnp.arange(STEPS))
        return ls[-1], jax.tree_util.tree_map(lambda a: a[-1], gs)

    t_c = time.perf_counter()
    l, g = run(jax.random.PRNGKey(42))
    jax.block_until_ready(l)
    print(f"  [{gradient} seminorm={seminorm}] compile+first: "
          f"{time.perf_counter()-t_c:.1f}s loss={float(l):.4f}", flush=True)
    best = float("inf")
    for rep in range(3):
        t0 = time.perf_counter()
        l, g = run(jax.random.PRNGKey(42))
        jax.block_until_ready(l)
        best = min(best, (time.perf_counter() - t0) / STEPS)
    print(f"  [{gradient} seminorm={seminorm}] {best*1e3:.2f} ms/step  "
          f"{batch/best/1e6:.3f} M samples/s", flush=True)
    return best, l, g


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=4096)
    ap.add_argument("--method", default="dopri5",
                    help="dopri5 | tsit5 | abm (abm+quadrature = the "
                         "reference-default VCABM+QuadratureAdjoint stack)")
    args = ap.parse_args()
    print("device:", jax.devices()[0], "method:", args.method, flush=True)

    t_bs, l_bs, g_bs = bench("adjoint", args.batch, method=args.method)
    t_q, l_q, g_q = bench("quadrature", args.batch, method=args.method)

    diff = max(
        float(jnp.max(jnp.abs(a - b)))
        for a, b in zip(jax.tree_util.tree_leaves(g_bs), jax.tree_util.tree_leaves(g_q))
    )
    print(f"grad max|Δ| backsolve vs quadrature: {diff:.2e}  "
          f"(same probes: identical fold_in keys)", flush=True)
    print(f"speedup quadrature vs backsolve: {t_bs/t_q:.2f}x", flush=True)


if __name__ == "__main__":
    main()
