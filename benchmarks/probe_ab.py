"""Hutchinson probe A/B: VJP vs JVP contraction, and probe-count scaling.

The reference defaults to batched VJP Hutchinson (LuxVecJacMatrixMode,
reference src/core/icnf.jl:55) and also ships the JVP (forward-mode) variant
(LuxJacVecMatrixMode, utils.jl:160-170); both estimate tr(J) with the same
statistics (E[eps^T J eps] = tr J for isotropic eps).  Their cost
structures differ: the VJP transposes the MLP chain (reverse-mode residuals),
the JVP pushes a tangent through the forward chain (forward-mode, no
residuals) — under backprop-through-solver training, grad-of-JVP is
forward-over-reverse while grad-of-VJP is reverse-over-reverse.  Which wins
on the device is an empirical question this measures; the reference never does.

Also measures nprobes scaling {1,2,4,8}: probes multiply per-eval math
(variance down as 1/nprobes) — on a tiny net the extra probes may be
nearly free, a capability the reference lacks (fixed 1 probe,
base_icnf.jl:207-208).

    python benchmarks/probe_ab.py            # GPU
"""

import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax
import jax.numpy as jnp
import optax

import continuousnormalizingflows_tpu as cnf
from continuousnormalizingflows_tpu.config import Mode, SolverConfig, TraceEstimator

REPS = 10


def bench_train(nvariables, batch, trace, nprobes, method="rk4",
                gradient="backprop", label=""):
    solver = (SolverConfig(method=method, gradient=gradient, fixed_steps=32)
              if gradient == "backprop"
              else SolverConfig(method=method, rtol=1e-4, atol=1e-4,
                                gradient=gradient))
    icnf = cnf.ICNF.create(
        nvariables=nvariables, trace=trace, nprobes=nprobes, solver=solver,
        precision="default",
    )
    params = icnf.init(jax.random.PRNGKey(0))
    x = 0.5 * jax.random.normal(jax.random.PRNGKey(1), (batch, nvariables))
    opt = optax.adam(1e-3)
    opt_state = opt.init(params)

    @jax.jit
    def run(params, opt_state, key):
        def body(carry, _):
            params, opt_state, key = carry
            key, k = jax.random.split(key)
            l, g = jax.value_and_grad(
                lambda p: cnf.loss(icnf, Mode.TRAIN, x, p, key=k)
            )(params)
            u, opt_state = opt.update(g, opt_state)
            return (optax.apply_updates(params, u), opt_state, key), l

        (params, opt_state, _), ls = jax.lax.scan(
            body, (params, opt_state, key), jnp.arange(REPS)
        )
        return ls[-1]

    l = run(params, opt_state, jax.random.PRNGKey(2))
    jax.block_until_ready(l)
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        l = run(params, opt_state, jax.random.PRNGKey(2))
        jax.block_until_ready(l)
        best = min(best, (time.perf_counter() - t0) / REPS)
    print(f"  {label:>22}: {best*1e3:7.2f} ms/step | "
          f"{batch/best/1e6:6.3f} M samples/s | loss {float(l):.4f}",
          flush=True)
    return best


def trace_std(nvariables, trace, nprobes, batch=4096, ntrials=64):
    """Monte-Carlo std of the divergence estimate at t=0 across fresh probes
    (per-sample, averaged over the batch) — the statistical payoff side of
    the nprobes ledger."""
    from continuousnormalizingflows_tpu.core import sample_probe
    from continuousnormalizingflows_tpu.ops.dynamics import (
        make_augmented_dynamics,
    )

    icnf = cnf.ICNF.create(nvariables=nvariables, trace=trace, nprobes=nprobes)
    params = icnf.init(jax.random.PRNGKey(0))
    x = 0.5 * jax.random.normal(jax.random.PRNGKey(1), (batch, nvariables))
    nz = icnf.config.nz
    z = jnp.pad(x, ((0, 0), (0, nz - nvariables)))
    u0 = jnp.concatenate(
        [z, jnp.zeros((batch, 3), z.dtype)], axis=-1
    )
    f = make_augmented_dynamics(icnf.config, icnf.net, Mode.TRAIN)

    @jax.jit
    def divs(key):
        eps = sample_probe(icnf.config, key, batch)
        du = f(0.0, u0, {"params": params, "eps": eps, "ys": None})
        return du[:, nz]  # d(dlogp)/dt = -div estimate channel

    ds = jnp.stack([divs(jax.random.PRNGKey(100 + i)) for i in range(ntrials)])
    return float(jnp.mean(jnp.std(ds, axis=0)))


def main():
    print("device:", jax.devices()[0], flush=True)

    for d, batch in ((2, 65536), (43, 4096)):
        print(f"\nTRAIN rk4-32 backprop default precision, d={d}, batch={batch} "
              f"(VJP = reference default):", flush=True)
        t_v = bench_train(d, batch, TraceEstimator.HUTCH_VJP, 1,
                          label="hutch-VJP p=1")
        t_j = bench_train(d, batch, TraceEstimator.HUTCH_JVP, 1,
                          label="hutch-JVP p=1")
        print(f"  JVP is {t_v/t_j:.2f}x the VJP step rate", flush=True)

    print(f"\nTRAIN adjoint dopri5 fp32 (reference-default path), d=2, "
          f"batch=65536:", flush=True)
    t_v = bench_train(2, 65536, TraceEstimator.HUTCH_VJP, 1, method="dopri5",
                      gradient="adjoint", label="hutch-VJP p=1")
    t_j = bench_train(2, 65536, TraceEstimator.HUTCH_JVP, 1, method="dopri5",
                      gradient="adjoint", label="hutch-JVP p=1")
    print(f"  JVP is {t_v/t_j:.2f}x the VJP step rate", flush=True)

    print("\nnprobes scaling (rk4-32 backprop default precision, d=2, batch=65536):",
          flush=True)
    base = None
    for p in (1, 2, 4, 8):
        t = bench_train(2, 65536, TraceEstimator.HUTCH_VJP, p,
                        label=f"hutch-VJP p={p}")
        base = base or t
        sd = trace_std(2, TraceEstimator.HUTCH_VJP, p)
        print(f"      -> {t/base:.2f}x cost of p=1; per-sample trace-est "
              f"std {sd:.3f}", flush=True)


if __name__ == "__main__":
    main()
