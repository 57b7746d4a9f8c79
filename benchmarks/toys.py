"""2-D toy-suite parity — BASELINE.md configs 1-3.

1. RNODE + Hutchinson on the ring-of-Gaussians mixture (usage.jl-style):
   test NLL against the analytic mixture entropy (the achievable optimum).
2. FFJORD exact-trace vs Hutchinson NLL parity on moons/circles: the same
   fitted model evaluated both ways must agree within Monte-Carlo error.
3. CondRNODE: class-conditional density on a two-class mixture; checks the
   conditional densities separate the classes.

Run: JAX_PLATFORMS=cpu python benchmarks/toys.py --epochs 40   (quick CPU)
     python benchmarks/toys.py                                  (GPU, full)
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax
import jax.numpy as jnp
import numpy as np

import continuousnormalizingflows_tpu as cnf
from continuousnormalizingflows_tpu.config import Mode, SolverConfig
from continuousnormalizingflows_tpu.utils import datasets

FAST = SolverConfig(method="rk4", gradient="backprop", fixed_steps=32)


def fit(icnf, x, y=None, epochs=100, batchsize=512, seed=0):
    cls = cnf.CondICNFModel if icnf.config.conditioned else cnf.ICNFModel
    model = cls(icnf, batchsize=batchsize, epochs=epochs, key=jax.random.PRNGKey(seed))
    return model.fit(x, y) if y is not None else model.fit(x)


def config1_rnode_mixture(epochs):
    print("== config 1: RNODE + Hutchinson on 2-D Gaussian mixture ==")
    x = datasets.gaussian_mixture(jax.random.PRNGKey(0), 4096)
    icnf = cnf.ICNF.create(
        nvariables=2, naugments=0, lambda_3=0.0, steer_rate=0.1, solver=FAST
    )
    res = fit(icnf, x, epochs=epochs)
    xt = datasets.gaussian_mixture(jax.random.PRNGKey(9), 2048)
    lp, _, nfe = cnf.inference(icnf, Mode.TEST, xt, res.params)
    nll = -float(jnp.mean(lp))
    opt_nll = -float(jnp.mean(datasets.gaussian_mixture_logpdf(xt)))
    print(f"  test NLL {nll:.3f}  (analytic optimum {opt_nll:.3f}, gap {nll-opt_nll:+.3f})")
    return {"nll": nll, "optimum": opt_nll}


def config2_exact_vs_hutch(epochs):
    print("== config 2: FFJORD exact vs Hutchinson parity (moons, circles) ==")
    out = {}
    for name, gen in (("moons", datasets.two_moons), ("circles", datasets.circles)):
        x = gen(jax.random.PRNGKey(0), 4096)
        icnf = cnf.ICNF.create(
            nvariables=2, naugments=0,
            lambda_1=0.0, lambda_2=0.0, lambda_3=0.0, steer_rate=0.0,
            nprobes=64, solver=FAST,
        )
        res = fit(icnf, x, epochs=epochs, seed=1)
        xt = gen(jax.random.PRNGKey(9), 1024)
        lp_exact, _, _ = cnf.inference(icnf, Mode.TEST, xt, res.params)
        lp_hutch, _, _ = cnf.inference(
            icnf, Mode.TRAIN, xt, res.params, key=jax.random.PRNGKey(3)
        )
        nll_e, nll_h = -float(jnp.mean(lp_exact)), -float(jnp.mean(lp_hutch))
        print(f"  {name}: NLL exact {nll_e:.4f} vs hutchinson {nll_h:.4f} (Δ {abs(nll_e-nll_h):.4f})")
        out[name] = {"exact": nll_e, "hutch": nll_h}
    return out


def config3_cond_rnode(epochs):
    print("== config 3: CondRNODE class-conditional density ==")
    n = 4096
    key = jax.random.PRNGKey(0)
    k1, k2 = jax.random.split(key)
    label = jax.random.bernoulli(k1, 0.5, (n, 1)).astype(jnp.float32)
    centers = jnp.where(label > 0, 2.0, -2.0)
    x = jax.random.normal(k2, (n, 2)) * 0.5 + centers
    icnf = cnf.ICNF.create(
        nvariables=2, naugments=0, nconditions=1, lambda_3=0.0, solver=FAST
    )
    res = fit(icnf, x, y=label, epochs=epochs, seed=2)
    probe = jnp.array([[2.0, 2.0], [-2.0, -2.0]])
    d1 = cnf.CondICNFDist(icnf, res.params, jnp.array([1.0]))
    d0 = cnf.CondICNFDist(icnf, res.params, jnp.array([0.0]))
    lp1, lp0 = np.asarray(d1.logpdf(probe)), np.asarray(d0.logpdf(probe))
    print(f"  logp(class=1) at (+2,+2)/(−2,−2): {lp1[0]:.2f} / {lp1[1]:.2f}")
    print(f"  logp(class=0) at (+2,+2)/(−2,−2): {lp0[0]:.2f} / {lp0[1]:.2f}")
    ok = lp1[0] > lp1[1] and lp0[1] > lp0[0]
    print(f"  conditional separation: {'OK' if ok else 'FAILED'}")
    return {"separated": bool(ok)}


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--epochs", type=int, default=100)
    args = ap.parse_args()
    config1_rnode_mixture(args.epochs)
    config2_exact_vs_hutch(args.epochs)
    config3_cond_rnode(args.epochs)
