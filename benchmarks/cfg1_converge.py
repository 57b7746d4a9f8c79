"""Config-1 convergence study: close (or bound) the ring-mixture NLL gap.

The round-1 quality anchor (PARITY.md) fitted BASELINE config 1 — the 2-D
8-mode ring-of-Gaussians RNODE (the reference ``examples/usage.jl:60-127``
pattern) — to test NLL 2.806 vs the analytic optimum 2.469 (**gap 0.337
nats**) at 16k samples / 150 epochs with the round-1 stack.  This study
re-runs the config to convergence with the current stack and decomposes the
gap into its three suspected sources:

* capacity — the reference-default net is 3->12->12->2 (icnf.jl:67-71);
  variant B widens to h=64;
* optimization — variant C adds cosine LR decay 1e-3 -> 1e-5, longer
  training, and the measured nprobes=4 variance optimum (PARITY round 3);
* regularization bias — RNODE's lambda=0.01 kinetic/Frobenius penalties
  trade likelihood for smoothness *by design*; variant D drops them
  (FFJORD-style) to isolate how much of the gap is the RNODE objective
  rather than misfit.

Train: rk4-32 discretize-then-optimize at precision "default", batch 1024,
``steps_per_dispatch=16`` (dispatch-bound host).  Eval: float32 "highest"
adaptive dopri5 at the reference tolerances, exact trace, held-out 8192.

Run: python benchmarks/cfg1_converge.py --epochs 300        (GPU)
     JAX_PLATFORMS=cpu python benchmarks/cfg1_converge.py --epochs 30 --quick
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax
import jax.numpy as jnp
import optax

import continuousnormalizingflows_tpu as cnf
from continuousnormalizingflows_tpu.config import Mode, SolverConfig
from continuousnormalizingflows_tpu.models.nets import MLP
from continuousnormalizingflows_tpu.utils import datasets

FAST = SolverConfig(method="rk4", gradient="backprop", fixed_steps=32)
EVAL = SolverConfig(method="dopri5", rtol=1e-4, atol=1e-4)


def make_icnf(h=None, nprobes=1, lambdas=0.01):
    kw = dict(
        nvariables=2, naugments=0, lambda_3=0.0, steer_rate=0.1,
        lambda_1=lambdas, lambda_2=lambdas, nprobes=nprobes, solver=FAST,
        precision="default",
    )
    icnf = cnf.ICNF.create(**kw)
    if h is not None:
        cfg = icnf.config
        net = MLP((cfg.n_in, h, h, cfg.n_out), dtype=cfg.dtype,
                  precision="default")
        icnf = cnf.ICNF(config=cfg, net=net)
    return icnf


def run_variant(name, icnf, x, xt, epochs, lr_schedule=False, batch=1024):
    n_steps = (x.shape[0] // batch) * epochs
    if lr_schedule:
        lr = optax.cosine_decay_schedule(1e-3, n_steps, alpha=0.01)
        opt = optax.chain(optax.add_decayed_weights(1e-4), optax.adam(lr))
    else:
        opt = None
    model = cnf.ICNFModel(
        icnf, batchsize=batch, epochs=epochs, optimizer=opt,
        key=jax.random.PRNGKey(1), steps_per_dispatch=16,
    )
    t0 = time.time()
    res = model.fit(x)
    wall = time.time() - t0

    import dataclasses

    icnf_eval = cnf.ICNF(
        config=dataclasses.replace(icnf.config, solver=EVAL),
        net=MLP(icnf.net.widths, dtype=icnf.config.dtype, precision="highest"),
    )
    lp, _, stats = cnf.inference(icnf_eval, Mode.TEST, xt, res.params)
    nll = -float(jnp.mean(lp))
    opt_nll = -float(jnp.mean(datasets.gaussian_mixture_logpdf(xt)))
    gap = nll - opt_nll
    out = {
        "variant": name, "nll": round(nll, 4), "optimum": round(opt_nll, 4),
        "gap_nats": round(gap, 4), "epochs": epochs,
        "train_wall_s": round(wall, 1), "final_loss": res.stats["final_loss"],
        "eval_nfe": int(stats.nfe),
    }
    print(json.dumps(out), flush=True)
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--epochs", type=int, default=300)
    ap.add_argument("--quick", action="store_true",
                    help="small data for a CPU smoke run")
    ap.add_argument("--variants", default="ABCD")
    args = ap.parse_args()

    n = 8192 if args.quick else 65536
    x = datasets.gaussian_mixture(jax.random.PRNGKey(0), n)
    xt = datasets.gaussian_mixture(jax.random.PRNGKey(9), 8192)

    results = []
    if "A" in args.variants:  # the round-1 anchor config, current stack
        results.append(run_variant(
            "A_default_net", make_icnf(), x, xt, args.epochs))
    if "B" in args.variants:  # capacity
        results.append(run_variant(
            "B_h64", make_icnf(h=64), x, xt, args.epochs))
    if "C" in args.variants:  # capacity + optimization + probe optimum
        results.append(run_variant(
            "C_h64_cosine_p4", make_icnf(h=64, nprobes=4), x, xt,
            args.epochs * 2, lr_schedule=True))
    if "D" in args.variants:  # regularization bias isolated
        results.append(run_variant(
            "D_h64_cosine_p4_noreg", make_icnf(h=64, nprobes=4, lambdas=0.0),
            x, xt, args.epochs * 2, lr_schedule=True))
    print(json.dumps({"summary": {r["variant"]: r["gap_nats"] for r in results}}),
          flush=True)


if __name__ == "__main__":
    main()
