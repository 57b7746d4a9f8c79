"""A/B: carried starting step (dt0="carry") vs fixed ramp vs HNW auto on the
reference-parity adaptive train stack — on the NEAR-INIT field (what bench.py
times) AND on a TRAINED field (sharper dynamics, where the carried steady
state accepts more steps per solve and the win must be re-earned).

Also a quality leg on the UNAUGMENTED config-1 class (naugments=0 — with the
default augmentation the reported log-density is a joint slice, not a
normalized 2-D density, so its NLL drifts unboundedly and two correct runs
can land far apart): train with carry vs fixed ramp vs a DIFFERENT-SEED
fixed ramp on fresh batches and compare TestMode exact NLL against the
analytic optimum.  Any two within-tolerance gradient discretizations give
chaotically different SGD paths; the claim to verify is that the carry-ramp
quality gap is within the seed-to-seed noise yardstick.

Run: python benchmarks/carry_ab.py            (GPU)
     python benchmarks/carry_ab.py --cpu --steps 5 --quality-steps 50
"""

import argparse
import json
import sys
import time

sys.path.insert(0, __file__.rsplit("/", 2)[0])

if "--cpu" in sys.argv:  # must precede backend init
    sys.argv.remove("--cpu")
    import jax

    jax.config.update("jax_platforms", "cpu")
import jax
import jax.numpy as jnp
import optax

import continuousnormalizingflows_tpu as cnf
from continuousnormalizingflows_tpu.config import Mode, SolverConfig
from continuousnormalizingflows_tpu.utils import datasets


def make(dt0):
    return cnf.ICNF.create(
        nvariables=2,
        solver=SolverConfig(method="dopri5", rtol=1e-4, atol=1e-4,
                            gradient="adjoint", dt0=dt0),
        precision="highest",
    )


def train_block(icnf, params, x, steps, carry, key, lr=1e-3,
                fresh_batch=0):
    """One jitted scan of ``steps`` optimizer steps; returns params + stats.
    ``fresh_batch > 0`` draws a new mixture batch of that size every step
    (infinite data) instead of reusing ``x``."""
    opt = optax.adam(lr)

    def step(carry_state, i):
        params, opt_state, key, dt = carry_state
        key, k = jax.random.split(key)
        if fresh_batch:
            k, k_data = jax.random.split(k)
            xb = datasets.gaussian_mixture(k_data, fresh_batch)
        else:
            xb = x
        (l, stats), grads = jax.value_and_grad(
            lambda p: cnf.loss_with_stats(
                icnf, Mode.TRAIN, xb, p, key=k, dt0=dt if carry else None
            ),
            has_aux=True,
        )(params)
        updates, opt_state = opt.update(grads, opt_state)
        dt = jnp.abs(stats.dt_final) if carry else dt
        return (optax.apply_updates(params, updates), opt_state, key, dt), (
            l, stats.nfe,
        )

    @jax.jit
    def run(params, key):
        (params, _o, _k, _dt), (losses, nfes) = jax.lax.scan(
            step, (params, opt.init(params), key, jnp.zeros((), jnp.float32)),
            jnp.arange(steps),
        )
        return params, losses, nfes

    return run


def timed(run, params, key, steps, reps=3):
    p, losses, nfes = run(params, key)
    jax.block_until_ready(losses)
    best = float("inf")
    for r in range(reps):
        t0 = time.perf_counter()
        p, losses, nfes = run(params, jax.random.fold_in(key, r))
        jax.block_until_ready(losses)
        best = min(best, (time.perf_counter() - t0) / steps)
    return best, [int(v) for v in nfes[-3:]], float(losses[-1])


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=65536)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--pretrain-steps", type=int, default=600)
    ap.add_argument("--quality-steps", type=int, default=400)
    args = ap.parse_args()
    print("device:", jax.devices()[0], flush=True)

    x = datasets.gaussian_mixture(jax.random.PRNGKey(1), args.batch)
    xte = datasets.gaussian_mixture(jax.random.PRNGKey(2), 4096)
    icnf_rk4 = cnf.ICNF.create(
        nvariables=2,
        solver=SolverConfig(method="rk4", gradient="backprop", fixed_steps=32),
        precision="highest",
    )
    p0 = icnf_rk4.init(jax.random.PRNGKey(0))

    # sharpen the field first (fast fixed-step pre-training on fresh batches
    # — a fixed batch memorizes into an unrepresentatively spiky field by a
    # few hundred full-batch steps; the throughput legs below time FIXED
    # batches as every bench row does, but the field itself must be a
    # properly trained one)
    pre = train_block(icnf_rk4, p0, x, args.pretrain_steps, carry=False,
                      key=jax.random.PRNGKey(3), fresh_batch=args.batch)
    p_trained, losses, _ = pre(p0, jax.random.PRNGKey(3))
    jax.block_until_ready(losses)
    print(f"pretrained {args.pretrain_steps} steps, loss {float(losses[-1]):.4f}",
          flush=True)

    for field, params in (("near_init", p0), ("trained", p_trained)):
        rows = {}
        for name, dt0, carry in (("ramp_0.01", 0.01, False),
                                 ("auto", "auto", False),
                                 ("carry", "carry", True)):
            icnf = make(dt0)
            run = train_block(icnf, params, x, args.steps, carry,
                              jax.random.PRNGKey(4))
            t, nfes, l = timed(run, params, jax.random.PRNGKey(4), args.steps)
            rows[name] = dict(ms_per_step=round(t * 1e3, 3),
                              samples_per_sec=round(args.batch / t, 1),
                              last_nfes=nfes, loss=round(l, 4))
        speedup = rows["ramp_0.01"]["ms_per_step"] / rows["carry"]["ms_per_step"]
        print(json.dumps({"field": field, "rows": rows,
                          "carry_speedup_vs_ramp": round(speedup, 3)}),
              flush=True)

    # quality leg: unaugmented config-1 class (real normalized density,
    # analytic optimum), fresh batches, seed-noise yardstick
    def make_q(dt0):
        return cnf.ICNF.create(
            nvariables=2, naugments=0, lambda_3=0.0,
            solver=SolverConfig(method="dopri5", rtol=1e-4, atol=1e-4,
                                gradient="adjoint", dt0=dt0),
            precision="highest",
        )

    pq = make_q(0.01).init(jax.random.PRNGKey(7))
    nlls = {}
    for name, dt0, carry, seed in (
        ("ramp_0.01", 0.01, False, 5),
        ("carry", "carry", True, 5),
        ("ramp_0.01_seed6", 0.01, False, 6),
    ):
        icnf = make_q(dt0)
        run = train_block(icnf, pq, x, args.quality_steps, carry,
                          jax.random.PRNGKey(seed), fresh_batch=4096)
        p_fin, losses, nfes = run(pq, jax.random.PRNGKey(seed))
        icnf_eval = make_q(0.01)
        lp, _, stats = cnf.inference(icnf_eval, Mode.TEST, xte, p_fin)
        nlls[name] = dict(test_nll=round(-float(jnp.mean(lp)), 5),
                          final_train_loss=round(float(losses[-1]), 5),
                          final_nfe=int(nfes[-1]), eval_nfe=int(stats.nfe))
    true_nll = -float(jnp.mean(datasets.gaussian_mixture_logpdf(xte)))
    gap_carry = abs(nlls["carry"]["test_nll"] - nlls["ramp_0.01"]["test_nll"])
    gap_seed = abs(nlls["ramp_0.01_seed6"]["test_nll"]
                   - nlls["ramp_0.01"]["test_nll"])
    print(json.dumps({"quality": nlls, "true_nll": round(true_nll, 5),
                      "carry_vs_ramp_gap": round(gap_carry, 5),
                      "seed_noise_yardstick": round(gap_seed, 5)}),
          flush=True)


if __name__ == "__main__":
    main()
