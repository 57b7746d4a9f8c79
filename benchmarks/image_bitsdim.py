"""Image-scale FFJORD quality run with an exactly measurable NLL gap.

BASELINE config 5 is "MNIST-scale FFJORD"; real MNIST is unreachable in a
zero-egress environment, so this trains a 784-d flow on the smooth-image
mixture (datasets.smooth_image_mixture — analytic density; see PARITY.md) and
reports a *convergence curve in bits/dim* against the true density's bits/dim
on the same held-out set.  The reference's regression pattern is a fitted
density compared against the ground truth (reference
test/ci_tests/regression_tests.jl:17-28) — this is that check at image scale.

Evaluation is the exact-trace (TestMode) path — O(1)-matmul analytic MLP
trace (ops/dynamics.py:_mlp_exact_trace), so exact 784-d log-likelihoods are
cheap enough to run at every checkpoint.

    python benchmarks/image_bitsdim.py                    # full 784-d run (GPU)
    python benchmarks/image_bitsdim.py --side 8 --steps 400 --hidden 128  # smoke
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

if "--cpu" in sys.argv:  # must precede jax backend init
    sys.argv.remove("--cpu")
    import jax

    jax.config.update("jax_platforms", "cpu")
import jax
import jax.numpy as jnp
import optax

import continuousnormalizingflows_tpu as cnf
from continuousnormalizingflows_tpu.config import Mode
from continuousnormalizingflows_tpu.utils import datasets
from chip_smoke import image_flow


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--side", type=int, default=28)
    ap.add_argument("--ncomp", type=int, default=3)
    ap.add_argument("--hidden", type=int, default=1024)
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--eval-n", type=int, default=2048)
    ap.add_argument("--steps", type=int, default=4000)
    ap.add_argument("--eval-every", type=int, default=500)
    ap.add_argument("--lr", type=float, default=1e-3)
    # 16384 overfits the 2.7M-param net hard (measured: eval bits/dim bottoms
    # at ~step 12k then climbs while train loss keeps falling); 131072 gives
    # gap +0.07 at 28k steps and still falling
    ap.add_argument("--train-n", type=int, default=131072)
    ap.add_argument("--cosine", action="store_true",
                    help="cosine-decay the learning rate over --steps")
    ap.add_argument("--precision", default="default",
                    help="train matmul precision: default (TF32 on the GPU) | highest")
    ap.add_argument("--save", default=None,
                    help="checkpoint path for the final params (pickle backend)")
    args = ap.parse_args()
    d = args.side * args.side
    print("device:", jax.devices()[0], "| d =", d, flush=True)

    icnf, icnf_eval = image_flow(args.side, args.hidden, args.precision)
    params = icnf.init(jax.random.PRNGKey(0))
    n_params = sum(p.size for p in jax.tree_util.tree_leaves(params))
    print(f"params: {n_params/1e6:.2f} M", flush=True)

    x_train = datasets.smooth_image_mixture(
        jax.random.PRNGKey(1), args.train_n, args.side, args.ncomp
    )
    x_eval = datasets.smooth_image_mixture(
        jax.random.PRNGKey(2), args.eval_n, args.side, args.ncomp
    )
    true_nll = float(-jnp.mean(
        datasets.smooth_image_mixture_logpdf(x_eval, args.side, args.ncomp)
    ))
    true_bpd = float(datasets.nats_to_bits_per_dim(jnp.float32(true_nll), d))
    print(f"true NLL {true_nll:.2f} nats = {true_bpd:.4f} bits/dim", flush=True)

    lr = (
        optax.cosine_decay_schedule(args.lr, args.steps, alpha=0.02)
        if args.cosine
        else args.lr
    )
    opt = optax.chain(optax.clip_by_global_norm(1.0),
                      optax.adamw(lr, weight_decay=1e-4))
    opt_state = opt.init(params)

    @jax.jit
    def run_chunk(params, opt_state, key, xb_all):
        # batches are pre-gathered outside jit: an in-scan gather over the
        # full train set materialized a train_n-sized temp per step (device
        # out of memory at d=784); the chunk of batches is a modest dense input
        def step(carry, xb):
            params, opt_state, key = carry
            key, k_s = jax.random.split(key)
            l, g = jax.value_and_grad(
                lambda p: cnf.loss(icnf, Mode.TRAIN, xb, p, key=k_s)
            )(params)
            updates, opt_state = opt.update(g, opt_state, params)
            return (optax.apply_updates(params, updates), opt_state, key), l

        (params, opt_state, key), ls = jax.lax.scan(
            step, (params, opt_state, key), xb_all
        )
        return params, opt_state, key, ls[-1]

    @jax.jit
    def eval_bpd(params):
        lp, _a, stats = cnf.inference(icnf_eval, Mode.TEST, x_eval, params)
        return datasets.nats_to_bits_per_dim(-jnp.mean(lp), d), stats.nfe

    key = jax.random.PRNGKey(3)
    key_batch = jax.random.PRNGKey(4)
    bpd0, nfe0 = eval_bpd(params)
    print(f"step 0: bits/dim {float(bpd0):.4f} (true {true_bpd:.4f}, "
          f"gap {float(bpd0)-true_bpd:.4f}) NFE {int(nfe0)}", flush=True)
    curve = [(0, float("nan"), float(bpd0))]
    t0 = time.perf_counter()
    done = 0
    while done < args.steps:
        key_batch, kb = jax.random.split(key_batch)
        idx = jax.random.randint(
            kb, (args.eval_every, args.batch), 0, args.train_n
        )
        xb_all = x_train[idx]  # gathered once per chunk, outside the scan
        params, opt_state, key, l = run_chunk(params, opt_state, key, xb_all)
        done += args.eval_every
        bpd, nfe = eval_bpd(params)
        dt = time.perf_counter() - t0
        print(
            f"step {done}: train loss {float(l):.2f} | eval bits/dim "
            f"{float(bpd):.4f} (true {true_bpd:.4f}, gap "
            f"{float(bpd)-true_bpd:+.4f}) | NFE {int(nfe)} | "
            f"{done*args.batch/dt:,.0f} samples/s cum",
            flush=True,
        )
        curve.append((done, float(l), float(bpd)))

    gap = curve[-1][2] - true_bpd
    print(f"\nFINAL: bits/dim {curve[-1][2]:.4f} vs true {true_bpd:.4f} "
          f"(gap {gap:+.4f} bits/dim) after {args.steps} steps "
          f"({time.perf_counter()-t0:.0f}s)", flush=True)
    if args.save:
        from continuousnormalizingflows_tpu.utils import save_checkpoint

        save_checkpoint(args.save, jax.device_get(params), step=args.steps)
        print(f"saved params to {args.save}", flush=True)


if __name__ == "__main__":
    main()
