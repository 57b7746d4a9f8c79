"""Real-image-data FFJORD/RNODE run: sklearn handwritten digits (1,797 real
8x8 images, 64-d, 17 gray levels) with the standard quantized-image pipeline
— uniform dequantization + logit transform + per-dim standardization — and
test bits/dim under the dequantization bound.

This closes the last gap in BASELINE config 5 ("MNIST-scale FFJORD"): the
784-d smooth-image-mixture run (benchmarks/image_bitsdim.py) proves scale
against an analytic density; this run proves the *real-data pattern* of the
reference (fit samples, evaluate the fitted density — reference
examples/usage.jl:60-127, test/ci_tests/regression_tests.jl:17-28) on actual
images, where the yardsticks are a held-out test set and a fitted diagonal
Gaussian baseline instead of a known pdf.

    python benchmarks/digits_bitsdim.py                 # full run (GPU)
    python benchmarks/digits_bitsdim.py --steps 300 --cpu   # smoke

Reports train/test bits/dim each eval (overfitting monitor — the round-2
lesson: small data + big net overfits silently), the Gaussian-baseline gap,
and writes a generated-digit grid to --grid (PGM, no plotting deps).
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
import numpy as np
import optax

import continuousnormalizingflows_tpu as cnf
from continuousnormalizingflows_tpu.config import Mode, SolverConfig
from continuousnormalizingflows_tpu.models.nets import MLP
from continuousnormalizingflows_tpu.utils import datasets

D = 64
ALPHA = 0.05


def build(hidden, train_precision, nprobes=1):
    cfg_train = cnf.ICNFConfig(
        nvariables=D,
        naugments=0,
        lambda_1=0.01,  # RNODE regularization: straight trajectories keep
        lambda_2=0.01,  # eval NFE down on the sharpened field
        lambda_3=0.0,
        steer_rate=0.0,
        nprobes=nprobes,
        solver=SolverConfig(method="rk4", gradient="backprop", fixed_steps=24),
    )
    net = MLP((cfg_train.n_in, hidden, hidden, cfg_train.n_out),
              precision=train_precision)
    icnf_train = cnf.ICNF(config=cfg_train, net=net)
    import dataclasses

    cfg_eval = dataclasses.replace(
        cfg_train, solver=SolverConfig(method="dopri5", rtol=1e-4, atol=1e-4)
    )
    icnf_eval = cnf.ICNF(config=cfg_eval, net=MLP(net.widths, precision="highest"))
    return icnf_train, icnf_eval


def gaussian_baseline_bpd(y_train, ldj_test, y_test):
    """Diagonal-Gaussian yardstick bits/dim (shared formula:
    utils.datasets.diagonal_gaussian_logp)."""
    logp = datasets.diagonal_gaussian_logp(y_train, y_test)
    return float(jnp.mean(datasets.quantized_bits_per_dim(logp, ldj_test, D)))


def write_pgm_grid(path, imgs_levels, cols=8):
    """(n, 64) gray-level images -> one PGM grid file (no plotting deps)."""
    n = imgs_levels.shape[0]
    rows = (n + cols - 1) // cols
    grid = np.zeros((rows * 9 + 1, cols * 9 + 1), dtype=np.uint8)
    for i in range(n):
        r, c = divmod(i, cols)
        img = np.asarray(imgs_levels[i]).reshape(8, 8)
        grid[r * 9 + 1 : r * 9 + 9, c * 9 + 1 : c * 9 + 9] = (
            img * (255 / 16)
        ).astype(np.uint8)
    with open(path, "w") as f:
        f.write(f"P2\n{grid.shape[1]} {grid.shape[0]}\n255\n")
        for row in grid:
            f.write(" ".join(str(int(v)) for v in row) + "\n")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--hidden", type=int, default=256)
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--steps", type=int, default=6000)
    ap.add_argument("--eval-every", type=int, default=500)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--weight-decay", type=float, default=1e-4)
    ap.add_argument("--deq-draws", type=int, default=8,
                    help="dequantization draws averaged at eval")
    ap.add_argument("--precision", default="default")
    ap.add_argument("--augment-prob", type=float, default=0.5,
                    help="fraction of samples shifted when --augment is on "
                         "(0.5 is the measured optimum — full shifting is "
                         "WORSE than no augmentation at 8x8, PARITY round 4)")
    ap.add_argument("--augment", action="store_true",
                    help="random +-1px translation augmentation per step "
                         "(batch_transform hook; the standard small-image "
                         "anti-overfit lever)")
    ap.add_argument("--nprobes", type=int, default=1,
                    help="Hutchinson probes per solve (4 = the measured "
                         "variance-per-wall-clock optimum, PARITY round 3)")
    ap.add_argument("--patience", type=int, default=6,
                    help="early-stop after this many stale validation evals "
                         "(0 = fixed budget, no early stop)")
    ap.add_argument("--n-val", type=int, default=150,
                    help="train rows held out for validation-based control")
    ap.add_argument("--grid", default=None, help="PGM path for generated digits")
    ap.add_argument("--save", default=None)
    args = ap.parse_args()
    print("device:", jax.devices()[0], flush=True)

    # canonical split + standardization (shared with tests/test_digits.py);
    # a validation slice comes OFF THE TRAIN SPLIT for early stopping and
    # best-params selection — the test set stays untouched until the final
    # report (the round-4 protocol monitored test bpd per chunk; round 5
    # routes control through fit(validation_data=...) honestly)
    x_train_i, x_test_i = datasets.digits_split()
    x_val_i, x_fit_i = x_train_i[: args.n_val], x_train_i[args.n_val :]
    m, s, log_s_sum, y0 = datasets.digits_standardizer(x_fit_i, alpha=ALPHA)

    icnf, icnf_eval = build(args.hidden, args.precision, args.nprobes)
    params = icnf.init(jax.random.PRNGKey(0))
    n_params = sum(p.size for p in jax.tree_util.tree_leaves(params))
    print(f"params: {n_params/1e3:.0f} k | train {x_fit_i.shape[0]} "
          f"val {x_val_i.shape[0]} test {x_test_i.shape[0]}", flush=True)

    lr = optax.cosine_decay_schedule(args.lr, args.steps, alpha=0.02)
    opt = optax.chain(optax.clip_by_global_norm(1.0),
                      optax.adamw(lr, weight_decay=args.weight_decay))

    # Training goes through the SUPPORTED estimator API: per-step jitted
    # dequantization via batch_transform, one dispatch per epoch via
    # steps_per_dispatch, and eval-between-chunks via exact warm-start resume
    # (params + opt_state + key round-trip FitResult) — no custom train loop.
    def deq_standardize(k, xb_int):
        if args.augment:
            k, k_shift = jax.random.split(k)
            xb_int = datasets.random_shift_images(k_shift, xb_int, side=8,
                                                  prob=args.augment_prob)
        yb, _ = datasets.dequantize_logit(xb_int, k, alpha=ALPHA)
        return (yb - m) / s

    @jax.jit
    def eval_bpd(params, x_int, key):
        def one(k):
            y, ldj = datasets.dequantize_logit(x_int, k, alpha=ALPHA)
            v = (y - m) / s
            lp_v, _a, stats = cnf.inference(icnf_eval, Mode.TEST, v, params)
            lp_y = lp_v - log_s_sum
            return jnp.mean(datasets.quantized_bits_per_dim(lp_y, ldj, D)), stats.nfe

        bpds, nfes = jax.vmap(one)(jax.random.split(key, args.deq_draws))
        return jnp.mean(bpds), nfes[0]

    # yardsticks
    y_te, ldj_te = datasets.dequantize_logit(x_test_i, jax.random.PRNGKey(8),
                                             alpha=ALPHA)
    base_bpd = gaussian_baseline_bpd(y0, ldj_te, y_te)
    print(f"diagonal-Gaussian baseline: {base_bpd:.4f} bits/dim "
          f"(uniform model: {np.log2(17.0):.4f})", flush=True)

    k_ev = jax.random.PRNGKey(9)
    bpd0, nfe0 = eval_bpd(params, x_test_i, k_ev)
    print(f"step 0: test bits/dim {float(bpd0):.4f} NFE {int(nfe0)}", flush=True)

    # Training control goes through the SUPPORTED validated-fit API (round
    # 5): per-step jitted dequantization via batch_transform, one dispatch
    # per epoch via steps_per_dispatch, periodic TestMode validation NLL on
    # the adaptive eval solver (eval_icnf) with best-params tracking and
    # early stopping — no hand-rolled chunk/eval loop.  The validation
    # metric is the NLL of ONE fixed dequantization draw of the val slice in
    # standardized space: a monotone proxy for val bits/dim (fixed ldj).
    y_val, _ = datasets.dequantize_logit(x_val_i, jax.random.PRNGKey(11),
                                         alpha=ALPHA)
    v_val = (y_val - m) / s
    steps_per_epoch = max(1, x_fit_i.shape[0] // args.batch)
    epochs = max(1, args.steps // steps_per_epoch)
    eval_epochs = max(1, args.eval_every // steps_per_epoch)
    t0 = time.perf_counter()

    def monitor(epoch, vnll):
        done = epoch * steps_per_epoch
        print(f"step {done}: val NLL {vnll:.2f} | "
              f"{done*args.batch/(time.perf_counter()-t0):,.0f} samples/s cum",
              flush=True)

    model = cnf.ICNFModel(
        icnf, eval_icnf=icnf_eval, optimizer=opt, batchsize=args.batch,
        epochs=epochs, steps_per_dispatch=steps_per_epoch,
        batch_transform=deq_standardize, log_every=10**9,
        val_callback=monitor, key=jax.random.PRNGKey(3),
    )
    res = model.fit(x_fit_i, params=params, validation_data=v_val,
                    eval_every=eval_epochs,
                    patience=args.patience if args.patience > 0 else None)
    params = res.best_params if res.best_params is not None else res.params
    done = res.stats["epochs_run"] * steps_per_epoch

    bpd_te, nfe = eval_bpd(params, x_test_i, k_ev)
    bpd_tr, _ = eval_bpd(params, x_fit_i[:512], k_ev)
    print(f"\nFINAL (best-val params, epoch {res.best_epoch}, "
          f"{done} steps run of {args.steps}): "
          f"test {float(bpd_te):.4f} bits/dim vs Gaussian baseline "
          f"{base_bpd:.4f} (margin {base_bpd-float(bpd_te):+.4f}); train-test "
          f"gap {float(bpd_te)-float(bpd_tr):+.4f} | NFE {int(nfe)} "
          f"({time.perf_counter()-t0:.0f}s)", flush=True)

    if args.grid:
        gen = cnf.generate(icnf_eval, Mode.TEST, params,
                           jax.random.PRNGKey(12), 32)
        y_gen = gen * s + m
        write_pgm_grid(args.grid, datasets.logit_to_levels(y_gen, alpha=ALPHA))
        print(f"generated grid -> {args.grid}", flush=True)
    if args.save:
        from continuousnormalizingflows_tpu.utils import save_checkpoint

        save_checkpoint(args.save, jax.device_get(params), step=done)


if __name__ == "__main__":
    main()
