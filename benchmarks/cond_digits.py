"""Class-conditional real-image-data run: CondRNODE on sklearn digits with
one-hot label conditioning — the reference's conditional pattern
(CondICNFModel fit on (X, Y) tables, core_cond_icnf.jl:32-61; conditional
smoke data test/ci_tests/smoke_tests.jl:2-8) at real-data scale instead of
the 2-D toy in BASELINE config 3.

Yardsticks (no analytic pdf): per-class test bits/dim must beat (a) the
UNCONDITIONAL model trained identically (conditioning must help: classes
have different densities) and (b) the label-matched diagonal-Gaussian
baseline.  Also reports the classification-by-likelihood accuracy
argmax_y logp(x | y) — a density model that has learned the classes
separates them.

    python benchmarks/cond_digits.py                 # full run (GPU)
    python benchmarks/cond_digits.py --steps 200 --cpu   # smoke
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
NCLASS = 10
ALPHA = 0.05


def build(hidden, conditional: bool):
    cfg = cnf.ICNFConfig(
        nvariables=D,
        naugments=0,
        nconditions=NCLASS if conditional else 0,
        lambda_1=0.01,
        lambda_2=0.01,
        lambda_3=0.0,
        steer_rate=0.0,
        solver=SolverConfig(method="rk4", gradient="backprop", fixed_steps=24),
    )
    net = MLP((cfg.n_in, hidden, hidden, cfg.n_out))
    icnf = cnf.ICNF(config=cfg, net=net)
    import dataclasses

    cfg_eval = dataclasses.replace(
        cfg, solver=SolverConfig(method="dopri5", rtol=1e-4, atol=1e-4)
    )
    icnf_eval = cnf.ICNF(config=cfg_eval, net=MLP(net.widths, precision="highest"))
    return icnf, icnf_eval


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--hidden", type=int, default=256)
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--steps", type=int, default=4000)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--augment-prob", type=float, default=0.0,
                    help="fraction of samples given a random +-1px shift per "
                         "step (labels unchanged; 0.5 measured optimal on "
                         "unconditional digits, PARITY round 4)")
    ap.add_argument("--eval-every", type=int, default=500,
                    help="steps between validation evaluations")
    ap.add_argument("--patience", type=int, default=6,
                    help="early-stop after this many stale validation evals "
                         "(0 = fixed budget)")
    ap.add_argument("--n-val", type=int, default=150)
    args = ap.parse_args()
    print("device:", jax.devices()[0], flush=True)

    x_tr_all, x_te, lab_tr_all, lab_te = datasets.digits_split(with_labels=True)
    # validation slice off the train split (round 5: control through
    # fit(validation_data=...); test untouched until the final report)
    x_val_i, x_tr = x_tr_all[: args.n_val], x_tr_all[args.n_val :]
    lab_val, lab_tr = lab_tr_all[: args.n_val], lab_tr_all[args.n_val :]
    y_tr = jax.nn.one_hot(lab_tr, NCLASS, dtype=jnp.float32)
    y_te = jax.nn.one_hot(lab_te, NCLASS, dtype=jnp.float32)
    y_val = jax.nn.one_hot(lab_val, NCLASS, dtype=jnp.float32)
    m, s, log_s_sum, y0 = datasets.digits_standardizer(x_tr, alpha=ALPHA)
    yv_logit, _ = datasets.dequantize_logit(x_val_i, jax.random.PRNGKey(11),
                                            alpha=ALPHA)
    v_val = (yv_logit - m) / s  # fixed standardized val tensor (one draw)

    def deq_standardize(k, xb_int):
        if args.augment_prob > 0.0:
            k, k_shift = jax.random.split(k)
            xb_int = datasets.random_shift_images(k_shift, xb_int, side=8,
                                                  prob=args.augment_prob)
        yb, _ = datasets.dequantize_logit(xb_int, k, alpha=ALPHA)
        return (yb - m) / s

    steps_per_epoch = max(1, x_tr.shape[0] // args.batch)
    epochs = max(1, args.steps // steps_per_epoch)

    results = {}
    for name, conditional in (("cond", True), ("uncond", False)):
        icnf, icnf_eval = build(args.hidden, conditional)
        lr = optax.cosine_decay_schedule(args.lr, epochs * steps_per_epoch,
                                         alpha=0.02)
        opt = optax.chain(optax.clip_by_global_norm(1.0),
                          optax.adamw(lr, weight_decay=1e-4))
        cls = cnf.CondICNFModel if conditional else cnf.ICNFModel
        model = cls(icnf, eval_icnf=icnf_eval, optimizer=opt,
                    batchsize=args.batch, epochs=epochs,
                    steps_per_dispatch=steps_per_epoch,
                    batch_transform=deq_standardize,
                    key=jax.random.PRNGKey(3), log_every=10_000_000,
                    val_callback=lambda e, v: print(
                        f"  {name} step {e*steps_per_epoch}: val NLL {v:.2f}",
                        flush=True))
        t0 = time.perf_counter()
        eval_epochs = max(1, args.eval_every // steps_per_epoch)
        patience = args.patience if args.patience > 0 else None
        res = model.fit(
            x_tr, y_tr if conditional else None,
            validation_data=(v_val, y_val) if conditional else v_val,
            eval_every=eval_epochs, patience=patience,
        )
        train_s = time.perf_counter() - t0
        best_params = res.best_params if res.best_params is not None else res.params

        @jax.jit
        def bpd(x_int, ys, k, params=best_params, icnf_eval=icnf_eval):
            y, ldj = datasets.dequantize_logit(x_int, k, alpha=ALPHA)
            lp, _a, _s2 = cnf.inference(icnf_eval, Mode.TEST, (y - m) / s,
                                        params, ys=ys)
            return datasets.quantized_bits_per_dim(lp - log_s_sum, ldj, D)

        k_ev = jax.random.PRNGKey(9)
        bpd_te = jnp.mean(bpd(x_te, y_te if conditional else None, k_ev))
        results[name] = float(bpd_te)
        print(f"{name:>7}: test {float(bpd_te):.4f} bits/dim (best-val epoch "
              f"{res.best_epoch}; {train_s:.0f}s train, "
              f"{res.stats['epochs_run'] * steps_per_epoch} steps run of "
              f"{epochs * steps_per_epoch})", flush=True)

        if conditional:
            # classification by likelihood: argmax_y logp(x | y)
            @jax.jit
            def class_lp(x_int, k, params=best_params, icnf_eval=icnf_eval):
                y, _ = datasets.dequantize_logit(x_int, k, alpha=ALPHA)
                v = (y - m) / s

                def lp_for(c):
                    ys = jnp.broadcast_to(
                        jax.nn.one_hot(c, NCLASS, dtype=jnp.float32),
                        (v.shape[0], NCLASS),
                    )
                    lp, _a, _s2 = cnf.inference(icnf_eval, Mode.TEST, v,
                                                params, ys=ys)
                    return lp

                return jnp.stack([lp_for(c) for c in range(NCLASS)], axis=1)

            lps = class_lp(x_te, k_ev)
            acc = float(jnp.mean((jnp.argmax(lps, axis=1) == lab_te)))
            print(f"         likelihood-classification accuracy: {acc:.3f} "
                  f"(chance 0.1)", flush=True)
            results["acc"] = acc

    # label-matched Gaussian baseline: per-class diagonal Gaussians
    y_te_l, ldj_te = datasets.dequantize_logit(x_te, jax.random.PRNGKey(9),
                                               alpha=ALPHA)
    lp_g = jnp.zeros(x_te.shape[0])
    for c in range(NCLASS):
        tr_mask = np.asarray(lab_tr) == c
        te_mask = np.asarray(lab_te) == c
        if tr_mask.sum() and te_mask.sum():
            lp_c = datasets.diagonal_gaussian_logp(y0[tr_mask], y_te_l[te_mask])
            lp_g = lp_g.at[np.where(te_mask)[0]].set(lp_c)
    bpd_gauss = float(jnp.mean(
        datasets.quantized_bits_per_dim(lp_g, ldj_te, D)
    ))
    print(f"per-class Gaussian baseline: {bpd_gauss:.4f} bits/dim", flush=True)
    print(f"\nFINAL: cond {results['cond']:.4f} vs uncond {results['uncond']:.4f} "
          f"(conditioning gain {results['uncond']-results['cond']:+.4f}) vs "
          f"class-Gaussian {bpd_gauss:.4f}; likelihood-cls acc "
          f"{results.get('acc', float('nan')):.3f}", flush=True)


if __name__ == "__main__":
    main()
