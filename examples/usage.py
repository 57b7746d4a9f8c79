"""End-to-end usage example — mirror of the reference ``examples/usage.jl``.

Fits the reference's example task (1-D Beta(2,4), n=1024, default augmented
RNODE with STEER) with the reference-default optimizer, saves/loads the fitted
model, evaluates the density against the truth, draws samples, and plots.

Run:  JAX_PLATFORMS=cpu python examples/usage.py        (CPU)
      python examples/usage.py                          (GPU)
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax
import jax.numpy as jnp
import numpy as np

import continuousnormalizingflows_tpu as cnf
from continuousnormalizingflows_tpu.config import Mode, SolverConfig
from continuousnormalizingflows_tpu.utils import datasets, load_checkpoint, save_checkpoint

# ---- Data (usage.jl "Data" block) -----------------------------------------
ndata = 1024
r = datasets.beta_samples(jax.random.PRNGKey(0), ndata)  # (1024, 1)
nvariables = r.shape[1]

# ---- Model (usage.jl "Model" block — all reference defaults) --------------
icnf = cnf.ICNF.create(
    nvariables=nvariables,
    naugments=nvariables + 1,     # augmented flow (ANODE)
    nconditions=0,
    lambda_1=0.01,                # regulate flow (kinetic energy)
    lambda_2=0.01,                # regulate volume change (Jacobian norm)
    lambda_3=0.01,                # regulate augmented dimensions
    steer_rate=0.1,               # STEER: randomize end time
    tspan=(0.0, 1.0),
    autonomous=False,             # non-autonomous flow (t concatenated)
    trace=cnf.TraceEstimator.HUTCH_VJP,  # batched VJP Hutchinson (reference default)
    solver=SolverConfig(method="rk4", gradient="backprop", fixed_steps=32),
)

# ---- Fit It (usage.jl "Fit It" block) -------------------------------------
ckpt = os.path.join(os.path.dirname(__file__), "icnf-machine")
if not os.path.isdir(ckpt):
    model = cnf.ICNFModel(
        icnf,
        batchsize=1024,
        epochs=300,
        key=jax.random.PRNGKey(1),
        log_every=64,
        callback=lambda it, l: print(f"Iteration: {it} | Loss: {l:.4f}"),
    )
    result = model.fit(r)
    save_checkpoint(ckpt, result.params, step=result.stats["iterations"])
    print("fit stats:", result.stats)
params, _opt, _step = load_checkpoint(ckpt)  # load it

# ---- Use It ---------------------------------------------------------------
d = cnf.ICNFDist(icnf, params, mode=Mode.TEST)
actual_pdf = np.asarray(datasets.beta_pdf(r[:, 0]))
estimated_pdf = np.asarray(d.pdf(r))
new_data = d.sample(jax.random.PRNGKey(2), ndata)
# fast sampling (bare-field integration — same distribution, skips the
# per-step trace estimate) and one-solve (sample, logpdf) pairs:
fast_data = d.sample(jax.random.PRNGKey(2), ndata, trace_free=True)
pairs, pair_logp = d.sample_with_logpdf(jax.random.PRNGKey(3), 8)

# ---- Evaluate It ----------------------------------------------------------
mad_ = float(np.mean(np.abs(estimated_pdf - actual_pdf)))
msd_ = float(np.mean((estimated_pdf - actual_pdf) ** 2))
tv_dis = float(np.sum(np.abs(estimated_pdf - actual_pdf)) / ndata)
print(f"mad={mad_:.4f}  msd={msd_:.4f}  tv={tv_dis:.4f}")
print(
    "note: with augmentation (naugments>0, the reference default) the reported "
    "density is the zero-padded joint slice and is NOT normalized over x, so "
    "these metrics are not comparable to the true pdf (the reference prints the "
    "same comparison and never asserts on it); set naugments=0 for calibrated "
    "densities"
)
print(f"sample mean={float(jnp.mean(new_data)):.4f} (Beta(2,4) mean={1/3:.4f})")

# ---- Plot It --------------------------------------------------------------
try:
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    grid = np.linspace(0.0, 1.0, 256)
    fig, ax = plt.subplots()
    ax.set_title("Result")
    ax.plot(grid, np.asarray(datasets.beta_pdf(jnp.asarray(grid))), label="Actual")
    ax.plot(grid, np.asarray(d.pdf(grid[:, None])), label="Estimated")
    ax.legend()
    fig.savefig(os.path.join(os.path.dirname(__file__), "result-figure.png"), dpi=120)
    print("wrote result-figure.png")

    # flow paths x -> z over integration time (dense-output interpolation)
    ts = jnp.linspace(0.0, 1.0, 33)
    path, _nfe = cnf.trajectory(icnf, r[::8], params, ts)  # (T, b, nz)
    fig2, ax2 = plt.subplots()
    ax2.set_title("Flow trajectories z(t)")
    ax2.set_xlabel("t")
    for i in range(path.shape[1]):
        ax2.plot(np.asarray(ts), np.asarray(path[:, i, 0]), lw=0.8)
    fig2.savefig(os.path.join(os.path.dirname(__file__), "trajectories.png"), dpi=120)
    print("wrote trajectories.png")
except ImportError:
    print("matplotlib not available; skipping plot")

# ---- Round-4 extras: custom base distribution + serving export ------------
# Pluggable base (the reference's `basedist` argument): refit with a
# heavy-tailed logistic base — one constructor kwarg.
from continuousnormalizingflows_tpu import distributions as dists

icnf_log = cnf.ICNF.create(
    nvariables=1, naugments=0, lambda_3=0.0,
    base_dist=dists.logistic(), solver=icnf.config.solver,
)
res_log = cnf.ICNFModel(icnf_log, batchsize=0, epochs=60,
                        key=jax.random.PRNGKey(5)).fit(r)
print("logistic-base final loss:", res_log.stats["final_loss"])

# Serving export: the fitted flow as a standalone StableHLO artifact —
# a serving process needs only jax.export.deserialize (no model code).
from continuousnormalizingflows_tpu.utils import export as cnf_export

artifact_path = os.path.join(os.path.dirname(__file__), "model.cnfx")
cnf_export.save_artifact(artifact_path, cnf_export.export_logpdf(icnf, params))
logp_served = cnf_export.load_artifact(artifact_path).call(r)
print("served logp matches:", bool(jnp.allclose(
    logp_served, cnf.log_prob(icnf, cnf.Mode.TEST, r, params), atol=1e-5)))
os.remove(artifact_path)

# ---- Round-5 extras: validated fit + pluggable steering ------------------
# Validation-based training control (beyond the reference's fixed-epochs
# fit): held-out val NLL every eval_every epochs, best-val params, early
# stopping — the measured-necessary pattern for small real datasets.
r_val = datasets.beta_samples(jax.random.PRNGKey(9), 256)
model_v = cnf.ICNFModel(icnf_log, batchsize=0, epochs=120,
                        key=jax.random.PRNGKey(6))
res_v = model_v.fit(r, validation_data=r_val, eval_every=10, patience=3)
print(f"validated fit: best val NLL {res_v.best_val_nll:.3f} at epoch "
      f"{res_v.best_epoch} ({res_v.stats['epochs_run']} of 120 epochs run); "
      f"test-style score at best params: "
      f"{model_v.score(r_val, res_v.best_params):.3f}")

# Pluggable steering distribution (the reference's `steerdist` field):
# steer the end time with any sampler, not just Uniform(-rate, rate).
icnf_steer = cnf.ICNF.create(
    nvariables=1, steer_rate=0.0,
    steer_dist=dists.uniform_probe(),  # any object with a sample_fn
    solver=icnf.config.solver,
)
l = cnf.loss(icnf_steer, cnf.Mode.TRAIN, r[:128],
             icnf_steer.init(jax.random.PRNGKey(7)), key=jax.random.PRNGKey(8))
print("custom-steerdist train loss:", float(l))
