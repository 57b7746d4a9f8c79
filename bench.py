"""Benchmark harness — prints ONE JSON line.

Flagship config (BASELINE.md config 1): 2-D ring-of-Gaussians RNODE with
Hutchinson-VJP trace, reference-default hyperparameters, measuring

* ``train_samples_per_sec_per_chip`` — full train step (loss + grad + Adam)
  throughput, and
* NFE-normalized log-prob evals/s on the TestMode exact-trace path
  (reported in the auxiliary fields).

Runs on one NVIDIA GPU and refuses anything else: a CPU time is not a device
metric.  MFU divides by the peak of the arithmetic each row runs (``PEAKS``).

    python bench.py
"""

import json
import time

import jax
import jax.numpy as jnp
import optax

import continuousnormalizingflows_tpu as cnf
from continuousnormalizingflows_tpu.config import Mode, SolverConfig
from continuousnormalizingflows_tpu.utils import datasets, profiling
from continuousnormalizingflows_tpu.utils.compile_cache import enable_compile_cache

BATCH = 65536
EVAL_BATCH = 4096
TRAIN_STEPS = 20

# Dense peak rates per card, keyed by JAX's device_kind.  Source: NVIDIA H100
# Tensor Core GPU data sheet, SXM5 part, without sparsity, at the 700 W power
# limit (a card set below it cannot hold these clocks under load).
PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "bf16_tflops": 989.0,
        "tf32_tflops": 495.0,
        "fp32_tflops": 67.0,
        "hbm_tb_per_s": 3.35,
    },
}


def peaks_for(device_kind: str) -> dict:
    """The peak table row of ``device_kind``; an unknown card is an error."""
    if device_kind not in PEAKS:
        raise KeyError(
            f"no peak rates on record for {device_kind!r}; add the card's "
            "data-sheet numbers to bench.PEAKS"
        )
    return PEAKS[device_kind]


def bench_train(icnf, params, x, carry=False):
    """Time TRAIN_STEPS optimizer steps executed as ONE device program.

    The whole timed window is a single jitted ``lax.scan``, so host dispatch
    stays out of the window.  Three reps, best-of.

    ``carry=True`` threads the previous step's accepted dt into each solve
    (the ``SolverConfig.dt0 == "carry"`` warm start) — what ``ICNFModel``
    does automatically for carry configs.
    """
    opt = optax.adam(1e-3)
    opt_state = opt.init(params)

    def step(carry_state, i):
        params, opt_state, key, dt = carry_state
        key, k = jax.random.split(key)
        (l, stats), grads = jax.value_and_grad(
            lambda p: cnf.loss_with_stats(
                icnf, Mode.TRAIN, x, p, key=k, dt0=dt if carry else None
            ),
            has_aux=True,
        )(params)
        updates, opt_state = opt.update(grads, opt_state)
        dt = jnp.abs(stats.dt_final) if carry else dt
        return (optax.apply_updates(params, updates), opt_state, key, dt), (
            l, stats.nfe,
        )

    @jax.jit
    def run(params, opt_state, key):
        (params, opt_state, _key, _dt), (losses, nfes) = jax.lax.scan(
            step, (params, opt_state, key, jnp.zeros((), jnp.float32)),
            jnp.arange(TRAIN_STEPS)
        )
        return params, opt_state, losses[-1], nfes[-1]

    key = jax.random.PRNGKey(0)
    # warmup/compile
    _p, _o, l, nfe = run(params, opt_state, key)
    jax.block_until_ready(l)
    times = []
    for rep in range(3):
        t0 = time.perf_counter()
        _p, _o, l, nfe = run(params, opt_state, jax.random.PRNGKey(rep))
        jax.block_until_ready(l)
        times.append((time.perf_counter() - t0) / TRAIN_STEPS)
    best = min(times)
    # the forward-solve NFE of the LAST step — attribution aux: a throughput
    # drift with unchanged NFE is dispatch/kernel time, with changed NFE it
    # is solver behavior
    return BATCH / best, float(l), int(nfe), times


def bench_eval(icnf_eval, params, x):
    reps = 5

    @jax.jit
    def ev(params):
        def body(carry, _):
            lp, _augs, stats = cnf.inference(icnf_eval, Mode.TEST, x, params)
            return carry, (lp[0], stats.nfe)

        _, (lps, nfes) = jax.lax.scan(body, 0, jnp.arange(reps))
        return lps, nfes

    lps, nfes = ev(params)
    jax.block_until_ready(lps)
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        lps, nfes = ev(params)
        jax.block_until_ready(lps)
        times.append((time.perf_counter() - t0) / reps)
    best = min(times)
    nfe = int(nfes[-1])
    n = x.shape[0]
    return n / best, nfe, n * nfe / best, times


def spread_pct(times) -> float:
    """Same-session dispersion of the repeated timed drives, as a percent of
    the best rep — the in-run noise bound: a moved metric is a regression
    only if NFE changed or the NFE-normalized rate moved by more than this
    spread."""
    return round(100.0 * (max(times) - min(times)) / min(times), 2)


def mlp_fwd_flops(widths) -> int:
    """Logical matmul FLOPs of ONE forward dynamics-net eval per sample."""
    return 2 * sum(a * b for a, b in zip(widths[:-1], widths[1:]))


def train_mfu(samples_per_sec, nfe, widths, bwd_factor, peak_tflops):
    """Achieved useful FLOP/s of a train path and its fraction of peak
    (dynamics FLOPs x NFE x batch / step time).

    Counted per sample: ``2F`` logical FLOPs per field eval (forward + the
    Hutchinson VJP sweep, each one matmul chain) x forward-solve NFE x
    ``bwd_factor`` (4 for remat'd backprop: primal + recompute + backward;
    3 for the adjoint rows: forward solve + a backward solve of the ~2x-cost
    adjoint system — an estimate, so treat MFU as tracked-trend, not truth).
    Logical FLOPs only: padding and recomputation do not count."""
    tflops = samples_per_sec * nfe * 2 * mlp_fwd_flops(widths) * bwd_factor / 1e12
    return round(tflops, 3), round(100.0 * tflops / peak_tflops, 2)


def main():
    profiling.require_gpu()
    device = profiling.device_record()
    peaks = peaks_for(device["kind"])
    smi = profiling.nvidia_smi_identity()
    enable_compile_cache()
    # headline train path: fixed-step at precision "default" — float32
    # operands in TF32 on the card (stochastic-trace noise dominates the
    # rounding); eval path: fp32 + adaptive 1e-4 (reference tolerances) for
    # density parity.
    icnf = cnf.ICNF.create(
        nvariables=2,
        solver=SolverConfig(method="rk4", gradient="backprop", fixed_steps=32),
        precision="default",
    )
    # reference-parity train path: adaptive dopri5 at the reference tolerances
    # + continuous adjoint + float32 "highest" (both paths are reported so
    # the headline cannot quietly optimize only the easy fixed-step path).
    # dt0 pinned to the fixed 0.01 start so the NFE stays comparable with
    # the rows on record: dt0="auto" helps TRAINED fields but costs its +1
    # probe eval on the near-untrained 20-step field benched here.
    icnf_ref = cnf.ICNF.create(
        nvariables=2,
        solver=SolverConfig(method="dopri5", rtol=1e-4, atol=1e-4,
                            gradient="adjoint", dt0=0.01),
        precision="highest",
    )
    icnf_eval = cnf.ICNF.create(
        nvariables=2,
        solver=SolverConfig(method="dopri5", rtol=1e-4, atol=1e-4, dt0=0.01),
        precision="highest",
    )
    # round-5 capability row: the same reference-parity adaptive stack with
    # the carried starting step (dt0="carry") — each step's solve warm-starts
    # from the previous accepted dt, eliminating the per-solve controller
    # ramp the pinned dt0=0.01 row pays by design
    icnf_carry = cnf.ICNF.create(
        nvariables=2,
        solver=SolverConfig(method="dopri5", rtol=1e-4, atol=1e-4,
                            gradient="adjoint", dt0="carry"),
        precision="highest",
    )
    # the reference's DEFAULT sensitivity stack, solver-class-for-class:
    # VCABM + QuadratureAdjoint (icnf.jl:89-99) = abm + interpolation
    # quadrature adjoint here
    icnf_abm = cnf.ICNF.create(
        nvariables=2,
        solver=SolverConfig(method="abm", rtol=1e-4, atol=1e-4,
                            gradient="quadrature"),
        precision="highest",
    )
    params = icnf.init(jax.random.PRNGKey(0))
    x = datasets.gaussian_mixture(jax.random.PRNGKey(1), BATCH)

    train_sps, final_loss, nfe_fixed, t_head = bench_train(icnf, params, x)
    ref_sps, _ref_loss, ref_nfe, t_ref = bench_train(icnf_ref, params, x)
    carry_sps, _c_loss, carry_nfe, t_carry = bench_train(
        icnf_carry, params, x, carry=True
    )
    abm_sps, _abm_loss, abm_nfe, t_abm = bench_train(icnf_abm, params, x)
    eval_sps, nfe, dyn_evals_ps, t_ev = bench_eval(
        icnf_eval, params, datasets.gaussian_mixture(jax.random.PRNGKey(2), EVAL_BATCH)
    )

    print(f"device: {device} | nvidia-smi: {smi}", flush=True)
    print(
        json.dumps(
            {
                "metric": "train_samples_per_sec_per_chip",
                "value": round(train_sps, 1),
                "unit": "samples/s/chip",
                "aux": {
                    "train_adaptive_fp32_samples_per_sec": round(ref_sps, 1),
                    "train_adaptive_nfe": ref_nfe,
                    "train_abm_quadrature_samples_per_sec": round(abm_sps, 1),
                    "train_abm_nfe": abm_nfe,
                    "train_adaptive_carry_samples_per_sec": round(carry_sps, 1),
                    "carry_vs_adaptive_fixed_ramp": round(carry_sps / ref_sps, 3),
                    "train_carry_nfe": carry_nfe,
                    "testmode_logprob_evals_per_sec": round(eval_sps, 1),
                    "testmode_nfe": nfe,
                    "dynamics_evals_per_sec": round(dyn_evals_ps, 1),
                    # same-session rep spreads (% of best) — the in-run noise
                    # bound
                    "spread_pct": {
                        "headline": spread_pct(t_head),
                        "adaptive_fp32": spread_pct(t_ref),
                        "abm_quadrature": spread_pct(t_abm),
                        "adaptive_carry": spread_pct(t_carry),
                        "testmode": spread_pct(t_ev),
                    },
                    # NFE-normalized series (dynamics evals/s)
                    "adaptive_dyn_evals_per_sec": round(ref_sps * ref_nfe, 1),
                    "abm_dyn_evals_per_sec": round(abm_sps * abm_nfe, 1),
                    # achieved useful FLOP/s + fraction of the card's peak
                    # for the arithmetic the row runs (train_mfu docstring):
                    # the headline runs TF32, the adaptive row float32
                    "mfu": dict(
                        zip(
                            ("headline_tflops", "headline_mfu_pct"),
                            train_mfu(train_sps, nfe_fixed, icnf.net.widths,
                                      4, peaks["tf32_tflops"]),
                        )
                    ) | dict(
                        zip(
                            ("adaptive_tflops", "adaptive_mfu_pct"),
                            train_mfu(ref_sps, ref_nfe, icnf_ref.net.widths,
                                      3, peaks["fp32_tflops"]),
                        )
                    ),
                    "train_loss": round(final_loss, 4),
                    "batch": BATCH,
                    "device": device,
                    "nvidia_smi": smi,
                    "power_limit_w": profiling.parse_smi_line(
                        smi.splitlines()[0]
                    )[1],
                },
            }
        )
    )


if __name__ == "__main__":
    main()
