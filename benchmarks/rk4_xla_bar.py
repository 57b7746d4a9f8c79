"""What XLA makes of the plain fixed-step train step on the card.

The bar a hand-written whole-solve kernel (rk4 + backprop in one kernel) has
to beat end to end: the d=2 rk4-32 backprop train step (loss + gradient +
Adam) at batch 65,536 for hidden widths 24 and 128, timed with the profiler
off, then traced for a few steps to count the device kernels per step and
the device's busy share.

    python benchmarks/rk4_xla_bar.py [--hidden 24 128] [--precision default highest]

Needs a GPU; prints one line per (width, precision), each with the card's
power limit.
"""

import argparse
import glob
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax
import numpy as np
import optax

import continuousnormalizingflows_tpu as cnf
from continuousnormalizingflows_tpu.config import Mode, SolverConfig
from continuousnormalizingflows_tpu.models.nets import MLP
from continuousnormalizingflows_tpu.utils import datasets, profiling
from continuousnormalizingflows_tpu.utils.compile_cache import enable_compile_cache

BATCH = 65536
STEPS = 20  # steps per timed window (best of 3 windows)
TRACED_STEPS = 3


def device_events(xplane_path):
    """``(name, start_ns, duration_ns)`` of every kernel event on the GPU
    planes' stream lines."""
    pd = jax.profiler.ProfileData.from_file(xplane_path)
    out, seen = [], []
    for plane in pd.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            seen.append(f"{plane.name}/{line.name}")
            if not line.name.startswith("Stream"):
                continue
            out += [(e.name, e.start_ns, e.duration_ns) for e in line.events]
    if not out:
        raise RuntimeError(f"no kernel events on GPU stream lines; lines: {seen}")
    return out


def busy_ns(events):
    """Union length of the events' intervals."""
    total, end = 0.0, -np.inf
    for _, s, d in sorted(events, key=lambda e: e[1]):
        if s >= end:
            total += d
            end = s + d
        elif s + d > end:
            total += s + d - end
            end = s + d
    return total


def measure(hidden, precision, power_limit_w):
    cfg = cnf.ICNFConfig(
        nvariables=2,
        solver=SolverConfig(method="rk4", gradient="backprop", fixed_steps=32),
    )
    icnf = cnf.ICNF(
        config=cfg,
        net=MLP((cfg.n_in, hidden, hidden, cfg.n_out), precision=precision),
    )
    opt = optax.adam(1e-3)
    params = icnf.init(jax.random.PRNGKey(0))
    opt_state = opt.init(params)
    x = datasets.gaussian_mixture(jax.random.PRNGKey(1), BATCH)

    @jax.jit
    def step(params, opt_state, key):
        key, k = jax.random.split(key)
        l, g = jax.value_and_grad(
            lambda p: cnf.loss(icnf, Mode.TRAIN, x, p, key=k)
        )(params)
        updates, opt_state = opt.update(g, opt_state)
        return optax.apply_updates(params, updates), opt_state, key, l

    key = jax.random.PRNGKey(2)
    t0 = time.perf_counter()
    params, opt_state, key, l = step(params, opt_state, key)
    jax.block_until_ready(l)
    compile_s = time.perf_counter() - t0
    for _ in range(3):
        params, opt_state, key, l = step(params, opt_state, key)
    jax.block_until_ready(l)
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        for _ in range(STEPS):
            params, opt_state, key, l = step(params, opt_state, key)
        jax.block_until_ready(l)
        times.append((time.perf_counter() - t0) / STEPS)

    with tempfile.TemporaryDirectory() as logdir:
        with profiling.trace(logdir):
            t0 = time.perf_counter()
            for _ in range(TRACED_STEPS):
                params, opt_state, key, l = step(params, opt_state, key)
            jax.block_until_ready(l)
            window_ns = (time.perf_counter() - t0) * 1e9
        (path,) = glob.glob(os.path.join(logdir, "**", "*.xplane.pb"),
                            recursive=True)
        events = device_events(path)
    print(
        f"h={hidden} precision={precision} batch={BATCH} power limit "
        f"{power_limit_w} W: step "
        f"{1e3 * min(times):.3f} ms (reps {[round(1e3 * t, 3) for t in times]}), "
        f"{BATCH / min(times):.4g} samples/s, compile {compile_s:.1f} s; "
        f"traced {TRACED_STEPS} steps: {len(events) / TRACED_STEPS:.0f} device "
        f"kernels/step, {len(set(n for n, _, _ in events))} distinct, device "
        f"busy {busy_ns(events) / TRACED_STEPS / 1e6:.3f} ms/step = "
        f"{100 * busy_ns(events) / window_ns:.1f}% of the traced window, "
        f"loss {float(l):.4f}",
        flush=True,
    )


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--hidden", type=int, nargs="+", default=[24, 128])
    ap.add_argument("--precision", nargs="+", default=["default", "highest"])
    args = ap.parse_args()
    profiling.require_gpu()
    smi = profiling.nvidia_smi_identity()
    print(f"device: {profiling.device_record()} | nvidia-smi: {smi}", flush=True)
    _name, power_limit_w = profiling.parse_smi_line(smi.splitlines()[0])
    enable_compile_cache()
    for h in args.hidden:
        for p in args.precision:
            measure(h, p, power_limit_w)


if __name__ == "__main__":
    main()
