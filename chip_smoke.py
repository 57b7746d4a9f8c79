"""On-card smoke run of the CNF trainer's main path.

    python chip_smoke.py               # one GPU: flagship, full width, export
    python chip_smoke.py --four-cards  # four GPUs: the mesh paths only

Every phase goes through the public API (``ICNF.create`` -> ``ICNFModel.fit``
-> ``ICNFDist`` / ``log_prob`` -> ``utils.export``) and checks what it got.
Results that can be compared are compared with the same call on the host
CPU in this process (float32, precision "highest").  A failed check raises;
nothing is caught and turned into a pass.  The last line of standard output
is one JSON object, ``{"ok": true, "device": {...}}``, and it is printed only
when every phase passed.  With no GPU the script exits non-zero and prints
no result.

The phases are importable functions that take their sizes as arguments, so
the CPU tests (tests/test_chip_smoke.py) run the same code at tiny sizes.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from typing import Any, Dict, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

import continuousnormalizingflows_tpu as cnf
from continuousnormalizingflows_tpu import parallel
from continuousnormalizingflows_tpu.config import Mode, SolverConfig
from continuousnormalizingflows_tpu.models.nets import MLP
from continuousnormalizingflows_tpu.train import ICNFModel
from continuousnormalizingflows_tpu.utils import datasets, export, profiling
from continuousnormalizingflows_tpu.utils.compile_cache import enable_compile_cache

# GPU vs host-CPU log-density agreement: 10x the solver's atol (1e-4), since
# the two backends may accept slightly different step sequences.
LOGP_TOL = 1e-3
# a deserialized export runs the same program as the in-process call
EXPORT_TOL = 1e-5
# sharded vs one-card loss and gradients (a changed reduction order may
# flip no accept decision of the adaptive controller)
MESH_RTOL = 1e-4


class SmokeFailure(RuntimeError):
    """A phase's check did not hold."""


def log(*parts) -> None:
    print(*parts, flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)


def result_line(device: Dict[str, Any]) -> str:
    """The exact last line of a passing run."""
    return json.dumps({"ok": True, "device": device})


def host_cpu() -> jax.Device:
    return jax.devices("cpu")[0]


def _finite(x) -> bool:
    return bool(np.all(np.isfinite(np.asarray(x))))


def _max_abs_diff(a, b) -> float:
    return float(np.max(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64))))


def _on_device(device: jax.Device, fn, *arrays):
    """Run ``fn(*arrays)`` with the arrays committed to ``device`` and
    ``device`` as the default for whatever ``fn`` creates."""
    with jax.default_device(device):
        return fn(*jax.device_put(arrays, device))


def _fit_steps(model: ICNFModel, x, steps: int, label: str):
    """``steps`` full-batch ``fit`` calls, warm-started from each other, so
    each step's loss and forward NFE are on record."""
    res = None
    for i in range(steps):
        kw = {} if res is None else dict(
            params=res.params, opt_state=res.opt_state, key=res.key
        )
        res = model.fit(x, **kw)
        loss, nfe = res.stats["final_loss"], res.stats["nfe"]
        log(f"{label} step {i}: loss {loss:.6f} forward NFE {nfe}")
        check(np.isfinite(loss), f"{label} step {i}: loss {loss}")
    return res


def _peak_bytes(device: jax.Device) -> Optional[int]:
    stats = device.memory_stats()
    return None if stats is None else stats.get("peak_bytes_in_use")


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def flagship_phase(batch: int, steps: int, eval_n: int,
                   ref_device: Optional[jax.Device] = None) -> Dict[str, Any]:
    """The reference-default stack: 2-D RNODE, dopri5 at 1e-4, continuous
    adjoint, precision "highest", fitted on the ring of Gaussians."""
    ref_device = ref_device or host_cpu()
    icnf = cnf.ICNF.create(nvariables=2)
    x = datasets.gaussian_mixture(jax.random.PRNGKey(1), batch)
    model = ICNFModel(icnf, batchsize=0, epochs=1, key=jax.random.PRNGKey(0))
    res = _fit_steps(model, x, steps, "flagship")
    params = res.params

    xe = datasets.gaussian_mixture(jax.random.PRNGKey(2), eval_n)
    dist = cnf.ICNFDist(icnf, params)
    lp = dist.logpdf(xe)
    samples = dist.sample(jax.random.PRNGKey(3), eval_n)
    check(lp.shape == (eval_n,) and _finite(lp), f"logpdf {lp.shape}")
    check(samples.shape == (eval_n, 2) and _finite(samples),
          f"samples {samples.shape}")
    nfe = int(cnf.inference(icnf, Mode.TEST, xe, params)[2].nfe)

    def ref(p, xx):
        lp_r = cnf.ICNFDist(icnf, p).logpdf(xx)
        return lp_r, int(cnf.inference(icnf, Mode.TEST, xx, p)[2].nfe)

    lp_ref, nfe_ref = _on_device(ref_device, ref, params, xe)
    diff = _max_abs_diff(lp, lp_ref)
    log(f"flagship logpdf on {eval_n} rows: mean {float(jnp.mean(lp)):.6f} "
        f"max |device - host CPU| {diff:.3e} nats (tol {LOGP_TOL:g}); "
        f"TestMode NFE device {nfe} host CPU {nfe_ref}")
    log(f"flagship sample on {eval_n} points: mean "
        f"{np.asarray(jnp.mean(samples, axis=0)).round(4).tolist()}")
    check(diff <= LOGP_TOL, f"flagship logpdf differs from host CPU by {diff}")

    # bench.py's TestMode row (dt0=0.01, init params): its NFE on the card
    # and on the host CPU, which should not differ
    icnf_b = cnf.ICNF.create(
        nvariables=2, solver=SolverConfig(method="dopri5", dt0=0.01)
    )
    p0 = icnf_b.init(jax.random.PRNGKey(0))

    def bench_nfe(p, xx):
        return int(cnf.inference(icnf_b, Mode.TEST, xx, p)[2].nfe)

    nfe_b, nfe_b_ref = bench_nfe(p0, xe), _on_device(ref_device, bench_nfe, p0, xe)
    log(f"bench.py TestMode row on {eval_n} rows: NFE device {nfe_b} "
        f"host CPU {nfe_b_ref}")
    return {"icnf": icnf, "params": params, "x_eval": xe, "nfe": nfe,
            "nfe_ref": nfe_ref, "logp_diff": diff,
            "nfe_bench_row": (nfe_b, nfe_b_ref)}


def image_flow(side: int, hidden: int, precision: str, nprobes: int = 1,
               probe_axis: Optional[str] = None):
    """The image-scale flow (benchmarks/image_bitsdim.py) at ``side``: an
    RNODE-regularized MLP field (d, h, h, d), d = side², trained with rk4-24
    backprop, and its eval twin (dopri5 1e-4, analytic exact trace,
    "highest")."""
    d = side * side
    cfg = cnf.ICNFConfig(
        nvariables=d, naugments=0, lambda_1=0.01, lambda_2=0.01, lambda_3=0.0,
        steer_rate=0.0, nprobes=nprobes, probe_axis=probe_axis,
        solver=SolverConfig(method="rk4", gradient="backprop", fixed_steps=24),
    )
    net = MLP((cfg.n_in, hidden, hidden, cfg.n_out), precision=precision)
    cfg_eval = dataclasses.replace(
        cfg, nprobes=1, probe_axis=None,
        solver=SolverConfig(method="dopri5", rtol=1e-4, atol=1e-4),
    )
    icnf_eval = cnf.ICNF(config=cfg_eval, net=MLP(net.widths, precision="highest"))
    return cnf.ICNF(config=cfg, net=net), icnf_eval


def full_width_phase(side: int, hidden: int, batch: int, steps: int,
                     eval_n: int,
                     ref_device: Optional[jax.Device] = None) -> Dict[str, Any]:
    """The widest supported model: trained once at "highest" and once at
    "default" (TF32 on the card) from the same init, data and probes."""
    ref_device = ref_device or host_cpu()
    d = side * side
    x = datasets.smooth_image_mixture(jax.random.PRNGKey(1), batch * steps, side)
    xe = datasets.smooth_image_mixture(jax.random.PRNGKey(2), eval_n, side)
    lps = {}
    for precision in ("highest", "default"):
        icnf, icnf_eval = image_flow(side, hidden, precision)
        model = ICNFModel(
            icnf, optimizer=cnf.default_optimizer(clip_norm=1.0),
            batchsize=batch, epochs=1, key=jax.random.PRNGKey(3), log_every=1,
            callback=lambda i, l, p=precision: log(
                f"full-width[{p}] step {i}: loss {l:.4f}"),
        )
        res = model.fit(x)
        check(np.isfinite(res.stats["final_loss"]) and
              res.stats["iterations"] == steps,
              f"full-width[{precision}] fit {res.stats}")
        n_params = sum(int(p.size) for p in jax.tree_util.tree_leaves(res.params))
        log(f"full-width[{precision}] widths {icnf.net.widths} params {n_params} "
            f"batch {batch} peak bytes in use "
            f"{_peak_bytes(jax.devices()[0])}")
        lp, _augs, stats = cnf.inference(icnf_eval, Mode.TEST, xe, res.params)
        check(lp.shape == (eval_n,) and _finite(lp), f"full-width[{precision}] logp")
        lps[precision] = (lp, int(stats.nfe), res.params, icnf_eval)

    lp, nfe, params, icnf_eval = lps["highest"]
    lp_ref = _on_device(
        ref_device, lambda p, xx: cnf.log_prob(icnf_eval, Mode.TEST, xx, p),
        params, xe,
    )
    diff = _max_abs_diff(lp, lp_ref)
    bpd = float(datasets.nats_to_bits_per_dim(-jnp.mean(lp), d))
    true_bpd = float(datasets.nats_to_bits_per_dim(
        -jnp.mean(datasets.smooth_image_mixture_logpdf(xe, side)), d))
    tf32 = _max_abs_diff(lp, lps["default"][0])
    log(f"full-width TestMode log_prob on {eval_n} rows: NFE {nfe}, "
        f"bits/dim {bpd:.6f} (true density {true_bpd:.6f}); "
        f"max |device - host CPU| {diff:.3e} nats (tol {LOGP_TOL:g})")
    log(f"full-width trained at default vs highest: max |dlogp| {tf32:.3e} "
        f"nats, TestMode NFE {lps['default'][1]} vs {nfe}")
    check(diff <= LOGP_TOL, f"full-width log_prob differs from host CPU by {diff}")
    return {"logp_diff": diff, "bits_per_dim": bpd, "true_bits_per_dim": true_bpd,
            "tf32_logp_diff": tf32, "nfe": nfe}


def export_phase(icnf, params, x) -> Dict[str, Any]:
    """Export the TestMode log-density for the default platform and run the
    artifact on the default device; it must equal the in-process ``logpdf``.
    (Writing it to bytes needs the ``flatbuffers`` package, which a card
    host need not have; tests/test_export.py covers that round trip.)"""
    exported = export.export_logpdf(icnf, params)
    lp = exported.call(x)
    lp_in = cnf.ICNFDist(icnf, params).logpdf(x)
    diff = _max_abs_diff(lp, lp_in)
    log(f"export: platforms {exported.platforms}, "
        f"max |artifact - in-process| {diff:.3e} (tol {EXPORT_TOL:g})")
    check(diff <= EXPORT_TOL, f"exported logpdf differs by {diff}")
    return {"export_diff": diff}


def _loss_and_grad(icnf):
    def step(params, opt_state, key, xs, ys):
        return jax.value_and_grad(
            lambda p: cnf.loss(icnf, Mode.TRAIN, xs, p, key=key)
        )(params)

    return step


def _compare_step(label: str, one, sharded) -> Dict[str, float]:
    """Loss and per-leaf gradients, sharded vs one card: relative error in
    the max norm, each within MESH_RTOL."""
    (l1, g1), (ls, gs) = jax.device_get(one), jax.device_get(sharded)
    l_err = abs(float(ls) - float(l1)) / abs(float(l1))
    g_err = max(
        float(np.max(np.abs(b - a)) / np.max(np.abs(a)))
        for a, b in zip(jax.tree_util.tree_leaves(g1), jax.tree_util.tree_leaves(gs))
    )
    log(f"{label}: loss one card {float(l1):.6f} sharded {float(ls):.6f} "
        f"rel err {l_err:.3e}; gradient max rel err {g_err:.3e} "
        f"(rtol {MESH_RTOL:g})")
    check(np.isfinite(float(ls)) and l_err <= MESH_RTOL, f"{label} loss {l_err}")
    check(g_err <= MESH_RTOL, f"{label} gradients {g_err}")
    return {"loss_rel_err": l_err, "grad_rel_err": g_err}


def data_parallel_phase(devices: Sequence[jax.Device], batch: int,
                        steps: int) -> Dict[str, Any]:
    """Data parallel over ``devices`` with the reference-default stack: one
    step's loss and gradients against the unsharded step on ``devices[0]``,
    then ``fit`` steps under the mesh, then carried-dt adaptive steps."""
    key = jax.random.PRNGKey(2)
    icnf = cnf.ICNF.create(nvariables=2)
    mesh = parallel.make_mesh(devices=devices)
    x = datasets.gaussian_mixture(jax.random.PRNGKey(1), batch)
    params = icnf.init(jax.random.PRNGKey(0))
    step = _loss_and_grad(icnf)
    one = jax.jit(step)(*jax.device_put(
        (params, None, key, x, None), jax.sharding.SingleDeviceSharding(devices[0])
    ))
    xs, _ = parallel.shard_batch_arrays(mesh, x)
    sh = parallel.shard_train_step(step, mesh)(
        jax.tree_util.tree_map(jnp.copy, params), None, key, xs, None
    )
    out = _compare_step(f"dp {dict(mesh.shape)}", one, sh)
    _fit_steps(ICNFModel(icnf, mesh=mesh, batchsize=0, epochs=1,
                         key=jax.random.PRNGKey(0)), x, steps, "dp fit")

    # carried starting step: the second step's solves start from the first
    # step's accepted dt
    icnf_c = cnf.ICNF.create(
        nvariables=2, solver=SolverConfig(method="dopri5", dt0="carry")
    )
    res = ICNFModel(icnf_c, mesh=mesh, batchsize=batch // 2, epochs=1,
                    key=jax.random.PRNGKey(3)).fit(x)
    log(f"carry fit under {dict(mesh.shape)}: {res.stats['iterations']} steps, "
        f"loss {res.stats['final_loss']:.6f} NFE {res.stats['nfe']} dt_final "
        f"{res.stats['dt_final']:.4g}")
    check(np.isfinite(res.stats["final_loss"]) and res.stats["dt_final"] > 0,
          f"carry fit {res.stats}")
    return out


def tensor_parallel_phase(devices: Sequence[jax.Device], side: int,
                          hidden: int, batch: int) -> Dict[str, Any]:
    """2 x 2 data x model over four devices: the wide MLP split with
    ``shard_mlp_params`` and a 2-probe ensemble split over ``model``; one
    step's loss and gradients against the unsharded step on ``devices[0]``."""
    key = jax.random.PRNGKey(2)
    icnf, _ = image_flow(side, hidden, "highest", nprobes=2, probe_axis="model")
    icnf_one = cnf.ICNF(
        config=dataclasses.replace(icnf.config, probe_axis=None), net=icnf.net
    )
    mesh = parallel.make_mesh(devices=devices, model=2)
    x = datasets.smooth_image_mixture(jax.random.PRNGKey(1), batch, side)
    params = icnf.init(jax.random.PRNGKey(0))
    one = jax.jit(_loss_and_grad(icnf_one))(*jax.device_put(
        (params, None, key, x, None), jax.sharding.SingleDeviceSharding(devices[0])
    ))
    xs, _ = parallel.shard_batch_arrays(mesh, x)
    with jax.set_mesh(mesh):
        sh = parallel.shard_train_step(
            _loss_and_grad(icnf), mesh, tensor_parallel=True
        )(parallel.shard_mlp_params(mesh, params), None, key, xs, None)
    return _compare_step(f"dp x tp {dict(mesh.shape)}", one, sh)


# ---------------------------------------------------------------------------


def _with_host_cpu() -> None:
    """Keep the CPU backend available beside the GPU for the references."""
    platforms = jax.config.jax_platforms
    if platforms and "cpu" not in platforms.split(","):
        jax.config.update("jax_platforms", platforms + ",cpu")


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the four-card mesh paths")
    args = ap.parse_args(argv)

    _with_host_cpu()
    try:
        devices = profiling.require_gpu()
    except RuntimeError as e:
        raise SmokeFailure(str(e)) from e
    device = profiling.device_record()
    log(f"device: {device}")
    log(f"nvidia-smi: {profiling.nvidia_smi_identity()}")
    log(f"compile cache: {enable_compile_cache()}")

    t0 = time.perf_counter()
    if args.four_cards:
        if len(devices) < 4:
            raise SmokeFailure(f"--four-cards needs 4 GPUs, found {len(devices)}")
        data_parallel_phase(devices[:4], batch=65536, steps=3)
        log(f"data-parallel phase: {time.perf_counter() - t0:.1f} s")
        t1 = time.perf_counter()
        tensor_parallel_phase(devices[:4], side=28, hidden=1024, batch=1024)
        log(f"tensor-parallel phase: {time.perf_counter() - t1:.1f} s")
    else:
        flag = flagship_phase(batch=65536, steps=4, eval_n=4096)
        log(f"flagship phase: {time.perf_counter() - t0:.1f} s")
        t1 = time.perf_counter()
        full_width_phase(side=28, hidden=1024, batch=256, steps=4, eval_n=256)
        log(f"full-width phase: {time.perf_counter() - t1:.1f} s")
        t1 = time.perf_counter()
        export_phase(flag["icnf"], flag["params"], flag["x_eval"])
        log(f"export phase: {time.perf_counter() - t1:.1f} s")
    print(result_line(device), flush=True)


if __name__ == "__main__":
    try:
        main()
    except SmokeFailure as e:
        sys.exit(f"chip_smoke: FAILED: {e}")
