"""Two-process distributed-runtime validation (multi-host mechanism, CPU only).

Spawns N worker processes on this host, each running
``jax.distributed.initialize`` against a local coordinator with one CPU
device per process, builds the global mesh, and runs one sharded ICNF train
step — validating the multi-host wiring (`parallel.initialize_distributed`,
process-spanning mesh, psum gradient reduction) that a multi-host job uses.
The workers are pinned to the CPU: several processes must never share one
GPU (each would reserve most of its memory).

Run: python benchmarks/multiprocess_check.py [--nprocs 2]
"""

import argparse
import os
import subprocess
import sys

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))


def worker(nprocs: int, rank: int, port: int) -> None:
    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax

    jax.config.update("jax_platforms", "cpu")
    sys.path.insert(0, REPO)
    from continuousnormalizingflows_tpu.parallel import initialize_distributed

    initialize_distributed(
        coordinator_address=f"127.0.0.1:{port}",
        num_processes=nprocs,
        process_id=rank,
        local_device_ids=[0],
    )
    import jax.numpy as jnp
    import optax

    import continuousnormalizingflows_tpu as cnf
    from continuousnormalizingflows_tpu.config import Mode, SolverConfig
    from continuousnormalizingflows_tpu.parallel import data_sharding, make_mesh, shard_train_step

    assert jax.process_count() == nprocs, jax.process_count()
    mesh = make_mesh()
    assert mesh.devices.size == nprocs

    icnf = cnf.ICNF.create(
        nvariables=2,
        solver=SolverConfig(method="rk4", gradient="backprop", fixed_steps=8),
    )
    params = icnf.init(jax.random.PRNGKey(0))
    opt = optax.adam(1e-3)
    opt_state = opt.init(params)

    def step(params, opt_state, key, xs, ys):
        l, grads = jax.value_and_grad(
            lambda p: cnf.loss(icnf, Mode.TRAIN, xs, p, key=key)
        )(params)
        updates, opt_state = opt.update(grads, opt_state)
        return optax.apply_updates(params, updates), opt_state, l

    fn = shard_train_step(step, mesh, conditional=False)
    # global batch assembled from per-process shards
    per = 8
    local = 0.5 * jax.random.normal(jax.random.PRNGKey(rank + 1), (per, 2))
    global_shape = (per * nprocs, 2)
    xb = jax.make_array_from_process_local_data(
        data_sharding(mesh), local, global_shape
    )
    params, opt_state, l = fn(params, opt_state, jax.random.PRNGKey(9), xb, None)
    jax.block_until_ready(l)
    print(f"[rank {rank}] loss={float(l):.5f} procs={jax.process_count()} OK", flush=True)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--nprocs", type=int, default=2)
    ap.add_argument("--port", type=int, default=39731)
    ap.add_argument("--rank", type=int, default=None, help="(internal)")
    args = ap.parse_args()

    if args.rank is not None:
        worker(args.nprocs, args.rank, args.port)
        return

    procs = [
        subprocess.Popen(
            [sys.executable, os.path.abspath(__file__),
             "--nprocs", str(args.nprocs), "--port", str(args.port),
             "--rank", str(r)],
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
        )
        for r in range(args.nprocs)
    ]
    ok = True
    for r, p in enumerate(procs):
        out, _ = p.communicate(timeout=900)
        text = out.decode()
        tail = "\n".join(text.strip().splitlines()[-3:])
        print(f"--- rank {r} (exit {p.returncode}) ---\n{tail}")
        ok &= p.returncode == 0 and "OK" in text
    print("MULTIPROCESS CHECK:", "PASS" if ok else "FAIL")
    sys.exit(0 if ok else 1)


if __name__ == "__main__":
    main()
