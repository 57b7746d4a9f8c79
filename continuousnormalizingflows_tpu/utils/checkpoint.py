"""Checkpoint / resume.

The reference only persists fitted models via MLJ machine serialization
(``fitresult = (ps, st)``; examples/usage.jl:79-103) and has no mid-training
resume.  Here checkpoints cover params + optimizer state + step, enabling the
failure-recovery story a multi-host accelerator job needs (SURVEY.md §5): save
periodically, restart from the latest on preemption.

Backends: plain numpy-pickle (default — fast, single-host) and Orbax
(``use_orbax=True``; the JAX-ecosystem standard, async-capable and multi-host
aware — opt-in because tensorstore's many tiny fsyncs can take minutes on
slow network filesystems).  Both write a ``meta.json`` with the step and the backend used, and
:func:`load_checkpoint` auto-detects.
"""

from __future__ import annotations

import json
import os
import pickle
import threading
from typing import Any, Optional, Tuple

import jax
import numpy as np

__all__ = ["save_checkpoint", "load_checkpoint", "AsyncCheckpointer"]

Pytree = Any


def _orbax():
    try:
        import orbax.checkpoint as ocp

        return ocp
    except Exception:  # pragma: no cover - environment without orbax
        return None


def save_checkpoint(
    path: str,
    params: Pytree,
    opt_state: Pytree = None,
    step: int = 0,
    use_orbax: Optional[bool] = None,
) -> None:
    """Write ``{params, opt_state, step}`` to ``path`` (a directory)."""
    path = os.path.abspath(path)
    os.makedirs(path, exist_ok=True)
    ocp = _orbax() if use_orbax else None
    payload = {"params": params}
    if opt_state is not None:
        payload["opt_state"] = opt_state

    backend = "pickle"
    if ocp is not None:
        try:
            with ocp.PyTreeCheckpointer() as ckptr:
                ckptr.save(os.path.join(path, "state"), payload, force=True)
            backend = "orbax"
        except Exception:
            if use_orbax:
                raise
    if backend == "pickle":
        host = jax.tree_util.tree_map(np.asarray, payload)
        with open(os.path.join(path, "state.pkl"), "wb") as f:
            pickle.dump(host, f)

    with open(os.path.join(path, "meta.json"), "w") as f:
        json.dump({"step": int(step), "backend": backend,
                   "has_opt_state": opt_state is not None}, f)


def load_checkpoint(path: str) -> Tuple[Pytree, Optional[Pytree], int]:
    """Returns ``(params, opt_state, step)``; backend auto-detected."""
    path = os.path.abspath(path)
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)

    if meta.get("backend") == "orbax":
        ocp = _orbax()
        if ocp is None:
            raise RuntimeError("checkpoint was written with orbax, which is unavailable")
        with ocp.PyTreeCheckpointer() as ckptr:
            payload = ckptr.restore(os.path.join(path, "state"))
    else:
        with open(os.path.join(path, "state.pkl"), "rb") as f:
            payload = pickle.load(f)
        payload = jax.tree_util.tree_map(jax.numpy.asarray, payload)

    return payload["params"], payload.get("opt_state"), meta["step"]


class AsyncCheckpointer:
    """Non-blocking checkpointing for the training loop.

    ``save()`` pulls arrays to host on the caller thread (fast; afterwards the
    device buffers are free to be donated/overwritten by the next step) and
    hands serialization + fsync to a single worker thread — on this class of
    filesystem a synchronous save costs seconds to minutes (module docstring),
    which would stall every train step that hits the checkpoint cadence.

    One save is in flight at a time: a new ``save`` first joins the previous
    one, bounding host memory to two checkpoint copies.  ``wait()`` blocks
    until the last save is durable (call before exiting); errors raised in the
    worker re-surface on the next ``save``/``wait``.  In a multi-process run
    only process 0 writes the pickle backend (Orbax coordinates multi-host
    saves itself — pass ``use_orbax=True`` there).
    """

    def __init__(self, use_orbax: Optional[bool] = None) -> None:
        self._use_orbax = use_orbax
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def _join(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def save(
        self, path: str, params: Pytree, opt_state: Pytree = None, step: int = 0
    ) -> None:
        self._join()
        if not self._use_orbax and jax.process_index() != 0:
            return
        host_params = jax.device_get(params)
        host_opt = jax.device_get(opt_state) if opt_state is not None else None
        use_orbax = self._use_orbax

        def work() -> None:
            try:
                save_checkpoint(path, host_params, host_opt, step, use_orbax)
            except BaseException as e:  # noqa: BLE001 — resurface on next call
                self._error = e

        self._thread = threading.Thread(target=work, name="cnf-ckpt", daemon=True)
        self._thread.start()

    def wait(self) -> None:
        """Block until the in-flight save (if any) is durable."""
        self._join()

    # context-manager sugar: ``with AsyncCheckpointer() as ckpt: ...``
    def __enter__(self) -> "AsyncCheckpointer":
        return self

    def __exit__(self, *exc) -> None:
        self.wait()
