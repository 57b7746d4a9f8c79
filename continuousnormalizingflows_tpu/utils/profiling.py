"""Profiling / observability helpers.

The reference's observability is solver stats + loss callbacks (SURVEY.md §5).
JAX-native additions: ``jax.profiler`` trace capture (view in TensorBoard /
Perfetto), wall-clock step timing, and NFE accounting (every ``inference``
already returns the dynamics-evaluation count the way SciML exposes
``sol.stats``).
"""

from __future__ import annotations

import contextlib
import subprocess
import time
from typing import Iterator, List, Optional, Tuple

import jax

__all__ = [
    "trace",
    "StepTimer",
    "require_gpu",
    "device_record",
    "nvidia_smi_identity",
    "parse_smi_line",
]

SMI_QUERY = [
    "nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
]


def require_gpu() -> List[jax.Device]:
    """The default backend's devices, or ``RuntimeError`` when they are not
    GPUs — a measurement that finds only a CPU fails instead of timing it."""
    devices = jax.devices()
    if devices[0].platform != "gpu":
        raise RuntimeError(
            f"no GPU: JAX's default backend is {devices[0].platform!r} "
            f"({devices[0].device_kind})"
        )
    return devices


def device_record() -> dict:
    """``{"platform", "kind", "count"}`` of the default backend, as JAX
    reports them — printed beside every on-card result."""
    devices = jax.devices()
    return {
        "platform": devices[0].platform,
        "kind": devices[0].device_kind,
        "count": len(devices),
    }


def nvidia_smi_identity() -> str:
    """Card name and power limit, one line per card, as ``nvidia-smi``
    prints them.  Runs in a child process that never imports JAX."""
    out = subprocess.run(
        SMI_QUERY, check=True, capture_output=True, text=True, timeout=60
    )
    return out.stdout.strip()


def parse_smi_line(line: str) -> Tuple[str, Optional[float]]:
    """``"NVIDIA H100 80GB HBM3, 700.00 W"`` -> ``(name, watts)``; a power
    limit the driver does not report (``[N/A]``) gives ``None``."""
    name, _, limit = line.rpartition(",")
    if not name:
        raise ValueError(f"not a name,power.limit line: {line!r}")
    limit = limit.strip()
    if limit.endswith("W"):
        try:
            return name.strip(), float(limit[:-1])
        except ValueError:
            pass
    return name.strip(), None


@contextlib.contextmanager
def trace(logdir: str) -> Iterator[None]:
    """Capture a device trace: ``with profiling.trace('/tmp/trace'): step()``."""
    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


class StepTimer:
    """Throughput meter with compile-step exclusion.

    >>> timer = StepTimer(batch=4096)
    >>> for i in range(n):
    ...     out = step(...)
    ...     timer.tick(out)   # blocks on `out`, starts timing after step 0
    >>> timer.samples_per_sec
    """

    def __init__(self, batch: int) -> None:
        self.batch = batch
        self.steps = 0
        self._t0: Optional[float] = None

    def tick(self, out=None) -> None:
        if out is not None:
            jax.block_until_ready(out)
        if self._t0 is None:
            self._t0 = time.perf_counter()  # first tick = end of compile step
        else:
            self.steps += 1

    @property
    def seconds_per_step(self) -> float:
        if not self.steps or self._t0 is None:
            return float("nan")
        return (time.perf_counter() - self._t0) / self.steps

    @property
    def samples_per_sec(self) -> float:
        return self.batch / self.seconds_per_step
