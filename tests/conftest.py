"""Test configuration: run on a virtual 8-device CPU mesh.

Mirrors the reference's CI strategy of exercising the full API sweep on CPU
(reference ``test/runtests.jl:41``), with the 8 virtual devices standing in
for a multi-card host so sharding paths compile and execute without hardware
(SURVEY.md §4).

Installed pytest plugins (jaxtyping) import jax before this conftest runs,
so the platform is forced through jax.config updates, which work any time
before backend initialization; the asserts fail loudly if some plugin
already started another backend (a GPU would run float32 matmuls in TF32 and
break the tolerance-based assertions).
"""

import os

os.environ["JAX_PLATFORMS"] = "cpu"

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", 8)
jax.config.update("jax_enable_x64", False)

assert jax.devices()[0].platform == "cpu", (
    "JAX initialized a non-CPU backend before conftest could force CPU; "
    f"got {jax.devices()}"
)
assert len(jax.devices()) == 8, f"expected 8 virtual CPU devices, got {jax.devices()}"
