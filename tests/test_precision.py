"""Jaxpr audit: on a net built with precision "highest", every float32
``dot_general`` in the value and the gradient of ``cnf.loss`` asks for
``Precision.HIGHEST``.

A contraction with no precision runs at the backend's default, which is TF32
on NVIDIA GPUs (about 10 mantissa bits) — far coarser than the adaptive
solver's 1e-4 error control.  The CPU runs such a product in full float32,
so only the traced program can show the omission here."""

import jax
import jax.numpy as jnp
import pytest
from jax.extend.core import ClosedJaxpr, Jaxpr

import continuousnormalizingflows_tpu as cnf
from continuousnormalizingflows_tpu.config import Mode, SolverConfig
from continuousnormalizingflows_tpu.models.nets import MLP, CondLayer, Planar


def _sub_jaxprs(value):
    if isinstance(value, ClosedJaxpr):
        yield value.jaxpr
    elif isinstance(value, Jaxpr):
        yield value
    elif isinstance(value, (tuple, list)):
        for v in value:
            yield from _sub_jaxprs(v)


def _dot_precisions(jaxpr):
    """``(operand dtypes, precision)`` of every dot_general, recursively."""
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            yield tuple(v.aval.dtype for v in eqn.invars), eqn.params["precision"]
        for value in eqn.params.values():
            for sub in _sub_jaxprs(value):
                yield from _dot_precisions(sub)


def _stack(name):
    """``(icnf, mode, needs_ys)`` for each audited configuration."""
    if name == "default_dopri5_adjoint":
        return cnf.ICNF.create(nvariables=2), Mode.TRAIN, False
    if name == "abm_quadrature":
        solver = SolverConfig(method="abm", gradient="quadrature")
        return cnf.ICNF.create(nvariables=2, solver=solver), Mode.TRAIN, False
    if name == "rk4_backprop":
        solver = SolverConfig(method="rk4", gradient="backprop", fixed_steps=4)
        return cnf.ICNF.create(nvariables=2, solver=solver), Mode.TRAIN, False
    if name == "one_hidden_testmode":
        cfg = cnf.ICNFConfig(nvariables=2)
        return cnf.ICNF(config=cfg, net=MLP((cfg.n_in, 8, cfg.n_out))), Mode.TEST, False
    if name == "generic_exact_chunk":
        cfg = cnf.ICNFConfig(nvariables=2, exact_chunk=2)
        net = MLP((cfg.n_in, 8, 8, 8, cfg.n_out))  # no analytic trace
        return cnf.ICNF(config=cfg, net=net), Mode.TEST, False
    if name == "planar":
        cfg = cnf.ICNFConfig(nvariables=2)
        return cnf.ICNF(config=cfg, net=Planar(cfg.n_in, cfg.n_out)), Mode.TRAIN, False
    if name == "conditional_condlayer":
        cfg = cnf.ICNFConfig(nvariables=2, nconditions=1)
        inner = MLP((cfg.n_in + 1, 8, 8, cfg.n_out))
        net = CondLayer(inner, jnp.ones((1,), jnp.float32))
        return cnf.ICNF(config=cfg, net=net), Mode.TRAIN, True
    raise ValueError(name)


STACKS = [
    "default_dopri5_adjoint",
    "abm_quadrature",
    "rk4_backprop",
    "one_hidden_testmode",
    "generic_exact_chunk",
    "planar",
    "conditional_condlayer",
]


@pytest.mark.parametrize("part", ["value", "grad"])
@pytest.mark.parametrize("stack", STACKS)
def test_every_float32_contraction_is_highest(stack, part):
    icnf, mode, needs_ys = _stack(stack)
    params = icnf.init(jax.random.PRNGKey(0))
    x = jnp.full((8, icnf.config.nvariables), 0.1, jnp.float32)
    ys = jnp.full((8, icnf.config.nconditions), 0.5, jnp.float32) if needs_ys else None
    key = jax.random.PRNGKey(1) if mode.stochastic else None

    def f(p):
        return cnf.loss(icnf, mode, x, p, key=key, ys=ys)

    traced = jax.make_jaxpr(jax.grad(f) if part == "grad" else f)(params)
    dots = list(_dot_precisions(traced.jaxpr))
    assert dots, "no contraction traced"
    highest = (jax.lax.Precision.HIGHEST, jax.lax.Precision.HIGHEST)
    loose = [
        (dtypes, prec) for dtypes, prec in dots
        if jnp.float32 in dtypes and prec != highest
    ]
    assert not loose, f"{len(loose)} of {len(dots)} dot_generals below HIGHEST: {loose[:3]}"
