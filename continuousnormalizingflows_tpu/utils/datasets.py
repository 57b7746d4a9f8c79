"""Toy data generators used by tests, benchmarks, and examples.

Covers the data configurations referenced by the baselines (BASELINE.md):
1-D Beta(2,4) (reference test/ci_tests/regression_tests.jl:2-6), 2-D Gaussian
mixtures (examples/usage.jl style), and the two-moons / circles 2-D toy suite.
Everything is generated with ``jax.random`` — no sklearn dependency.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

__all__ = ["beta_samples", "beta_pdf", "gaussian_mixture", "gaussian_mixture_logpdf", "two_moons", "circles"]


def beta_samples(key: jax.Array, n: int, a: float = 2.0, b: float = 4.0, ndim: int = 1) -> jax.Array:
    """(n, ndim) i.i.d. Beta(a, b) samples — the reference regression config."""
    return jax.random.beta(key, a, b, (n, ndim), jnp.float32)


def beta_pdf(x: jax.Array, a: float = 2.0, b: float = 4.0) -> jax.Array:
    """Beta(a, b) pdf evaluated elementwise (ground truth for parity checks)."""
    from jax.scipy.special import betaln

    x = jnp.clip(x, 1e-12, 1.0 - 1e-12)
    logpdf = (a - 1) * jnp.log(x) + (b - 1) * jnp.log1p(-x) - betaln(a, b)
    return jnp.exp(logpdf)


def _ring_means(k: int, radius: float) -> jax.Array:
    ang = jnp.arange(k) * (2 * jnp.pi / k)
    return radius * jnp.stack([jnp.cos(ang), jnp.sin(ang)], axis=-1)


def gaussian_mixture(
    key: jax.Array, n: int, k: int = 8, radius: float = 2.0, std: float = 0.3
) -> jax.Array:
    """(n, 2) samples from a k-mode ring-of-Gaussians mixture."""
    k_comp, k_noise = jax.random.split(key)
    means = _ring_means(k, radius)
    comp = jax.random.randint(k_comp, (n,), 0, k)
    return means[comp] + std * jax.random.normal(k_noise, (n, 2))


def gaussian_mixture_logpdf(
    x: jax.Array, k: int = 8, radius: float = 2.0, std: float = 0.3
) -> jax.Array:
    means = _ring_means(k, radius)
    d2 = jnp.sum(jnp.square(x[..., None, :] - means), axis=-1)  # (..., k)
    comp_logp = -0.5 * d2 / std**2 - jnp.log(2 * jnp.pi * std**2)
    return jax.nn.logsumexp(comp_logp, axis=-1) - jnp.log(k)


def two_moons(key: jax.Array, n: int, noise: float = 0.08) -> jax.Array:
    """(n, 2) two-interleaving-moons samples."""
    k_side, k_ang, k_noise = jax.random.split(key, 3)
    side = jax.random.bernoulli(k_side, 0.5, (n,))
    theta = jax.random.uniform(k_ang, (n,), minval=0.0, maxval=jnp.pi)
    x = jnp.where(side, jnp.cos(theta), 1.0 - jnp.cos(theta))
    y = jnp.where(side, jnp.sin(theta), 0.5 - jnp.sin(theta))
    pts = jnp.stack([x, y], axis=-1)
    return pts + noise * jax.random.normal(k_noise, (n, 2))


def circles(key: jax.Array, n: int, factor: float = 0.5, noise: float = 0.05) -> jax.Array:
    """(n, 2) two-concentric-circles samples."""
    k_side, k_ang, k_noise = jax.random.split(key, 3)
    side = jax.random.bernoulli(k_side, 0.5, (n,))
    theta = jax.random.uniform(k_ang, (n,), minval=0.0, maxval=2 * jnp.pi)
    r = jnp.where(side, 1.0, factor)
    pts = jnp.stack([r * jnp.cos(theta), r * jnp.sin(theta)], axis=-1)
    return pts + noise * jax.random.normal(k_noise, (n, 2))


# ---------------------------------------------------------------------------
# image-scale synthetic task with KNOWN likelihood (BASELINE config 5 stand-in)
# ---------------------------------------------------------------------------
#
# Real MNIST is unavailable in a zero-egress build environment, so the
# image-scale quality benchmark uses a mixture of spatially-smooth Gaussian
# random fields over the pixel grid: each component is N(mu_k, Sigma_k) with
# an RBF-kernel covariance (texture with its own correlation length) around a
# smooth low-frequency mean pattern plus i.i.d. pixel noise (the 0.05 jitter
# — also keeps the covariance condition number flow-learnable, ~1e2 instead
# of the ~1e6 of a pure RBF kernel).  Samples look like soft noisy
# blobs/stripes; the density is analytic, so the fitted flow's NLL gap (and
# bits/dim) is *exactly* measurable — unlike MNIST, where the true likelihood
# is unknown.


def _rbf_chol_np(side: int, lengthscale: float, var: float, jitter: float = 0.05):
    import numpy as _np

    idx = _np.arange(side, dtype=_np.float64)
    gx, gy = _np.meshgrid(idx, idx, indexing="ij")
    pts = _np.stack([gx.ravel(), gy.ravel()], axis=1)
    d2 = ((pts[:, None, :] - pts[None, :, :]) ** 2).sum(-1)
    cov = var * _np.exp(-d2 / (2.0 * lengthscale**2)) + jitter * _np.eye(side * side)
    return _np.linalg.cholesky(cov)


def _image_mixture_components(side: int, ncomp: int):
    """(means (k, d), chols (k, d, d)) — cached float32 device constants."""
    import numpy as _np

    key = (side, ncomp)
    cache = _image_mixture_components.__dict__.setdefault("_cache", {})
    if key in cache:
        return cache[key]
    lengthscales = (1.2, 2.5, 5.0, 1.8, 3.5)[:ncomp]
    idx = _np.arange(side, dtype=_np.float64) / side
    gx, gy = _np.meshgrid(idx, idx, indexing="ij")
    patterns = [
        1.5 * _np.sin(2 * _np.pi * gx),
        1.5 * _np.cos(2 * _np.pi * gy),
        1.5 * _np.sin(2 * _np.pi * (gx + gy)),
        1.5 * _np.cos(4 * _np.pi * gx) * _np.sin(2 * _np.pi * gy),
        -1.5 * _np.sin(4 * _np.pi * gy),
    ][:ncomp]
    means = _np.stack([p.ravel() for p in patterns])
    chols = _np.stack([_rbf_chol_np(side, l, 1.0) for l in lengthscales])
    out = (jnp.asarray(means, jnp.float32), jnp.asarray(chols, jnp.float32))
    cache[key] = out
    return out


def smooth_image_mixture(key: jax.Array, n: int, side: int = 28, ncomp: int = 3) -> jax.Array:
    """(n, side*side) samples from the smooth-image mixture."""
    means, chols = _image_mixture_components(side, ncomp)
    k_comp, k_noise = jax.random.split(key)
    comp = jax.random.randint(k_comp, (n,), 0, ncomp)
    xi = jax.random.normal(k_noise, (n, side * side), jnp.float32)
    # one (n, d) x (d, d) matmul per component + select — never materialize a
    # per-sample (d, d) Cholesky gather (40 GB at d = 784, n = 16k)
    noise_k = jnp.stack([
        jnp.matmul(xi, chols[k].T, precision="highest") for k in range(ncomp)
    ])  # (k, n, d)
    noise = jnp.take_along_axis(noise_k, comp[None, :, None], axis=0)[0]
    return means[comp] + noise


def smooth_image_mixture_logpdf(x: jax.Array, side: int = 28, ncomp: int = 3) -> jax.Array:
    """Exact log-density of the mixture (the measurable ground truth that real
    image datasets lack).  ``x``: (n, side*side)."""
    from jax.scipy.linalg import solve_triangular

    means, chols = _image_mixture_components(side, ncomp)
    d = side * side
    from ..config import LOG_2PI as _LOG_2PI

    def comp_logpdf(mu, chol):
        diff = (x - mu).T  # (d, n)
        z = solve_triangular(chol, diff, lower=True)  # (d, n)
        logdet = jnp.sum(jnp.log(jnp.diagonal(chol)))
        return -0.5 * (d * _LOG_2PI + jnp.sum(z * z, axis=0)) - logdet

    lps = jax.vmap(comp_logpdf)(means, chols)  # (k, n)
    return jax.scipy.special.logsumexp(lps, axis=0) - jnp.log(ncomp)


def nats_to_bits_per_dim(nll_nats: jax.Array, d: int) -> jax.Array:
    """bits/dim = NLL_nats / (d * ln 2) — the image-modeling convention."""
    return nll_nats / (d * 0.6931471805599453)


# ---------------------------------------------------------------------------
# real image data: sklearn handwritten digits (offline-available), with the
# standard quantized-image preprocessing (uniform dequantization + logit)
# ---------------------------------------------------------------------------


def digits_data() -> "np.ndarray":
    """The 1,797 real 8x8 handwritten-digit images (UCI via sklearn, offline),
    as an (n, 64) integer-valued float array with 17 gray levels {0..16}.
    This is BASELINE config 5's real-data stand-in at reduced resolution —
    the reference's fit-real-samples pattern
    (reference examples/usage.jl:60-127, test/ci_tests/regression_tests.jl:17-28)."""
    from sklearn.datasets import load_digits

    return load_digits().data


DIGITS_LEVELS = 17  # gray levels in the digits data: {0, 1, ..., 16}


def dequantize_logit(x_int: jax.Array, key: jax.Array, levels: int = DIGITS_LEVELS,
                     alpha: float = 0.05):
    """Uniform dequantization + logit transform (the FFJORD/RealNVP image
    preprocessing): ``z = (x + u)/levels`` with ``u ~ U(0,1)`` per pixel, then
    ``y = logit(alpha + (1-2 alpha) z)``.  Returns ``(y, ldj)`` where ``ldj``
    is the per-sample ``sum log dy/dz`` needed to express model likelihoods in
    the quantized data space."""
    u = jax.random.uniform(key, x_int.shape, dtype=jnp.float32)
    z = (x_int + u) / levels
    s = alpha + (1.0 - 2.0 * alpha) * z
    y = jnp.log(s) - jnp.log1p(-s)
    ldj = jnp.sum(
        jnp.log(1.0 - 2.0 * alpha) - jnp.log(s) - jnp.log1p(-s), axis=-1
    )
    return y, ldj


def logit_to_levels(y: jax.Array, levels: int = DIGITS_LEVELS,
                    alpha: float = 0.05) -> jax.Array:
    """Inverse of :func:`dequantize_logit` back to gray levels [0, levels-1]
    (for rendering generated samples)."""
    s = jax.nn.sigmoid(y)
    z = (s - alpha) / (1.0 - 2.0 * alpha)
    return jnp.clip(z * levels, 0.0, levels - 1.0)


def digits_split(n_train: int = 1500, seed: int = 42, with_labels: bool = False):
    """Canonical shuffled digits train/test split — the SINGLE definition
    shared by benchmarks/digits_bitsdim.py and tests/test_digits.py so the
    test's measured-threshold provenance cannot silently diverge from the
    benchmark it cites.  With ``with_labels`` also returns the 0-9 class
    labels (for conditional models): ``(x_tr, x_te, y_tr, y_te)``."""
    import numpy as np
    from sklearn.datasets import load_digits

    ds = load_digits()
    x_all = np.asarray(ds.data, np.float32)
    perm = np.asarray(jax.random.permutation(jax.random.PRNGKey(seed), len(x_all)))
    xs = jnp.asarray(x_all[perm[:n_train]]), jnp.asarray(x_all[perm[n_train:]])
    if not with_labels:
        return xs
    labels = np.asarray(ds.target, np.int32)
    return xs + (jnp.asarray(labels[perm[:n_train]]),
                 jnp.asarray(labels[perm[n_train:]]))


def digits_standardizer(x_train_i: jax.Array, alpha: float = 0.05,
                        seed: int = 7):
    """Per-dim standardization constants from ONE train dequantization draw
    (a fixed diagonal affine layer of the model; its log|det| enters the
    likelihood).  Returns ``(m, s, log_s_sum, y0)`` with ``y0`` the drawn
    train logits (reused for Gaussian baselines)."""
    y0, _ = dequantize_logit(x_train_i, jax.random.PRNGKey(seed), alpha=alpha)
    m = jnp.mean(y0, axis=0)
    s = jnp.std(y0, axis=0) + 1e-3
    return m, s, float(jnp.sum(jnp.log(s))), y0


def diagonal_gaussian_logp(y_train: jax.Array, y_test: jax.Array) -> jax.Array:
    """log-density of test points under a diagonal Gaussian fitted on train —
    the 'did the flow learn anything' yardstick real data substitutes for an
    analytic pdf."""
    mu = jnp.mean(y_train, axis=0)
    v = jnp.var(y_train, axis=0) + 1e-6
    return -0.5 * jnp.sum(
        jnp.log(2 * jnp.pi * v) + (y_test - mu) ** 2 / v, axis=-1
    )


def quantized_bits_per_dim(logp_y: jax.Array, ldj: jax.Array, d: int,
                           levels: int = DIGITS_LEVELS) -> jax.Array:
    """bits/dim of the *quantized* data under the dequantization bound:
    ``log P(x) >= E_u[log p_z] - d log(levels)`` (Jensen), with
    ``log p_z = log p_y + ldj``.  Lower is better; ``log2(levels)`` is the
    0-bits reference of a uniform model."""
    nll_z = -(logp_y + ldj)
    return nll_z / (d * 0.6931471805599453) + jnp.log2(float(levels))


def load_tabular_real(name: str, seed: int = 0, test_frac: float = 0.2,
                      jitter: float = 0.02):
    """Real UCI tabular data for density estimation, from sklearn's bundled
    copies (``wine`` 178x13, ``breast_cancer`` 569x30, ``diabetes`` 442x9
    raw clinical measurements) — the offline stand-in for the flow
    literature's UCI tables (POWER/GAS/...), as sklearn digits stands in for
    MNIST.

    Standard tabular-flow preprocessing: z-score standardize on TRAIN
    statistics, add small Gaussian jitter (both tables contain repeated /
    discretized measurement values — a continuous density on exact duplicates
    diverges), shuffle-split.  Returns ``(x_train, x_test)`` float32 arrays.
    """
    import numpy as np
    from sklearn import datasets as skd

    loaders = {
        "wine": skd.load_wine,
        "breast_cancer": skd.load_breast_cancer,
        # 442 patients x 10 raw clinical measurements (scaled=False keeps the
        # real units); the binary sex column is dropped — a continuous density
        # model can game a two-spike marginal through the dequantization
        # jitter, so the estimation task is over the 9 continuous features
        # (the UCI tabular-flow literature drops discrete columns the same way)
        "diabetes": lambda: skd.load_diabetes(scaled=False),
    }
    if name not in loaders:
        raise ValueError(f"unknown tabular dataset {name!r}; use {sorted(loaders)}")
    x = np.asarray(loaders[name]().data, dtype=np.float64)
    if name == "diabetes":
        x = np.delete(x, 1, axis=1)
    rng = np.random.default_rng(seed)
    x = x[rng.permutation(x.shape[0])]
    n_test = max(1, int(round(test_frac * x.shape[0])))
    xte, xtr = x[:n_test], x[n_test:]
    m, s = xtr.mean(0), xtr.std(0) + 1e-6
    xtr = (xtr - m) / s + jitter * rng.standard_normal(xtr.shape)
    xte = (xte - m) / s + jitter * rng.standard_normal(xte.shape)
    return (jnp.asarray(xtr, jnp.float32), jnp.asarray(xte, jnp.float32))


def random_shift_images(key: jax.Array, x_int: jax.Array, side: int,
                        max_shift: int = 1, prob: float = 1.0) -> jax.Array:
    """Per-sample random integer translation of flattened ``(B, side*side)``
    images (zero fill — the digits background level), the standard small-image
    augmentation.  Jit-safe: shifts are gathered with clipped index arithmetic,
    no dynamic slicing.  Designed for the ``ICNFModel.fit`` ``batch_transform``
    hook (fresh shifts every step)."""
    b = x_int.shape[0]
    imgs = x_int.reshape(b, side, side)
    k1, k2, k3 = jax.random.split(key, 3)
    dy = jax.random.randint(k1, (b,), -max_shift, max_shift + 1)
    dx = jax.random.randint(k2, (b,), -max_shift, max_shift + 1)
    if prob < 1.0:
        # soften: shift only a `prob` fraction of samples (at small image
        # sides a 1-px shift is a large distribution distortion)
        on = jax.random.bernoulli(k3, prob, (b,)).astype(dy.dtype)
        dy, dx = dy * on, dx * on
    rows = jnp.arange(side)[None, :, None] - dy[:, None, None]  # (b, s, 1)
    cols = jnp.arange(side)[None, None, :] - dx[:, None, None]  # (b, 1, s)
    valid = ((rows >= 0) & (rows < side) & (cols >= 0) & (cols < side))
    r = jnp.clip(rows, 0, side - 1)
    c = jnp.clip(cols, 0, side - 1)
    shifted = jnp.take_along_axis(
        jnp.take_along_axis(imgs, jnp.broadcast_to(r, (b, side, side)), axis=1),
        jnp.broadcast_to(c, (b, side, side)), axis=2,
    )
    return jnp.where(valid, shifted, 0).reshape(b, side * side).astype(x_int.dtype)
