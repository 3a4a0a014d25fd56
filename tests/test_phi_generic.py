"""Tile-streamed generic phi: equivalence vs brute force and tiling
invariance.

The generic path serves arbitrary composed/user kernels (the reference's
signature capability, Kernel.hpp:55-223); the tiled rewrite must match the
mathematically explicit per-pair computation exactly and be invariant to
the tile size.
"""

import jax
import jax.numpy as jnp
import numpy as np

from svgdcpp_jax.kernels.gaussian_rbf import rbf_kernel_fn
from svgdcpp_jax.ops.phi import (
    phi_generic,
    phi_generic_cross,
    phi_rbf,
)


def phi_bruteforce(coords, scores, kernel_fn, params):
    """Explicit per-pair K and grad-K, dense (test oracle only)."""
    n = coords.shape[0]

    def pair(xj, xi):
        return kernel_fn(xj, params, xi)

    k = jax.vmap(lambda xi: jax.vmap(lambda xj: pair(xj, xi))(coords))(coords)
    g = jax.vmap(
        lambda xi: jax.vmap(lambda xj: jax.grad(pair, 0)(xj, xi))(coords)
    )(coords)
    return (k @ scores + jnp.sum(g, axis=1)) / n


def composed_kernel_fn(x, params, location):
    """RBF + scaled RBF with distinct inverse-scale matrices."""
    return rbf_kernel_fn(x, (params[0],), location) + 0.5 * rbf_kernel_fn(
        x, (params[1],), location
    )


def test_generic_matches_bruteforce_composed(rng):
    n, m = 37, 3
    coords = jnp.asarray(rng.normal(size=(n, m)))
    scores = jnp.asarray(rng.normal(size=(n, m)))
    params = (
        jnp.asarray(0.7 * np.eye(m) + 0.05),
        jnp.asarray(0.2 * np.eye(m)),
    )
    expect = phi_bruteforce(coords, scores, composed_kernel_fn, params)
    got = phi_generic(coords, scores, composed_kernel_fn, params, row_tile=8)
    np.testing.assert_allclose(np.asarray(got), np.asarray(expect), rtol=1e-10)


def test_generic_tile_size_invariance(rng):
    n, m = 50, 4
    coords = jnp.asarray(rng.normal(size=(n, m)))
    scores = jnp.asarray(rng.normal(size=(n, m)))
    params = (jnp.asarray(0.5 * np.eye(m)),)
    full = phi_generic(coords, scores, rbf_kernel_fn, params, row_tile=64)
    for tile in (8, 16, 24):
        tiled = phi_generic(coords, scores, rbf_kernel_fn, params, row_tile=tile)
        np.testing.assert_allclose(
            np.asarray(tiled), np.asarray(full), rtol=1e-12
        )


def test_generic_matches_closed_form_rbf(rng):
    """For a plain RBF the generic VJP path must equal the closed form."""
    n, m = 40, 2
    coords = jnp.asarray(rng.normal(size=(n, m)))
    scores = jnp.asarray(rng.normal(size=(n, m)))
    p = jnp.asarray(np.array([[0.8, 0.1], [0.1, 0.6]]))
    closed = phi_rbf(coords, scores, p)
    got = phi_generic(coords, scores, rbf_kernel_fn, (p,), row_tile=16)
    np.testing.assert_allclose(np.asarray(got), np.asarray(closed), rtol=1e-9)


def test_generic_cross_split_targets(rng):
    """Cross form over a target subset equals the same rows of the full phi."""
    n, m = 30, 3
    coords = jnp.asarray(rng.normal(size=(n, m)))
    scores = jnp.asarray(rng.normal(size=(n, m)))
    params = (jnp.asarray(0.4 * np.eye(m)),)
    full = phi_generic(coords, scores, rbf_kernel_fn, params, row_tile=8)
    part = phi_generic_cross(
        coords[10:22], coords, scores, rbf_kernel_fn, params, row_tile=8
    )
    np.testing.assert_allclose(
        np.asarray(part), np.asarray(full)[10:22], rtol=1e-12
    )


def test_generic_scales_past_dense_ceiling(rng):
    """N well beyond the old O(n^2 m) ceiling runs and stays finite.

    (The old implementation materialized (n, n, m); at this size that is
    ~0.9 GB f64 — the tiled path holds only (row_tile, n, m).)
    """
    n, m = 4096, 8
    coords = jnp.asarray(rng.normal(size=(n, m)).astype(np.float32))
    scores = jnp.asarray(rng.normal(size=(n, m)).astype(np.float32))
    params = (
        jnp.asarray(0.3 * np.eye(m, dtype=np.float32)),
        jnp.asarray(0.1 * np.eye(m, dtype=np.float32)),
    )
    out = phi_generic(coords, scores, composed_kernel_fn, params)
    assert out.shape == (n, m)
    assert np.isfinite(np.asarray(out)).all()
