"""Kernel Stein discrepancy tests: closed form vs a jax.grad oracle, and
monotone decrease along an SVGD run."""

import jax
import jax.numpy as jnp
import numpy as np

import svgdcpp_jax as sv
from svgdcpp_jax.ops.ksd import ksd_rbf, ksd_squared_rbf


def u_p_autodiff(x, y, s_fn, p_matrix):
    """Stein kernel u_p via autodiff (oracle)."""
    k = lambda a, b: jnp.exp(-(a - b) @ p_matrix @ (a - b))
    gx = jax.grad(k, 0)
    gy = jax.grad(k, 1)
    hxy = jax.jacfwd(gy, 0)(x, y)  # d/dx of grad_y k -> (m, m)
    return (
        s_fn(x) @ s_fn(y) * k(x, y)
        + s_fn(x) @ gy(x, y)
        + gx(x, y) @ s_fn(y)
        + jnp.trace(hxy)
    )


def test_ksd_matches_autodiff_oracle(rng):
    n, m = 12, 3
    coords = jnp.asarray(rng.normal(size=(n, m)))
    p_mat = jnp.asarray(np.array([[0.7, 0.1, 0.0], [0.1, 0.5, 0.2], [0.0, 0.2, 0.9]]))
    mean = jnp.zeros(m)
    cov_inv = jnp.asarray(np.linalg.inv(np.eye(m) + 0.3))
    s_fn = lambda x: -cov_inv @ (x - mean)
    scores = jax.vmap(s_fn)(coords)

    closed = float(ksd_squared_rbf(coords, scores, p_mat, row_tile=4))
    oracle = float(
        np.mean(
            [
                float(u_p_autodiff(coords[i], coords[j], s_fn, p_mat))
                for i in range(n)
                for j in range(n)
            ]
        )
    )
    assert np.isclose(closed, oracle, rtol=1e-8), (closed, oracle)


def test_ksd_decreases_along_svgd(rng):
    n, dim = 64, 2
    mean = np.array([0.5, -0.5])
    cov = np.array([[1.0, 0.2], [0.2, 0.8]])
    model = sv.MultivariateNormal(mean, cov)
    x0 = rng.normal(size=(n, dim)) * 3 + 2

    ksd_before = float(ksd_rbf(model, x0))

    kernel = sv.GaussianRBFKernel(x0, sv.ScaleMethod.MEDIAN, model)
    svgd = sv.SVGD(
        sv.SVGDOptions(dimension=dim, num_iterations=200, coordinate_matrix=x0,
                       kernel=kernel, model=model,
                       optimizer=sv.AdaGrad(dim, n, 0.1))
    )
    svgd.initialize()
    out = np.asarray(svgd.run())
    ksd_after = float(ksd_rbf(model, out))
    # finite-n particles keep a residual KSD; a converged run shrinks it
    # several-fold (measured ~4x at n=64 after 200 iters)
    assert ksd_after < 0.4 * ksd_before, (ksd_before, ksd_after)


def test_ksd_terms_matches_autodiff_oracle(rng):
    """Composed-kernel KSD (signed sum of per-term closed forms) == the
    autodiff Stein-kernel oracle through the composed kernel function."""
    from svgdcpp_jax.kernels.algebra import flatten_rbf_terms
    from svgdcpp_jax.ops.ksd import ksd_squared_rbf_terms

    n, m = 12, 2
    coords = jnp.asarray(rng.normal(size=(n, m)))
    mean = jnp.zeros(m)
    cov_inv = jnp.asarray(np.linalg.inv(np.eye(m) + 0.3))
    s_fn = lambda x: -cov_inv @ (x - mean)
    scores = jax.vmap(s_fn)(coords)

    p1 = jnp.asarray(np.array([[0.7, 0.1], [0.1, 0.5]]))
    p2 = jnp.asarray(0.1 * np.eye(m))
    x0 = np.asarray(coords)
    k_a = sv.GaussianRBFKernel(x0, sv.ScaleMethod.CONSTANT, constant_scale=p1)
    k_b = sv.GaussianRBFKernel(x0, sv.ScaleMethod.CONSTANT, constant_scale=p2)
    # product/division exercise the collapsed and indefinite-P branches
    kernel = (k_a + k_b) / k_b
    terms = flatten_rbf_terms(kernel)
    assert terms is not None

    closed = float(
        ksd_squared_rbf_terms(
            coords, scores, kernel.parameters, terms, row_tile=4
        )
    )

    def k_composed(a, b):
        ka = jnp.exp(-(a - b) @ p1 @ (a - b))
        kb = jnp.exp(-(a - b) @ p2 @ (a - b))
        return (ka + kb) / kb

    def u_p(x, y):
        gx = jax.grad(k_composed, 0)
        gy = jax.grad(k_composed, 1)
        hxy = jax.jacfwd(gy, 0)(x, y)
        return (
            s_fn(x) @ s_fn(y) * k_composed(x, y)
            + s_fn(x) @ gy(x, y)
            + gx(x, y) @ s_fn(y)
            + jnp.trace(hxy)
        )

    oracle = float(
        np.mean(
            [
                float(u_p(coords[i], coords[j]))
                for i in range(n)
                for j in range(n)
            ]
        )
    )
    assert np.isclose(closed, oracle, rtol=1e-7), (closed, oracle)


def test_ksd_rbf_kernel_argument(rng):
    """ksd_rbf(kernel=...) evaluates under the composed kernel; a custom
    (non-flattenable) kernel routes through the autodiff Stein kernel and,
    for a kernel that happens to BE an RBF, must equal the closed form."""
    n, dim = 32, 2
    model = sv.MultivariateNormal(np.zeros(dim), np.eye(dim))
    x0 = rng.normal(size=(n, dim))
    kernel = sv.GaussianRBFKernel(
        x0, sv.ScaleMethod.CONSTANT, constant_scale=np.eye(dim)
    ) + sv.GaussianRBFKernel(
        x0, sv.ScaleMethod.CONSTANT, constant_scale=0.2 * np.eye(dim)
    )
    val = float(ksd_rbf(model, x0, kernel=kernel))
    assert np.isfinite(val) and val > 0
    custom = sv.Kernel(
        dimension=dim,
        kernel_fn=lambda x, p, loc: jnp.exp(-jnp.sum((x - loc) ** 2)),
    )
    generic_val = float(ksd_rbf(model, x0, kernel=custom, ustat=True))
    closed_val = float(
        ksd_rbf(model, x0, p_matrix=jnp.eye(dim, dtype=x0.dtype), ustat=True)
    )
    np.testing.assert_allclose(generic_val, closed_val, rtol=1e-6)


def test_ksd_generic_matches_closed_form_rbf(rng):
    """The autodiff Stein kernel (ksd_squared_generic) against the
    closed-form RBF KSD, anisotropic P, both statistics."""
    from svgdcpp_jax.ops.ksd import ksd_squared_generic

    n, m = 24, 3
    coords = jnp.asarray(rng.normal(size=(n, m)))
    scores = jnp.asarray(rng.normal(size=(n, m)))
    p_mat = jnp.asarray(
        np.array([[0.7, 0.1, 0.0], [0.1, 0.5, 0.2], [0.0, 0.2, 0.9]])
    )

    def kfn(x, params, loc):
        d = x - loc
        return jnp.exp(-d @ params[0] @ d)

    for ustat in (False, True):
        g = float(
            ksd_squared_generic(
                coords, scores, kfn, (p_mat,), row_tile=8, ustat=ustat
            )
        )
        c = float(
            ksd_squared_rbf(coords, scores, p_mat, row_tile=8, ustat=ustat)
        )
        np.testing.assert_allclose(g, c, rtol=1e-8)


def test_ksd_generic_matches_terms_on_composed(rng):
    """Generic autodiff KSD on a composed (sum) kernel function equals the
    signed closed-form term sum."""
    from svgdcpp_jax.ops.ksd import ksd_squared_generic, ksd_squared_rbf

    n, m = 20, 2
    coords = jnp.asarray(rng.normal(size=(n, m)))
    scores = jnp.asarray(rng.normal(size=(n, m)))
    p1 = jnp.asarray(np.array([[0.8, 0.1], [0.1, 0.6]]))
    p2 = 0.2 * jnp.eye(m)

    def kfn(x, params, loc):
        d = x - loc
        return jnp.exp(-d @ params[0] @ d) + jnp.exp(-d @ params[1] @ d)

    g = float(
        ksd_squared_generic(
            coords, scores, kfn, (p1, p2), row_tile=8, ustat=False
        )
    )
    c = float(
        ksd_squared_rbf(coords, scores, p1, row_tile=8)
        + ksd_squared_rbf(coords, scores, p2, row_tile=8)
    )
    np.testing.assert_allclose(g, c, rtol=1e-8)


def test_ksd_huge_n_no_int32_overflow():
    """The n^2 normalization must not overflow int32 weak typing when
    x64 is disabled (n > ~46k on the f32 device path). Trace-only check via
    eval_shape on a non-x64 closure — no O(n^2) compute."""
    from svgdcpp_jax.ops.ksd import ksd_squared_rbf

    n, m = 100_000, 2
    coords = jax.ShapeDtypeStruct((n, m), jnp.float32)
    scores = jax.ShapeDtypeStruct((n, m), jnp.float32)
    p = jnp.eye(m, dtype=jnp.float32)
    prev = jax.config.jax_enable_x64
    try:
        jax.config.update("jax_enable_x64", False)
        for ustat in (False, True):
            out = jax.eval_shape(
                lambda c, s: ksd_squared_rbf(c, s, p, row_tile=4096,
                                             ustat=ustat),
                coords, scores,
            )
            assert out.shape == ()
    finally:
        jax.config.update("jax_enable_x64", prev)
