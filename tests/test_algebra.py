"""Algebraic composed-RBF dispatch (kernels/algebra.py).

`+ - * /` trees of pure Gaussian RBF kernels (the reference's composition
operators, Kernel.hpp:55-223) flatten to signed sums of closed-form RBF
terms; phi then runs on the closed-form tile path instead of the generic VJP. These
tests pin (1) the flattening rules, (2) phi equivalence against the
explicit per-pair oracle, and (3) driver-level trajectory equality between
the algebraic path and the generic path.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import svgdcpp_jax as sv
from svgdcpp_jax.kernels.algebra import flatten_rbf_terms
from svgdcpp_jax.ops.phi import phi_generic, phi_rbf_terms


def rbf(x0, p):
    return sv.GaussianRBFKernel(
        x0, sv.ScaleMethod.CONSTANT, constant_scale=jnp.asarray(p)
    )


def spd(rng, m, scale=1.0):
    a = rng.normal(size=(m, m))
    return scale * (a @ a.T / m + np.eye(m))


# ----------------------------------------------------------------------
# Flattening rules
# ----------------------------------------------------------------------


def test_flatten_sum_and_difference(rng):
    m = 3
    x0 = rng.normal(size=(8, m))
    a, b = rbf(x0, spd(rng, m)), rbf(x0, spd(rng, m))
    assert flatten_rbf_terms(a + b) == [(1, ((0, 1),)), (1, ((1, 1),))]
    assert flatten_rbf_terms(a - b) == [(1, ((0, 1),)), (-1, ((1, 1),))]


def test_flatten_product_collapses_and_distributes(rng):
    m = 2
    x0 = rng.normal(size=(8, m))
    a, b, c = (rbf(x0, spd(rng, m)) for _ in range(3))
    # a*b: one term with both precision slots summed
    assert flatten_rbf_terms(a * b) == [(1, ((0, 1), (1, 1)))]
    # (a+b)*c distributes: slots 0+2 and 1+2
    assert flatten_rbf_terms((a + b) * c) == [
        (1, ((0, 1), (2, 1))),
        (1, ((1, 1), (2, 1))),
    ]


def test_flatten_division(rng):
    m = 2
    x0 = rng.normal(size=(8, m))
    a, b, c, d = (rbf(x0, spd(rng, m)) for _ in range(4))
    # single-term divisor: negated slot
    assert flatten_rbf_terms(a / b) == [(1, ((0, 1), (1, -1)))]
    # multi-term divisor leaves the RBF algebra
    assert flatten_rbf_terms((a + b) / (c + d)) is None


def test_flatten_rejects_custom_leaf(rng):
    m = 2
    x0 = rng.normal(size=(8, m))
    a = rbf(x0, spd(rng, m))
    custom = sv.Kernel(
        dimension=m,
        kernel_fn=lambda x, p, loc: jnp.exp(-jnp.sum((x - loc) ** 2)),
    )
    assert flatten_rbf_terms(a + custom) is None
    assert flatten_rbf_terms(custom) is None


def test_flatten_term_blowup_falls_back(rng):
    m = 2
    x0 = rng.normal(size=(8, m))
    k = rbf(x0, spd(rng, m)) + rbf(x0, spd(rng, m))
    prod = k
    # (a+b)^5 = 32 terms > MAX_RBF_TERMS
    for _ in range(4):
        prod = prod * k
    assert flatten_rbf_terms(prod) is None


# ----------------------------------------------------------------------
# phi equivalence vs the explicit per-pair oracle
# ----------------------------------------------------------------------


def _phi_oracle(coords, scores, kernel):
    """Dense per-pair phi through the composed kernel function itself."""
    fn, params = kernel._kernel_fn, kernel.parameters
    n = coords.shape[0]

    def pair(xj, xi):
        return fn(xj, params, xi)

    k = jax.vmap(lambda xi: jax.vmap(lambda xj: pair(xj, xi))(coords))(coords)
    g = jax.vmap(
        lambda xi: jax.vmap(lambda xj: jax.grad(pair, 0)(xj, xi))(coords)
    )(coords)
    return (k @ scores + jnp.sum(g, axis=1)) / n


@pytest.mark.parametrize("expr", ["a+b", "a-b", "a*b", "a/b", "(a+b)*c", "(a*b)/c"])
def test_phi_terms_matches_oracle(rng, expr):
    n, m = 24, 3
    coords = jnp.asarray(rng.normal(size=(n, m)))
    scores = jnp.asarray(rng.normal(size=(n, m)))
    x0 = np.asarray(coords)
    # Division terms are indefinite; keep the divisor precision small so
    # exp(+quad) stays in range.
    a = rbf(x0, spd(rng, m))
    b = rbf(x0, spd(rng, m, scale=0.2 if "/b" in expr else 1.0))
    c = rbf(x0, spd(rng, m, scale=0.2 if "/c" in expr else 0.5))
    kernel = eval(expr)  # noqa: S307 - test-local fixed expressions
    terms = flatten_rbf_terms(kernel)
    assert terms is not None
    expect = _phi_oracle(coords, scores, kernel)
    got = phi_rbf_terms(coords, scores, kernel.parameters, terms, row_tile=8)
    np.testing.assert_allclose(np.asarray(got), np.asarray(expect), rtol=1e-9)
    # and the generic VJP path agrees too (three-way consistency)
    gen = phi_generic(
        coords, scores, kernel._kernel_fn, kernel.parameters, row_tile=8
    )
    np.testing.assert_allclose(np.asarray(got), np.asarray(gen), rtol=1e-9)


# ----------------------------------------------------------------------
# Driver integration: auto-selection + trajectory equality vs generic
# ----------------------------------------------------------------------


def _run(x0, model, kernel, phi_impl, steps=6):
    svgd = sv.SVGD(
        sv.SVGDOptions(
            dimension=x0.shape[1], num_iterations=steps,
            coordinate_matrix=x0.copy(), kernel=kernel, model=model,
            optimizer=sv.Adam(x0.shape[1], x0.shape[0], 0.05, 0.9, 0.999),
            phi_impl=phi_impl,
        )
    )
    svgd.initialize()
    return svgd, np.asarray(svgd.run())


def test_driver_auto_selects_rbf_terms_and_matches_generic(rng):
    """The hier-bench kernel shape: RBF(median) + RBF(constant)."""
    n, m = 30, 3
    model = sv.MultivariateNormal(np.zeros(m), np.eye(m))
    x0 = rng.normal(size=(n, m))

    def make_kernel(x):
        return sv.GaussianRBFKernel(x, sv.ScaleMethod.MEDIAN, model) + rbf(
            x, 0.1 * np.eye(m)
        )

    svgd_a, traj_a = _run(x0, model, make_kernel(x0), "auto")
    assert svgd_a._phi_impl == "rbf_terms"
    svgd_g, traj_g = _run(x0, model, make_kernel(x0), "generic")
    assert svgd_g._phi_impl == "generic"
    np.testing.assert_allclose(traj_a, traj_g, rtol=1e-9)


def test_driver_rbf_terms_adaptive_product(rng):
    """Adaptive (median) slot inside a PRODUCT keeps adapting per step."""
    n, m = 20, 2
    model = sv.MultivariateNormal(np.zeros(m), np.eye(m))
    x0 = rng.normal(size=(n, m))

    def make_kernel(x):
        return sv.GaussianRBFKernel(x, sv.ScaleMethod.MEDIAN, model) * rbf(
            x, 0.05 * np.eye(m)
        )

    _, traj_t = _run(x0, model, make_kernel(x0), "rbf_terms")
    _, traj_g = _run(x0, model, make_kernel(x0), "generic")
    np.testing.assert_allclose(traj_t, traj_g, rtol=1e-9)


def test_driver_rbf_terms_rejects_custom_kernel(rng):
    n, m = 10, 2
    model = sv.MultivariateNormal(np.zeros(m), np.eye(m))
    x0 = rng.normal(size=(n, m))
    custom = sv.Kernel(
        dimension=m,
        kernel_fn=lambda x, p, loc: jnp.exp(-jnp.sum((x - loc) ** 2)),
    )
    svgd = sv.SVGD(
        sv.SVGDOptions(
            dimension=m, num_iterations=2, coordinate_matrix=x0.copy(),
            kernel=custom, model=model,
            optimizer=sv.AdaGrad(m, n, 0.1), phi_impl="rbf_terms",
        )
    )
    with pytest.raises(ValueError, match="rbf_terms"):
        svgd.initialize()


def test_sharded_rbf_terms_matches_generic(rng):
    """Sharded algebraic path (gather + ring) == sharded generic VJP path."""
    from svgdcpp_jax.parallel import (
        ShardedSVGD,
        ShardedSVGDConfig,
        make_particle_mesh,
    )

    mesh = make_particle_mesh()
    n, m, iters = 32, 2, 5
    x0 = rng.normal(size=(n, m)) * 2

    def build(mode, kernel_phi):
        model = sv.MultivariateNormal(np.zeros(m), np.eye(m))
        kernel = sv.GaussianRBFKernel(
            x0, sv.ScaleMethod.MEDIAN, model, median_method="exact"
        ) * rbf(x0, 0.05 * np.eye(m))
        return ShardedSVGD(
            model, sv.AdaGrad(m, n, 0.1), num_particles=n, dimension=m,
            mesh=mesh, kernel=kernel,
            config=ShardedSVGDConfig(
                phi_mode=mode, median_bins=16, median_passes=10,
                row_tile=4, warm_start=False, kernel_phi=kernel_phi,
            ),
        )

    ref = build("gather", "generic")
    assert ref._rbf_terms is None
    expect = np.asarray(ref.run(x0.copy(), iters))
    for mode in ("gather", "ring"):
        sh = build(mode, "rbf_terms")
        assert sh._rbf_terms is not None
        got = np.asarray(sh.run(x0.copy(), iters))
        np.testing.assert_allclose(got, expect, rtol=1e-7, atol=1e-10)


def test_sharded_rbf_terms_rejects_custom_kernel(rng):
    from svgdcpp_jax.parallel import (
        ShardedSVGD,
        ShardedSVGDConfig,
        make_particle_mesh,
    )

    n, m = 16, 2
    custom = sv.Kernel(
        dimension=m,
        kernel_fn=lambda x, p, loc: jnp.exp(-jnp.sum((x - loc) ** 2)),
    )
    with pytest.raises(ValueError, match="rbf_terms"):
        ShardedSVGD(
            sv.MultivariateNormal(np.zeros(m), np.eye(m)),
            sv.AdaGrad(m, n, 0.1), num_particles=n, dimension=m,
            mesh=make_particle_mesh(), kernel=custom,
            config=ShardedSVGDConfig(kernel_phi="rbf_terms"),
        )


def test_driver_auto_custom_kernel_still_generic(rng):
    n, m = 10, 2
    model = sv.MultivariateNormal(np.zeros(m), np.eye(m))
    x0 = rng.normal(size=(n, m))
    custom = sv.Kernel(
        dimension=m,
        kernel_fn=lambda x, p, loc: jnp.exp(-jnp.sum((x - loc) ** 2))
        * (1.0 + jnp.sum(x * loc)) ** 0,
    )
    svgd, _ = _run(x0, model, custom, "auto", steps=2)
    assert svgd._phi_impl == "generic"


# ----------------------------------------------------------------------
# Indefinite (non-PSD) precision matrices: the clamp must be skipped
# ----------------------------------------------------------------------


def _saddle_gmm_setup(rng, n=20, m=2):
    """GMM with modes at x0 = +-4: hessian-scale P is indefinite for
    particles straddling the saddle region (eigenvalues of mixed sign)."""
    m1 = sv.MultivariateNormal(np.array([4.0, 0.0]), np.eye(m))
    m2 = sv.MultivariateNormal(np.array([-4.0, 0.0]), np.eye(m))
    gmm = m1 + m2
    coords = rng.normal(size=(n, m)) * 1.5  # centered on the saddle
    return gmm, np.asarray(coords)


def test_hessian_slot_term_not_clamped(rng):
    """Composed kernel with a HESSIAN slot on a non-log-concave model:
    the algebraic path must match the generic VJP path exactly (the
    quadratic form is legitimately negative; regression for the psd
    misclassification that clamped it)."""
    from svgdcpp_jax.kernels.algebra import flatten_rbf_terms, term_psd_flags

    gmm, x0 = _saddle_gmm_setup(rng)
    n, m = x0.shape
    kernel = sv.GaussianRBFKernel(x0, sv.ScaleMethod.HESSIAN, gmm) + rbf(
        x0, 0.1 * np.eye(m)
    )
    kernel.initialize()
    terms = flatten_rbf_terms(kernel)
    flags = term_psd_flags(terms, kernel.adaptive_slots(), kernel.parameters)
    assert flags == [False, True]  # hessian slot unknown-PSD, constant PSD
    # make the indefiniteness real before comparing phi
    p_hess = np.asarray(kernel.parameters[0])
    ev = np.linalg.eigvalsh(0.5 * (p_hess + p_hess.T))
    assert ev.min() < -1e-3, ev

    coords = jnp.asarray(x0)
    scores = jnp.asarray(rng.normal(size=(n, m)))
    got = phi_rbf_terms(
        coords, scores, kernel.parameters, terms, row_tile=8, psd_flags=flags
    )
    expect = phi_generic(
        coords, scores, kernel._kernel_fn, kernel.parameters, row_tile=8
    )
    np.testing.assert_allclose(np.asarray(got), np.asarray(expect), rtol=1e-9)


def test_driver_auto_hessian_composed_matches_generic(rng):
    """End-to-end: auto-selected algebraic path on the saddle-region GMM
    with a Hessian slot equals the forced-generic trajectory."""
    gmm, x0 = _saddle_gmm_setup(rng)
    n, m = x0.shape

    def build(impl):
        model = sv.MultivariateNormal(np.array([4.0, 0.0]), np.eye(m)) + \
            sv.MultivariateNormal(np.array([-4.0, 0.0]), np.eye(m))
        kernel = sv.GaussianRBFKernel(x0, sv.ScaleMethod.HESSIAN, model) + rbf(
            x0, 0.1 * np.eye(m)
        )
        return _run(x0, model, kernel, impl, steps=4)

    svgd_a, traj_a = build("auto")
    assert svgd_a._phi_impl == "rbf_terms"
    assert svgd_a._term_psd == [False, True]
    _, traj_g = build("generic")
    np.testing.assert_allclose(traj_a, traj_g, rtol=1e-8)


def test_single_kernel_hessian_blocked_not_clamped(rng):
    """Uncomposed RBF with HESSIAN scale on a non-log-concave model: the
    blocked/dense closed forms must match the generic path (latent clamp
    bug on indefinite P, independent of the algebra feature)."""
    from svgdcpp_jax.ops.phi import phi_rbf, phi_rbf_blocked

    gmm, x0 = _saddle_gmm_setup(rng)
    n, m = x0.shape
    kernel = sv.GaussianRBFKernel(x0, sv.ScaleMethod.HESSIAN, gmm)
    kernel.initialize()
    p = kernel.parameters[0]
    assert np.linalg.eigvalsh(0.5 * np.asarray(p + p.T)).min() < -1e-3

    coords = jnp.asarray(x0)
    scores = jnp.asarray(rng.normal(size=(n, m)))
    expect = phi_generic(
        coords, scores, kernel._kernel_fn, kernel.parameters, row_tile=8
    )
    for got in (
        phi_rbf(coords, scores, p, psd=False),
        phi_rbf_blocked(coords, scores, p, row_tile=8, psd=False),
    ):
        np.testing.assert_allclose(
            np.asarray(got), np.asarray(expect), rtol=1e-9
        )
    # and the driver's own psd classification picks psd=False
    svgd = sv.SVGD(
        sv.SVGDOptions(
            dimension=m, num_iterations=1, coordinate_matrix=x0.copy(),
            kernel=sv.GaussianRBFKernel(x0, sv.ScaleMethod.HESSIAN, gmm),
            model=gmm, optimizer=sv.AdaGrad(m, n, 0.05), phi_impl="blocked",
        )
    )
    svgd.initialize()
    assert svgd._rbf_psd is False


def test_sharded_run_requires_iterations(rng):
    from svgdcpp_jax.parallel import ShardedSVGD, make_particle_mesh

    n, m = 16, 2
    model = sv.MultivariateNormal(np.zeros(m), np.eye(m))
    sh = ShardedSVGD(
        model, sv.AdaGrad(m, n, 0.1), num_particles=n, dimension=m,
        mesh=make_particle_mesh(),
    )
    with pytest.raises(ValueError, match="num_iterations"):
        sh.run(rng.normal(size=(n, m)))


def test_ksd_rejects_p_matrix_with_kernel(rng):
    from svgdcpp_jax.ops.ksd import ksd_rbf

    n, m = 16, 2
    model = sv.MultivariateNormal(np.zeros(m), np.eye(m))
    x0 = rng.normal(size=(n, m))
    kernel = rbf(x0, np.eye(m)) + rbf(x0, 0.2 * np.eye(m))
    with pytest.raises(ValueError, match="not both"):
        ksd_rbf(model, x0, p_matrix=np.eye(m), kernel=kernel)


@pytest.mark.parametrize("seed", range(8))
def test_random_tree_three_way_consistency(seed):
    """Property test: random + - * / trees of RBF leaves (depth <= 3) keep
    the oracle / rbf_terms / generic paths in agreement; non-flattenable
    trees still agree oracle-vs-generic."""
    tree_rng = np.random.default_rng(1000 + seed)
    n, m = 16, 2
    coords = jnp.asarray(tree_rng.normal(size=(n, m)))
    scores = jnp.asarray(tree_rng.normal(size=(n, m)))
    x0 = np.asarray(coords)

    def leaf():
        # small scales keep division terms' exp(+quad) in f64 range
        return rbf(x0, spd(tree_rng, m, scale=0.15))

    def build(depth):
        if depth == 0 or tree_rng.uniform() < 0.3:
            return leaf()
        op = tree_rng.choice(["+", "-", "*", "/"])
        l, r = build(depth - 1), build(depth - 1)
        if op == "+":
            return l + r
        if op == "-":
            # keep densities positive-ish is irrelevant for kernels; fine
            return l - r
        if op == "*":
            return l * r
        return l / leaf()  # single-leaf divisor stays flattenable more often

    kernel = build(3)
    expect = np.asarray(_phi_oracle(coords, scores, kernel))
    gen = np.asarray(
        phi_generic(
            coords, scores, kernel._kernel_fn, kernel.parameters, row_tile=8
        )
    )
    np.testing.assert_allclose(gen, expect, rtol=1e-8, atol=1e-12)
    terms = flatten_rbf_terms(kernel)
    if terms is not None:
        got = np.asarray(
            phi_rbf_terms(coords, scores, kernel.parameters, terms, row_tile=8)
        )
        np.testing.assert_allclose(got, expect, rtol=1e-8, atol=1e-12)
