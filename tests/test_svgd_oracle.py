"""End-to-end SVGD oracle test — mirrors reference tests/test_svgd.cpp.

The reference runs its SVGD class 15 iterations on a 2-D custom model with a
simple RBF kernel, Adam, and bounds, then re-implements every step manually
with plain double loops and requires isApprox equality
(test_svgd.cpp:21-63, 190-203). Here the oracle is a NumPy per-pair loop and
the framework runs the whole 15 iterations inside one jitted lax.scan.
"""

import numpy as np
import pytest

import svgdcpp_jax as sv

DIM, N_PARTICLES, N_ITER = 2, 10, 15
LOWER = np.array([-1.0, -1.0])
UPPER = np.array([1.0, 1.0])
MODEL_PARAMS = (7.5, 10.0, 3.0, -6.0)


def model_fn(x, params):
    # a cos(x0) + b cos(x1) + c x0 x1 + d (reference test_svgd.cpp:78-85)
    import jax.numpy as jnp

    a, b, c, d = params
    return a * jnp.cos(x[0]) + b * jnp.cos(x[1]) + c * x[0] * x[1] + d


def kernel_fn(x, params, location):
    import jax.numpy as jnp

    diff = x - location
    return jnp.exp(-diff @ diff)


# ---------------------------------------------------------------------------
# NumPy oracle (reference ManualSVGDStep, test_svgd.cpp:21-63)
# ---------------------------------------------------------------------------


def np_model(x, p=MODEL_PARAMS):
    a, b, c, d = p
    return a * np.cos(x[0]) + b * np.cos(x[1]) + c * x[0] * x[1] + d


def np_log_model_grad(x, p=MODEL_PARAMS):
    a, b, c, _ = p
    g = np.array([-a * np.sin(x[0]) + c * x[1], -b * np.sin(x[1]) + c * x[0]])
    return g / np_model(x, p)


def np_kernel(x, loc):
    d = x - loc
    return np.exp(-d @ d)


def np_kernel_grad(x, loc):
    d = x - loc
    return -2.0 * d * np.exp(-d @ d)


class NpAdam:
    def __init__(self, lr, b1, b2, eps=1e-8):
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        self.m = 0.0
        self.v = 0.0
        self.t = 0

    def step(self, g):
        self.m = self.b1 * self.m + (1 - self.b1) * g
        self.v = self.b2 * self.v + (1 - self.b2) * g * g
        self.t += 1
        m_hat = self.m / (1 - self.b1**self.t)
        v_hat = self.v / (1 - self.b2**self.t)
        return self.lr * m_hat / (self.eps + np.sqrt(v_hat))


def manual_svgd_step(x, opt, log_grad_fn, k_fn, kg_fn, lower, upper):
    """One manual step over (n, m) particles (reference test_svgd.cpp:21-63)."""
    n = x.shape[0]
    phi = np.zeros_like(x)
    for i in range(n):
        for j in range(n):
            kv = k_fn(x[j], x[i])
            phi[i] += kv * log_grad_fn(x[j]) + kg_fn(x[j], x[i])
    phi /= n
    x_out = x + opt.step(phi)
    return np.clip(x_out, lower, upper)


# ---------------------------------------------------------------------------


def build_svgd(x0, **extra):
    model = sv.Model(DIM, density_fn=model_fn, parameters=MODEL_PARAMS)
    kernel = sv.Kernel(DIM, kernel_fn=kernel_fn)
    opt = sv.Adam(DIM, N_PARTICLES, 0.1, 0.9, 0.999)
    options = sv.SVGDOptions(
        dimension=DIM,
        num_iterations=N_ITER,
        coordinate_matrix=x0,
        kernel=kernel,
        model=model,
        optimizer=opt,
        lower_bound=LOWER,
        upper_bound=UPPER,
        **extra,
    )
    return sv.SVGD(options)


def test_svgd_matches_manual_loop(rng):
    x0 = rng.uniform(-1, 1, (N_PARTICLES, DIM))

    svgd = build_svgd(x0.copy())
    svgd.initialize()
    result = np.asarray(svgd.run())

    x = x0.copy()
    opt = NpAdam(0.1, 0.9, 0.999)
    for _ in range(N_ITER):
        x = manual_svgd_step(
            x, opt, np_log_model_grad, np_kernel, np_kernel_grad, LOWER, UPPER
        )

    assert not np.allclose(x0, x)  # particles moved
    np.testing.assert_allclose(result, x, rtol=1e-9, atol=1e-12)


def test_svgd_with_debug_logging(tmp_path, rng):
    x0 = rng.uniform(-1, 1, (N_PARTICLES, DIM))
    path = str(tmp_path / "log.txt")
    svgd = build_svgd(
        x0.copy(),
        log_intermediate_matrices=True,
        intermediate_matrices_output_path=path,
    )
    svgd.initialize()
    result_logged = np.asarray(svgd.run())

    # Logging must not perturb the trajectory
    svgd2 = build_svgd(x0.copy())
    svgd2.initialize()
    np.testing.assert_allclose(result_logged, np.asarray(svgd2.run()), rtol=1e-12)

    text = open(path).read()
    assert text.count("========== Step") == N_ITER
    for section in ("LogModelGrad=", "Kernel=", "KernelGrad=", "CoordMat="):
        assert text.count(section) == N_ITER
    # Spot-check: Step 1 LogModelGrad first column = grad log p(x0_particle0)
    first_block = text.split("LogModelGrad=\n")[1].split("\n\n")[0]
    mat = np.array([[float(v) for v in row.split()] for row in first_block.split("\n")])
    np.testing.assert_allclose(mat[:, 0], np_log_model_grad(x0[0]), rtol=1e-6)


def test_rbf_adaptive_median_oracle(rng):
    """End-to-end adaptive-bandwidth parity: RBF median + AdaGrad, 5 steps.

    Exercises the in-graph bandwidth recomputation path (reference kernel
    Step(), GaussianRBFKernel.hpp:141-156) against a NumPy oracle.
    """
    n, dim, iters = 8, 2, 5
    mean = np.array([-0.6871, 0.8010])
    cov = 5 * np.array([[0.2260, 0.1652], [0.1652, 0.6779]])
    cov_inv = np.linalg.inv(cov)
    x0 = rng.uniform(-3, 3, (n, dim))

    model = sv.MultivariateNormal(mean, cov)
    kernel = sv.GaussianRBFKernel(x0, sv.ScaleMethod.MEDIAN, model)
    opt = sv.AdaGrad(dim, n, 0.1)
    svgd = sv.SVGD(
        sv.SVGDOptions(
            dimension=dim,
            num_iterations=iters,
            coordinate_matrix=x0.copy(),
            kernel=kernel,
            model=model,
            optimizer=opt,
        )
    )
    svgd.initialize()
    result = np.asarray(svgd.run())

    # NumPy oracle
    def np_median_scale(x):
        d = np.sqrt(((x[:, None, :] - x[None, :, :]) ** 2).sum(-1)).ravel()
        d.sort()
        t = d.shape[0]
        med = 0.5 * (d[t // 2 - 1] + d[t // 2]) if t % 2 == 0 else d[t // 2]
        return np.log(n) / med**2

    x = x0.copy()
    s_accum = np.zeros_like(x)
    for _ in range(iters):
        gamma = np_median_scale(x)
        phi = np.zeros_like(x)
        for i in range(n):
            for j in range(n):
                diff = x[j] - x[i]
                kv = np.exp(-gamma * diff @ diff)
                score = -cov_inv @ (x[j] - mean)
                phi[i] += kv * score + (-2.0 * gamma * diff * kv)
        phi /= n
        s_accum += phi * phi
        x = x + 0.1 * phi / (1e-8 + np.sqrt(s_accum))

    np.testing.assert_allclose(result, x, rtol=1e-8, atol=1e-12)


@pytest.mark.parametrize("impl", ["dense", "blocked", "generic"])
def test_phi_impls_agree(rng, impl):
    """All phi implementations produce the same update for an RBF kernel."""
    n, dim = 12, 3
    x0 = rng.normal(size=(n, dim))
    mean = np.zeros(dim)
    cov = np.eye(dim)

    model = sv.MultivariateNormal(mean, cov)
    kernel = sv.GaussianRBFKernel(x0, sv.ScaleMethod.MEDIAN, model)
    opt = sv.AdaGrad(dim, n, 0.05)
    svgd = sv.SVGD(
        sv.SVGDOptions(
            dimension=dim,
            num_iterations=3,
            coordinate_matrix=x0.copy(),
            kernel=kernel,
            model=model,
            optimizer=opt,
            phi_impl=impl,
            row_tile=5,  # force multiple ragged tiles in blocked mode
        )
    )
    svgd.initialize()
    result = np.asarray(svgd.run())

    if not hasattr(test_phi_impls_agree, "_ref"):
        test_phi_impls_agree._ref = {}
    key = None
    ref = test_phi_impls_agree._ref.setdefault(key, result)
    np.testing.assert_allclose(result, ref, rtol=1e-10, atol=1e-13)


def test_blocked_gram_branch_large_m(rng):
    """m > 4 routes the blocked phi through the Gram-identity branch; it
    must agree with the dense path."""
    from svgdcpp_jax.ops.phi import phi_rbf, phi_rbf_blocked

    n, m = 30, 6
    coords = np.asarray(rng.normal(size=(n, m)))
    scores = np.asarray(rng.normal(size=(n, m)))
    p_mat = np.eye(m) * 0.3 + 0.05
    dense = np.asarray(phi_rbf(coords, scores, p_mat))
    blocked = np.asarray(phi_rbf_blocked(coords, scores, p_mat, row_tile=8))
    np.testing.assert_allclose(blocked, dense, rtol=1e-10)
