"""Optimizer tests: exact parity with the reference update formulas.

Each optimizer is run for several random gradient steps and compared against
a NumPy transcription of the reference's Eigen expressions
(Adam.hpp:75-96, AdaGrad.hpp:60-65, RMSProp.hpp:71-73).
"""

import numpy as np
import pytest

from svgdcpp_jax import AdaGrad, Adam, RMSProp, SVGDError

DIM, N = 3, 5
LR, EPS = 0.1, 1e-8


def run_steps(opt, grads):
    state = opt.init(np.float64)
    out = []
    for g in grads:
        state, inc = opt.step(state, g)
        out.append(np.asarray(inc))
    return out


def test_adagrad_matches_reference(rng):
    grads = [rng.normal(size=(N, DIM)) for _ in range(5)]
    incs = run_steps(AdaGrad(DIM, N, LR, EPS), grads)
    s = np.zeros((N, DIM))
    for g, inc in zip(grads, incs):
        s += g * g
        expected = LR * g / (EPS + np.sqrt(s))
        np.testing.assert_allclose(inc, expected, rtol=1e-12)


def test_rmsprop_matches_reference(rng):
    beta = 0.9
    grads = [rng.normal(size=(N, DIM)) for _ in range(5)]
    incs = run_steps(RMSProp(DIM, N, LR, beta, EPS), grads)
    s = np.zeros((N, DIM))
    for g, inc in zip(grads, incs):
        s = beta * s + (1 - beta) * g * g
        expected = LR * g / (EPS + np.sqrt(s))
        np.testing.assert_allclose(inc, expected, rtol=1e-12)


def test_adam_matches_reference(rng):
    b1, b2 = 0.9, 0.999
    grads = [rng.normal(size=(N, DIM)) for _ in range(5)]
    incs = run_steps(Adam(DIM, N, LR, b1, b2, EPS), grads)
    m = np.zeros((N, DIM))
    v = np.zeros((N, DIM))
    for t, (g, inc) in enumerate(zip(grads, incs), start=1):
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * g * g
        m_hat = m / (1 - b1**t)
        v_hat = v / (1 - b2**t)
        # epsilon BEFORE the sqrt'd v_hat — the reference's exact form
        # (Adam.hpp:82)
        expected = LR * m_hat / (EPS + np.sqrt(v_hat))
        np.testing.assert_allclose(inc, expected, rtol=1e-12)


def test_adam_rejects_bad_betas():
    with pytest.raises(SVGDError):
        Adam(DIM, N, LR, 1.0, 0.999)
    with pytest.raises(SVGDError):
        Adam(DIM, N, LR, 0.9, -0.1)


def test_rmsprop_rejects_bad_beta():
    with pytest.raises(SVGDError):
        RMSProp(DIM, N, LR, 1.5)


def test_stateful_oo_api(rng):
    # Initialize/Step parity surface (reference Optimizer.hpp:40-42)
    opt = AdaGrad(DIM, N, LR, EPS)
    opt.Initialize()
    g = rng.normal(size=(N, DIM))
    inc = np.asarray(opt.Step(g))
    expected = LR * g / (EPS + np.sqrt(g * g))
    np.testing.assert_allclose(inc, expected, rtol=1e-12)


def test_optax_adapter_runs_svgd(rng):
    """OptaxOptimizer drives a full SVGD run and converges."""
    import optax

    import svgdcpp_jax as sv

    dim, n = 2, 16
    model = sv.MultivariateNormal(np.array([1.0, -1.0]), 0.5 * np.eye(2))
    x0 = rng.normal(size=(n, dim)) * 3
    kernel = sv.GaussianRBFKernel(x0, sv.ScaleMethod.MEDIAN, model)
    svgd = sv.SVGD(
        sv.SVGDOptions(
            dimension=dim, num_iterations=300, coordinate_matrix=x0,
            kernel=kernel, model=model,
            optimizer=sv.OptaxOptimizer(optax.adam(0.1), dim, n),
        )
    )
    svgd.initialize()
    out = np.asarray(svgd.run())
    assert np.isfinite(out).all()
    np.testing.assert_allclose(out.mean(0), [1.0, -1.0], atol=0.4)


def test_optax_sgd_matches_plain_ascent(rng):
    """optax.sgd(lr) increment == lr * phi (sign convention check)."""
    import optax

    from svgdcpp_jax.optimizers.optax_adapter import OptaxOptimizer

    opt = OptaxOptimizer(optax.sgd(0.05), 2, 4)
    state = opt.init(np.float64)
    g = rng.normal(size=(4, 2))
    _, inc = opt.step(state, g)
    np.testing.assert_allclose(np.asarray(inc), 0.05 * g, rtol=1e-12)


def test_optax_params_dependent_transform(rng):
    """Params-dependent optax transforms (adamw-style weight decay) get the
    current coords threaded through step(state, grad, params)."""
    import optax

    import svgdcpp_jax as sv

    dim, n = 2, 16
    model = sv.MultivariateNormal(np.array([1.0, -1.0]), 0.5 * np.eye(2))
    x0 = rng.normal(size=(n, dim)) * 2
    kernel = sv.GaussianRBFKernel(x0, sv.ScaleMethod.MEDIAN, model)
    svgd = sv.SVGD(
        sv.SVGDOptions(
            dimension=dim, num_iterations=50, coordinate_matrix=x0,
            kernel=kernel, model=model,
            optimizer=sv.OptaxOptimizer(optax.adamw(0.1, weight_decay=1e-3),
                                        dim, n),
        )
    )
    svgd.initialize()
    out = np.asarray(svgd.run())
    assert np.isfinite(out).all()

    # the decay term actually depends on params: same grad, different params
    from svgdcpp_jax.optimizers.optax_adapter import OptaxOptimizer

    opt = OptaxOptimizer(optax.add_decayed_weights(1e-2), 2, 4)
    state = opt.init(np.float32)
    g = rng.normal(size=(4, 2)).astype(np.float32)
    p1 = np.zeros((4, 2), np.float32)
    p2 = np.ones((4, 2), np.float32)
    _, inc1 = opt.step(state, g, p1)
    _, inc2 = opt.step(state, g, p2)
    assert not np.allclose(np.asarray(inc1), np.asarray(inc2))
