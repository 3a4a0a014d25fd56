"""Model tests — mirrors the reference suite tests/test_model.cpp.

Pattern (reference test_model.cpp:30-149): define density functions AND
hand-derived closed forms for grad / log-grad / Hessian / log-Hessian, then
check the autodiff output against the closed forms. Covers construction,
all four composition operators (incl. dimension-mismatch throws,
test_model.cpp:186-234), the six Evaluate* methods (:246-315), and
parameter/function hot-swap on a composed model (:317-430).
"""

import jax.numpy as jnp
import numpy as np
import pytest

from svgdcpp_jax import (
    DimensionMismatchError,
    Model,
    MultivariateNormal,
    UnsetError,
    mixture,
)


def trig_fn(x, params):
    # a cos(x0) + b cos(x1) + c x0 x1 + d  (the reference oracle model,
    # tests/test_svgd.cpp:78-85)
    a, b, c, d = params
    return a * jnp.cos(x[0]) + b * jnp.cos(x[1]) + c * x[0] * x[1] + d


TRIG_PARAMS = (7.5, 10.0, 3.0, -6.0)


def trig_np(x, p=TRIG_PARAMS):
    a, b, c, d = p
    return a * np.cos(x[0]) + b * np.cos(x[1]) + c * x[0] * x[1] + d


def trig_grad_np(x, p=TRIG_PARAMS):
    a, b, c, _ = p
    return np.array([-a * np.sin(x[0]) + c * x[1], -b * np.sin(x[1]) + c * x[0]])


def trig_hess_np(x, p=TRIG_PARAMS):
    a, b, c, _ = p
    return np.array([[-a * np.cos(x[0]), c], [c, -b * np.cos(x[1])]])


def quad_fn(x, params):
    # x^T Q x + r
    q, r = params
    return x @ q @ x + r


QUAD_Q = np.array([[2.0, 0.5], [0.5, 1.0]])
QUAD_R = np.array(3.0)


def quad_np(x):
    return x @ QUAD_Q @ x + QUAD_R


def quad_grad_np(x):
    return (QUAD_Q + QUAD_Q.T) @ x


@pytest.fixture
def trig_model():
    m = Model(2, density_fn=trig_fn, parameters=TRIG_PARAMS)
    m.initialize()
    return m


@pytest.fixture
def quad_model():
    m = Model(2, density_fn=quad_fn, parameters=(QUAD_Q, QUAD_R))
    m.initialize()
    return m


class TestConstruction:
    def test_unset_raises(self):
        with pytest.raises(UnsetError):
            Model(2).initialize()

    def test_bad_dimension_raises(self):
        with pytest.raises(UnsetError):
            Model(-1, density_fn=trig_fn).initialize()

    def test_clone_is_deep(self, trig_model):
        c = trig_model.clone()
        c.update_parameters((1.0, 1.0, 1.0, 1.0))
        assert float(trig_model.parameters[0]) == 7.5
        assert float(c.parameters[0]) == 1.0


class TestEvaluate:
    def test_model_value(self, trig_model, rng):
        for _ in range(5):
            x = rng.uniform(-2, 2, 2)
            assert np.isclose(float(trig_model.evaluate_model(x)), trig_np(x))

    def test_log_model_value(self, trig_model, rng):
        x = np.array([0.1, -0.2])  # trig_np > 0 here
        assert np.isclose(
            float(trig_model.evaluate_log_model(x)), np.log(trig_np(x))
        )

    def test_model_grad(self, trig_model, rng):
        for _ in range(5):
            x = rng.uniform(-2, 2, 2)
            np.testing.assert_allclose(
                np.asarray(trig_model.evaluate_model_grad(x)), trig_grad_np(x),
                rtol=1e-12,
            )

    def test_log_model_grad(self, trig_model, rng):
        x = np.array([0.3, 0.4])
        expected = trig_grad_np(x) / trig_np(x)
        np.testing.assert_allclose(
            np.asarray(trig_model.evaluate_log_model_grad(x)), expected, rtol=1e-12
        )

    def test_model_hessian(self, trig_model, rng):
        x = np.array([0.5, -0.7])
        np.testing.assert_allclose(
            np.asarray(trig_model.evaluate_model_hessian(x)), trig_hess_np(x),
            rtol=1e-12,
        )

    def test_log_model_hessian(self, trig_model):
        # hess log f = hess f / f - (grad f)(grad f)^T / f^2
        x = np.array([0.2, 0.1])
        f, g, h = trig_np(x), trig_grad_np(x), trig_hess_np(x)
        expected = h / f - np.outer(g, g) / f**2
        np.testing.assert_allclose(
            np.asarray(trig_model.evaluate_log_model_hessian(x)), expected,
            rtol=1e-12,
        )

    def test_batched_evaluate(self, trig_model, rng):
        xs = rng.uniform(-2, 2, (7, 2))
        vals = np.asarray(trig_model.evaluate_model(xs))
        for i in range(7):
            assert np.isclose(vals[i], trig_np(xs[i]))


class TestComposition:
    def test_sum(self, trig_model, quad_model, rng):
        m = trig_model + quad_model
        x = rng.uniform(-1, 1, 2)
        assert np.isclose(float(m.evaluate_model(x)), trig_np(x) + quad_np(x))
        np.testing.assert_allclose(
            np.asarray(m.evaluate_model_grad(x)),
            trig_grad_np(x) + quad_grad_np(x),
            rtol=1e-12,
        )

    def test_difference(self, trig_model, quad_model, rng):
        m = trig_model - quad_model
        x = rng.uniform(-1, 1, 2)
        assert np.isclose(float(m.evaluate_model(x)), trig_np(x) - quad_np(x))

    def test_product(self, trig_model, quad_model, rng):
        m = trig_model * quad_model
        x = rng.uniform(-1, 1, 2)
        assert np.isclose(float(m.evaluate_model(x)), trig_np(x) * quad_np(x))
        expected = trig_grad_np(x) * quad_np(x) + trig_np(x) * quad_grad_np(x)
        np.testing.assert_allclose(
            np.asarray(m.evaluate_model_grad(x)), expected, rtol=1e-12
        )

    def test_quotient(self, trig_model, quad_model, rng):
        m = trig_model / quad_model
        x = rng.uniform(-1, 1, 2)
        assert np.isclose(float(m.evaluate_model(x)), trig_np(x) / quad_np(x))

    def test_dimension_mismatch_raises(self, trig_model):
        other = Model(3, density_fn=lambda x, p: jnp.sum(x * x))
        with pytest.raises(DimensionMismatchError):
            _ = trig_model + other

    def test_unset_operand_raises(self, trig_model):
        with pytest.raises(UnsetError):
            _ = trig_model + Model(2)

    def test_composed_log_grad(self, trig_model, quad_model):
        # grad log(f+g) = (grad f + grad g) / (f+g) — exact through the sum,
        # like the reference's single tape through both branches
        # (SURVEY.md §3.5).
        m = trig_model + quad_model
        x = np.array([0.25, -0.5])
        expected = (trig_grad_np(x) + quad_grad_np(x)) / (trig_np(x) + quad_np(x))
        np.testing.assert_allclose(
            np.asarray(m.evaluate_log_model_grad(x)), expected, rtol=1e-12
        )


class TestParameterHotSwap:
    def test_update_parameters(self, trig_model):
        x = np.array([0.5, 0.5])
        new_params = (1.0, 2.0, 3.0, 4.0)
        trig_model.update_parameters(new_params)
        assert np.isclose(
            float(trig_model.evaluate_model(x)), trig_np(x, new_params)
        )

    def test_update_on_composed(self, trig_model, quad_model):
        # Composed params = concatenation; swap the trig block
        # (reference test_model.cpp:317-430).
        m = trig_model + quad_model
        assert len(m.parameters) == 6
        new_trig = (1.0, 1.0, 1.0, 0.0)
        m.update_parameters(list(new_trig) + [QUAD_Q, QUAD_R])
        x = np.array([0.3, 0.6])
        assert np.isclose(
            float(m.evaluate_model(x)), trig_np(x, new_trig) + quad_np(x)
        )

    def test_update_function(self, trig_model):
        trig_model.update_model(lambda x, p: jnp.sum(x * x))
        trig_model.initialize()
        x = np.array([1.0, 2.0])
        assert np.isclose(float(trig_model.evaluate_model(x)), 5.0)


class TestMultivariateNormal:
    MEAN = np.array([-0.6871, 0.8010])
    COV = 5 * np.array([[0.2260, 0.1652], [0.1652, 0.6779]])

    def test_density_matches_closed_form(self, rng):
        mvn = MultivariateNormal(self.MEAN, self.COV)
        x = rng.uniform(-2, 2, 2)
        diff = x - self.MEAN
        expected = np.exp(-0.5 * diff @ np.linalg.inv(self.COV) @ diff)
        assert np.isclose(float(mvn.evaluate_model(x)), expected)

    def test_log_grad(self, rng):
        mvn = MultivariateNormal(self.MEAN, self.COV)
        x = rng.uniform(-2, 2, 2)
        expected = -np.linalg.inv(self.COV) @ (x - self.MEAN)
        np.testing.assert_allclose(
            np.asarray(mvn.evaluate_log_model_grad(x)), expected, rtol=1e-10
        )

    def test_log_hessian(self):
        mvn = MultivariateNormal(self.MEAN, self.COV)
        np.testing.assert_allclose(
            np.asarray(mvn.evaluate_log_model_hessian(np.zeros(2))),
            -np.linalg.inv(self.COV),
            rtol=1e-10,
        )

    def test_normalization_constant(self):
        mvn = MultivariateNormal(self.MEAN, self.COV)
        expected = 1.0 / (2 * np.pi * np.sqrt(np.linalg.det(self.COV)))
        assert np.isclose(mvn.get_normalization_constant(), expected)

    def test_normalized_evaluate(self, rng):
        mvn = MultivariateNormal(self.MEAN, self.COV)
        x = rng.uniform(-2, 2, 2)
        assert np.isclose(
            float(mvn.evaluate_model_normalized(x)),
            mvn.norm_const * float(mvn.evaluate_model(x)),
        )

    def test_ctor_dimension_mismatch(self):
        with pytest.raises(DimensionMismatchError):
            MultivariateNormal(np.zeros(3), np.eye(2))

    def test_update_parameters_guard(self):
        mvn = MultivariateNormal(self.MEAN, self.COV)
        with pytest.raises(DimensionMismatchError):
            mvn.update_parameters([np.zeros(3), np.eye(3)])
        mvn.update_parameters([np.zeros(2), np.eye(2)])
        assert np.isclose(mvn.get_normalization_constant(), 1.0 / (2 * np.pi))

    def test_gmm_composition(self):
        # GMM = mvn1 + mvn2 (reference gmm_example.cpp:24)
        mvn1 = MultivariateNormal(np.array([1.0, 0.0]), np.eye(2))
        mvn2 = MultivariateNormal(np.array([-1.0, 0.0]), 2 * np.eye(2))
        gmm = mvn1 + mvn2
        x = np.array([0.5, 0.5])
        e1 = np.exp(-0.5 * (x - [1, 0]) @ (x - [1, 0]))
        e2 = np.exp(-0.25 * (x - [-1, 0]) @ (x - [-1, 0]))
        assert np.isclose(float(gmm.evaluate_model(x)), e1 + e2)

    def test_mixture_matches_sum(self):
        # logsumexp mixture == log of density sum where both are finite
        mvn1 = MultivariateNormal(np.array([1.0, 0.0]), np.eye(2))
        mvn2 = MultivariateNormal(np.array([-1.0, 0.0]), 2 * np.eye(2))
        gmm_sum = mvn1 + mvn2
        gmm_mix = mixture([mvn1, mvn2])
        x = np.array([0.3, -0.4])
        assert np.isclose(
            float(gmm_mix.evaluate_log_model(x)),
            float(gmm_sum.evaluate_log_model(x)),
        )
        np.testing.assert_allclose(
            np.asarray(gmm_mix.evaluate_log_model_grad(x)),
            np.asarray(gmm_sum.evaluate_log_model_grad(x)),
            rtol=1e-10,
        )


class TestLogSpaceComposition:
    """Stable log-space composition (review finding: density-space product
    underflowed to -inf/NaN even with finite operand log-densities)."""

    def test_product_of_experts_no_underflow(self):
        m1 = MultivariateNormal(np.zeros(2), 0.01 * np.eye(2))
        m2 = MultivariateNormal(np.full(2, 3.0), 0.01 * np.eye(2))
        prod = m1 * m2
        x = np.array([4.0, 4.0])
        lv = float(prod.evaluate_log_model(x))
        # l1 + l2 = -0.5/0.01 * (|x|^2 + |x-3|^2) = -50*(32 + 2) = -1700
        assert np.isclose(lv, -1700.0)
        g = np.asarray(prod.evaluate_log_model_grad(x))
        assert np.isfinite(g).all()
        # grad = -(x)/0.01 - (x-3)/0.01 = -[400+100, ...] = -500 per coord
        np.testing.assert_allclose(g, [-500.0, -500.0], rtol=1e-10)

    def test_quotient_log_space(self):
        m1 = MultivariateNormal(np.zeros(2), np.eye(2))
        m2 = MultivariateNormal(np.ones(2), 2 * np.eye(2))
        quot = m1 / m2
        x = np.array([0.3, -0.2])
        l1 = float(m1.evaluate_log_model(x))
        l2 = float(m2.evaluate_log_model(x))
        assert np.isclose(float(quot.evaluate_log_model(x)), l1 - l2)

    def test_difference_negative_density_still_nan(self):
        # reference semantics: log of a negative composed density is NaN
        m1 = MultivariateNormal(np.zeros(2), np.eye(2))
        m2 = MultivariateNormal(np.zeros(2), np.eye(2))
        diff = m1 - m2  # density identically 0 -> log = -inf / nan
        v = float(diff.evaluate_log_model(np.array([1.0, 1.0])))
        assert not np.isfinite(v)


def test_mvn_normalization_large_dimension():
    """f32 det overflow regression: d=60 cov=40*I. The log constant must be
    finite (reference computes ~1.5e-72 in double); the plain constant may
    legitimately underflow to 0.0."""
    mvn = MultivariateNormal(np.zeros(60), 40.0 * np.eye(60))
    expected_log = -0.5 * (60 * np.log(2 * np.pi) + 60 * np.log(40.0))
    assert np.isclose(mvn.get_log_normalization_constant(), expected_log)
    x = np.zeros(60)
    val = float(mvn.evaluate_log_model_normalized(x))
    assert np.isfinite(val) and np.isclose(val, expected_log)

    # non-PSD covariance is rejected instead of yielding NaN
    bad = np.eye(3)
    bad[0, 0] = -1.0
    with pytest.raises(ValueError, match="positive definite"):
        MultivariateNormal(np.zeros(3), bad)


def test_mvn_rejected_update_leaves_model_intact():
    """A non-PD covariance update must raise BEFORE mutating parameters:
    the guard is useless if a caught error leaves a half-updated model."""
    mvn = MultivariateNormal(np.zeros(2), 2.0 * np.eye(2))
    old_const = mvn.get_normalization_constant()
    bad = np.eye(2)
    bad[1, 1] = -1.0
    with pytest.raises(ValueError, match="positive definite"):
        mvn.update_parameters([np.zeros(2), bad])
    np.testing.assert_allclose(np.asarray(mvn.parameters[1]), 2.0 * np.eye(2))
    assert mvn.get_normalization_constant() == old_const
