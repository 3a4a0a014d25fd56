"""Bayesian logistic regression + hierarchical/composed-kernel tests.

BASELINE.md configs 3-4. Closed-form gradient checks mirror the reference's
test pattern (AD vs hand-derived forms); the composed-kernel oracle test
validates per-step bandwidth adaptation on a composed kernel end-to-end
against a NumPy per-pair loop.
"""

import jax.numpy as jnp
import numpy as np
import pytest

import svgdcpp_jax as sv
from svgdcpp_jax.models.bayesian_logistic_regression import (
    make_synthetic_classification,
)


def sigmoid(z):
    return 1.0 / (1.0 + np.exp(-z))


class TestBLR:
    def setup_method(self, _):
        rng = np.random.default_rng(7)
        self.X = rng.normal(size=(40, 5))
        self.y = np.where(rng.uniform(size=40) < 0.5, 1.0, -1.0)
        self.alpha = 0.1
        self.model = sv.BayesianLogisticRegression(self.X, self.y, self.alpha)

    def np_log_density(self, w):
        z = self.y * (self.X @ w)
        return np.sum(np.log(sigmoid(z))) - 0.5 * self.alpha * w @ w

    def np_grad(self, w):
        z = self.y * (self.X @ w)
        return (self.y * sigmoid(-z)) @ self.X - self.alpha * w

    def test_log_density(self, rng):
        w = rng.normal(size=5)
        assert np.isclose(
            float(self.model.evaluate_log_model(w)), self.np_log_density(w)
        )

    def test_score(self, rng):
        w = rng.normal(size=5)
        np.testing.assert_allclose(
            np.asarray(self.model.evaluate_log_model_grad(w)),
            self.np_grad(w),
            rtol=1e-10,
        )

    def test_svgd_recovers_weights(self, rng):
        features, labels, true_w = make_synthetic_classification(
            rng, n_data=400, dim=5
        )
        model = sv.BayesianLogisticRegression(features, labels, 0.1)
        n = 50
        x0 = rng.normal(size=(n, 5))
        kernel = sv.GaussianRBFKernel(x0, sv.ScaleMethod.MEDIAN, model)
        svgd = sv.SVGD(
            sv.SVGDOptions(
                dimension=5, num_iterations=300, coordinate_matrix=x0,
                kernel=kernel, model=model,
                optimizer=sv.Adam(5, n, 0.05, 0.9, 0.999),
            )
        )
        svgd.initialize()
        post_mean = np.asarray(svgd.run()).mean(axis=0)
        # posterior mean should classify like the true weights
        agreement = np.mean(
            np.sign(np.asarray(features) @ post_mean)
            == np.sign(np.asarray(features) @ np.asarray(true_w))
        )
        assert agreement > 0.9


class TestHierarchicalBLR:
    def test_score_matches_finite_difference(self, rng):
        X = rng.normal(size=(30, 4))
        y = np.where(rng.uniform(size=30) < 0.5, 1.0, -1.0)
        model = sv.HierarchicalBayesianLogisticRegression(X, y, a0=1.0, b0=0.01)
        x = np.concatenate([rng.normal(size=4), [0.3]])
        g = np.asarray(model.evaluate_log_model_grad(x))
        eps = 1e-6
        for k in range(5):
            xp, xm = x.copy(), x.copy()
            xp[k] += eps
            xm[k] -= eps
            fd = (
                float(model.evaluate_log_model(xp))
                - float(model.evaluate_log_model(xm))
            ) / (2 * eps)
            assert np.isclose(g[k], fd, rtol=1e-4), (k, g[k], fd)

    def test_dimension_is_d_plus_one(self, rng):
        X = rng.normal(size=(10, 7))
        y = np.ones(10)
        model = sv.HierarchicalBayesianLogisticRegression(X, y)
        assert model.dimension == 8


class TestComposedAdaptiveKernel:
    """Composed kernel with a per-step adaptive RBF slot (BASELINE config 4)."""

    def test_adaptive_slots_exposed(self, rng):
        x0 = rng.normal(size=(10, 3))
        model = sv.MultivariateNormal(np.zeros(3), np.eye(3))
        k_ad = sv.GaussianRBFKernel(x0, sv.ScaleMethod.MEDIAN, model)
        k_fix = sv.GaussianRBFKernel(
            x0, sv.ScaleMethod.CONSTANT, constant_scale=0.5 * np.eye(3)
        )
        comp = k_ad + k_fix
        assert len(comp.parameters) == 2
        slots = comp.adaptive_slots()
        assert len(slots) == 1 and slots[0][0] == 0 and slots[0][1] is k_ad

    def test_composed_adaptive_matches_manual_loop(self, rng):
        n, dim, iters = 8, 2, 4
        mean = np.array([0.3, -0.5])
        cov = np.array([[1.0, 0.2], [0.2, 0.7]])
        cov_inv = np.linalg.inv(cov)
        p0 = np.array([[0.4, 0.0], [0.0, 0.6]])
        x0 = rng.normal(size=(n, dim))

        model = sv.MultivariateNormal(mean, cov)
        k_ad = sv.GaussianRBFKernel(
            x0, sv.ScaleMethod.MEDIAN, model, median_method="exact"
        )
        k_fix = sv.GaussianRBFKernel(x0, sv.ScaleMethod.CONSTANT, constant_scale=p0)
        comp = k_ad + k_fix
        svgd = sv.SVGD(
            sv.SVGDOptions(
                dimension=dim, num_iterations=iters, coordinate_matrix=x0.copy(),
                kernel=comp, model=model, optimizer=sv.AdaGrad(dim, n, 0.1),
            )
        )
        svgd.initialize()
        result = np.asarray(svgd.run())

        # NumPy oracle: k = exp(-g||d||^2) + exp(-d^T P0 d), g from median
        def np_median_gamma(x):
            d = np.sqrt(((x[:, None, :] - x[None, :, :]) ** 2).sum(-1)).ravel()
            d.sort()
            t = d.size
            med = 0.5 * (d[t // 2 - 1] + d[t // 2]) if t % 2 == 0 else d[t // 2]
            return np.log(n) / med**2

        x = x0.copy()
        s_accum = np.zeros_like(x)
        for _ in range(iters):
            g = np_median_gamma(x)
            phi = np.zeros_like(x)
            for i in range(n):
                for j in range(n):
                    d = x[j] - x[i]
                    k1 = np.exp(-g * d @ d)
                    k2 = np.exp(-d @ p0 @ d)
                    score = -cov_inv @ (x[j] - mean)
                    grad_k = -2.0 * g * d * k1 - (p0 + p0.T) @ d * k2
                    phi[i] += (k1 + k2) * score + grad_k
            phi /= n
            s_accum += phi * phi
            x = x + 0.1 * phi / (1e-8 + np.sqrt(s_accum))

        np.testing.assert_allclose(result, x, rtol=1e-8, atol=1e-12)


class TestBenchBaselines:
    """bench.py's vectorized NumPy baselines must implement the exact same
    per-step algorithm as the JAX engine (they anchor vs_baseline for
    BASELINE configs 3-4)."""

    @staticmethod
    def _bench():
        import sys
        from pathlib import Path

        sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
        import bench

        return bench

    @pytest.mark.parametrize("hierarchical", [False, True])
    def test_numpy_blr_baseline_matches_engine(self, rng, hierarchical):
        bench = self._bench()
        n, d, n_data, iters = 12, 3, 30, 5
        X = rng.normal(size=(n_data, d))
        y = np.where(rng.uniform(size=n_data) < 0.5, 1.0, -1.0)
        full_dim = d + 1 if hierarchical else d
        x0 = rng.normal(size=(n, full_dim))

        if hierarchical:
            model = sv.HierarchicalBayesianLogisticRegression(X, y)
        else:
            model = sv.BayesianLogisticRegression(X, y, 0.1)
        kernel = sv.GaussianRBFKernel(
            x0, sv.ScaleMethod.MEDIAN, model, median_method="exact"
        )
        if hierarchical:
            kernel = kernel + sv.GaussianRBFKernel(
                x0, sv.ScaleMethod.CONSTANT,
                constant_scale=0.1 * np.eye(full_dim),
            )
        svgd = sv.SVGD(
            sv.SVGDOptions(
                dimension=full_dim, num_iterations=iters,
                coordinate_matrix=x0.copy(), kernel=kernel, model=model,
                optimizer=sv.Adam(full_dim, n, 5e-2, 0.9, 0.999),
            )
        )
        svgd.initialize()
        engine = np.asarray(svgd.run())

        x = x0.astype(np.float64).copy()
        opt = {"m": np.zeros_like(x), "v": np.zeros_like(x), "t": 0}
        for _ in range(iters):
            x, opt = bench.numpy_blr_step(
                x, opt, X, y, hierarchical, 5e-2, 0.9, 0.999
            )
        np.testing.assert_allclose(engine, x, rtol=1e-8, atol=1e-11)


def test_hessian_bandwidth_on_blr(rng):
    """Hessian (Stein-Newton) bandwidth with a data-driven model: the scale
    is SPD for the log-concave BLR posterior and the run stays finite."""
    X = rng.normal(size=(60, 4))
    y = np.where(rng.uniform(size=60) < 0.5, 1.0, -1.0)
    model = sv.BayesianLogisticRegression(X, y, 0.1)
    n = 20
    x0 = rng.normal(size=(n, 4))
    kernel = sv.GaussianRBFKernel(x0, sv.ScaleMethod.HESSIAN, model)
    p0 = np.asarray(kernel.parameters[0])
    eig = np.linalg.eigvalsh(0.5 * (p0 + p0.T))
    assert (eig > 0).all()  # log-concave => -hessian PSD => P SPD

    svgd = sv.SVGD(
        sv.SVGDOptions(dimension=4, num_iterations=20, coordinate_matrix=x0,
                       kernel=kernel, model=model,
                       optimizer=sv.AdaGrad(4, n, 0.05))
    )
    svgd.initialize()
    out = np.asarray(svgd.run())
    assert np.isfinite(out).all()


class TestClosedFormScore:
    """The models' grad_log_density_pure overrides (reference virtual
    Evaluate* pattern, Model.hpp:335-338) must equal jax.grad of the log
    density, and the driver must actually route scores through the
    override."""

    def test_blr_score_matches_autodiff(self, rng):
        import jax

        features, labels, _ = make_synthetic_classification(
            rng, n_data=64, dim=7
        )
        model = sv.BayesianLogisticRegression(features, labels, 0.1)
        params = tuple(model.parameters)
        for _ in range(3):
            x = jnp.asarray(rng.normal(size=7))
            ad = jax.grad(model.log_density_pure)(x, params)
            closed = model.grad_log_density_pure(x, params)
            np.testing.assert_allclose(
                np.asarray(closed), np.asarray(ad), rtol=1e-10
            )

    def test_hier_score_matches_autodiff(self, rng):
        import jax

        features, labels, _ = make_synthetic_classification(
            rng, n_data=64, dim=5
        )
        model = sv.HierarchicalBayesianLogisticRegression(features, labels)
        params = tuple(model.parameters)
        for _ in range(3):
            x = jnp.asarray(rng.normal(size=6))
            ad = jax.grad(model.log_density_pure)(x, params)
            closed = model.grad_log_density_pure(x, params)
            np.testing.assert_allclose(
                np.asarray(closed), np.asarray(ad), rtol=1e-10
            )

    def test_driver_honors_score_override(self, rng):
        """A model whose score override doubles the gradient must produce
        the same trajectory as annealing with tau=2 on the base model —
        proof the scan calls grad_log_density_pure, not jax.grad directly."""
        n, dim, iters = 24, 2, 5
        mean, cov = np.zeros(dim), np.eye(dim)
        x0 = rng.normal(size=(n, dim))

        class DoubledScore(sv.MultivariateNormal):
            def grad_log_density_pure(self, x, params):
                return 2.0 * super().grad_log_density_pure(x, params)

        def run(model, annealing=None):
            svgd = sv.SVGD(
                sv.SVGDOptions(
                    dimension=dim, num_iterations=iters,
                    coordinate_matrix=x0.copy(),
                    kernel=sv.GaussianRBFKernel(
                        x0, sv.ScaleMethod.MEDIAN, model,
                        median_method="exact",
                    ),
                    model=model, optimizer=sv.AdaGrad(dim, n, 0.1),
                    annealing=annealing,
                )
            )
            svgd.initialize()
            return np.asarray(svgd.run())

        doubled = run(DoubledScore(mean, cov))
        base_tau2 = run(
            sv.MultivariateNormal(mean, cov),
            annealing=np.full(iters, 2.0),
        )
        np.testing.assert_allclose(doubled, base_tau2, rtol=1e-12)
