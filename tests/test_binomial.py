"""BinomialLikelihood model tests.

The reference's module header includes a BinomialLikelihood.hpp that does
not exist in the snapshot (SURVEY.md C14); this validates our working
implementation: closed-form log-density/score and a bounded SVGD run whose
particles concentrate near the MLE p = k/n inside (0, 1).
"""

import numpy as np
import pytest

import svgdcpp_jax as sv


def test_log_density_matches_closed_form():
    trials = np.array([20.0, 50.0])
    successes = np.array([5.0, 40.0])
    m = sv.BinomialLikelihood(trials, successes)
    x = np.array([0.3, 0.7])
    from scipy.stats import binom

    expected = sum(
        binom.logpmf(k, n, p) for n, k, p in zip(trials, successes, x)
    )
    assert np.isclose(float(m.evaluate_log_model(x)), expected)


def test_score_closed_form(rng):
    trials = np.array([30.0, 10.0, 25.0])
    successes = np.array([12.0, 3.0, 20.0])
    m = sv.BinomialLikelihood(trials, successes)
    x = rng.uniform(0.1, 0.9, 3)
    expected = successes / x - (trials - successes) / (1.0 - x)
    np.testing.assert_allclose(
        np.asarray(m.evaluate_log_model_grad(x)), expected, rtol=1e-10
    )


def test_dimension_mismatch():
    with pytest.raises(sv.DimensionMismatchError):
        sv.BinomialLikelihood(np.ones(3), np.ones(2))


def test_bounded_svgd_concentrates_at_mle(rng):
    """SVGD on the unit box recovers p_hat = k/n per coordinate."""
    trials = np.array([200.0, 100.0])
    successes = np.array([60.0, 85.0])
    mle = successes / trials  # (0.3, 0.85)
    model = sv.BinomialLikelihood(trials, successes)

    n_particles = 30
    x0 = rng.uniform(0.05, 0.95, (n_particles, 2))
    kernel = sv.GaussianRBFKernel(x0, sv.ScaleMethod.MEDIAN, model)
    svgd = sv.SVGD(
        sv.SVGDOptions(
            dimension=2,
            num_iterations=400,
            coordinate_matrix=x0,
            kernel=kernel,
            model=model,
            optimizer=sv.Adam(2, n_particles, 0.005, 0.9, 0.999),
            lower_bound=np.array([1e-3, 1e-3]),
            upper_bound=np.array([1.0 - 1e-3, 1.0 - 1e-3]),
        )
    )
    svgd.initialize()
    out = np.asarray(svgd.run())
    assert (out > 0).all() and (out < 1).all()
    post_mean = out.mean(axis=0)
    # posterior concentrates near the MLE (binomial posterior sd ~ sqrt(p q / n))
    sd = np.sqrt(mle * (1 - mle) / trials)
    assert np.all(np.abs(post_mean - mle) < 4 * sd), (post_mean, mle)


def test_ctor_value_validation():
    """successes > trials (or negatives) must raise, not silently produce a
    -inf density with a finite boundary-pushing score."""
    import pytest

    from svgdcpp_jax.models.binomial_likelihood import BinomialLikelihood

    with pytest.raises(ValueError, match="successes"):
        BinomialLikelihood(trials=[5.0], successes=[7.0])
    with pytest.raises(ValueError, match="successes"):
        BinomialLikelihood(trials=[5.0], successes=[-1.0])
    with pytest.raises(ValueError, match="successes"):
        BinomialLikelihood(trials=[-2.0], successes=[-3.0])
