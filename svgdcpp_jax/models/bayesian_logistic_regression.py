"""Bayesian logistic regression targets.

BASELINE.md measurement configs 3-4: "Bayesian logistic regression, d~50,
1k particles" and "hierarchical model with custom composed kernel +
per-step bandwidth adaptation". The reference library has no built-in
likelihood models beyond the multivariate normal (its BinomialLikelihood
header is a dangling include, SURVEY.md C14); these models fill that role
the vectorized way: the whole-dataset log-likelihood is one
(num_particles x N_data) matmul under vmap.

Two targets:

  * :class:`BayesianLogisticRegression` — particles are weight vectors
    w in R^d; fixed Gaussian prior precision alpha:

        log p(w) = sum_i log sigmoid(y_i x_i . w) - alpha/2 ||w||^2

  * :class:`HierarchicalBayesianLogisticRegression` — the Liu & Wang (2016)
    hierarchical setup: particles are [w, log alpha] in R^{d+1} with a
    Gamma(a0, b0) prior on the precision alpha:

        log p(w, log a) = sum_i log sigmoid(y_i x_i . w)
                          + d/2 log a - a/2 ||w||^2          (w | a)
                          + a0 log a - b0 a                  (Gamma + Jacobian
                                                              of the log-a
                                                              parametrization)
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..core.exceptions import DimensionMismatchError
from .model import Model


def _log_sigmoid(z):
    # stable log sigmoid: -softplus(-z)
    return -jnp.logaddexp(0.0, -z)


def blr_log_density(x, params):
    features, labels, alpha = params
    logits = features @ x  # (N_data,)
    loglik = jnp.sum(_log_sigmoid(labels * logits))
    return loglik - 0.5 * alpha * jnp.sum(x * x)


class BayesianLogisticRegression(Model):
    """Logistic-regression posterior over weights with Gaussian prior."""

    def __init__(self, features, labels, prior_precision: float = 0.01):
        features = jnp.asarray(features)
        labels = jnp.reshape(jnp.asarray(labels), (-1,)).astype(features.dtype)
        if features.shape[0] != labels.shape[0]:
            raise DimensionMismatchError(
                "features and labels must agree on the data axis."
            )
        super().__init__(
            dimension=int(features.shape[1]),
            density_fn=lambda x, p: jnp.exp(blr_log_density(x, p)),
            log_density_fn=blr_log_density,
            parameters=(features, labels, jnp.asarray(prior_precision, features.dtype)),
        )

    def grad_log_density_pure(self, x, params):
        """Closed-form score (reference virtual-override pattern,
        Model.hpp:335-338):

            grad_w log p = sum_i sigmoid(-y_i z_i) y_i x_i - alpha w

        — two data-matrix contractions instead of an AD forward+backward;
        verified against jax.grad in tests/test_blr.py."""
        features, labels, alpha = params
        logits = features @ x
        s = jax.nn.sigmoid(-labels * logits)
        # jax.grad returns the tangent in x's dtype even with f64 params
        # (x64 parity lane) — match it so the scan carry dtype is stable.
        return ((s * labels) @ features - alpha * x).astype(x.dtype)


def hier_blr_log_density(x, params):
    features, labels, a0, b0 = params
    d = features.shape[1]
    w = x[:d]
    log_alpha = x[d]
    alpha = jnp.exp(log_alpha)
    logits = features @ w
    loglik = jnp.sum(_log_sigmoid(labels * logits))
    log_prior_w = 0.5 * d * log_alpha - 0.5 * alpha * jnp.sum(w * w)
    # Gamma(a0, b0) density on alpha plus the log-parametrization Jacobian
    # (d alpha = alpha d log_alpha): (a0 - 1) log a + log a = a0 log a.
    log_prior_alpha = a0 * log_alpha - b0 * alpha
    return loglik + log_prior_w + log_prior_alpha


class HierarchicalBayesianLogisticRegression(Model):
    """Hierarchical BLR: particles are [w (d), log alpha] in R^{d+1}."""

    def __init__(self, features, labels, a0: float = 1.0, b0: float = 0.01):
        features = jnp.asarray(features)
        labels = jnp.reshape(jnp.asarray(labels), (-1,)).astype(features.dtype)
        if features.shape[0] != labels.shape[0]:
            raise DimensionMismatchError(
                "features and labels must agree on the data axis."
            )
        super().__init__(
            dimension=int(features.shape[1]) + 1,
            density_fn=lambda x, p: jnp.exp(hier_blr_log_density(x, p)),
            log_density_fn=hier_blr_log_density,
            parameters=(
                features,
                labels,
                jnp.asarray(a0, features.dtype),
                jnp.asarray(b0, features.dtype),
            ),
        )

    def grad_log_density_pure(self, x, params):
        """Closed-form score in [w, log alpha] (see BayesianLogisticRegression;
        the log-alpha component is d/2 - a/2 ||w||^2 + a0 - b0 a)."""
        features, labels, a0, b0 = params
        d = features.shape[1]
        w, log_a = x[:d], x[d]
        a = jnp.exp(log_a)
        logits = features @ w
        s = jax.nn.sigmoid(-labels * logits)
        score_w = (s * labels) @ features - a * w
        score_la = 0.5 * d - 0.5 * a * jnp.sum(w * w) + a0 - b0 * a
        return jnp.concatenate(
            [score_w, jnp.reshape(score_la.astype(score_w.dtype), (1,))]
        ).astype(x.dtype)


def make_synthetic_classification(rng, n_data: int = 512, dim: int = 50,
                                  w_scale: float = 2.0):
    """Deterministic synthetic two-class data for examples/benchmarks."""
    true_w = w_scale * rng.standard_normal(dim) / (dim ** 0.5)
    features = rng.standard_normal((n_data, dim))
    logits = features @ true_w
    labels = jnp.where(
        jnp.asarray(rng.uniform(size=n_data)) < 1.0 / (1.0 + jnp.exp(-logits)),
        1.0,
        -1.0,
    )
    return jnp.asarray(features), labels, jnp.asarray(true_w)
