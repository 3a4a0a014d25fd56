"""Multivariate normal model.

JAX redesign of the reference MultivariateNormal
(reference: include/SVGDCpp/Model/MultivariateNormal.hpp).

The density function matches the reference's unnormalized form
``exp(-0.5 (x-mu)^T Sigma^{-1} (x-mu))`` (MultivariateNormal.hpp:56-61).
Unlike the reference — which takes ``params[1].inverse()`` inside the AD
tape — the solve here uses a Cholesky factorization (SURVEY.md §7), which is
both faster and numerically stable, and a closed-form log-density is
supplied so the score never round-trips through exp/log.

Parity surface kept from the reference:
  * params = (mean, covariance) (MultivariateNormal.hpp:49-50)
  * normalization constant 1/((2 pi)^{d/2} |Sigma|^{1/2})
    (MultivariateNormal.hpp:182-186)
  * normalized evaluate variants (MultivariateNormal.hpp:143-168)
  * guarded ``update_parameters`` that re-derives the constant
    (MultivariateNormal.hpp:94-115)
"""

from __future__ import annotations

import math

import jax.numpy as jnp
import jax.scipy.linalg

from ..core.exceptions import DimensionMismatchError, compare_vector_sizes
from .model import Model


def _mvn_quad(x, params):
    """0.5 (x-mu)^T Sigma^{-1} (x-mu) via Cholesky solve."""
    mean, cov = params[0], params[1]
    diff = x - jnp.reshape(mean, (-1,))
    chol = jnp.linalg.cholesky(cov)
    w = jax.scipy.linalg.solve_triangular(chol, diff, lower=True)
    return 0.5 * jnp.dot(w, w)


def mvn_density(x, params):
    """Unnormalized gaussian density (reference MultivariateNormal.hpp:56-61)."""
    return jnp.exp(-_mvn_quad(x, params))


def mvn_log_density(x, params):
    """Unnormalized gaussian log-density: -0.5 (x-mu)^T Sigma^{-1} (x-mu)."""
    return -_mvn_quad(x, params)


class MultivariateNormal(Model):
    """Multivariate normal target with unnormalized/normalized evaluators."""

    def __init__(self, mean, covariance):
        mean = jnp.reshape(jnp.asarray(mean), (-1,))
        covariance = jnp.asarray(covariance)
        if not (
            compare_vector_sizes(mean, covariance[:, 0])
            and compare_vector_sizes(mean, covariance[0, :])
        ):
            raise DimensionMismatchError(
                "Dimensions of parameter vectors/matrices do not match."
            )
        super().__init__(
            dimension=int(mean.shape[0]),
            density_fn=mvn_density,
            log_density_fn=mvn_log_density,
            parameters=(mean, covariance),
        )
        self._compute_normalization_constant()

    # ------------------------------------------------------------------
    def update_parameters(self, params):
        """Guarded parameter update (reference MultivariateNormal.hpp:94-115)."""
        mean = jnp.reshape(jnp.asarray(params[0]), (-1,))
        covariance = jnp.asarray(params[1])
        if not (
            compare_vector_sizes(mean, covariance[:, 0])
            and compare_vector_sizes(mean, covariance[0, :])
        ):
            raise DimensionMismatchError(
                "Dimensions of parameter vectors/matrices do not match each "
                "other (# of rows must be equal)."
            )
        if int(mean.shape[0]) != self.dimension:
            raise DimensionMismatchError(
                "Dimensions of parameter vectors/matrices do not match "
                "original dimension."
            )
        # Validate (slogdet raises on non-PD) BEFORE mutating any state so
        # a rejected update leaves the model fully on its old parameters.
        log_const = self._derive_log_norm_const(covariance)
        self.parameters = (mean, covariance)
        self._set_norm_const(log_const)

    def _derive_log_norm_const(self, covariance) -> float:
        """log of 1/((2 pi)^{d/2} |Sigma|^{1/2}) (reference
        MultivariateNormal.hpp:182-186), via a host f64 slogdet: an f32
        determinant over/underflows around d ~ 50 (det(40*I_60) = inf in
        f32), which would silently zero the constant where the
        double-precision reference stays finite. Raises on non-PD input.
        """
        import numpy as np

        cov = np.asarray(covariance, dtype=np.float64)
        sign, logdet = np.linalg.slogdet(cov)
        if sign <= 0:
            raise ValueError("Covariance matrix must be positive definite.")
        return float(
            -0.5 * (self.dimension * math.log(2.0 * math.pi) + logdet)
        )

    def _set_norm_const(self, log_const: float):
        self._log_norm_const = log_const
        # may underflow to 0.0 for large d — use the log form then
        self.norm_const = math.exp(log_const)

    def _compute_normalization_constant(self):
        self._set_norm_const(self._derive_log_norm_const(self.parameters[1]))

    def get_normalization_constant(self) -> float:
        return self.norm_const

    def get_log_normalization_constant(self) -> float:
        """log of the constant, finite even where norm_const underflows."""
        return self._log_norm_const

    # Normalized variants (reference MultivariateNormal.hpp:143-168)
    def evaluate_model_normalized(self, x):
        return self.norm_const * self.evaluate_model(x)

    def evaluate_log_model_normalized(self, x):
        return self._log_norm_const + self.evaluate_log_model(x)

    def evaluate_model_grad_normalized(self, x):
        return self.norm_const * self.evaluate_model_grad(x)

    # CamelCase aliases
    UpdateParameters = update_parameters
    GetNormalizationConstant = get_normalization_constant
    GetLogNormalizationConstant = get_log_normalization_constant
    EvaluateModelNormalized = evaluate_model_normalized
    EvaluateLogModelNormalized = evaluate_log_model_normalized
    EvaluateModelGradNormalized = evaluate_model_grad_normalized
