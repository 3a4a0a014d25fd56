"""Bayesian logistic regression example (BASELINE.md config 3).

d~50 weight dimensions, 1k particles, Gaussian-RBF median-bandwidth kernel,
Adam. The dataset is synthetic two-class data; the posterior mean should
classify like the generating weights.
"""

import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import svgdcpp_jax as sv
from svgdcpp_jax.models.bayesian_logistic_regression import (
    make_synthetic_classification,
)


def run(num_particles=1000, num_iterations=500, dim=50, n_data=1024, seed=0,
        verbose=True):
    rng = np.random.default_rng(seed)
    features, labels, true_w = make_synthetic_classification(
        rng, n_data=n_data, dim=dim
    )
    model = sv.BayesianLogisticRegression(features, labels, prior_precision=0.1)

    x0 = rng.normal(size=(num_particles, dim)).astype(np.float32)
    kernel = sv.GaussianRBFKernel(x0, sv.ScaleMethod.MEDIAN, model)
    optimizer = sv.Adam(dim, num_particles, 5e-2, 0.9, 0.999)

    svgd = sv.SVGD(
        sv.SVGDOptions(
            dimension=dim,
            num_iterations=num_iterations,
            coordinate_matrix=x0,
            kernel=kernel,
            model=model,
            optimizer=optimizer,
        )
    )
    svgd.initialize()
    final = np.asarray(svgd.run())

    post_mean = final.mean(axis=0)
    agreement = np.mean(
        np.sign(np.asarray(features) @ post_mean)
        == np.sign(np.asarray(features) @ np.asarray(true_w))
    )
    if verbose:
        print(f"posterior-mean vs true-weight label agreement: {agreement:.3f}")
    return final, agreement, np.asarray(true_w)


if __name__ == "__main__":
    from svgdcpp_jax.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    run()
