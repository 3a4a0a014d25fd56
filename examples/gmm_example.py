"""Gaussian-mixture example.

Mirror of the reference example (reference:
examples/gaussian_mixture_model/gmm_example.cpp:9-45): GMM = MVN1 + MVN2 via
sum composition, 20 particles, 1000 iterations, RBF-median kernel,
Adam(0.1, 0.9, 0.999), x0 ~ 8*U(-1,1).
"""

import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import svgdcpp_jax as sv


def run(num_particles=20, num_iterations=1000, seed=0, verbose=True):
    mean1 = np.array([3.6871, -2.801])
    mean2 = np.array([-2.9802, 4.3387])
    cov1 = 5.0 * np.array([[0.5001, 0.2426], [0.2426, 0.8420]])
    cov2 = 5.0 * np.array([[0.6779, -0.1652], [-0.1652, 0.2260]])

    mvn1 = sv.MultivariateNormal(mean1, cov1)
    mvn2 = sv.MultivariateNormal(mean2, cov2)
    gmm = mvn1 + mvn2  # sum composition (reference gmm_example.cpp:24)

    dim = 2
    rng = np.random.default_rng(seed)
    x0 = 8.0 * rng.uniform(-1.0, 1.0, (num_particles, dim))

    if verbose:
        print("Initial particle coordinates")
        print(x0.T)

    kernel = sv.GaussianRBFKernel(x0, sv.ScaleMethod.MEDIAN, gmm)
    optimizer = sv.Adam(dim, num_particles, 1.0e-1, 0.9, 0.999)

    svgd = sv.SVGD(
        sv.SVGDOptions(
            dimension=dim,
            num_iterations=num_iterations,
            coordinate_matrix=x0,
            kernel=kernel,
            model=gmm,
            optimizer=optimizer,
        )
    )
    svgd.initialize()
    final = np.asarray(svgd.run())

    if verbose:
        print("Final particle coordinates")
        print(final.T)
    return x0, final, (mean1, cov1), (mean2, cov2)


if __name__ == "__main__":
    from svgdcpp_jax.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    run()
