"""Multivariate-normal example.

Mirror of the reference example (reference:
examples/multivariate_normal/mvn_example.cpp:9-35): 2-D MVN target,
10 particles, 1000 iterations, Gaussian-RBF kernel with median bandwidth,
AdaGrad lr=0.1, x0 ~ 3*U(-1,1).

Prints initial and final particle coordinates like the reference binary so
the notebook-style overlay workflow (examples/README.md) carries over.
"""

import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import svgdcpp_jax as sv


def run(num_particles=10, num_iterations=1000, seed=0, verbose=True):
    mean = np.array([-0.6871, 0.8010])
    covariance = 5.0 * np.array([[0.2260, 0.1652], [0.1652, 0.6779]])

    mvn = sv.MultivariateNormal(mean, covariance)

    dim = 2
    rng = np.random.default_rng(seed)
    x0 = 3.0 * rng.uniform(-1.0, 1.0, (num_particles, dim))

    if verbose:
        print("Initial particle coordinates")
        print(x0.T)  # reference prints m x n

    kernel = sv.GaussianRBFKernel(x0, sv.ScaleMethod.MEDIAN, mvn)
    optimizer = sv.AdaGrad(dim, num_particles, 1.0e-1)

    svgd = sv.SVGD(
        sv.SVGDOptions(
            dimension=dim,
            num_iterations=num_iterations,
            coordinate_matrix=x0,
            kernel=kernel,
            model=mvn,
            optimizer=optimizer,
        )
    )
    svgd.initialize()
    final = np.asarray(svgd.run())

    if verbose:
        print("Final particle coordinates")
        print(final.T)
    return x0, final, mean, covariance


if __name__ == "__main__":
    from svgdcpp_jax.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    run()
