"""svgdcpp_jax — Stein Variational Gradient Descent in JAX.

Brand-new JAX/XLA/Pallas implementation, functionally equivalent to the C++
reference library khaiyichin/SVGDCpp (see SURVEY.md): Model/Kernel/Optimizer
composition, Gaussian-RBF kernel with median/Hessian/constant bandwidth,
Adam/AdaGrad/RMSProp particle optimizers, bounded domains, intermediate
matrix debug logging — plus extras the reference never had: a fused
Pallas phi kernel for NVIDIA GPUs, tile-streamed O(n^2) computation that never
materializes the kernel matrix, multi-device particle sharding over a
``jax.sharding.Mesh``, a distributed median, and checkpoint/resume.
"""

from .core.exceptions import (
    DimensionMismatchError,
    SVGDError,
    UnsetError,
)
from .core.types import ParticleStore, PrecisionPolicy, as_coords
from .kernels.gaussian_rbf import GaussianRBFKernel, ScaleMethod
from .kernels.kernel import Kernel
from .models.bayesian_logistic_regression import (
    BayesianLogisticRegression,
    HierarchicalBayesianLogisticRegression,
)
from .models.binomial_likelihood import BinomialLikelihood
from .models.model import Model, mixture
from .models.multivariate_normal import MultivariateNormal
from .ops.ksd import ksd_rbf
from .optimizers.adagrad import AdaGrad
from .optimizers.adam import Adam
from .optimizers.base import Optimizer
from .optimizers.optax_adapter import OptaxOptimizer
from .optimizers.rmsprop import RMSProp
from .parallel.mesh import initialize_distributed, make_particle_mesh
from .svgd import SVGD, SVGDOptions

__version__ = "1.0.0"  # keep in sync with pyproject.toml

__all__ = [
    "SVGD",
    "SVGDOptions",
    "Model",
    "mixture",
    "MultivariateNormal",
    "BinomialLikelihood",
    "BayesianLogisticRegression",
    "HierarchicalBayesianLogisticRegression",
    "Kernel",
    "GaussianRBFKernel",
    "ScaleMethod",
    "Optimizer",
    "Adam",
    "AdaGrad",
    "RMSProp",
    "OptaxOptimizer",
    "ParticleStore",
    "PrecisionPolicy",
    "as_coords",
    "ksd_rbf",
    "initialize_distributed",
    "make_particle_mesh",
    "SVGDError",
    "DimensionMismatchError",
    "UnsetError",
]
