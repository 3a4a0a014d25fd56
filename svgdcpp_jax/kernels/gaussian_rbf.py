"""Gaussian RBF kernel with adaptive bandwidth.

JAX redesign of the reference GaussianRBFKernel
(reference: include/SVGDCpp/Kernel/GaussianRBFKernel.hpp).

    k(x, x') = exp( -(x - x')^T P (x - x') )        (reference :75-81)

where P is the inverse-scale matrix parameter, recomputed every SVGD step
(reference Step() override :141-156) by one of:

  * MEDIAN  — Liu & Wang 2016 heuristic: P = log(n) / median^2 * I, median
              over ALL n^2 pairwise distances including self-zeros
              (reference :164-187, :66).
  * HESSIAN — Stein variational Newton: P = 1/(2 d n) * sum_i -hess log p(x_i)
              (reference :189-210; requires a model, throws otherwise :55-58).
  * CONSTANT — fixed user-provided P. The reference left this as a TODO
              (reference :29); implemented here.

Where the reference re-records its CppAD tape after every bandwidth update
(reference :155), here the bandwidth is just data flowing through the jitted
step — ``compute_scale_pure`` is a pure function of the particle positions
that the SVGD scan calls inline.
"""

from __future__ import annotations

import enum
from typing import Optional

import jax
import jax.numpy as jnp

from ..core.exceptions import DimensionMismatchError, UnsetError
from ..core.types import ParticleStore, as_store
from ..models.model import Model
from ..ops.median import pairwise_distance_median
from .kernel import Kernel


class ScaleMethod(enum.Enum):
    MEDIAN = 0
    HESSIAN = 1
    CONSTANT = 2


def rbf_kernel_fn(x, params, location):
    """k(x, x') = exp(-(x-x')^T P (x-x')) (reference GaussianRBFKernel.hpp:75-81)."""
    diff = x - location
    return jnp.exp(-diff @ params[0] @ diff)


def scale_from_median(med, n: int, m: int, dtype) -> jnp.ndarray:
    """P = log(n) / median^2 * I — THE bandwidth formula (reference
    GaussianRBFKernel.hpp:187); single definition shared by every selection
    path (exact/hybrid/warm, sharded, ring). The scalar is cast to the
    requested dtype BEFORE the product: the warm/bisect median arrives in
    f64 under x64 and would otherwise promote the whole scale matrix (and
    the downstream phi accumulators)."""
    gamma = (jnp.log(float(n)) / (med * med)).astype(dtype)
    return gamma * jnp.eye(m, dtype=dtype)


def median_scale(coords: jnp.ndarray, median_method: str = "auto") -> jnp.ndarray:
    """P = log(n) / median^2 * I (reference GaussianRBFKernel.hpp:179-187)."""
    n, m = coords.shape
    med = pairwise_distance_median(coords, method=median_method)
    return scale_from_median(med, n, m, coords.dtype)


def hessian_scale(coords: jnp.ndarray, hessian_fn, model_params) -> jnp.ndarray:
    """P = 1/(2 d n) * sum_i -hess log p(x_i) (reference GaussianRBFKernel.hpp:199-209).

    ``hessian_fn(x, params) -> (m, m)`` is the model's
    ``hessian_log_density_pure`` — routed through the score so a
    closed-form ``grad_log_density_pure`` override is honored here like on
    every other hot path (CLAUDE.md convention).
    """
    n, m = coords.shape
    hessians = jax.vmap(lambda x: hessian_fn(x, model_params))(coords)
    return -jnp.sum(hessians, axis=0) / (2.0 * m * n)


class GaussianRBFKernel(Kernel):
    """Gaussian RBF kernel sharing the particle store with the driver."""

    ScaleMethod = ScaleMethod  # nested-enum parity with the reference

    def __init__(
        self,
        coords,
        method: ScaleMethod = ScaleMethod.MEDIAN,
        model: Optional[Model] = None,
        constant_scale=None,
        median_method: str = "auto",
    ):
        store = as_store(coords)
        super().__init__(dimension=store.dimension, kernel_fn=rbf_kernel_fn)
        self.scale_method = method
        self.store: ParticleStore = store
        self.target_model = model
        self.median_method = median_method

        if method == ScaleMethod.HESSIAN and model is None:
            # reference GaussianRBFKernel.hpp:55-58
            raise UnsetError("Hessian-based scale requires a model.")
        if method == ScaleMethod.CONSTANT:
            if constant_scale is None:
                raise UnsetError("Constant scale requires a constant_scale matrix.")
            constant_scale = jnp.asarray(constant_scale)
            if constant_scale.shape != (self.dimension, self.dimension):
                raise DimensionMismatchError(
                    "constant_scale must be (dimension, dimension)."
                )
            self.constant_scale = constant_scale
        else:
            self.constant_scale = None

        # Single inverse-scale parameter slot (reference :71); composed
        # kernels carry more slots and Step() refills all of them (:143-153).
        self.update_parameters((self.compute_scale(),))

    # ------------------------------------------------------------------
    @property
    def adaptive(self) -> bool:
        """True when the bandwidth must be recomputed each SVGD step."""
        return self.scale_method in (ScaleMethod.MEDIAN, ScaleMethod.HESSIAN)

    def adaptive_slots(self):
        """This kernel owns one inverse-scale slot (reference :71)."""
        if not self.adaptive:
            return []
        return [(0, self)]

    # -- warm-started median (temporal coherence across SVGD steps) -----
    def init_scale_aux(self, coords):
        """Aux state for warm-started bandwidth selection, or None.

        Only the scalable median path benefits (the exact path sorts
        anyway). The aux carries the previous step's distance bracket and
        the max particle displacement of the last update.
        """
        from ..ops.median import EXACT_MEDIAN_MAX_PARTICLES

        n = coords.shape[0]
        if (
            self.scale_method != ScaleMethod.MEDIAN
            or self.median_method not in ("auto", "hybrid", "warm")
            or n <= EXACT_MEDIAN_MAX_PARTICLES
        ):
            return None
        fdt = jnp.float64 if jax.config.jax_enable_x64 else jnp.float32
        # One bracket per middle order statistic (ops/median.two_rank_edges);
        # hi < lo marks a cold start.
        return {
            "lo1": jnp.asarray(0.0, fdt),
            "hi1": jnp.asarray(-1.0, fdt),
            "lo2": jnp.asarray(0.0, fdt),
            "hi2": jnp.asarray(-1.0, fdt),
            "disp": jnp.asarray(0.0, fdt),
        }

    def init_fused_aux(self, coords):
        """Aux for the fused phi+median-count pipeline (phi_impl='fused'):
        the initial positions' median (exact/hybrid, one-time cost) seeds
        the lag-1 scale; the bracket starts tight around it and is expanded
        by the movement bound each step."""
        from ..ops.median import fused_median_seed

        return fused_median_seed(coords, self.median_method)

    def compute_scale_with_aux(self, coords, model_params=None, aux=None):
        """Scale computation threading warm-start aux through the scan."""
        if aux is None:
            return self.compute_scale_pure(coords, model_params), None
        from ..ops.median import pairwise_distance_median_warm

        n, m = coords.shape
        med, lo1, hi1, lo2, hi2 = pairwise_distance_median_warm(
            coords, aux["lo1"], aux["hi1"], aux["lo2"], aux["hi2"],
            aux["disp"],
        )
        scale = scale_from_median(med, n, m, coords.dtype)
        return scale, {
            "lo1": lo1, "hi1": hi1, "lo2": lo2, "hi2": hi2,
            "disp": aux["disp"],
        }

    def compute_scale_pure(self, coords: jnp.ndarray, model_params=None) -> jnp.ndarray:
        """Pure inverse-scale computation — the jit/scan-safe hot path.

        Mirrors ComputeScale (reference GaussianRBFKernel.hpp:164-214).
        """
        if self.scale_method == ScaleMethod.MEDIAN:
            return median_scale(coords, self.median_method)
        if self.scale_method == ScaleMethod.HESSIAN:
            if model_params is None:
                model_params = self.target_model.parameters
            return hessian_scale(
                coords, self.target_model.hessian_log_density_pure, model_params
            )
        if self.scale_method == ScaleMethod.CONSTANT:
            return self.constant_scale
        raise ValueError("Invalid scale method Enum provided.")

    def compute_scale(self) -> jnp.ndarray:
        """Stateful variant reading the shared particle store."""
        return self.compute_scale_pure(self.store.value)

    def step(self, coords: Optional[jnp.ndarray] = None):
        """Recompute the scale and refill every parameter slot.

        Mirrors the reference Step() override (GaussianRBFKernel.hpp:141-156)
        minus the re-taping — parameters are plain data here.
        """
        if coords is None:
            coords = self.store.value
        scale = self.compute_scale_pure(coords)
        self.update_parameters(tuple(scale for _ in self.parameters))

    # Step: inherited dynamic CamelCase wrapper (Kernel.Step) dispatches to
    # this class's step override.
    ComputeScale = compute_scale
