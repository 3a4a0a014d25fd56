"""Core array conventions and precision policy.

The reference stores particles as an m x n column-major Eigen matrix
(reference: include/SVGDCpp/SVGD.hpp:176-181). The layout here is
(n, m) row-major — particles along the leading axis, coordinates
contiguous — so per-particle reductions vectorize and the n x n kernel
matrix maps onto matmul tiles.

Two precision modes exist from day one (SURVEY.md §7 "Hard parts"):
  * parity:   float64 (tests vs. the NumPy oracle; enable jax_enable_x64)
  * perf:     float32 storage / float32 accumulation (bench path)
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp

Array = jnp.ndarray

# Default dtype follows JAX config (f64 when jax_enable_x64 is on in tests,
# f32 otherwise). Library code is dtype-polymorphic: it follows its inputs.


def as_coords(x, dtype=None) -> Array:
    """Canonicalize a particle coordinate array to shape (n, m).

    Accepts (n, m) arrays. 1-D input is treated as a single particle (1, m).
    """
    arr = jnp.asarray(x, dtype=dtype)
    if arr.ndim == 1:
        arr = arr[None, :]
    if arr.ndim != 2:
        raise ValueError(f"coordinates must be 2-D (n, m), got shape {arr.shape}")
    return arr


class ParticleStore:
    """Mutable holder for the particle coordinate array.

    The reference shares one Eigen matrix between SVGD, the kernel, and the
    user through shared_ptr (reference SVGD.hpp:176,
    GaussianRBFKernel.hpp:52), mutating it in place (SVGD.hpp:393). JAX
    arrays are immutable, so the shared-pointer idiom becomes a shared
    *holder*: components keep a reference to the store and the driver swaps
    ``store.value`` after each (jitted) run segment.
    """

    def __init__(self, coords):
        self.value = as_coords(coords)

    @property
    def num_particles(self) -> int:
        return int(self.value.shape[0])

    @property
    def dimension(self) -> int:
        return int(self.value.shape[1])


def as_store(coords_or_store) -> ParticleStore:
    if isinstance(coords_or_store, ParticleStore):
        return coords_or_store
    return ParticleStore(coords_or_store)


@dataclasses.dataclass(frozen=True)
class PrecisionPolicy:
    """Dtype policy for the SVGD compute path."""

    coords_dtype: jnp.dtype = jnp.float32
    accum_dtype: jnp.dtype = jnp.float32  # accumulation / reductions

    @staticmethod
    def parity() -> "PrecisionPolicy":
        return PrecisionPolicy(jnp.float64, jnp.float64)

    @staticmethod
    def perf() -> "PrecisionPolicy":
        return PrecisionPolicy(jnp.float32, jnp.float32)
