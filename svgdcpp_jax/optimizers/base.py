"""Optimizer interface.

JAX redesign of the reference Optimizer base
(reference: include/SVGDCpp/Optimizer/Optimizer.hpp). The reference mutates
internal Eigen buffers; here optimizers are *functional*: ``init`` returns a
state pytree and ``step`` maps ``(state, grad) -> (state, increment)`` so the
whole SVGD loop rolls into one ``lax.scan``.

The returned increment is the actual position update — the reference's
``Step(grad_matrix) -> step_matrix`` contract (Optimizer.hpp:42), applied by
the driver as ``coords += increment`` (SVGD.hpp:393).
"""

from __future__ import annotations

from typing import Any, Tuple

import jax.numpy as jnp


class Optimizer:
    """Abstract optimizer (reference Optimizer.hpp:28-42)."""

    #: Set True in a subclass whose ``step`` takes a third ``params``
    #: argument (the current particle coordinates) — e.g. weight-decay
    #: transforms. The drivers then call ``step(state, grad, coords)``.
    needs_params: bool = False

    def __init__(self, dimension: int, num_particles: int, lr: float,
                 epsilon: float = 1.0e-8):
        self.dimension = int(dimension)
        self.num_particles = int(num_particles)
        self.learning_rate = float(lr)
        self.stabilizer = float(epsilon)

    # Functional API ----------------------------------------------------
    def init(self, dtype=jnp.float32) -> Any:
        """Return a zeroed optimizer state pytree (reference Initialize())."""
        raise NotImplementedError

    def step(self, state: Any, grad: jnp.ndarray) -> Tuple[Any, jnp.ndarray]:
        """Map (state, grad (n, m)) -> (new_state, increment (n, m))."""
        raise NotImplementedError

    def state_is_particle_sharded(self, state) -> Any:
        """Pytree of bools over ``state``: which leaves are particle-major
        (num_particles, dimension) arrays to row-shard over the particle
        mesh axis (ShardedSVGD / GSPMD placement). Scalars like Adam's step
        counter stay replicated. Override in a custom optimizer whose state
        carries non-particle matrices (e.g. an (m, m) preconditioner) —
        a bare shape heuristic would mis-shard those.
        """
        import jax

        expect = (self.num_particles, self.dimension)
        return jax.tree.map(
            lambda x: getattr(x, "shape", None) == expect, state
        )

    # Convenience: stateful OO parity -----------------------------------
    def initialize(self, dtype=jnp.float32):
        """Reset held state (reference Optimizer::Initialize)."""
        self._state = self.init(dtype)
        return self

    def apply(self, grad: jnp.ndarray, params=None) -> jnp.ndarray:
        """Stateful step for the OO API (reference Optimizer::Step)."""
        grad = jnp.asarray(grad)
        if not hasattr(self, "_state"):
            self._state = self.init(grad.dtype)
        if self.needs_params:
            self._state, inc = self.step(self._state, grad, params)
        else:
            self._state, inc = self.step(self._state, grad)
        return inc

    Initialize = initialize
    Step = apply

    def _zeros(self, dtype):
        return jnp.zeros((self.num_particles, self.dimension), dtype=dtype)
