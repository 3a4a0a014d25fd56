"""Kernel: autodiff'd k(x, x') with functional composition.

JAX redesign of the reference Kernel base class
(reference: include/SVGDCpp/Kernel/Kernel.hpp).

The reference re-records a CppAD tape for k(., x') every time the location
x' changes — once per particle per iteration (SVGD.hpp:441-442), which is
why it deliberately skips tape optimization (Kernel.hpp:411-414). Here the
kernel is a pure JAX function

    kernel_fn(x, params, location) -> scalar

traced once; the location is just data, so "re-taping" disappears entirely
and the whole n x n evaluation vmaps/fuses on device.

API parity:
  * ``update_kernel``        <-> Kernel::UpdateKernel (Kernel.hpp:364-367)
  * ``initialize``           <-> Kernel::Initialize (Kernel.hpp:400-415)
  * ``update_location``      <-> Kernel::UpdateLocation (Kernel.hpp:322-330)
  * ``evaluate_kernel``      <-> Kernel.hpp:279-282
  * ``evaluate_kernel_grad`` <-> Kernel.hpp:294-297 (Jacobian w.r.t. x)
  * ``+ - * /`` composition  <-> Kernel.hpp:55-223
  * ``step`` hook            <-> Kernel.hpp:356
"""

from __future__ import annotations

import copy
from typing import Callable, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp

from ..core.exceptions import DimensionMismatchError, UnsetError

KernelFn = Callable[
    [jnp.ndarray, Tuple[jnp.ndarray, ...], jnp.ndarray], jnp.ndarray
]


def _as_param_tuple(params) -> Tuple[jnp.ndarray, ...]:
    return tuple(jnp.asarray(p) for p in params)


class Kernel:
    """A kernel function k(x, x'; params) with JAX autodiff."""

    def __init__(
        self,
        dimension: int = -1,
        kernel_fn: Optional[KernelFn] = None,
        parameters: Sequence = (),
    ):
        self.dimension = int(dimension)
        self._kernel_fn = kernel_fn
        self.parameters: Tuple[jnp.ndarray, ...] = _as_param_tuple(parameters)
        # Location x' (2nd kernel argument), zero-initialized like the
        # reference (Kernel.hpp:45 location_vec_ad_ = Zero(dim)).
        self.location = (
            jnp.zeros(self.dimension) if self.dimension > 0 else jnp.zeros(0)
        )

    # ------------------------------------------------------------------
    # Setup / mutation
    # ------------------------------------------------------------------
    def update_kernel(self, kernel_fn: KernelFn):
        """Set the kernel function (reference Kernel.hpp:364-367)."""
        self._kernel_fn = kernel_fn
        # A replaced function invalidates any structural record of how this
        # kernel was composed — the algebraic dispatch (kernels/algebra.py)
        # must fall back to evaluating the new function generically, and the
        # old composition's adaptive slots no longer describe the new
        # function's parameters (a stale slot list would make the driver
        # refill — or index past — the new params every step).
        if hasattr(self, "_compose_info"):
            del self._compose_info
        if hasattr(self, "_composed_adaptive_slots"):
            del self._composed_adaptive_slots

    def initialize(self):
        """Validate the kernel (reference Kernel.hpp:400-415).

        No tape recording happens — a pure JAX function needs none.
        """
        if self.dimension <= 0:
            raise UnsetError(
                f"Kernel dimension ({self.dimension}) is improperly or not set."
            )
        if self._kernel_fn is None:
            raise UnsetError("Kernel function is unset.")
        return self

    def update_location(self, location):
        """Set the kernel location x' (reference Kernel.hpp:322-330)."""
        location = jnp.reshape(jnp.asarray(location), (-1,))
        if int(location.shape[0]) != self.dimension:
            raise DimensionMismatchError(
                "Dimension of location vector does not match the kernel's."
            )
        self.location = location

    def update_parameters(self, params: Sequence):
        """Replace kernel parameters (reference Kernel.hpp:334-350 analog)."""
        self.parameters = _as_param_tuple(params)

    def get_parameters(self):
        return list(self.parameters)

    def step(self, coords: Optional[jnp.ndarray] = None):
        """Per-iteration hook; default no-op (reference Kernel.hpp:356)."""

    def adaptive_slots(self):
        """[(param_slot_index, owner_kernel)] for per-step bandwidth
        adaptation.

        ``owner_kernel`` is the (usually leaf GaussianRBF) kernel whose
        inverse-scale lives in ``parameters[param_slot_index]`` of THIS
        kernel's concatenated tuple; the driver recomputes that slot each
        SVGD step via the owner's ``compute_scale_pure`` / ``scale_method``
        / ``target_model``. Base kernels adapt nothing; GaussianRBFKernel
        contributes ``(0, self)``; composed kernels concatenate children's
        slots with offsets — the general form of the reference's "assign
        the scale to every parameter slot" behavior (reference
        GaussianRBFKernel.hpp:143-153).
        """
        return list(getattr(self, "_composed_adaptive_slots", []))

    def clone(self) -> "Kernel":
        """Deep copy (reference CloneUnique/SharedPointer, Kernel.hpp:244-257).

        The reference needed one clone per particle to dodge CppAD tape
        races (SVGD.hpp:239-249); with pure functions clones are only for
        user convenience.
        """
        return copy.deepcopy(self)

    # ------------------------------------------------------------------
    # Pure functions (jit/vmap/grad-safe)
    # ------------------------------------------------------------------
    def kernel_pure(self, x: jnp.ndarray, params, location: jnp.ndarray) -> jnp.ndarray:
        """k(x, location; params) as a pure scalar function."""
        if self._kernel_fn is None:
            raise UnsetError("Kernel function is unset.")
        return jnp.squeeze(jnp.asarray(self._kernel_fn(x, params, location)))

    def kernel_grad_pure(self, x: jnp.ndarray, params, location: jnp.ndarray) -> jnp.ndarray:
        """grad_x k(x, location; params)."""
        return jax.grad(self.kernel_pure)(x, params, location)

    # ------------------------------------------------------------------
    # Evaluate API mirroring the reference (batch-friendly on x)
    # ------------------------------------------------------------------
    def _batched(self, fn, x):
        x = jnp.asarray(x)
        if x.ndim == 2:
            return jax.vmap(lambda xi: fn(xi, self.parameters, self.location))(x)
        return fn(x, self.parameters, self.location)

    def evaluate_kernel(self, x):
        """k(x, x') (reference Kernel.hpp:279-282)."""
        return self._batched(self.kernel_pure, x)

    def evaluate_kernel_grad(self, x):
        """grad_x k(x, x') (reference Kernel.hpp:294-297)."""
        return self._batched(self.kernel_grad_pure, x)

    # ------------------------------------------------------------------
    # Functional composition (reference Kernel.hpp:55-223)
    # ------------------------------------------------------------------
    def _compose(self, other: "Kernel", op, op_name: str) -> "Kernel":
        if not isinstance(other, Kernel):
            return NotImplemented
        if self.dimension != other.dimension:
            raise DimensionMismatchError(
                f"Only kernels with the same variable dimensions can be {op_name}."
            )
        if self._kernel_fn is None or other._kernel_fn is None:
            raise UnsetError(
                "One of the kernel functions is unset; functional composition "
                "requires both kernel functions to be set."
            )
        n1 = len(self.parameters)
        f1 = self.kernel_pure
        f2 = other.kernel_pure

        def fn(x, params, location):
            # Split concatenated parameters (reference Kernel.hpp:77-81).
            return op(
                f1(x, tuple(params[:n1]), location),
                f2(x, tuple(params[n1:]), location),
            )

        composed = Kernel(
            self.dimension,
            kernel_fn=fn,
            parameters=self.parameters + other.parameters,
        )
        composed._composed_adaptive_slots = list(self.adaptive_slots()) + [
            (idx + n1, fn_) for idx, fn_ in other.adaptive_slots()
        ]
        # Structural record for algebraic dispatch (kernels/algebra.py): an
        # arithmetic tree of pure RBF kernels flattens to a signed sum of
        # RBF terms with a closed-form phi (phi is linear in k; RBF products
        # collapse by adding precision matrices), which the driver uses
        # instead of the generic VJP path. n1 pins the parameter split the
        # composed closure uses.
        composed._compose_info = (op_name, self, other, n1)
        return composed

    def __add__(self, other):
        return self._compose(other, lambda a, b: a + b, "added")

    def __sub__(self, other):
        return self._compose(other, lambda a, b: a - b, "subtracted")

    def __mul__(self, other):
        return self._compose(other, lambda a, b: a * b, "multiplied")

    def __truediv__(self, other):
        return self._compose(other, lambda a, b: a / b, "divided")

    # ------------------------------------------------------------------
    # CamelCase aliases
    # ------------------------------------------------------------------
    UpdateKernel = update_kernel
    Initialize = initialize
    UpdateLocation = update_location
    UpdateParameters = update_parameters
    GetParameters = get_parameters

    def Step(self, *args, **kwargs):
        """CamelCase parity spelling of the per-iteration hook.

        A dynamic wrapper (not a class-level alias): a subclass overriding
        only snake_case ``step`` must be reachable through ``Step()`` too —
        ``Step = step`` would freeze the BASE implementation at class
        definition and silently skip the override.
        """
        return self.step(*args, **kwargs)

    EvaluateKernel = evaluate_kernel
    EvaluateKernelGrad = evaluate_kernel_grad
