"""Model: autodiff'd target density with functional composition.

JAX redesign of the reference Model base class
(reference: include/SVGDCpp/Model/Model.hpp).

Where the reference records TWO CppAD tapes (density and log-density,
Model.hpp:465-487) and evaluates gradients/Hessians by tape replay, here the
user supplies plain JAX functions

    density_fn(x, params)      -> scalar      (f(x; theta) >= 0)
    log_density_fn(x, params)  -> scalar      (optional; defaults to log(f))

with ``x`` a (m,) array and ``params`` a tuple of arrays (a pytree).
Derivatives come from ``jax.grad`` / ``jax.hessian`` — no tape, no
re-recording, everything jit-compiles once.

API parity with the reference:
  * ``update_model``            <-> Model::UpdateModel (Model.hpp:421-424)
  * ``initialize``              <-> Model::Initialize (Model.hpp:268-278)
  * ``evaluate_model`` etc.     <-> Model::Evaluate* (Model.hpp:290-370)
  * ``update_parameters``/``get_parameters`` <-> Model.hpp:377-406
  * ``step``                    <-> per-iteration hook (Model.hpp:413)
  * ``+ - * /`` composition     <-> Model.hpp:55-227 (parameter vectors are
    concatenated and split inside the composed function, Model.hpp:80-81)
  * ``clone``                   <-> CloneUniquePointer/CloneSharedPointer

CamelCase aliases are provided so reference users can switch with minimal
edits.
"""

from __future__ import annotations

import copy
from typing import Callable, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp

from ..core.exceptions import DimensionMismatchError, UnsetError

DensityFn = Callable[[jnp.ndarray, Tuple[jnp.ndarray, ...]], jnp.ndarray]


def _as_param_tuple(params) -> Tuple[jnp.ndarray, ...]:
    return tuple(jnp.asarray(p) for p in params)


class Model:
    """A target density f(x; params) >= 0 with JAX autodiff.

    Like the reference, a ``Model`` may be used directly by supplying a
    density function, or subclassed (see
    :class:`~svgdcpp_jax.models.multivariate_normal.MultivariateNormal`).
    Subclasses may pass a closed-form ``log_density_fn`` to bypass the
    ``log(f)`` composition — the analog of overriding the virtual
    ``Evaluate*`` methods in the reference (Model.hpp:282-370).
    """

    def __init__(
        self,
        dimension: int = -1,
        density_fn: Optional[DensityFn] = None,
        log_density_fn: Optional[DensityFn] = None,
        parameters: Sequence = (),
    ):
        self.dimension = int(dimension)
        self._density_fn = density_fn
        self._log_density_fn = log_density_fn
        self.parameters: Tuple[jnp.ndarray, ...] = _as_param_tuple(parameters)

    # ------------------------------------------------------------------
    # Setup / mutation (host-side, outside jit)
    # ------------------------------------------------------------------
    def update_model(self, density_fn: DensityFn, log_density_fn: Optional[DensityFn] = None):
        """Set the model's density function (reference Model.hpp:421-424)."""
        self._density_fn = density_fn
        self._log_density_fn = log_density_fn

    def initialize(self):
        """Validate the model (reference Model.hpp:268-278).

        The reference records+optimizes the CppAD tapes here; with JAX the
        "tape" is the traced function itself, so initialization is pure
        validation.
        """
        if self.dimension <= 0:
            raise UnsetError(
                f"Model dimension ({self.dimension}) is improperly or not set."
            )
        if self._density_fn is None and self._log_density_fn is None:
            raise UnsetError("Model function is unset.")
        return self

    def update_parameters(self, params: Sequence):
        """Replace model parameters (reference Model.hpp:377-388)."""
        self.parameters = _as_param_tuple(params)

    def get_parameters(self):
        """Return model parameters (reference Model.hpp:395-406)."""
        return list(self.parameters)

    def step(self):
        """Per-iteration hook; default no-op (reference Model.hpp:413)."""

    def clone(self) -> "Model":
        """Deep copy (reference CloneUnique/SharedPointer, Model.hpp:248-261)."""
        return copy.deepcopy(self)

    # ------------------------------------------------------------------
    # Pure functions (jit/vmap/grad-safe) — the device compute path
    # ------------------------------------------------------------------
    def density_pure(self, x: jnp.ndarray, params) -> jnp.ndarray:
        """f(x; params) as a pure scalar function of (x, params)."""
        if self._density_fn is None:
            if self._log_density_fn is None:
                raise UnsetError("Model function is unset.")
            return jnp.exp(self._log_density_fn(x, params))
        return jnp.squeeze(jnp.asarray(self._density_fn(x, params)))

    def log_density_pure(self, x: jnp.ndarray, params) -> jnp.ndarray:
        """log f(x; params) as a pure scalar function.

        Defaults to ``log(density)`` exactly like the reference's
        ``LogModelFun`` (Model.hpp:451-454); subclasses/users may supply a
        numerically stable closed form instead.
        """
        if self._log_density_fn is not None:
            return jnp.squeeze(jnp.asarray(self._log_density_fn(x, params)))
        return jnp.log(self.density_pure(x, params))

    def grad_log_density_pure(self, x: jnp.ndarray, params) -> jnp.ndarray:
        """score: grad_x log f(x; params).

        Subclasses may override with a closed form to skip autodiff — the
        reference's virtual-``Evaluate*`` override pattern (reference
        Model.hpp:335-338; doc/instructions.md:234-301). The SVGD driver,
        the sharded step and the KSD diagnostic all route the score through
        this method, so an override takes effect on every hot path.
        """
        return jax.grad(self.log_density_pure)(x, params)

    def hessian_log_density_pure(self, x: jnp.ndarray, params) -> jnp.ndarray:
        """hess_x log f(x; params) — the Jacobian of the SCORE.

        Routed through ``grad_log_density_pure`` so a closed-form score
        override propagates to every Hessian consumer (the HESSIAN
        bandwidth, Evaluate*): autodiffing ``log(density)`` directly would
        NaN in tails where the density underflows but a stable score
        override stays finite. Overridable like the other ``*_pure``
        methods (reference virtual Evaluate*, Model.hpp:366-370).
        """
        return jax.jacfwd(self.grad_log_density_pure)(x, params)

    # ------------------------------------------------------------------
    # Evaluate* — stateful convenience API mirroring the reference.
    # Each accepts a single particle (m,) or a batch (n, m).
    # ------------------------------------------------------------------
    def _batched(self, fn, x):
        x = jnp.asarray(x)
        if x.ndim == 2:
            return jax.vmap(lambda xi: fn(xi, self.parameters))(x)
        return fn(x, self.parameters)

    def evaluate_model(self, x):
        """f(x) (reference Model.hpp:290-293)."""
        return self._batched(self.density_pure, x)

    def evaluate_log_model(self, x):
        """log f(x) (reference Model.hpp:305-308)."""
        return self._batched(self.log_density_pure, x)

    def evaluate_model_grad(self, x):
        """grad f(x) (reference Model.hpp:320-323)."""
        return self._batched(lambda xi, p: jax.grad(self.density_pure)(xi, p), x)

    def evaluate_log_model_grad(self, x):
        """grad log f(x) (reference Model.hpp:335-338)."""
        return self._batched(lambda xi, p: jax.grad(self.log_density_pure)(xi, p), x)

    def evaluate_model_hessian(self, x):
        """hessian f(x) (reference Model.hpp:350-354)."""
        return self._batched(lambda xi, p: jax.hessian(self.density_pure)(xi, p), x)

    def evaluate_log_model_hessian(self, x):
        """hessian log f(x) (reference Model.hpp:366-370)."""
        return self._batched(self.hessian_log_density_pure, x)

    # ------------------------------------------------------------------
    # Functional composition (reference Model.hpp:55-227)
    # ------------------------------------------------------------------
    def _compose(self, other: "Model", op, op_name: str, log_op=None) -> "Model":
        if not isinstance(other, Model):
            return NotImplemented
        if self.dimension != other.dimension:
            raise DimensionMismatchError(
                f"Only models with the same variable dimensions can be {op_name}."
            )
        if (self._density_fn is None and self._log_density_fn is None) or (
            other._density_fn is None and other._log_density_fn is None
        ):
            raise UnsetError(
                "One of the model functions is unset; functional composition "
                "requires both model functions to be set."
            )
        n1 = len(self.parameters)
        f1 = self.density_pure
        f2 = other.density_pure
        l1 = self.log_density_pure
        l2 = other.log_density_pure

        def fn(x, params):
            # Split the concatenated parameter tuple back into the two
            # operands' parameter sets (reference Model.hpp:80-81).
            return op(f1(x, tuple(params[:n1])), f2(x, tuple(params[n1:])))

        # Stable log-space composition: the default log(f1 op f2) underflows
        # whenever exp(l) leaves the float range even though l1, l2 are
        # finite (e.g. products of experts). Each operator has an exact
        # log-space form; '-' keeps the reference's semantics of NaN for a
        # negative composed density (log1p of a value <= -1).
        if log_op is not None:

            def log_fn(x, params):
                return log_op(
                    l1(x, tuple(params[:n1])), l2(x, tuple(params[n1:]))
                )

        else:
            log_fn = None

        return Model(
            self.dimension,
            density_fn=fn,
            log_density_fn=log_fn,
            parameters=self.parameters + other.parameters,
        )

    def __add__(self, other):
        return self._compose(other, lambda a, b: a + b, "added",
                             log_op=jnp.logaddexp)

    def __sub__(self, other):
        return self._compose(
            other, lambda a, b: a - b, "subtracted",
            log_op=lambda a, b: a + jnp.log1p(-jnp.exp(b - a)),
        )

    def __mul__(self, other):
        return self._compose(other, lambda a, b: a * b, "multiplied",
                             log_op=lambda a, b: a + b)

    def __truediv__(self, other):
        return self._compose(other, lambda a, b: a / b, "divided",
                             log_op=lambda a, b: a - b)

    # ------------------------------------------------------------------
    # CamelCase aliases (drop-in familiarity for reference users)
    # ------------------------------------------------------------------
    UpdateModel = update_model
    Initialize = initialize
    UpdateParameters = update_parameters
    GetParameters = get_parameters
    def Step(self, *args, **kwargs):
        """CamelCase parity hook; dynamic so a snake_case ``step`` override
        is reachable through it (see Kernel.Step)."""
        return self.step(*args, **kwargs)
    EvaluateModel = evaluate_model
    EvaluateLogModel = evaluate_log_model
    EvaluateModelGrad = evaluate_model_grad
    EvaluateLogModelGrad = evaluate_log_model_grad
    EvaluateModelHessian = evaluate_model_hessian
    EvaluateLogModelHessian = evaluate_log_model_hessian


def mixture(models: Sequence[Model], weights: Optional[Sequence[float]] = None) -> Model:
    """Numerically stable mixture density in log-space.

    Vectorized alternative to chained ``+`` composition: where the reference
    computes ``log(f1 + f2)`` through f64 headroom
    (gmm_example.cpp:24 via Model.hpp:55-92), this combinator builds the
    log-density directly with ``logsumexp`` so it is stable in f32 too.
    Parameter tuples are concatenated in model order, like ``operator+``.
    """
    models = list(models)
    if not models:
        raise UnsetError("mixture() requires at least one model.")
    dim = models[0].dimension
    for m in models[1:]:
        if m.dimension != dim:
            raise DimensionMismatchError(
                "Only models with the same variable dimensions can be mixed."
            )
    sizes = [len(m.parameters) for m in models]
    offsets = [0]
    for s in sizes:
        offsets.append(offsets[-1] + s)
    log_fns = [m.log_density_pure for m in models]
    if weights is None:
        log_w = jnp.zeros(len(models))
    else:
        log_w = jnp.log(jnp.asarray(weights))

    def log_fn(x, params):
        logs = jnp.stack(
            [
                f(x, tuple(params[offsets[i] : offsets[i + 1]]))
                for i, f in enumerate(log_fns)
            ]
        )
        return jax.scipy.special.logsumexp(logs + log_w)

    all_params = sum((m.parameters for m in models), ())
    return Model(dim, log_density_fn=log_fn, parameters=all_params)
