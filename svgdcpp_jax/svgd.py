"""SVGD driver.

A JAX redesign of the reference SVGD class (reference:
include/SVGDCpp/SVGD.hpp). The construction/validation surface, options
struct, Initialize/Run lifecycle, bounds clamping, parameter hot-swap and
intermediate-matrix logging all mirror the reference; the execution model
does not: instead of a Python/C++ loop around per-pair tape evaluations, the
whole iteration — bandwidth adaptation, scores, phi, optimizer, clamp —
compiles into ONE ``lax.scan`` under ``jit``, so a full Run() is a single
device program.

The reference's ``Parallel`` flag (OpenMP threads + per-thread kernel tape
clones, SVGD.hpp:239-249) has no analog: the step is always data
parallel over particles, and multi-device scaling is provided by ``mesh``
sharding instead (see svgdcpp_jax.parallel).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import jax
import jax.numpy as jnp

from .core.exceptions import DimensionMismatchError, SVGD_LOG_PREFIX
from .core.types import ParticleStore, as_store
from .kernels.algebra import flatten_rbf_terms
from .kernels.gaussian_rbf import GaussianRBFKernel, rbf_kernel_fn
from .kernels.kernel import Kernel
from .models.model import Model
from .optimizers.base import Optimizer
from .ops.phi import (
    kernel_matrix_and_grad,
    phi_generic,
    phi_rbf,
    phi_rbf_blocked,
    phi_rbf_terms,
)
from .utils.logging import write_intermediate_matrices

#: Above this particle count the dense n x n phi switches to the
#: tile-streamed implementation (which also uses the cancellation-free
#: difference form for small m — see ops/phi.py).
DENSE_PHI_MAX_PARTICLES = 1024

#: Every phi_impl the driver accepts.
PHI_IMPLS = (
    "auto", "dense", "blocked", "generic", "rbf_terms",
    "fused", "fused_terms", "fused_pallas", "fused_terms_pallas",
)

#: The fused phi + median-count sweep, (single RBF, isotropic terms): the
#: XLA tile loop (ops/phi.py) runs on every backend.
XLA_FUSED_IMPLS = ("fused", "fused_terms")

#: The same sweep as one compiled Pallas kernel (ops/pallas_phi.py).
PALLAS_IMPLS = ("fused_pallas", "fused_terms_pallas")

#: phi_impl='auto' fused choice per backend; absent backends use
#: XLA_FUSED_IMPLS.
FUSED_IMPLS = {"gpu": PALLAS_IMPLS}


@dataclasses.dataclass
class SVGDOptions:
    """Options struct (reference SVGDOptions, SVGD.hpp:27-52).

    ``lower_bound=None`` / ``upper_bound=None`` disable bound checking — the
    reference's +/-inf sentinel (SVGD.hpp:41-43, 184-190).
    """

    dimension: int = 0
    num_iterations: int = 0
    coordinate_matrix: Any = None  # (n, m) array or ParticleStore
    kernel: Optional[Kernel] = None
    model: Optional[Model] = None
    optimizer: Optional[Optimizer] = None
    lower_bound: Any = None
    upper_bound: Any = None
    intermediate_matrices_output_path: str = "log.txt"
    parallel: bool = True  # accepted for parity; always data parallel
    log_intermediate_matrices: bool = False
    # --- extensions beyond the reference ---
    phi_impl: str = "auto"  # one of PHI_IMPLS
    row_tile: int = 1024
    mesh: Any = None  # jax.sharding.Mesh to shard the particle axis over
    #: Annealed SVGD: per-iteration temperature tau scaling the scores
    #: (phi uses tau * grad log p). Either a (num_iterations,) array or a
    #: callable iteration -> tau (traced; use jnp ops). None = no annealing.
    annealing: Any = None
    #: Record cheap per-step statistics (phi RMS, max step size, bandwidth)
    #: during run(); available afterwards as ``svgd.stats`` (stacked arrays).
    track_stats: bool = False
    #: Median-selection bins per fused sweep (phi_impl='fused*'). Each
    #: pair pays fused_bins+1 threshold compares, so fewer bins = cheaper
    #: sweeps at coarser per-pass bracket refinement. The steady-state
    #: bracket width is ~4*disp*bins/(bins-1), so the median estimate error
    #: is bounded by half that, ~2*disp*bins/(bins-1) — at the default 2
    #: that is 4x the max per-step displacement, the same class as the
    #: lag-1 scale's own 2*disp movement error. The count-verified bracket
    #: check + in-graph bisection fallback hold for any value.
    fused_bins: int = 2


def _prepare_bound(bound, dimension, name) -> Optional[jnp.ndarray]:
    """Validate/broadcast a bound to shape (m,) (reference SVGD.hpp:193-216)."""
    if bound is None:
        return None
    b = jnp.reshape(jnp.asarray(bound, jnp.result_type(float)), (-1,))
    if b.shape[0] == 1:
        b = jnp.broadcast_to(b, (dimension,))
    elif b.shape[0] != dimension:
        raise DimensionMismatchError(
            f"The provided {name} bounds have incorrect dimensions."
        )
    return b


class SVGD:
    """Main driver (reference SVGD class, SVGD.hpp:84-511)."""

    def __init__(self, *args, **kwargs):
        # Ctor parity: SVGD(options) or
        # SVGD(dim, iter, coords, kernel, model, optimizer, [lower, upper, ...])
        # (reference SVGD.hpp:93-250).
        if len(args) == 1 and isinstance(args[0], SVGDOptions) and not kwargs:
            opts = args[0]
        else:
            names = [
                "dimension",
                "num_iterations",
                "coordinate_matrix",
                "kernel",
                "model",
                "optimizer",
                "lower_bound",
                "upper_bound",
                "parallel",
                "log_intermediate_matrices",
                "intermediate_matrices_output_path",
            ]
            if len(args) > len(names):
                raise TypeError(
                    f"SVGD() takes at most {len(names)} positional arguments "
                    f"({len(args)} given)"
                )
            merged = dict(zip(names, args))
            dup = set(merged) & set(kwargs)
            if dup:
                raise TypeError(
                    "SVGD() got multiple values for argument(s): "
                    + ", ".join(sorted(dup))
                )
            merged.update(kwargs)
            opts = SVGDOptions(**merged)

        self.options = opts
        self.store: ParticleStore = as_store(opts.coordinate_matrix)
        self.dimension = self.store.dimension
        self.num_particles = self.store.num_particles
        self.num_iterations = int(opts.num_iterations)

        # Dimension check (reference SVGD.hpp:169-173).
        if self.dimension != int(opts.dimension):
            raise DimensionMismatchError(
                "Specified dimension does not match the particle coordinate matrix."
            )

        # Null-component validation (reference SVGD.hpp:223-236).
        if opts.kernel is None:
            raise ValueError(SVGD_LOG_PREFIX + "[Argument Error] Invalid Kernel object.")
        if opts.model is None:
            raise ValueError(SVGD_LOG_PREFIX + "[Argument Error] Invalid Model object.")
        if opts.optimizer is None:
            raise ValueError(
                SVGD_LOG_PREFIX + "[Argument Error] Invalid Optimizer object."
            )
        self.kernel: Kernel = opts.kernel
        self.model: Model = opts.model
        self.optimizer: Optimizer = opts.optimizer

        # Share the particle store with the kernel — the reference's
        # shared-pointer contract (SVGD.hpp:176, GaussianRBFKernel.hpp:52):
        # the kernel sees updated particle positions without explicit data
        # flow.
        if hasattr(self.kernel, "store"):
            self.kernel.store = self.store

        self.lower_bound = _prepare_bound(opts.lower_bound, self.dimension, "lower")
        self.upper_bound = _prepare_bound(opts.upper_bound, self.dimension, "upper")
        self.check_bounds = self.lower_bound is not None or self.upper_bound is not None
        if self.check_bounds:
            print(SVGD_LOG_PREFIX + "Bound checking enabled.")

        self.log_intermediate_matrices = bool(opts.log_intermediate_matrices)
        self.intermediate_matrices_output_path = opts.intermediate_matrices_output_path
        self.mesh = opts.mesh
        self._initialized = False

    # ------------------------------------------------------------------
    # Lifecycle
    # ------------------------------------------------------------------
    def initialize(self):
        """Initialize components and compile the step (reference SVGD.hpp:268-296)."""
        self.model.initialize()
        self.kernel.initialize()
        coords = self.store.value
        self._opt_state = self.optimizer.init(coords.dtype)
        # Full-reset lifecycle (reference re-Initialize): the annealing
        # iteration restarts and the warm/lag-1 median brackets are
        # re-seeded from the CURRENT coordinates — a stale bracket from a
        # previous run would silently feed the first fused step's phi.
        self._iteration = 0
        self._scale_aux = None
        self._select_impl()
        self._build_step()
        self._intermediate_logs = None
        self._initialized = True
        return self

    def _select_impl(self):
        opts = self.options
        self._is_rbf = (
            isinstance(self.kernel, GaussianRBFKernel)
            and self.kernel._kernel_fn is rbf_kernel_fn
        )
        # (slot_index, owning kernel) pairs whose inverse-scale parameter is
        # recomputed in-graph each step (incl. composed kernels' RBF slots).
        self._adaptive_slots = self.kernel.adaptive_slots()
        # Algebraic flattening of `+ - * /` trees of pure RBF kernels
        # (kernels/algebra.py): closed-form phi instead of the generic VJP.
        self._rbf_terms = (
            None if self._is_rbf else flatten_rbf_terms(self.kernel)
        )
        self._refresh_psd()
        impl = opts.phi_impl
        if impl not in PHI_IMPLS:
            raise ValueError(
                f"unknown phi_impl {impl!r}; expected one of {PHI_IMPLS}."
            )
        from .kernels.algebra import fused_terms_eligible

        if self.log_intermediate_matrices:
            # The debug dump needs the explicit K / grad-K stacks, which only
            # the generic path materializes (reference logs them too,
            # SVGD.hpp:346-358).
            impl = "generic"
        elif impl == "auto":
            # The fused sweep per backend (FUSED_IMPLS); a mesh whose first
            # axis does not split the particles evenly keeps the XLA
            # sweep, which GSPMD partitions for any n.
            single_impl, terms_impl = (
                FUSED_IMPLS.get(jax.default_backend(), XLA_FUSED_IMPLS)
                if self._mesh_pallas_ok()
                else XLA_FUSED_IMPLS
            )
            big = self.num_particles > DENSE_PHI_MAX_PARTICLES
            if self._rbf_terms is not None:
                eligible = fused_terms_eligible(
                    self._rbf_terms, self._adaptive_slots,
                    self.kernel.parameters,
                )
                impl = terms_impl if big and eligible else "rbf_terms"
            elif not self._is_rbf:
                impl = "generic"
            elif big and (
                getattr(self.kernel, "scale_method", None)
                == GaussianRBFKernel.ScaleMethod.MEDIAN
            ):
                # Median-adaptive at scale: ONE fused O(n^2) sweep per step
                # (phi contraction + next step's median counts) instead of
                # separate count and phi sweeps.
                impl = single_impl
            elif not big:
                impl = "dense"
            else:
                impl = "blocked"
        if impl in ("dense", "blocked", "fused", "fused_pallas") and (
            not self._is_rbf
        ):
            raise ValueError(
                f"phi_impl={impl!r} requires an uncomposed GaussianRBFKernel."
            )
        if (
            impl in ("rbf_terms", "fused_terms", "fused_terms_pallas")
            and self._rbf_terms is None
        ):
            raise ValueError(
                f"phi_impl={impl!r} requires a `+ - * /` composition of "
                "pure GaussianRBFKernels (see kernels/algebra.py)."
            )
        if impl in ("fused_terms", "fused_terms_pallas") and not (
            fused_terms_eligible(
                self._rbf_terms, self._adaptive_slots, self.kernel.parameters
            )
        ):
            raise ValueError(
                f"phi_impl={impl!r} requires every adaptive slot to "
                "be median-scaled and every constant slot isotropic "
                "(gamma * I); use 'rbf_terms' for the general case."
            )
        if impl in ("fused", "fused_pallas") and (
            getattr(self.kernel, "scale_method", None)
            != GaussianRBFKernel.ScaleMethod.MEDIAN
        ):
            raise ValueError(
                "phi_impl='fused' requires ScaleMethod.MEDIAN (the fused "
                "sweep produces median-selection counts)."
            )
        if impl in PALLAS_IMPLS:
            if jax.default_backend() != "gpu":
                raise ValueError(
                    f"phi_impl={impl!r} is a compiled GPU kernel and the "
                    f"backend is {jax.default_backend()!r}; use "
                    "'fused'/'fused_terms' (or phi_impl='auto')."
                )
            if not self._mesh_pallas_ok():
                mesh = self.options.mesh
                axis = mesh.axis_names[0]
                raise ValueError(
                    f"phi_impl={impl!r} with SVGDOptions.mesh requires "
                    f"num_particles ({self.num_particles}) to divide evenly "
                    f"over the {mesh.shape[axis]} devices of mesh axis "
                    f"{axis!r} (the axis the internal shard_map shards "
                    "over); use 'fused'/'fused_terms' (GSPMD partitions "
                    "them for any n). Do NOT pad the particle set with "
                    "duplicates — padded rows would bias phi and the "
                    "n^2 median (docs/instructions.md)."
                )
        self._phi_impl = impl

    def _mesh_pallas_ok(self) -> bool:
        """Whether the Pallas fused sweep can run under SVGDOptions.mesh:
        the internal shard_map shards rows over the mesh's FIRST axis, so
        the particle count must split evenly over that axis's size (not
        the total device count — a multi-axis mesh only row-shards on
        axis 0). (No mesh -> trivially ok.)"""
        mesh = self.options.mesh
        return (
            mesh is None
            or self.num_particles % mesh.shape[mesh.axis_names[0]] == 0
        )

    def _refresh_psd(self):
        """PSD-ness of the quadratic forms the closed-form paths clamp.

        MEDIAN scales are PSD by construction; HESSIAN scales may be
        indefinite (non-log-concave models) so the clamp-at-zero noise
        guard must be skipped; constant matrices are eigenvalue-checked on
        their current values (re-run on parameter hot-swap).
        """
        from .kernels.algebra import term_psd_flags

        if self._rbf_terms is not None:
            self._term_psd = term_psd_flags(
                self._rbf_terms, self._adaptive_slots, self.kernel.parameters
            )
        else:
            self._term_psd = None
        if self._is_rbf:
            method = self.kernel.scale_method
            if method == GaussianRBFKernel.ScaleMethod.MEDIAN:
                self._rbf_psd = True
            elif method == GaussianRBFKernel.ScaleMethod.HESSIAN:
                self._rbf_psd = False
            else:
                from .kernels.algebra import matrix_is_psd

                self._rbf_psd = matrix_is_psd(self.kernel.parameters[0])
        else:
            self._rbf_psd = True

    # Hooks: a custom (user-overridden) per-step hook cannot run inside the
    # jitted scan; fall back to an eager per-iteration loop, mirroring the
    # reference's hook-then-phi step order (SVGD.hpp:373-400).
    @staticmethod
    def _hook_override(obj, base_fns):
        """Return the overridden hook callable, honoring BOTH the snake_case
        ``step`` and the advertised CamelCase ``Step`` spelling (a subclass
        may override either; the class-level aliases bind the base function,
        so each attribute must be checked independently)."""
        cls = type(obj)
        if getattr(cls, "Step", None) not in base_fns:
            return obj.Step
        if getattr(cls, "step", None) not in base_fns:
            return obj.step
        return None

    _MODEL_BASE_HOOKS = (Model.step, Model.Step)
    _KERNEL_BASE_HOOKS = (
        Kernel.step,
        Kernel.Step,
        GaussianRBFKernel.step,
        GaussianRBFKernel.Step,
    )

    def _has_custom_hooks(self) -> bool:
        return (
            self._hook_override(self.model, self._MODEL_BASE_HOOKS) is not None
            or self._hook_override(self.kernel, self._KERNEL_BASE_HOOKS)
            is not None
        )

    # ------------------------------------------------------------------
    # Pure step construction
    # ------------------------------------------------------------------
    def _phi(self, coords, scores, kparams):
        if self._phi_impl == "generic":
            return phi_generic(
                coords, scores, self.kernel.kernel_pure, kparams,
                self.options.row_tile,
            )
        if self._phi_impl == "rbf_terms":
            return phi_rbf_terms(
                coords, scores, kparams, self._rbf_terms,
                self.options.row_tile, psd_flags=self._term_psd,
            )
        if self._phi_impl == "dense":
            return phi_rbf(coords, scores, kparams[0], psd=self._rbf_psd)
        if self._phi_impl == "blocked":
            return phi_rbf_blocked(
                coords, scores, kparams[0], self.options.row_tile,
                psd=self._rbf_psd,
            )
        raise ValueError(f"unknown phi_impl {self._phi_impl!r}")

    def _scale_params(self, coords, mparams, kparams, scale_aux, slot_mparams):
        """In-graph bandwidth adaptation (reference kernel Step(),
        GaussianRBFKernel.hpp:141-156), generalized to composed kernels:
        each adaptive slot is refilled from its owning kernel's pure scale
        function. ``scale_aux`` threads per-slot warm-start state (previous
        median bracket) through the scan; ``slot_mparams`` threads each
        slot's FOREIGN owning-model parameters (a Hessian slot may target a
        model other than the driver's — reference GaussianRBFKernel.hpp:52
        lets any kernel hold any model) so a later update_parameters on that
        model takes effect without a rebuild."""
        if not self._adaptive_slots:
            return kparams, scale_aux
        kparams = list(kparams)
        new_aux = list(scale_aux)
        for i, (idx, owner) in enumerate(self._adaptive_slots):
            if owner.target_model is self.model:
                mp = mparams
            else:
                mp = slot_mparams[i]  # None when the slot has no model
            if scale_aux[i] is not None and hasattr(owner, "compute_scale_with_aux"):
                kparams[idx], new_aux[i] = owner.compute_scale_with_aux(
                    coords, mp, scale_aux[i]
                )
            elif mp is not None:
                kparams[idx] = owner.compute_scale_pure(coords, mp)
            else:
                kparams[idx] = owner.compute_scale_pure(coords)
        return tuple(kparams), tuple(new_aux)

    def _pallas_sweep_mesh(self, coords, scores, thresholds, gammas, signs):
        """Fused Pallas sweep under ``SVGDOptions.mesh``: an internal
        shard_map over the mesh's first axis gathers the global
        sources/scores per device, runs the cross-form kernel on the local
        rows and psums the row-band selection counts — the schedule
        ShardedSVGD compiles in gather mode. GSPMD cannot partition a
        pallas_call, so without this wrapper a mesh would run the kernel
        on one device's view only."""
        from jax.sharding import PartitionSpec as P

        from .ops.pallas_phi import phi_rbf_terms_fused_pallas_cross

        axis = self.mesh.axis_names[0]

        def local(c_l, s_l, gs, thr):
            sources = jax.lax.all_gather(c_l, axis, tiled=True)
            scores_g = jax.lax.all_gather(s_l, axis, tiled=True)
            phi_l, counts_l = phi_rbf_terms_fused_pallas_cross(
                c_l, sources, scores_g, gs, signs, thr, axis_name=axis,
            )
            return phi_l, jax.lax.psum(counts_l, axis)

        return jax.shard_map(
            local, mesh=self.mesh,
            in_specs=(P(axis, None), P(axis, None), P(), P()),
            out_specs=(P(axis, None), P()),
        )(coords, scores, tuple(gammas), thresholds)

    def build_step_fn(self):
        """Return the pure step: state -> (state, debug|None).

        state = {coords, opt_state, kernel_params, model_params}. This is the
        function the scan rolls; it is also the graft/bench entry surface.
        """
        collect_debug = self.log_intermediate_matrices

        annealing = self.options.annealing
        if annealing is not None and not callable(annealing):
            annealing_arr = jnp.asarray(annealing)
            annealing = lambda it: annealing_arr[
                jnp.clip(it, 0, annealing_arr.shape[0] - 1)
            ]

        fused = self._phi_impl in (
            "fused", "fused_pallas", "fused_terms", "fused_terms_pallas",
        )
        fused_pallas = self._phi_impl in PALLAS_IMPLS
        fused_terms = self._phi_impl in ("fused_terms", "fused_terms_pallas")
        fused_bins = int(self.options.fused_bins)
        if fused_terms:
            median_slot_idx = [idx for idx, _ in self._adaptive_slots]
            term_signs = [s for s, _ in self._rbf_terms]
        else:
            term_signs = [1]

        def step_fn(state, _=None):
            coords = state["coords"]
            mparams = state["model_params"]
            # Through grad_log_density_pure so a model's closed-form score
            # override is honored (reference virtual Evaluate* pattern).
            scores = jax.vmap(
                lambda x: self.model.grad_log_density_pure(x, mparams)
            )(coords)
            if annealing is not None:
                tau = annealing(state["iteration"])
                scores = scores * jnp.asarray(tau, scores.dtype)
            if fused:
                # ONE O(n^2) sweep: phi with the PREVIOUS step's verified
                # median (lag-1 — within the 2*disp movement bound of the
                # current median) + this step's selection counts.
                from .ops.median import (
                    fused_lag1_plan,
                    fused_median_from_counts,
                )
                from .ops.phi import phi_rbf_terms_fused_counts

                n, m = coords.shape
                aux = state["scale_aux"][0]
                fdt = aux["med"].dtype
                gamma, sel = fused_lag1_plan(
                    aux, n, fused_bins, coords.dtype
                )
                thresholds = sel["edges"]
                if fused_terms:
                    # Refill every (median) adaptive slot with the lag-1
                    # scale; constant slots keep their state values
                    # (isotropy proven at init).
                    from .kernels.algebra import refill_median_slots

                    kparams, gammas = refill_median_slots(
                        state["kernel_params"], median_slot_idx, gamma, m,
                        coords.dtype, [p for _, p in self._rbf_terms],
                    )
                else:
                    kparams = (gamma * jnp.eye(m, dtype=coords.dtype),)
                    gammas = [gamma]
                if fused_pallas and self.mesh is not None:
                    phi, counts = self._pallas_sweep_mesh(
                        coords, scores, thresholds, gammas, term_signs
                    )
                elif fused_pallas:
                    from .ops.pallas_phi import phi_rbf_terms_fused_pallas

                    phi, counts = phi_rbf_terms_fused_pallas(
                        coords, scores, gammas, term_signs, thresholds
                    )
                else:
                    phi, counts = phi_rbf_terms_fused_counts(
                        coords, scores, gammas, term_signs, thresholds,
                        self.options.row_tile,
                    )
                from .ops.median import centered_count_env

                count_fn, hi0 = centered_count_env(
                    coords, row_tile=self.options.row_tile
                )
                med_new, lo1_n, hi1_n, lo2_n, hi2_n = fused_median_from_counts(
                    counts, sel, n * n, count_fn, hi0,
                    initialized=aux["hi1"] >= aux["lo1"],
                )
                scale_aux = (
                    {
                        "med": med_new.astype(fdt),
                        "lo1": lo1_n.astype(fdt),
                        "hi1": hi1_n.astype(fdt),
                        "lo2": lo2_n.astype(fdt),
                        "hi2": hi2_n.astype(fdt),
                        "disp": aux["disp"],
                    },
                )
            else:
                kparams, scale_aux = self._scale_params(
                    coords, mparams, state["kernel_params"], state["scale_aux"],
                    state["slot_model_params"],
                )
                phi = self._phi(coords, scores, kparams)
            # getattr: duck-typed user optimizers need not subclass Optimizer
            if getattr(self.optimizer, "needs_params", False):
                opt_state, inc = self.optimizer.step(
                    state["opt_state"], phi, coords
                )
            else:
                opt_state, inc = self.optimizer.step(state["opt_state"], phi)
            new_coords = coords + inc
            # Cast bounds to the coords dtype: under x64, f64 bounds would
            # otherwise promote an f32 carry and break the scan.
            if self.lower_bound is not None:
                new_coords = jnp.maximum(
                    new_coords, self.lower_bound.astype(new_coords.dtype)
                )
            if self.upper_bound is not None:
                new_coords = jnp.minimum(
                    new_coords, self.upper_bound.astype(new_coords.dtype)
                )
            if any(a is not None for a in scale_aux):
                # Max particle displacement of THIS update (bounds clamp
                # included) — next step's warm bracket expands by 2x this.
                disp = jnp.sqrt(
                    jnp.max(jnp.sum((new_coords - coords) ** 2, axis=1))
                )
                scale_aux = tuple(
                    {**a, "disp": disp.astype(a["disp"].dtype)}
                    if a is not None
                    else None
                    for a in scale_aux
                )
            new_state = {
                "coords": new_coords,
                "opt_state": opt_state,
                "kernel_params": kparams,
                "model_params": mparams,
                "scale_aux": scale_aux,
                "slot_model_params": state["slot_model_params"],
                "iteration": state["iteration"] + 1,
            }
            if collect_debug:
                k_mat, k_grad = kernel_matrix_and_grad(
                    coords, self.kernel.kernel_pure, kparams
                )
                debug = {
                    "log_model_grad": scores,
                    "kernel": k_mat,
                    "kernel_grad": k_grad,
                    "coords": new_coords,
                }
            elif self.options.track_stats:
                # The 'bandwidth' stat assumes an (m, m) inverse-scale in
                # slot 0; a custom kernel may carry no such parameter —
                # report NaN instead of failing at trace time.
                if kparams and getattr(kparams[0], "ndim", 0) == 2:
                    bandwidth = kparams[0][0, 0]
                else:
                    bandwidth = jnp.asarray(jnp.nan, coords.dtype)
                debug = {
                    "phi_rms": jnp.sqrt(jnp.mean(phi * phi)),
                    "step_max": jnp.max(
                        jnp.sqrt(jnp.sum((new_coords - coords) ** 2, axis=1))
                    ),
                    "bandwidth": bandwidth,
                }
            else:
                debug = 0.0  # scan needs a pytree output; keep it trivial
            return new_state, debug

        return step_fn

    def _build_step(self):
        step_fn = self.build_step_fn()
        self._jit_step = jax.jit(lambda s: step_fn(s)[0])
        self._jit_step_full = jax.jit(step_fn)  # keeps the debug output

        def run_n(state, num_steps):
            return jax.lax.scan(step_fn, state, None, length=num_steps)

        self._jit_run = jax.jit(run_n, static_argnums=1)

    def make_state(self):
        """Assemble the state pytree from current component parameters."""
        coords = self.store.value
        state = {
            "coords": coords,
            "opt_state": self._opt_state,
            # Kernel params (inverse-scale matrices) follow the coords dtype:
            # adaptive slots are REPLACED in-graph by values derived from
            # coords, and a dtype mismatch would break the scan carry.
            "kernel_params": tuple(
                jnp.asarray(p, coords.dtype) for p in self.kernel.parameters
            ),
            "model_params": tuple(self.model.parameters),
            # Foreign-model params per adaptive slot, read FRESH each
            # make_state so a hot-swap on a kernel's private target model is
            # honored by the next run (None for slots owned by self.model or
            # with no model at all).
            "slot_model_params": tuple(
                tuple(owner.target_model.parameters)
                if getattr(owner, "target_model", None) is not None
                and owner.target_model is not self.model
                else None
                for _, owner in self._adaptive_slots
            ),
            "scale_aux": self._current_scale_aux(coords),
            "iteration": jnp.asarray(getattr(self, "_iteration", 0), jnp.int32),
        }
        if self.mesh is not None:
            from jax.sharding import NamedSharding, PartitionSpec as P

            from .parallel.mesh import place_sharded

            axis = self.mesh.axis_names[0]
            sharding = NamedSharding(self.mesh, P(axis, None))
            replicated = NamedSharding(self.mesh, P())
            # place_sharded (not plain device_put): a multi-process mesh's
            # remote shards are not addressable. EVERY leaf gets an explicit
            # mesh sharding — replicated for the non-particle ones ONLY
            # (replicating the (n, m) arrays first would materialize a full
            # copy per device): leaves left on the default device would make
            # the input signature differ from the step's OUTPUT shardings,
            # so chaining a run's output back in would recompile once
            # (measured 2.6 s on the flagship shape).
            for key in (
                "kernel_params", "model_params", "slot_model_params",
                "scale_aux", "iteration",
            ):
                state[key] = jax.tree.map(
                    lambda x: place_sharded(jnp.asarray(x), replicated),
                    state[key],
                )
            state["coords"] = place_sharded(state["coords"], sharding)
            state["opt_state"] = jax.tree.map(
                lambda x, sharded_leaf: place_sharded(x, sharding)
                if sharded_leaf
                else place_sharded(jnp.asarray(x), replicated),
                state["opt_state"],
                self.optimizer.state_is_particle_sharded(state["opt_state"]),
            )
        return state

    def _current_scale_aux(self, coords):
        """Per-adaptive-slot warm-start aux (carried across run() calls)."""
        stored = getattr(self, "_scale_aux", None)
        if stored is not None:
            return stored
        if self._phi_impl in ("fused", "fused_pallas"):
            # {med, lo, hi, disp}: exact/hybrid median of the INITIAL
            # positions seeds the lag-1 fused pipeline.
            return (self.kernel.init_fused_aux(coords),)
        if self._phi_impl in ("fused_terms", "fused_terms_pallas"):
            # Composed kernel: same lag-1 seed as init_fused_aux, computed
            # at the root (only RBF leaves have init_fused_aux). Honor the
            # adaptive leaves' median_method — a leaf built with
            # median_method='exact' keeps the strict reference-parity seed
            # it would get on the uncomposed fused path.
            from .ops.median import fused_median_seed

            method = (
                self._adaptive_slots[0][1].median_method
                if self._adaptive_slots
                else "auto"
            )
            return (fused_median_seed(coords, method),)
        return tuple(
            owner.init_scale_aux(coords)
            if hasattr(owner, "init_scale_aux")
            else None
            for _, owner in self._adaptive_slots
        )

    def _absorb_state(self, state):
        self.store.value = state["coords"]
        self._opt_state = state["opt_state"]
        self._scale_aux = state["scale_aux"]
        self._iteration = int(state["iteration"])
        self.kernel.update_parameters(state["kernel_params"])

    # ------------------------------------------------------------------
    # Execution
    # ------------------------------------------------------------------
    def step(self):
        """Execute one SVGD step (reference SVGD::Step, SVGD.hpp:373-400)."""
        self._require_init()
        if self._has_custom_hooks():
            self._eager_hooks()
        state = self.make_state()
        self._absorb_state(self._jit_step(state))

    def run(self):
        """Execute num_iterations steps (reference SVGD::Run, SVGD.hpp:338-366)."""
        self._require_init()
        if self._has_custom_hooks():
            # Eager fallback: hooks are host-side Python, one jitted step per
            # iteration. Intermediate-matrix logging still collects per-step
            # snapshots like the reference (SVGD.hpp:346-366).
            debugs = []
            collect = self.log_intermediate_matrices or self.options.track_stats
            for _ in range(self.num_iterations):
                self._eager_hooks()
                state = self.make_state()
                new_state, debug = self._jit_step_full(state)
                self._absorb_state(new_state)
                if collect:
                    debugs.append(jax.tree.map(jax.device_get, debug))
            if collect and debugs:
                import numpy as np

                stacked = {
                    key: np.stack([np.asarray(d[key]) for d in debugs])
                    for key in debugs[0]
                }
                if self.log_intermediate_matrices:
                    self._intermediate_logs = stacked
                    write_intermediate_matrices(
                        self.intermediate_matrices_output_path, stacked
                    )
                else:
                    self.stats = stacked
        else:
            state = self.make_state()
            final_state, debug = self._jit_run(state, self.num_iterations)
            self._absorb_state(final_state)
            if self.log_intermediate_matrices:
                self._intermediate_logs = jax.tree.map(jax.device_get, debug)
                write_intermediate_matrices(
                    self.intermediate_matrices_output_path, self._intermediate_logs
                )
            elif self.options.track_stats:
                self.stats = jax.tree.map(jax.device_get, debug)
        return self.store.value

    def _eager_hooks(self):
        model_hook = self._hook_override(self.model, self._MODEL_BASE_HOOKS)
        if model_hook is not None:
            model_hook()
        kernel_hook = self._hook_override(self.kernel, self._KERNEL_BASE_HOOKS)
        if kernel_hook is not None:
            kernel_hook()

    def _require_init(self):
        if not self._initialized:
            raise RuntimeError(
                SVGD_LOG_PREFIX + "Initialize() must be called before stepping."
            )

    # ------------------------------------------------------------------
    # Parameter hot-swap (reference SVGD.hpp:304-332)
    # ------------------------------------------------------------------
    def update_kernel_parameters(self, params):
        if not getattr(self, "_initialized", False):
            # Pre-initialize hot-swap (reference allows it any time after
            # construction, SVGD.hpp:304-332): the impl/PSD flags don't
            # exist yet — initialize() derives them from the new values.
            self.kernel.update_parameters(params)
            self.kernel.initialize()
            return
        # Validate against the PROSPECTIVE values BEFORE mutating the
        # kernel (guarded swap, like MultivariateNormal.update_parameters):
        # a rejected swap must leave the running driver's parameters — and
        # the still-compiled step that reads them — untouched.
        from .kernels.kernel import _as_param_tuple

        new_params = _as_param_tuple(params)
        if self._phi_impl in ("fused_terms", "fused_terms_pallas"):
            # The fused-terms sweep reads each constant slot as gamma =
            # P[0, 0] (isotropy was proven at initialize()); an anisotropic
            # swap would be silently truncated — reject it instead.
            from .kernels.algebra import fused_terms_eligible

            if not fused_terms_eligible(
                self._rbf_terms, self._adaptive_slots, new_params
            ):
                raise ValueError(
                    "phi_impl='fused_terms' requires isotropic constant "
                    "slots; the swapped parameters are anisotropic. Rebuild "
                    "with phi_impl='rbf_terms' for anisotropic compositions."
                )
        self.kernel.update_parameters(new_params)
        self.kernel.initialize()
        # The PSD clamp flags are trace-time constants of the compiled
        # step: re-derive them and rebuild if one changed.
        before = (self._rbf_psd, self._term_psd)
        self._refresh_psd()
        if (self._rbf_psd, self._term_psd) != before:
            self._build_step()

    def update_model_parameters(self, params):
        self.model.update_parameters(params)
        self.model.initialize()

    # ------------------------------------------------------------------
    # CamelCase aliases
    # ------------------------------------------------------------------
    Initialize = initialize
    Run = run
    Step = step
    UpdateKernelParameters = update_kernel_parameters
    UpdateModelParameters = update_model_parameters
