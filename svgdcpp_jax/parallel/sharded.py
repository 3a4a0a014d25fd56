"""Multi-chip SVGD: explicit shard_map over the particle axis.

This is the multi-device generalization of the reference's OpenMP-over-particles
parallel mode (reference SVGD.hpp:239-249, 418-431; SURVEY.md §2 parallelism
accounting). Each device owns an n/D block of particles; the two globally
coupled computations are realized with collectives over the mesh axis:

  1. the cross-shard kernel blocks of phi — local target rows against
     all-gathered global sources (reference's dense nested loop,
     SVGD.hpp:426-430, 445-449), tile-streamed so the n x n matrix never
     materializes;
  2. the global pairwise-distance median for the RBF bandwidth — per-shard
     threshold counts psum'ed, then an identical deterministic
     count-bisection on every shard (the distributed analog of the
     reference's std::nth_element, GaussianRBFKernel.hpp:222-254).

Scores, optimizer state and the position update are purely local (embarrassing
data parallelism, like the reference's per-thread loop body).

Everything here is expressed with ``jax.shard_map`` + named collectives
(all_gather / psum / pmax) so XLA schedules the transfers (NCCL on GPUs).
"""

from __future__ import annotations

import dataclasses

from typing import Any, Callable, Optional

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..core.exceptions import DimensionMismatchError
from ..kernels.gaussian_rbf import ScaleMethod
from ..ops.median import kth_smallest_bisect
from ..kernels.algebra import flatten_rbf_terms
from ..ops.phi import phi_generic_cross, phi_rbf_cross, phi_rbf_terms_cross
from .mesh import make_particle_mesh


# ----------------------------------------------------------------------
# Collective building blocks (run INSIDE shard_map)
# ----------------------------------------------------------------------


def sharded_pairwise_median(
    coords_local: jnp.ndarray,
    sources_global: jnp.ndarray,
    axis_name: str,
    *,
    bins: int = 16,
    passes: int = 6,
    row_tile: int = 512,
) -> jnp.ndarray:
    """Global median of all n^2 pairwise distances, from inside shard_map.

    ``coords_local`` is this shard's row block; ``sources_global`` the
    all-gathered coordinates (shared with the phi computation, so the gather
    is paid once per step). Per-shard threshold COUNTS are psum'ed and the
    count-bisection refinement is identical on every shard, so the result is
    replicated with zero extra traffic. Even-count semantics match the
    reference (GaussianRBFKernel.hpp:224-245).
    """
    n = sources_global.shape[0]
    total = n * n

    # centered_count_env builds the psum'ed count closure and the hi0
    # bound from pmax of the LOCAL max of CENTERED norms (not max of the
    # all-gather output): psum/pmax yield replication-typed values, which
    # keeps the refinement — and hence the returned median — statically
    # replicated; centering keeps the bound tight for off-origin clusters.
    from ..ops.median import centered_count_env

    count_fn, hi0 = centered_count_env(
        coords_local, sources_global, axis_name=axis_name,
        n_global=n, row_tile=row_tile,
    )

    ks = (total // 2, total // 2 + 1) if total % 2 == 0 else ((total + 1) // 2,)
    mids = kth_smallest_bisect(count_fn, ks, 0.0, hi0, bins=bins, passes=passes)
    return jnp.mean(jnp.sqrt(mids))


def sharded_median_scale(
    coords_local, sources_global, axis_name, **kwargs
) -> jnp.ndarray:
    """P = log(n)/median^2 * I with a distributed median."""
    from ..kernels.gaussian_rbf import scale_from_median

    n, m = sources_global.shape
    med = sharded_pairwise_median(coords_local, sources_global, axis_name, **kwargs)
    return scale_from_median(med, n, m, coords_local.dtype)


def sharded_hessian_scale(
    coords_local: jnp.ndarray,
    hessian_fn: Callable,
    model_params,
    axis_name: str,
    n_global: int,
) -> jnp.ndarray:
    """P = 1/(2 d n) * sum_i -hess log p(x_i), psum over shards.

    ``hessian_fn`` is the model's ``hessian_log_density_pure`` (score-
    routed, so closed-form score overrides are honored).
    (reference GaussianRBFKernel.hpp:199-209)
    """
    m = coords_local.shape[1]
    local_sum = jnp.sum(
        jax.vmap(lambda x: hessian_fn(x, model_params))(coords_local),
        axis=0,
    )
    total = jax.lax.psum(local_sum, axis_name)
    return -total / (2.0 * m * n_global)


# ----------------------------------------------------------------------
# Full sharded training step
# ----------------------------------------------------------------------


@dataclasses.dataclass
class ShardedSVGDConfig:
    """Config for the explicit multi-chip step."""

    scale_method: ScaleMethod = ScaleMethod.MEDIAN
    constant_scale: Any = None  # (m, m) for ScaleMethod.CONSTANT
    lower_bound: Any = None
    upper_bound: Any = None
    median_bins: int = 16
    median_passes: int = 6
    row_tile: int = 1024
    #: 'gather' = one all-gather/step, O(n m) per-device memory;
    #: 'ring'   = ppermute streaming, O(n m / D) per-device memory (ring.py)
    phi_mode: str = "gather"
    #: carry the median bracket across steps (one verified count pass per
    #: step instead of a full bisection; see ops/median.warm_median_select)
    warm_start: bool = True
    #: Annealed SVGD (parity with SVGDOptions.annealing): a
    #: (num_iterations,) array or a traced callable iteration -> tau
    #: scaling the scores. None = no annealing.
    annealing: Any = None
    #: Record per-step stats (phi RMS, max step, bandwidth); available as
    #: ``sharded.stats`` after run()/run_state().
    track_stats: bool = False
    #: ONE cross-shard O(n^2/D) sweep per step: each local tile feeds both
    #: the phi contraction and the (psum'ed) median-selection counts; the
    #: scale lags one step within the movement bound (the sharded mirror of
    #: the driver's phi_impl='fused'). Gather mode + MEDIAN only. With a
    #: composed kernel this is the 'fused_terms' mirror: allowed when the
    #: kernel flattens to isotropic terms whose adaptive slots are all
    #: median-scaled (kernels/algebra.fused_terms_eligible).
    fused_phi: bool = False
    #: Median-selection bins per fused sweep (see SVGDOptions.fused_bins —
    #: fewer bins = cheaper per-pair compares, coarser per-pass refinement).
    fused_bins: int = 2
    #: Run the fused sweep as the Pallas kernel per device (the sharded
    #: twin of the driver's 'fused_pallas' / 'fused_terms_pallas'). None =
    #: auto: on where the driver's phi_impl='auto' picks the kernel
    #: (svgd.FUSED_IMPLS, a GPU backend). True forces it (raises off the
    #: GPU); False keeps the XLA sweep.
    fused_pallas: Optional[bool] = None
    #: Composed-kernel phi path (only used with kernel=<Kernel>):
    #: 'auto' = algebraic closed-form terms when the kernel is a `+ - * /`
    #: tree of pure RBFs (kernels/algebra.py), generic VJP otherwise;
    #: 'rbf_terms' = require the algebraic path; 'generic' = force the VJP
    #: path (the sharded mirror of the driver's phi_impl).
    kernel_phi: str = "auto"
    #: Per-iteration intermediate-matrix debug dump, the sharded mirror of
    #: SVGDOptions.log_intermediate_matrices (reference SVGD.hpp:346-366,
    #: 460-476): each device snapshots its target-row bands of
    #: LogModelGrad / Kernel / KernelGrad plus the updated coordinates;
    #: shard_map reassembles the global matrices and run()/run_state()
    #: writes them in the reference's text format after the run. Debug
    #: only: materializes (iterations, n, n, m) on host. Requires
    #: phi_mode='gather'.
    log_intermediate_matrices: bool = False
    intermediate_matrices_output_path: str = "log.txt"

    def __post_init__(self):
        if self.kernel_phi not in ("auto", "rbf_terms", "generic"):
            raise ValueError(
                "kernel_phi must be 'auto', 'rbf_terms' or 'generic', "
                f"got {self.kernel_phi!r}"
            )
        if self.phi_mode not in ("gather", "ring"):
            raise ValueError(
                f"phi_mode must be 'gather' or 'ring', got {self.phi_mode!r}"
            )
        if self.scale_method == ScaleMethod.CONSTANT and self.constant_scale is None:
            raise ValueError(
                "ScaleMethod.CONSTANT requires constant_scale to be set."
            )
        if self.fused_phi:
            if self.scale_method != ScaleMethod.MEDIAN:
                raise ValueError("fused_phi requires ScaleMethod.MEDIAN.")
            if self.phi_mode != "gather":
                raise ValueError("fused_phi currently requires phi_mode='gather'.")
        elif self.fused_pallas:
            # Explicitly forcing the Pallas sweep without the fused sweep is
            # a configuration error, not a silent no-op.
            raise ValueError("fused_pallas=True requires fused_phi=True.")
        if self.log_intermediate_matrices and self.phi_mode != "gather":
            raise ValueError(
                "log_intermediate_matrices requires phi_mode='gather' (the "
                "debug dump rebuilds the global kernel matrices from the "
                "gathered source set)."
            )


class ShardedSVGD:
    """Explicit shard_map SVGD over the particle axis.

    The flagship scale-out path: coords/optimizer state live row-sharded over
    a 1-D particle mesh; ``step``/``run`` are jitted device programs whose
    only cross-chip traffic is one coords all-gather, one scores all-gather,
    psum'ed median histograms, and (for Hessian scale) one m x m psum.

    Two kernel modes:

    * ``kernel=None`` (default) — the closed-form Gaussian-RBF fast path;
      the bandwidth is governed by ``config.scale_method``.
    * ``kernel=<Kernel>`` — any composed/user kernel. A `+ - * /` tree of
      pure RBF kernels is flattened algebraically (kernels/algebra.py) and
      phi runs closed-form term sweeps; anything else goes through the
      tile-streamed VJP path (ops/phi.phi_generic_cross, or its ring
      variant). Every adaptive slot (median- or Hessian-scaled RBF
      factors of a composition) is recomputed per step with the distributed
      machinery — the sharded generalization of the reference's "refill all
      parameter slots each Step" (GaussianRBFKernel.hpp:141-156).
    """

    def __init__(
        self,
        model,
        optimizer,
        num_particles: int,
        dimension: int,
        mesh: Optional[Mesh] = None,
        config: Optional[ShardedSVGDConfig] = None,
        kernel=None,
    ):
        self.model = model
        self.optimizer = optimizer
        self.kernel = kernel
        self.mesh = mesh if mesh is not None else make_particle_mesh()
        self.config = config or ShardedSVGDConfig()
        self.axis = self.mesh.axis_names[0]
        self.num_particles = int(num_particles)
        self.dimension = int(dimension)
        n_dev = self.mesh.devices.size
        if self.num_particles % n_dev != 0:
            raise DimensionMismatchError(
                f"num_particles ({self.num_particles}) must divide evenly "
                f"over {n_dev} devices. For an uneven count use the driver's "
                "GSPMD path instead — SVGD(SVGDOptions(mesh=...)) handles "
                "any n exactly (XLA pads internally). Do NOT pad the "
                "particle set with duplicates: padded particles participate "
                "in phi and the median and bias the posterior."
            )
        if kernel is not None:
            kernel.initialize()
            # (slot index, owning kernel) pairs, like the driver.
            self._adaptive_slots = kernel.adaptive_slots()
            # `+ - * /` trees of pure RBF kernels flatten to signed
            # closed-form terms (kernels/algebra.py) — phi then runs T
            # Gram-identity sweeps instead of the generic VJP path.
            self._rbf_terms = (
                None
                if self.config.kernel_phi == "generic"
                else flatten_rbf_terms(kernel)
            )
            if self.config.kernel_phi == "rbf_terms" and self._rbf_terms is None:
                raise ValueError(
                    "kernel_phi='rbf_terms' requires a `+ - * /` composition "
                    "of pure GaussianRBFKernels (see kernels/algebra.py)."
                )
            self._validate_fused_kernel()
        else:
            self._adaptive_slots = []
            self._rbf_terms = None
        self._refresh_psd()
        if self.config.scale_method == ScaleMethod.HESSIAN:
            self._rbf_psd = False
        elif self.config.scale_method == ScaleMethod.CONSTANT:
            from ..kernels.algebra import matrix_is_psd

            self._rbf_psd = matrix_is_psd(self.config.constant_scale)
        else:
            self._rbf_psd = True
        self._state = None
        self.stats = None
        #: Per-call debug-matrix chunks (see the ``intermediate_logs``
        #: property; None until log_intermediate_matrices produces them).
        self._intermediate_log_chunks = None
        self._fused_pallas = self._resolve_fused_pallas()
        self._build()

    def _validate_fused_kernel(self):
        """Composed-kernel fused mode (the sharded mirror of the driver's
        phi_impl='fused_terms'): every term must collapse to an isotropic
        gamma_t * sq so one cross-shard sq sweep serves all terms + the
        median counts. Re-run on parameter hot-swap (the fused sweep reads
        each constant slot as gamma = P[0, 0]; an anisotropic swap would be
        silently truncated)."""
        if not self.config.fused_phi:
            return
        from ..kernels.algebra import fused_terms_eligible

        if not fused_terms_eligible(
            self._rbf_terms, self._adaptive_slots, self.kernel.parameters
        ):
            raise ValueError(
                "fused_phi with a kernel requires a `+ - * /` tree "
                "of pure RBFs whose adaptive slots are all median-"
                "scaled and whose constant slots are isotropic "
                "(gamma * I); use kernel_phi='rbf_terms'/'generic' "
                "for the general case."
            )

    def _resolve_fused_pallas(self) -> bool:
        """Whether the fused sweep runs as the per-device Pallas kernel.

        Auto (config.fused_pallas=None) follows the driver's backend table
        (svgd.FUSED_IMPLS); explicit True raises off the GPU, where the
        kernel does not compile (the Pallas interpreter is a test route
        only)."""
        from ..svgd import FUSED_IMPLS, PALLAS_IMPLS

        cfg = self.config
        if not cfg.fused_phi or cfg.fused_pallas is False:
            return False
        backend = jax.default_backend()
        if cfg.fused_pallas is None:
            return FUSED_IMPLS.get(backend) == PALLAS_IMPLS
        if backend != "gpu":
            raise ValueError(
                "fused_pallas=True requires a GPU backend (found "
                f"{backend!r}); leave it None for auto-selection."
            )
        return True

    def _refresh_psd(self):
        """PSD-ness of the clamped quadratic forms: MEDIAN scales are PSD by
        construction, HESSIAN scales may be indefinite (skip the clamp),
        constant matrices are eigenvalue-checked on their CURRENT values
        (see kernels/algebra; re-run on parameter hot-swap, like the
        driver's _refresh_psd)."""
        from ..kernels.algebra import term_psd_flags

        if self._rbf_terms is not None:
            self._term_psd = term_psd_flags(
                self._rbf_terms, self._adaptive_slots, self.kernel.parameters
            )
        else:
            self._term_psd = None

    def update_kernel_parameters(self, params):
        """Hot-swap composed-kernel parameters (the sharded mirror of the
        driver's update_kernel_parameters; reference
        SVGD::UpdateKernelParameters, SVGD.hpp:304-318).

        Fused-sweep isotropy eligibility and the PSD clamp flags are
        trace-time constants of the compiled step — they are re-derived
        from the NEW values here and the step is rebuilt if a flag flipped.
        Takes effect at the next init_state()/run(coords); a live state
        pytree keeps the kernel_params it was built with.
        """
        if self.kernel is None:
            from ..core.exceptions import UnsetError

            raise UnsetError(
                "update_kernel_parameters requires a composed/user kernel; "
                "the built-in RBF fast path's scale is governed by "
                "config.scale_method."
            )
        self.kernel.update_parameters(params)
        self.kernel.initialize()
        self._refresh_trace_flags()

    UpdateKernelParameters = update_kernel_parameters

    def _refresh_trace_flags(self):
        """Re-derive the trace-time constants of the compiled step (fused
        isotropy eligibility, PSD clamp flags) from the kernel's CURRENT
        values and rebuild the step if any flipped — the single home shared
        by parameter hot-swap, init_state's stale-mutation guard and the
        eager hook loop."""
        self._validate_fused_kernel()
        before = self._term_psd
        self._refresh_psd()
        if self._term_psd != before:
            self._build()

    # ------------------------------------------------------------------
    def _scale(self, coords_local, sources_global, model_params):
        cfg = self.config
        if cfg.scale_method == ScaleMethod.MEDIAN:
            return sharded_median_scale(
                coords_local,
                sources_global,
                self.axis,
                bins=cfg.median_bins,
                passes=cfg.median_passes,
                row_tile=cfg.row_tile,
            )
        if cfg.scale_method == ScaleMethod.HESSIAN:
            return sharded_hessian_scale(
                coords_local,
                self.model.hessian_log_density_pure,
                model_params,
                self.axis,
                self.num_particles,
            )
        # Cast to the coords dtype like the median/Hessian branches: under
        # x64 an f64 constant with f32 coords would otherwise break the
        # scan carry (kernel_params is seeded f32 in init_state).
        return jnp.asarray(cfg.constant_scale, coords_local.dtype)

    def _build(self):
        axis = self.axis
        cfg = self.config
        model = self.model
        optimizer = self.optimizer
        generic = self.kernel is not None
        slots = self._adaptive_slots
        lower = (
            None if cfg.lower_bound is None else jnp.asarray(cfg.lower_bound)
        )
        upper = (
            None if cfg.upper_bound is None else jnp.asarray(cfg.upper_bound)
        )

        fused_terms = generic and cfg.fused_phi
        if fused_terms:
            median_slot_idx = [idx for idx, _ in slots]
            term_signs = [s for s, _ in self._rbf_terms]
            fused_term_plists = [plist for _, plist in self._rbf_terms]
        has_median = (
            any(o.scale_method == ScaleMethod.MEDIAN for _, o in slots)
            if generic
            else cfg.scale_method == ScaleMethod.MEDIAN
        )
        warm = cfg.warm_start and has_median
        n_global = self.num_particles
        total = n_global * n_global

        annealing = cfg.annealing
        if annealing is not None and not callable(annealing):
            ann_arr = jnp.asarray(annealing)
            annealing = lambda it: ann_arr[jnp.clip(it, 0, ann_arr.shape[0] - 1)]

        def _median_scale_warm(coords_local, sources, scale_aux):
            """Warm-started distributed median (gather or ring counts)."""
            from ..ops.median import (
                centered_count_env,
                median_sq_bracket_from_sample,
                warm_median_select,
            )

            lo1_d, hi1_d, lo2_d, hi2_d, disp = scale_aux
            count_fn, hi0 = centered_count_env(
                coords_local,
                None if cfg.phi_mode == "ring" else sources,
                axis_name=axis, n_global=n_global, row_tile=cfg.row_tile,
            )

            if cfg.phi_mode == "ring":
                from .ring import ring_count_le

                # ring mode has no gathered global set: stream the counts
                # around the ring instead (ring_count_le centers itself).
                count_fn = lambda thr: ring_count_le(
                    coords_local, thr, axis, n_global,
                    row_tile=cfg.row_tile,
                )
                sample_fn = None  # ring mode has no global random access
            else:

                def sample_fn():
                    # The sample is computed from the (device-varying-typed)
                    # gathered sources; values are identical on every shard,
                    # and a scalar pmax stamps them replication-typed.
                    lo_s, hi_s = median_sq_bracket_from_sample(
                        sources, min(1 << 16, total)
                    )
                    return (
                        jax.lax.pmax(lo_s, axis),
                        jax.lax.pmax(hi_s, axis),
                    )

            med, n_lo1, n_hi1, n_lo2, n_hi2 = warm_median_select(
                count_fn, total, hi0, lo1_d, hi1_d, lo2_d, hi2_d, disp,
                sample_bracket_fn=sample_fn,
                bins=cfg.median_bins, passes=cfg.median_passes,
            )
            from ..kernels.gaussian_rbf import scale_from_median

            m = coords_local.shape[1]
            scale = scale_from_median(med, n_global, m, coords_local.dtype)
            return scale, (n_lo1, n_hi1, n_lo2, n_hi2, disp)

        def _slot_scales(
            coords_local, sources, model_params, scale_aux, kparams,
            slot_mparams,
        ):
            """Refill every adaptive slot of a composed/custom kernel.

            The shared median scale (if any median slot exists) is computed
            once; Hessian slots each psum their own m x m (reference
            GaussianRBFKernel.hpp:143-153 refills all slots with ONE scale —
            here each slot gets the scale of its own method/model, the
            composed-kernel generalization the driver also implements)."""
            kparams = list(kparams)
            med_scale = None
            if has_median:
                if warm:
                    med_scale, scale_aux = _median_scale_warm(
                        coords_local, sources, scale_aux
                    )
                elif cfg.phi_mode == "ring":
                    from .ring import ring_median_scale

                    med_scale = ring_median_scale(
                        coords_local, axis, n_global,
                        bins=cfg.median_bins, passes=cfg.median_passes,
                        row_tile=cfg.row_tile,
                    )
                else:
                    med_scale = sharded_median_scale(
                        coords_local, sources, axis,
                        bins=cfg.median_bins, passes=cfg.median_passes,
                        row_tile=cfg.row_tile,
                    )
            for i, (idx, owner) in enumerate(slots):
                if owner.scale_method == ScaleMethod.MEDIAN:
                    kparams[idx] = med_scale.astype(kparams[idx].dtype)
                elif owner.scale_method == ScaleMethod.HESSIAN:
                    mp = (
                        model_params
                        if owner.target_model is model
                        else slot_mparams[i]
                    )
                    kparams[idx] = sharded_hessian_scale(
                        coords_local, owner.target_model.hessian_log_density_pure,
                        mp, axis, n_global,
                    ).astype(kparams[idx].dtype)
            return tuple(kparams), med_scale, scale_aux

        def local_step(
            coords_local, opt_state_local, model_params, scale_aux,
            kparams, slot_mparams, iteration,
        ):
            # Through grad_log_density_pure so a model's closed-form score
            # override is honored (reference virtual Evaluate* pattern).
            scores_local = jax.vmap(
                lambda x: model.grad_log_density_pure(x, model_params)
            )(coords_local)
            if annealing is not None:
                tau = annealing(iteration)
                scores_local = scores_local * jnp.asarray(
                    tau, scores_local.dtype
                )

            sources = None
            if cfg.phi_mode == "gather":
                # One gather shared by bandwidth + phi.
                sources = jax.lax.all_gather(coords_local, axis, tiled=True)

            if generic and not fused_terms:
                kparams, _, scale_aux = _slot_scales(
                    coords_local, sources, model_params, scale_aux,
                    kparams, slot_mparams,
                )
                terms = self._rbf_terms
                if cfg.phi_mode == "ring":
                    if terms is not None:
                        from .ring import ring_phi_rbf_terms

                        phi_local = ring_phi_rbf_terms(
                            coords_local, scores_local, kparams, terms,
                            axis, n_global, psd_flags=self._term_psd,
                            row_tile=cfg.row_tile,
                        )
                    else:
                        from .ring import ring_phi_generic

                        phi_local = ring_phi_generic(
                            coords_local, scores_local,
                            self.kernel.kernel_pure, kparams,
                            axis, n_global, cfg.row_tile,
                        )
                else:
                    scores = jax.lax.all_gather(
                        scores_local, axis, tiled=True
                    )
                    if terms is not None:
                        phi_local = phi_rbf_terms_cross(
                            coords_local, sources, scores, kparams, terms,
                            cfg.row_tile, axis_name=axis,
                            psd_flags=self._term_psd,
                        )
                    else:
                        phi_local = phi_generic_cross(
                            coords_local, sources, scores,
                            self.kernel.kernel_pure, kparams,
                            cfg.row_tile, axis_name=axis,
                        )
            elif cfg.fused_phi:
                # ONE cross-shard sweep: phi with the previous step's
                # verified median (lag-1, movement-bounded) + this step's
                # psum'ed selection counts (driver phi_impl='fused' /
                # 'fused_terms' mirror).
                from ..ops.median import (
                    fused_lag1_plan,
                    fused_median_from_counts,
                )
                from ..ops.phi import phi_rbf_terms_cross_fused_counts

                lo1_b, hi1_b, lo2_b, hi2_b, disp_a, med = scale_aux
                fdt = med.dtype
                fbins = int(cfg.fused_bins)
                aux_d = {
                    "med": med, "lo1": lo1_b, "hi1": hi1_b,
                    "lo2": lo2_b, "hi2": hi2_b, "disp": disp_a,
                }
                gamma, sel = fused_lag1_plan(
                    aux_d, n_global, fbins, coords_local.dtype
                )
                thresholds = sel["edges"]
                if fused_terms:
                    # Refill the (median) adaptive slots with the lag-1
                    # scale; constant slots keep their state values
                    # (isotropy proven at construction).
                    from ..kernels.algebra import refill_median_slots

                    kparams, gammas = refill_median_slots(
                        kparams, median_slot_idx, gamma, self.dimension,
                        coords_local.dtype, fused_term_plists,
                    )
                else:
                    kparams = (
                        gamma
                        * jnp.eye(self.dimension, dtype=coords_local.dtype),
                    )
                    gammas = [gamma]
                signs = term_signs if fused_terms else [1]
                scores = jax.lax.all_gather(scores_local, axis, tiled=True)
                if self._fused_pallas:
                    # Per-device Pallas sweep (the sharded twin of
                    # phi_impl='fused_pallas' / 'fused_terms_pallas').
                    from ..ops.pallas_phi import (
                        phi_rbf_terms_fused_pallas_cross,
                    )

                    phi_local, counts_local = phi_rbf_terms_fused_pallas_cross(
                        coords_local, sources, scores, gammas, signs,
                        thresholds, axis_name=axis,
                    )
                else:
                    phi_local, counts_local = phi_rbf_terms_cross_fused_counts(
                        coords_local, sources, scores, gammas, signs,
                        thresholds, cfg.row_tile, axis_name=axis,
                    )
                counts = jax.lax.psum(counts_local, axis)
                from ..ops.median import centered_count_env

                count_fn, hi0 = centered_count_env(
                    coords_local, sources, axis_name=axis,
                    n_global=n_global, row_tile=cfg.row_tile,
                )
                med_new, lo1_n, hi1_n, lo2_n, hi2_n = fused_median_from_counts(
                    counts, sel, total, count_fn, hi0,
                    initialized=hi1_b >= lo1_b,
                )
                scale_aux = (
                    lo1_n.astype(fdt), hi1_n.astype(fdt),
                    lo2_n.astype(fdt), hi2_n.astype(fdt),
                    disp_a, med_new.astype(fdt),
                )
            elif cfg.phi_mode == "ring":
                # Gather-free: bandwidth + phi via ppermute rotations.
                from .ring import ring_median_scale, ring_phi_rbf

                if warm:
                    p_matrix, scale_aux = _median_scale_warm(
                        coords_local, None, scale_aux
                    )
                elif cfg.scale_method == ScaleMethod.MEDIAN:
                    p_matrix = ring_median_scale(
                        coords_local, axis, self.num_particles,
                        bins=cfg.median_bins, passes=cfg.median_passes,
                        row_tile=cfg.row_tile,
                    )
                else:
                    p_matrix = self._scale(coords_local, None, model_params)
                kparams = (p_matrix,)
                phi_local = ring_phi_rbf(
                    coords_local, scores_local, p_matrix, axis,
                    self.num_particles, psd=self._rbf_psd,
                    row_tile=cfg.row_tile,
                )
            else:
                if warm:
                    p_matrix, scale_aux = _median_scale_warm(
                        coords_local, sources, scale_aux
                    )
                else:
                    p_matrix = self._scale(coords_local, sources, model_params)
                kparams = (p_matrix,)
                scores = jax.lax.all_gather(scores_local, axis, tiled=True)
                phi_local = phi_rbf_cross(
                    coords_local, sources, scores, p_matrix, cfg.row_tile,
                    axis_name=axis, psd=self._rbf_psd,
                )
            # getattr: duck-typed user optimizers need not subclass Optimizer
            if getattr(optimizer, "needs_params", False):
                opt_state_local, inc = optimizer.step(
                    opt_state_local, phi_local, coords_local
                )
            else:
                opt_state_local, inc = optimizer.step(opt_state_local, phi_local)
            new_coords = coords_local + inc
            if lower is not None:
                new_coords = jnp.maximum(new_coords, lower.astype(new_coords.dtype))
            if upper is not None:
                new_coords = jnp.minimum(new_coords, upper.astype(new_coords.dtype))
            if warm or cfg.fused_phi:
                # Max displacement across ALL shards -> next warm bracket.
                local_disp_sq = jnp.max(
                    jnp.sum((new_coords - coords_local) ** 2, axis=1)
                )
                disp = jnp.sqrt(jax.lax.pmax(local_disp_sq, axis))
                # Brackets occupy slots 0-3; disp is slot 4 in both layouts
                # ((lo1, hi1, lo2, hi2, disp[, med])).
                scale_aux = (
                    scale_aux[:4]
                    + (disp.astype(scale_aux[4].dtype),)
                    + scale_aux[5:]
                )
            if cfg.log_intermediate_matrices:
                # Per-iteration debug snapshot (reference SVGD.hpp:346-366):
                # each device contributes its target-row BANDS of the global
                # K / grad-K matrices (computed from the gathered sources
                # with the step's kernel parameters); shard_map's out_specs
                # reassemble the bands into the full matrices.
                from ..ops.phi import kernel_matrix_and_grad_cross

                if self.kernel is not None:
                    kfn = self.kernel.kernel_pure
                else:
                    from ..kernels.gaussian_rbf import rbf_kernel_fn

                    kfn = rbf_kernel_fn
                k_band, g_band = kernel_matrix_and_grad_cross(
                    coords_local, sources, kfn, kparams
                )
                stats = {
                    "log_model_grad": scores_local,
                    "kernel": k_band,
                    "kernel_grad": g_band,
                    "coords": new_coords,
                }
            elif cfg.track_stats:
                m = coords_local.shape[1]
                phi_rms = jnp.sqrt(
                    jax.lax.psum(jnp.sum(phi_local * phi_local), axis)
                    / (n_global * m)
                )
                step_max = jnp.sqrt(
                    jax.lax.pmax(
                        jnp.max(
                            jnp.sum((new_coords - coords_local) ** 2, axis=1)
                        ),
                        axis,
                    )
                )
                if kparams and kparams[0].ndim == 2:
                    bandwidth = kparams[0][0, 0]
                else:
                    bandwidth = jnp.asarray(jnp.nan, coords_local.dtype)
                # psum/pmax-typed values -> statically replicated outputs.
                stats = {
                    "phi_rms": phi_rms,
                    "step_max": step_max,
                    "bandwidth": bandwidth + 0.0 * phi_rms,
                }
            else:
                stats = jnp.asarray(0.0)
            return new_coords, opt_state_local, kparams, scale_aux, stats

        shard_spec = P(axis, None)
        # Optimizer state mixes (n, m) arrays (sharded) with scalars like
        # Adam's step counter (replicated) — the optimizer itself declares
        # which leaves are particle-major (state_is_particle_sharded), so a
        # custom optimizer with e.g. an (m, m) preconditioner is not
        # mis-sharded by a shape heuristic. eval_shape: structure only.
        opt_template = jax.eval_shape(lambda: optimizer.init(jnp.float32))
        opt_specs = jax.tree.map(
            lambda sharded_leaf, _: shard_spec if sharded_leaf else P(),
            optimizer.state_is_particle_sharded(opt_template),
            opt_template,
        )
        if cfg.log_intermediate_matrices:
            # Row bands reassemble into the global debug matrices; the
            # kernel-grad band is (n_local, n, m).
            stats_spec = {
                "log_model_grad": shard_spec,
                "kernel": shard_spec,
                "kernel_grad": P(axis, None, None),
                "coords": shard_spec,
            }
        else:
            stats_spec = P()
        sharded = jax.shard_map(
            local_step,
            mesh=self.mesh,
            in_specs=(shard_spec, opt_specs, P(), P(), P(), P(), P()),
            out_specs=(shard_spec, opt_specs, P(), P(), stats_spec),
        )

        # Pin output shardings to the state-contract specs: without this
        # GSPMD may emit equivalent-but-different shardings for replicated
        # leaves (a (m, m) kernel param drifting to P(axis, None) on small
        # meshes), making a chained run_state(output_state) recompile once
        # per signature drift.
        row_sh = NamedSharding(self.mesh, shard_spec)
        rep_sh = NamedSharding(self.mesh, P())
        opt_mask = optimizer.state_is_particle_sharded(opt_template)

        def _pin_rep(tree):
            return jax.tree.map(
                lambda x: jax.lax.with_sharding_constraint(x, rep_sh), tree
            )

        def step_fn(state):
            coords, opt_state, kparams, scale_aux, stats = sharded(
                state["coords"], state["opt_state"], state["model_params"],
                state["scale_aux"], state["kernel_params"],
                state["slot_model_params"], state["iteration"],
            )
            return {
                "coords": jax.lax.with_sharding_constraint(coords, row_sh),
                "opt_state": jax.tree.map(
                    lambda x, sharded_leaf: jax.lax.with_sharding_constraint(
                        x, row_sh if sharded_leaf else rep_sh
                    ),
                    opt_state,
                    opt_mask,
                ),
                "model_params": _pin_rep(state["model_params"]),
                "kernel_params": _pin_rep(kparams),
                "slot_model_params": state["slot_model_params"],
                "scale_aux": _pin_rep(scale_aux),
                "iteration": state["iteration"] + 1,
            }, stats

        self._step_full = jax.jit(step_fn)
        self.step_fn = jax.jit(lambda s: step_fn(s)[0])

        def run_fn(state, num_steps):
            def body(s, _):
                return step_fn(s)

            return jax.lax.scan(body, state, None, length=num_steps)

        # (final_state, stacked per-step stats) — stats are trivial zeros
        # unless config.track_stats.
        self.run_fn = jax.jit(run_fn, static_argnums=1)

    # ------------------------------------------------------------------
    def init_state(self, coords):
        coords = jnp.asarray(coords)
        if coords.shape != (self.num_particles, self.dimension):
            raise DimensionMismatchError(
                f"coords must be ({self.num_particles}, {self.dimension})."
            )
        if self.kernel is not None:
            # Catch direct kernel.update_parameters() mutations that bypassed
            # update_kernel_parameters(): the PSD clamp / fused-isotropy
            # flags are trace-time constants, so stale ones silently
            # mis-clamp the quadratic forms. Re-derive on the current values
            # (cheap (m, m) eigenvalue checks) and rebuild if flipped.
            self._refresh_trace_flags()
        from .mesh import place_sharded

        sharding = NamedSharding(self.mesh, P(self.axis, None))

        def place(x):
            # Row-shard over the mesh; multi-process safe (see place_sharded)
            return place_sharded(x, sharding)

        coords = place(coords)
        opt_state0 = self.optimizer.init(coords.dtype)
        opt_state = jax.tree.map(
            lambda x, sharded_leaf: place(x) if sharded_leaf else x,
            opt_state0,
            self.optimizer.state_is_particle_sharded(opt_state0),
        )
        fdt = jnp.float64 if jax.config.jax_enable_x64 else jnp.float32
        if self.kernel is not None:
            kparams = tuple(
                jnp.asarray(p, coords.dtype) for p in self.kernel.parameters
            )
        else:
            kparams = (jnp.eye(self.dimension, dtype=coords.dtype),)
        replicated = NamedSharding(self.mesh, P())
        # Replicated placement for every non-particle leaf: one left on the
        # default device would make the first CHAINED run_state (an output
        # state fed back in) recompile once — the output shardings would
        # not match the input signature (same fix as the driver's
        # make_state).
        rep = jax.tree.map(
            lambda x: place_sharded(jnp.asarray(x), replicated),
            {
                "model_params": tuple(self.model.parameters),
                "kernel_params": kparams,
                # Foreign-model params per adaptive slot (None for slots
                # owned by self.model or with no model) — driver contract.
                "slot_model_params": tuple(
                    tuple(owner.target_model.parameters)
                    if getattr(owner, "target_model", None) is not None
                    and owner.target_model is not self.model
                    else None
                    for _, owner in self._adaptive_slots
                ),
                # warm-start median aux: per-rank distance brackets
                # (lo1, hi1, lo2, hi2, max_disp [, med for fused_phi]);
                # hi < lo marks a cold start
                "scale_aux": self._init_scale_aux(coords, fdt),
                "iteration": jnp.asarray(0, jnp.int32),
            },
        )
        return {"coords": coords, "opt_state": opt_state, **rep}

    def _init_scale_aux(self, coords, fdt):
        if self.config.fused_phi:
            # Median of the INITIAL positions seeds the lag-1 fused
            # pipeline (the same fused_median_seed contract as the driver,
            # honoring the adaptive leaves' median_method).
            from ..ops.median import fused_median_seed

            method = (
                self._adaptive_slots[0][1].median_method
                if self._adaptive_slots
                else "auto"
            )
            seed = fused_median_seed(coords, method)
            return (
                jnp.asarray(seed["lo1"], fdt),
                jnp.asarray(seed["hi1"], fdt),
                jnp.asarray(seed["lo2"], fdt),
                jnp.asarray(seed["hi2"], fdt),
                jnp.asarray(seed["disp"], fdt),
                jnp.asarray(seed["med"], fdt),
            )
        # Warm (non-fused) layout: per-rank brackets + disp; hi < lo marks
        # a cold start.
        return (
            jnp.asarray(0.0, fdt),
            jnp.asarray(-1.0, fdt),
            jnp.asarray(0.0, fdt),
            jnp.asarray(-1.0, fdt),
            jnp.asarray(0.0, fdt),
        )

    # ------------------------------------------------------------------
    # Hooks (reference Model::Step / Kernel::Step, Model.hpp:413 /
    # Kernel.hpp:356): a custom per-step hook is host-side Python and
    # cannot run inside the compiled scan — fall back to an eager
    # one-jitted-step-per-iteration loop, like the driver.
    # ------------------------------------------------------------------
    def _has_custom_hooks(self) -> bool:
        from ..svgd import SVGD

        if SVGD._hook_override(self.model, SVGD._MODEL_BASE_HOOKS) is not None:
            return True
        return (
            self.kernel is not None
            and SVGD._hook_override(self.kernel, SVGD._KERNEL_BASE_HOOKS)
            is not None
        )

    def _eager_hooks(self):
        from ..svgd import SVGD

        hook = SVGD._hook_override(self.model, SVGD._MODEL_BASE_HOOKS)
        if hook is not None:
            hook()
        if self.kernel is not None:
            hook = SVGD._hook_override(self.kernel, SVGD._KERNEL_BASE_HOOKS)
            if hook is not None:
                hook()

    def _refresh_component_params(self, state):
        """Re-read model/kernel parameters into the state after hooks ran
        (the sharded analog of the driver's make_state re-read; the
        reference's hooks mutate through shared pointers). Trace-time
        flags (PSD clamps, fused isotropy eligibility) are
        re-derived and the step rebuilt if a hook's mutation flipped them.
        """
        state = dict(state)
        state["model_params"] = tuple(self.model.parameters)
        if self.kernel is not None:
            dtype = state["coords"].dtype
            state["kernel_params"] = tuple(
                jnp.asarray(p, dtype) for p in self.kernel.parameters
            )
            self._refresh_trace_flags()
            state["slot_model_params"] = tuple(
                tuple(owner.target_model.parameters)
                if getattr(owner, "target_model", None) is not None
                and owner.target_model is not self.model
                else None
                for _, owner in self._adaptive_slots
            )
        return state

    # ------------------------------------------------------------------
    # Execution
    # ------------------------------------------------------------------
    def step_state(self, state):
        """One sharded step: state -> state (stats recorded if configured;
        custom model/kernel hooks run eagerly first, reference
        SVGD.hpp:373-390 hook-then-phi order)."""
        if self._has_custom_hooks():
            self._eager_hooks()
            state = self._refresh_component_params(state)
        state, stats = self._step_full(state)
        if self.config.log_intermediate_matrices:
            self._write_logs(jax.tree.map(lambda x: x[None], stats))
        elif self.config.track_stats:
            self._record_stats(jax.tree.map(lambda x: x[None], stats))
        self._state = state
        return state

    def _normalize_state(self, state):
        """Re-place every state leaf under its EXACT contract sharding.

        jit may emit equivalent-but-differently-spec'ed output shardings
        for replicated leaves (a passthrough (m, m) model param drifting
        to P(axis, None) on small meshes — with_sharding_constraint is
        only advisory under Auto mesh axes), and a chained
        run_state(output_state) would then recompile once per drift.
        Exact-spec normalization is a no-op for
        already-conforming leaves."""
        from .mesh import place_sharded

        def renorm(x, sh):
            return place_sharded(jnp.asarray(x), sh, exact=True)

        row = NamedSharding(self.mesh, P(self.axis, None))
        rep = NamedSharding(self.mesh, P())
        opt_mask = self.optimizer.state_is_particle_sharded(
            state["opt_state"]
        )
        out = dict(state)
        out["coords"] = renorm(state["coords"], row)
        out["opt_state"] = jax.tree.map(
            lambda x, m: renorm(x, row if m else rep),
            state["opt_state"], opt_mask,
        )
        for key in ("model_params", "kernel_params", "slot_model_params",
                    "scale_aux", "iteration"):
            out[key] = jax.tree.map(lambda x: renorm(x, rep), state[key])
        return out

    def run_state(self, state, num_steps: int):
        """State-in/state-out run: preserves optimizer moments, the warm
        median bracket and the iteration counter across calls — the sharded
        analog of the driver's continue-in-place contract (reference
        SVGD.hpp:338-400 mutates the user matrix in place across Run()s).
        Custom model/kernel hooks force the eager per-iteration loop.
        """
        state = self._normalize_state(state)
        if self._has_custom_hooks():
            return self._run_state_eager(state, int(num_steps))
        final, stats = self.run_fn(state, int(num_steps))
        if self.config.log_intermediate_matrices:
            self._write_logs(stats)
        elif self.config.track_stats:
            self._record_stats(stats)
        self._state = final
        return final

    def _run_state_eager(self, state, num_steps: int):
        """Eager fallback honoring custom hooks every iteration (reference
        runs Model::Step then Kernel::Step before each phi,
        SVGD.hpp:373-390); logging/stats still collect per step."""
        import numpy as np

        collect = (
            self.config.log_intermediate_matrices or self.config.track_stats
        )
        debugs = []
        for _ in range(num_steps):
            self._eager_hooks()
            state = self._refresh_component_params(state)
            state, stats = self._step_full(state)
            if collect:
                debugs.append(
                    jax.tree.map(
                        lambda x: np.asarray(jax.device_get(x)), stats
                    )
                )
        if debugs:
            stacked = {
                key: np.stack([d[key] for d in debugs]) for key in debugs[0]
            }
            if self.config.log_intermediate_matrices:
                self._write_logs(stacked)
            else:
                self._record_stats(stacked)
        self._state = state
        return state

    @property
    def intermediate_logs(self):
        """Stacked (T, ...) per-iteration debug matrices accumulated across
        step_state()/run_state() calls (None before any logging run).
        Stored internally as per-call chunks so per-step driving appends in
        O(new steps); merged (and cached) here on access."""
        chunks = self._intermediate_log_chunks
        if chunks is None:
            return None
        if len(chunks) > 1:
            import numpy as np

            self._intermediate_log_chunks = [
                {
                    k: np.concatenate([c[k] for c in chunks])
                    for k in chunks[0]
                }
            ]
        return self._intermediate_log_chunks[0]

    @intermediate_logs.setter
    def intermediate_logs(self, value):
        self._intermediate_log_chunks = None if value is None else [value]

    def _write_logs(self, debug):
        """Host-side write of the stacked per-iteration matrices in the
        reference's text format (reference SVGD.hpp:460-476); also kept on
        the instance as ``intermediate_logs`` (stacked (T, ...) arrays).
        Accumulates across step_state()/run_state() calls like the stats
        recorder; only the NEW iterations are appended to the file (with
        continuing step numbers), so per-step driving stays O(new steps)
        in I/O. run(coords=...) resets the accumulation."""
        import numpy as np

        from ..utils.logging import write_intermediate_matrices

        host = jax.tree.map(lambda x: np.asarray(jax.device_get(x)), debug)
        if self._intermediate_log_chunks is None:
            prior_steps = 0
            self._intermediate_log_chunks = [host]
        else:
            # Append a chunk, don't re-concatenate the whole history: a
            # per-step driver would otherwise copy O(T^2) host memory. The
            # chunks merge lazily on first ``intermediate_logs`` access.
            prior_steps = sum(
                c["coords"].shape[0] for c in self._intermediate_log_chunks
            )
            self._intermediate_log_chunks.append(host)
        write_intermediate_matrices(
            self.config.intermediate_matrices_output_path,
            host,
            start_step=prior_steps + 1,
            append=prior_steps > 0,
        )

    def _record_stats(self, stats):
        import numpy as np

        host = jax.tree.map(lambda x: np.asarray(jax.device_get(x)), stats)
        if self.stats is None:
            self.stats = host
        else:
            self.stats = {
                k: np.concatenate([self.stats[k], host[k]]) for k in host
            }

    def run(self, coords=None, num_iterations: int = None):
        """Run num_iterations sharded steps.

        ``coords`` given -> fresh start from those positions (zeroed
        optimizer moments, cold bandwidth bracket). ``coords=None`` ->
        continue from the previous run's final state (in-place semantics).
        Use init_state()/run_state() for explicit checkpoint-resume.
        """
        if num_iterations is None or int(num_iterations) <= 0:
            # A defaulted/zero count would silently reset state, run a
            # length-0 scan and hand back the inputs unchanged.
            raise ValueError(
                "run() requires a positive num_iterations "
                f"(got {num_iterations!r})."
            )
        if coords is not None:
            self._state = self.init_state(coords)
            self.stats = None
            self.intermediate_logs = None
        elif self._state is None:
            raise RuntimeError(
                "run(coords=None) requires a previous run to continue from."
            )
        return self.run_state(self._state, int(num_iterations))["coords"]
