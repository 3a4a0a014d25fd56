"""Algebraic flattening of composed RBF kernel trees.

The reference composes kernels with `+ - * /` into an opaque function that
is then autodiffed per particle pair (reference Kernel.hpp:55-223 feeding
the per-pair loop SVGD.hpp:445-449). Here the generic path for such a
composition is the tile-streamed VJP (`ops/phi.phi_generic_cross`) — correct
for any kernel, but much more expensive than the closed-form RBF
contraction because each tile replays the composed kernel's
forward+backward instead of two matmuls.

For trees whose leaves are all *pure Gaussian RBF* kernels the composition
never needs the generic path, because of two identities:

  * phi is LINEAR in k:   phi_{a*k1 + b*k2} = a*phi_{k1} + b*phi_{k2}
  * RBF products COLLAPSE: exp(-d^T P1 d) * exp(-d^T P2 d)
                             = exp(-d^T (P1+P2) d)      (same for /: P1-P2)

so any `+ - * /` tree flattens to a signed sum of RBF terms, each with an
effective precision matrix that is a signed sum of leaf parameter slots —
and each term's phi runs on the closed-form tile-streamed path
(`ops/phi.phi_rbf_cross`). Per-step bandwidth adaptation keeps working
unchanged: the driver refills the adaptive slots in the flat parameter
tuple and the terms read the refreshed values.

A term is ``(sign, ((param_idx, psign), ...))`` representing

    sign * exp( - d^T ( sum_i psign * params[param_idx] ) d ).

``flatten_rbf_terms`` returns the term list, or ``None`` when the kernel is
not a pure-RBF arithmetic tree (custom leaf, non-single-term divisor, or a
term blow-up past ``MAX_RBF_TERMS`` from products of large sums).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

Term = Tuple[int, Tuple[Tuple[int, int], ...]]

# Products of sums multiply term counts; past this the generic VJP path is
# likely cheaper than many O(n^2) closed-form sweeps.
MAX_RBF_TERMS = 16


def flatten_rbf_terms(kernel, _offset: int = 0) -> Optional[List[Term]]:
    """Flatten a composed kernel into signed RBF terms, or None.

    ``_offset`` is the position of ``kernel``'s first parameter inside the
    ROOT kernel's concatenated parameter tuple (composition concatenates
    child parameters; reference Kernel.hpp:77-81).
    """
    from .gaussian_rbf import GaussianRBFKernel, rbf_kernel_fn

    info = getattr(kernel, "_compose_info", None)
    if info is None:
        # Leaf: must be a pure (un-overridden) Gaussian RBF with its single
        # inverse-scale parameter slot.
        if (
            isinstance(kernel, GaussianRBFKernel)
            and kernel._kernel_fn is rbf_kernel_fn
            and len(kernel.parameters) == 1
        ):
            return [(1, ((_offset, 1),))]
        return None

    op_name, left, right, n1 = info
    lt = flatten_rbf_terms(left, _offset)
    rt = flatten_rbf_terms(right, _offset + n1)
    if lt is None or rt is None:
        return None

    if op_name == "added":
        out = lt + rt
    elif op_name == "subtracted":
        out = lt + [(-s, p) for s, p in rt]
    elif op_name == "multiplied":
        # (sum_a) * (sum_b) distributes; each pair of RBF factors collapses
        # by adding precision matrices.
        out = [(sa * sb, pa + pb) for sa, pa in lt for sb, pb in rt]
    elif op_name == "divided":
        # Only a single-term positive divisor stays inside the RBF algebra:
        # 1/exp(-d^T P d) = exp(-d^T (-P) d).
        if len(rt) != 1 or rt[0][0] != 1:
            return None
        _, pdiv = rt[0]
        neg = tuple((idx, -ps) for idx, ps in pdiv)
        out = [(sa, pa + neg) for sa, pa in lt]
    else:  # pragma: no cover - future operators
        return None

    if len(out) > MAX_RBF_TERMS:
        return None
    return out


def fused_terms_eligible(terms, adaptive_slots, parameters) -> bool:
    """True when a flattened term list can run the single-sweep fused path
    (ops/phi.phi_rbf_terms_fused_counts + lag-1 median).

    Requirements:
      * at least one adaptive slot, and EVERY adaptive slot is
        median-scaled (a median slot's value is a function of the shared
        coords alone, so one lag-1 median serves all of them; Hessian
        slots are anisotropic in general and would break the shared-sq
        trick);
      * every non-adaptive slot currently holds an ISOTROPIC matrix
        (gamma * I) — each term's quadratic form then collapses to
        gamma_t * ||x_i - x_j||^2 and all terms share one squared-distance
        tile. Checked against the CONCRETE parameter values at driver
        initialization; hot-swapping an anisotropic matrix into a running
        fused-terms driver is rejected by the driver's re-validation.
    """
    import numpy as np

    from .gaussian_rbf import GaussianRBFKernel

    if terms is None or not adaptive_slots:
        return False
    adaptive_idx = set()
    for idx, owner in adaptive_slots:
        if owner.scale_method != GaussianRBFKernel.ScaleMethod.MEDIAN:
            return False
        adaptive_idx.add(idx)
    for _, plist in terms:
        for idx, _ in plist:
            if idx in adaptive_idx:
                continue
            if not _slot_is_isotropic(parameters[idx]):
                return False
    return True


def _slot_is_isotropic(p) -> bool:
    """True when a concrete parameter slot holds gamma * I."""
    import numpy as np

    p = np.asarray(p)
    return p.ndim == 2 and bool(
        np.allclose(p, p[0, 0] * np.eye(p.shape[0]))
    )


def term_is_psd(term: Term) -> bool:
    """True when the term's effective precision is a nonnegative combination
    of (PSD) leaf parameters — lets the phi tile pass clamp the quadratic
    form at zero as a numerical guard. Any negated slot (division) may make
    it indefinite, so the clamp must be skipped.

    NOTE: this positional rule assumes every leaf parameter is itself PSD,
    which holds for median/constant-isotropic slots but NOT for Hessian
    slots on non-log-concave models or arbitrary user constants — call
    sites with kernel context should use :func:`term_psd_flags` instead.
    """
    return all(ps > 0 for _, ps in term[1])


def matrix_is_psd(p, tol: float = -1e-12) -> bool:
    """PSD check on the symmetric part (the quadratic form only sees it).

    The single definition used by the driver, the sharded driver and the
    term flags — keep the symmetrization rule and tolerance here.
    """
    import numpy as np

    p = np.asarray(p)
    if p.ndim != 2 or p.shape[0] != p.shape[1]:
        return False
    sym = 0.5 * (p + p.T)
    return bool(np.linalg.eigvalsh(sym).min() >= tol)


def term_psd_flags(terms, adaptive_slots, parameters):
    """Per-term PSD-ness determined from slot TYPES and concrete values.

    A term's quadratic form may be clamped at zero (numerical guard) only
    when its effective precision is provably PSD:

      * every slot enters with positive sign (division negates),
      * median-adaptive slots are always PSD (log(n)/med^2 * I),
      * Hessian-adaptive slots are NEVER assumed PSD — on a non-log-concave
        model (e.g. a GMM saddle region) -mean(hess log p) is indefinite
        and the quadratic form is legitimately negative,
      * non-adaptive (constant) slots are eigenvalue-checked on their
        current concrete values.

    Returns a list of bools aligned with ``terms``.
    """
    from .gaussian_rbf import GaussianRBFKernel

    slot_method = {
        idx: owner.scale_method for idx, owner in adaptive_slots
    }

    def slot_psd(idx):
        method = slot_method.get(idx)
        if method == GaussianRBFKernel.ScaleMethod.MEDIAN:
            return True
        if method is not None:  # HESSIAN (or future adaptive methods)
            return False
        return matrix_is_psd(parameters[idx])

    return [
        all(ps > 0 and slot_psd(idx) for idx, ps in plist)
        for _, plist in terms
    ]


def term_precision(plist, kernel_params):
    """Effective precision matrix of one term: sum_i psign * params[idx].

    Single definition of the slot-to-P reduction used by every consumer of
    flattened terms (phi term sweeps, the ring variant, composed-kernel
    KSD) so a change to the term representation has one home.
    """
    p = None
    for idx, psign in plist:
        contrib = kernel_params[idx] if psign > 0 else -kernel_params[idx]
        p = contrib if p is None else p + contrib
    return p


def term_gamma(plist, kernel_params):
    """Effective isotropic gamma of one term: sum_i psign * params[idx][0, 0].

    Only meaningful once ``fused_terms_eligible`` proved every slot is
    isotropic (gamma * I) — the scalar twin of ``term_precision`` used by
    the fused multi-term sweeps.
    """
    return sum(
        float(psign) * kernel_params[idx][0, 0] for idx, psign in plist
    )


def refill_median_slots(kernel_params, median_slot_idx, gamma, dim, dtype,
                        plists):
    """Refill every median adaptive slot with ``gamma * I`` and return the
    per-term effective gammas (``term_gamma`` over the refreshed tuple).

    The in-scan half of the fused multi-term sweep's parameter refresh
    (constant slots keep their state values), shared by the driver and
    ShardedSVGD.
    """
    import jax.numpy as jnp

    kparams = list(kernel_params)
    med_scale = gamma * jnp.eye(dim, dtype=dtype)
    for idx in median_slot_idx:
        kparams[idx] = med_scale
    kparams = tuple(kparams)
    return kparams, [term_gamma(plist, kparams) for plist in plists]
