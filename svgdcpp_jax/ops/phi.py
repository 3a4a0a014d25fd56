"""Stein variational gradient phi_hat.

    phi(x_i) = (1/n) sum_j [ k(x_j, x_i) grad_{x_j} log p(x_j)
                             + grad_{x_j} k(x_j, x_i) ]

A vectorized redesign of the reference's O(n^2) hot loop
(reference: SVGD.hpp:407-454). The reference evaluates n^2 kernel forwards +
n^2 kernel Jacobians by CppAD tape replay, re-recording the tape once per
particle per iteration (SVGD.hpp:441-442), materializes an (m n) x n gradient
stack and contracts it with a replicated-identity indexer (SVGD.hpp:181,453).

Here there are three implementations:

  * ``phi_generic``     — any kernel function, via vmap + autodiff. The
                          (m n) x n stack and the indexer trick collapse into
                          a plain VJP reduction.
  * ``phi_rbf``         — closed-form Gaussian-RBF path: everything becomes
                          two matmuls against the kernel matrix
                          K = exp(-quad). grad_{x_j} k = -(P+P^T)(x_j-x_i) k,
                          so  sum_j grad k = -(K X - rowsum(K) * X)(P+P^T).
  * ``phi_rbf_blocked`` — same math, tile-streamed over row blocks so the
                          n x n kernel matrix never materializes in HBM
                          (100k+ particles; SURVEY.md §5 "long context"
                          analog).

The fused phi + median-count sweeps (``phi_rbf_terms_cross_fused_counts``
and its wrappers) have a one-kernel GPU form in ``pallas_phi.py``.

Every dot here runs at ``pairwise.DOT_PRECISION`` (f32, never TF32).

Index convention: K[i, j] = k(x_j, x_i) — row i is the target particle.
(The reference's kernel_matrix_(j, i) transposed to match the (n, m) row
layout; the contraction K @ S equals the reference's S_ref * K_ref.)
"""

from __future__ import annotations

from typing import Callable, Tuple

import jax
import jax.numpy as jnp

from .pairwise import pdot


# ----------------------------------------------------------------------
# Generic path: arbitrary kernel_fn(x, params, location)
# ----------------------------------------------------------------------


def phi_generic_cross(
    targets: jnp.ndarray,
    sources: jnp.ndarray,
    source_scores: jnp.ndarray,
    kernel_fn: Callable,
    kernel_params,
    row_tile: int = 128,
    axis_name=None,
) -> jnp.ndarray:
    """Tile-streamed phi for an arbitrary composed/user kernel.

    phi_i = (1/n_src) sum_j [ k(s_j, t_i) score_j + grad_{s_j} k(s_j, t_i) ]

    Per target i the summed kernel gradient is one ones-cotangent VJP (the
    reference's kernel_grad_indexer_ contraction, SVGD.hpp:453, IS that
    VJP); targets are processed in row tiles so the batched VJP residual —
    an O(row_tile * n_src * m) intermediate — never becomes the O(n^2 * m)
    array a full vmap would materialize. ``row_tile`` is auto-clamped to a
    fixed HBM budget, so composed kernels run at the same particle counts
    as the closed-form RBF paths.

    The cross form (local target rows x global sources) is the building
    block of the sharded multi-chip generic phi.
    """
    from .pairwise import auto_row_tile

    n_t, m = targets.shape
    n_s = sources.shape[0]
    # The live per-tile buffer is (row_tile, n_s, m) cotangents.
    row_tile = auto_row_tile(n_s, row_tile, elem_bytes=4 * m)
    num_tiles = -(-n_t // row_tile)
    pad = num_tiles * row_tile - n_t
    targets_pad = jnp.pad(targets, ((0, pad), (0, 0)))

    def per_target(x_i):
        def k_all(srcs):
            return jax.vmap(lambda x_j: kernel_fn(x_j, kernel_params, x_i))(srcs)

        k_row, vjp = jax.vjp(k_all, sources)
        (grad_sum,) = vjp(jnp.ones_like(k_row))  # (n_s, m): rows grad_{s_j} k
        return pdot(k_row, source_scores) + jnp.sum(grad_sum, axis=0)

    def tile_body(t, acc):
        rows = jax.lax.dynamic_slice_in_dim(targets_pad, t * row_tile, row_tile, 0)
        phi_tile = jax.vmap(per_target)(rows)
        return jax.lax.dynamic_update_slice_in_dim(acc, phi_tile, t * row_tile, 0)

    acc0 = jnp.zeros((num_tiles * row_tile, m), targets.dtype)
    if axis_name is not None:
        # shard_map VMA rules: mark the fori carry device-varying.
        acc0 = jax.lax.pcast(acc0, (axis_name,), to="varying")
    return jax.lax.fori_loop(0, num_tiles, tile_body, acc0)[:n_t] / n_s


def phi_generic(
    coords: jnp.ndarray,
    scores: jnp.ndarray,
    kernel_fn: Callable,
    kernel_params,
    row_tile: int = 128,
) -> jnp.ndarray:
    """phi for an arbitrary composed/user kernel (tile-streamed).

    coords: (n, m) particles; scores: (n, m) grad log p per particle.
    """
    return phi_generic_cross(
        coords, coords, scores, kernel_fn, kernel_params, row_tile
    )


def kernel_matrix_and_grad(
    coords: jnp.ndarray, kernel_fn: Callable, kernel_params
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Full K (n, n) and grad stack G (n, n, m) for debug logging.

    K[i, j] = k(x_j, x_i); G[i, j] = grad_{x_j} k(x_j, x_i). This is the
    reference's kernel_matrix_ / kernel_grad_matrix_ pair (SVGD.hpp:500-502)
    in (n, m) layout — only used by the intermediate-matrix debug dump.
    """
    return kernel_matrix_and_grad_cross(coords, coords, kernel_fn, kernel_params)


def kernel_matrix_and_grad_cross(
    targets: jnp.ndarray,
    sources: jnp.ndarray,
    kernel_fn: Callable,
    kernel_params,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Cross (sharded) form of :func:`kernel_matrix_and_grad`: the local
    target-row band K (n_local, n) / G (n_local, n, m) of the global debug
    matrices — shard_map reassembles the bands into the full matrices for
    ShardedSVGD's intermediate-matrix logging (reference SVGD.hpp:346-366
    snapshots the same pair every iteration)."""

    def pair(x_j, x_i):
        return kernel_fn(x_j, kernel_params, x_i)

    k = jax.vmap(lambda xi: jax.vmap(lambda xj: pair(xj, xi))(sources))(targets)
    g = jax.vmap(
        lambda xi: jax.vmap(lambda xj: jax.grad(pair, 0)(xj, xi))(sources)
    )(targets)
    return k, g


# ----------------------------------------------------------------------
# Gaussian-RBF closed form: dense XLA path
# ----------------------------------------------------------------------


def rbf_kernel_matrix(
    coords: jnp.ndarray, p_matrix: jnp.ndarray, psd: bool = True
) -> jnp.ndarray:
    """K[i, j] = exp(-(x_j - x_i)^T P (x_j - x_i)) via the Gram identity.

    ``psd=False`` skips the clamp-at-zero noise guard (indefinite P —
    Hessian scale on a non-log-concave model)."""
    from .pairwise import weighted_quadratic_pairwise

    return jnp.exp(-weighted_quadratic_pairwise(coords, p_matrix, psd=psd))


def phi_rbf(
    coords: jnp.ndarray,
    scores: jnp.ndarray,
    p_matrix: jnp.ndarray,
    psd: bool = True,
) -> jnp.ndarray:
    """Closed-form RBF phi: two matmuls against K.

    phi = (K S - (K X - rowsum(K) * X)(P + P^T)) / n
    """
    n = coords.shape[0]
    k = rbf_kernel_matrix(coords, p_matrix, psd=psd)
    p_sym = p_matrix + p_matrix.T
    ks = pdot(k, scores)
    kx = pdot(k, coords)
    rowsum = jnp.sum(k, axis=1)
    return (ks - pdot(kx - rowsum[:, None] * coords, p_sym)) / n


# ----------------------------------------------------------------------
# Gaussian-RBF closed form: tile-streamed (no n x n materialization)
# ----------------------------------------------------------------------


def phi_rbf_cross(
    targets: jnp.ndarray,
    sources: jnp.ndarray,
    source_scores: jnp.ndarray,
    p_matrix: jnp.ndarray,
    row_tile: int = 1024,
    axis_name=None,
    psd: bool = True,
) -> jnp.ndarray:
    """Streaming RBF phi for ``targets`` rows against global ``sources``.

    phi_i = (1/n_src) sum_j [ k(s_j, t_i) score_j + grad_{s_j} k(s_j, t_i) ]

    Tile-streamed over target rows; memory O(row_tile * n_src). Per tile:
    build the K tile from Gram pieces, then one matmul against
    B = [S | X | 1] gives K S, K X and rowsum(K) simultaneously — K never
    round-trips to HBM. The cross form is the building block of the sharded
    multi-chip phi (local targets x all-gathered sources, SURVEY.md §7).

    ``psd=False`` disables the clamp-at-zero numerical guard on the
    quadratic form: algebraic division terms (kernels/algebra.py) carry an
    indefinite effective P whose quadratic form is legitimately negative.
    """
    from .pairwise import auto_row_tile

    # phi is translation-invariant (kernel and its gradient depend only on
    # differences); centering protects the Gram-identity branch from f32
    # cancellation for off-origin clusters and costs one O(n m) pass.
    center = jnp.mean(sources, axis=0)
    targets = targets - center
    sources = sources - center

    n_t, m = targets.shape
    n_s = sources.shape[0]
    row_tile = auto_row_tile(n_s, row_tile)
    num_tiles = -(-n_t // row_tile)
    pad = num_tiles * row_tile - n_t
    p_sym = p_matrix + p_matrix.T
    q_src = jnp.sum(pdot(sources, p_matrix) * sources, axis=1)  # (n_s,)
    q_tgt = jnp.sum(pdot(targets, p_matrix) * targets, axis=1)  # (n_t,)
    src_ps = pdot(sources, p_sym)  # (n_s, m): rows s_j^T (P+P^T)
    b = jnp.concatenate(
        [source_scores, sources, jnp.ones((n_s, 1), sources.dtype)], axis=1
    )  # (n_s, 2m+1)

    targets_pad = jnp.pad(targets, ((0, pad), (0, 0)))
    q_tgt_pad = jnp.pad(q_tgt, (0, pad))

    # For small m, both f32 cancellation sites are avoided: the quadratic
    # form is built from explicit differences (the Gram identity
    # q_i + q_j - cross loses ~3 digits for nearby pairs), and the summed
    # kernel gradient is accumulated directly as sum_j K * diff (the
    # K X - rowsum(K) X rearrangement subtracts two nearly equal O(n)
    # sums). Costs O(m^2) elementwise ops per pair instead of a matmul —
    # a wash at small m.
    diff_form = m <= 4

    if diff_form:

        def tile_body(t, acc):
            rows = jax.lax.dynamic_slice_in_dim(
                targets_pad, t * row_tile, row_tile, 0
            )
            diffs = [rows[:, a, None] - sources[None, :, a] for a in range(m)]
            quad = jnp.zeros((row_tile, n_s), rows.dtype)
            for a in range(m):
                for bb in range(a, m):
                    w = p_sym[a, bb] if a != bb else p_matrix[a, a]
                    quad = quad + w * diffs[a] * diffs[bb]
            if psd:
                quad = jnp.maximum(quad, 0.0)
            k_tile = jnp.exp(-quad)
            ks = pdot(k_tile, source_scores)  # (row_tile, m)
            # sum_j grad_{x_j} k = (P+P^T) sum_j K (x_i - x_j) per target i
            t_vec = jnp.stack(
                [jnp.sum(k_tile * diffs[a], axis=1) for a in range(m)], axis=1
            )
            phi_tile = ks + pdot(t_vec, p_sym)
            return jax.lax.dynamic_update_slice_in_dim(
                acc, phi_tile, t * row_tile, 0
            )

        acc0 = jnp.zeros((num_tiles * row_tile, m), targets.dtype)
        if axis_name is not None:
            acc0 = jax.lax.pcast(acc0, (axis_name,), to="varying")
        return jax.lax.fori_loop(0, num_tiles, tile_body, acc0)[:n_t] / n_s

    def tile_body(t, acc):
        rows = jax.lax.dynamic_slice_in_dim(targets_pad, t * row_tile, row_tile, 0)
        q_rows = jax.lax.dynamic_slice_in_dim(q_tgt_pad, t * row_tile, row_tile)
        cross = pdot(rows, src_ps.T)  # (row_tile, n_s)
        quad = q_rows[:, None] + q_src[None, :] - cross
        if psd:
            quad = jnp.maximum(quad, 0.0)
        k_tile = jnp.exp(-quad)
        a_tile = pdot(k_tile, b)  # (row_tile, 2m+1)
        return jax.lax.dynamic_update_slice_in_dim(acc, a_tile, t * row_tile, 0)

    a0 = jnp.zeros((num_tiles * row_tile, 2 * m + 1), targets.dtype)
    if axis_name is not None:
        # shard_map VMA rules: the fori carry must match the body's
        # device-varying type; mark the zero init as varying.
        a0 = jax.lax.pcast(a0, (axis_name,), to="varying")
    a = jax.lax.fori_loop(0, num_tiles, tile_body, a0)[:n_t]

    ks = a[:, :m]
    kx = a[:, m : 2 * m]
    rowsum = a[:, 2 * m]
    return (ks - pdot(kx - rowsum[:, None] * targets, p_sym)) / n_s


def phi_rbf_blocked(
    coords: jnp.ndarray,
    scores: jnp.ndarray,
    p_matrix: jnp.ndarray,
    row_tile: int = 1024,
    psd: bool = True,
) -> jnp.ndarray:
    """Tile-streamed single-set RBF phi (see phi_rbf_cross)."""
    return phi_rbf_cross(coords, coords, scores, p_matrix, row_tile, psd=psd)


# ----------------------------------------------------------------------
# Algebraic composed-RBF path: signed sum of closed-form RBF terms
# ----------------------------------------------------------------------


def phi_rbf_terms_cross(
    targets: jnp.ndarray,
    sources: jnp.ndarray,
    source_scores: jnp.ndarray,
    kernel_params,
    terms,
    row_tile: int = 1024,
    axis_name=None,
    psd_flags=None,
) -> jnp.ndarray:
    """phi for a composed kernel flattened to signed RBF terms.

    ``terms`` comes from kernels/algebra.flatten_rbf_terms: phi is linear in
    k, so the composed kernel's phi is the signed sum of each term's
    closed-form RBF phi (effective P = signed sum of parameter slots). This
    replaces the generic VJP path for `+ - * /` trees of pure RBF kernels
    (reference Kernel.hpp:55-223) with T closed-form sweeps.

    ``psd_flags`` (from kernels/algebra.term_psd_flags, which accounts for
    Hessian-adaptive and indefinite constant slots) controls the per-term
    quadratic-form clamp; without it the positional term_is_psd rule is
    used, which is only safe when every leaf parameter is PSD.
    """
    from ..kernels.algebra import term_is_psd, term_precision

    if psd_flags is None:
        psd_flags = [term_is_psd(t) for t in terms]
    elif len(psd_flags) != len(terms):
        # zip() would silently drop trailing terms (stale flags
        # from a filtered/hot-swapped term list) — fail loudly.
        raise ValueError(
            f"psd_flags has {len(psd_flags)} entries for "
            f"{len(terms)} terms"
        )
    phi = None
    for (sign, plist), t_psd in zip(terms, psd_flags):
        p = term_precision(plist, kernel_params)
        t_phi = phi_rbf_cross(
            targets, sources, source_scores, p, row_tile,
            axis_name=axis_name, psd=t_psd,
        )
        t_phi = t_phi if sign > 0 else -t_phi
        phi = t_phi if phi is None else phi + t_phi
    return phi


def phi_rbf_terms(
    coords: jnp.ndarray,
    scores: jnp.ndarray,
    kernel_params,
    terms,
    row_tile: int = 1024,
    psd_flags=None,
) -> jnp.ndarray:
    """Single-chip algebraic composed-RBF phi (see phi_rbf_terms_cross)."""
    return phi_rbf_terms_cross(
        coords, coords, scores, kernel_params, terms, row_tile,
        psd_flags=psd_flags,
    )



def phi_rbf_terms_cross_fused_counts(
    targets: jnp.ndarray,
    sources: jnp.ndarray,
    source_scores: jnp.ndarray,
    gammas,
    signs,
    thresholds_sq: jnp.ndarray,
    row_tile: int = 1024,
    axis_name=None,
):
    """ONE O(n^2) tile sweep: phi of a signed sum of ISOTROPIC RBF terms
    AND the median-selection threshold counts, in cross (sharded) form.

    This is the single XLA implementation behind all four fused entry
    points (self/cross x single-term/multi-term — the wrappers below), and
    the plain reference of the fused GPU kernel (ops/pallas_phi.py). ``targets``
    is a local row shard, ``sources`` the (all-gathered) global set; the
    returned counts cover this shard's disjoint row-band of the global
    n x n pair matrix — psum them over the mesh axis for the global
    cumulative ranks (ops/median.fused_median_from_counts). Counts use the
    n^2-including-self-zeros semantics (reference GaussianRBFKernel.hpp:66)
    and are exact integers (int32 accumulation) while n_t * n_s < 2^31.

    ``gammas``/``signs`` come from the driver's algebraic flattening
    (kernels/algebra.py) restricted to isotropic terms: term t's quadratic
    form is gamma_t * sq, so every term shares ONE squared-distance tile.
    For a single positive term the tile contracts K against [S | X | 1] in
    one matmul (the primary-metric hot path); for T terms it combines

        k_c = sum_t sign_t exp(-gamma_t sq)            (for K S)
        w   = sum_t sign_t gamma_t exp(-gamma_t sq)    (for the grad part)

    into two matmuls totalling the same columns. A negative combined gamma
    (division terms) needs no clamp handling: the shared sq is a true
    distance, always >= 0.

    Returns (phi_local (n_t, m) normalized by n_src, counts (E,) f32).
    """
    from .pairwise import auto_row_tile

    center = jnp.mean(sources, axis=0)
    targets = targets - center
    sources = sources - center

    n_t, m = targets.shape
    n_s = sources.shape[0]
    row_tile = auto_row_tile(n_s, row_tile)
    num_tiles = -(-n_t // row_tile)
    pad = num_tiles * row_tile - n_t
    gammas = [jnp.asarray(g, targets.dtype) for g in gammas]
    signs = [float(s) for s in signs]
    thresholds_sq = jnp.asarray(thresholds_sq, targets.dtype)
    n_thresh = thresholds_sq.shape[0]
    # Single positive term: one combined contraction per tile.
    single = len(gammas) == 1 and signs[0] == 1.0

    targets_pad = jnp.pad(targets, ((0, pad), (0, 0)))
    if single:
        b = jnp.concatenate(
            [source_scores, sources, jnp.ones((n_s, 1), sources.dtype)],
            axis=1,
        )
    else:
        xs1 = jnp.concatenate(
            [sources, jnp.ones((n_s, 1), sources.dtype)], axis=1
        )
    q_src = jnp.sum(sources * sources, axis=1)
    q_tgt_pad = jnp.pad(jnp.sum(targets * targets, axis=1), (0, pad))
    diff_form = m <= 4

    # int32 counts are exact while the pair total fits; past that, f32.
    count_dtype = jnp.int32 if n_t * n_s < 2**31 else jnp.float32

    def _counts(sq, t):
        """Median selection counts on the tile (compare/reduce); padded
        target rows excluded."""
        row_ids = (
            jax.lax.broadcasted_iota(jnp.int32, (row_tile, n_s), 0)
            + t * row_tile
        )
        valid = row_ids < n_t
        return jnp.sum(
            (sq[None, :, :] <= thresholds_sq[:, None, None]) & valid[None, :, :],
            axis=(1, 2),
            dtype=count_dtype,
        )

    def _combine(sq):
        k_c = None
        w = None
        for s, g in zip(signs, gammas):
            k_t = jnp.exp(-g * sq)
            k_term = s * k_t
            w_term = (s * g) * k_t
            k_c = k_term if k_c is None else k_c + k_term
            w = w_term if w is None else w + w_term
        return k_c, w

    if diff_form:
        # Cancellation-free explicit differences; the summed kernel
        # gradient accumulates directly as sum_j K * diff.
        def tile_body(t, carry):
            acc, counts = carry
            rows = jax.lax.dynamic_slice_in_dim(
                targets_pad, t * row_tile, row_tile, 0
            )
            diffs = [rows[:, a, None] - sources[None, :, a] for a in range(m)]
            sq = jnp.zeros((row_tile, n_s), rows.dtype)
            for a in range(m):
                sq = sq + diffs[a] * diffs[a]
            if single:
                k_tile = jnp.exp(-gammas[0] * sq)
                ks = pdot(k_tile, source_scores)
                t_vec = jnp.stack(
                    [jnp.sum(k_tile * diffs[a], axis=1) for a in range(m)],
                    axis=1,
                )
                phi_tile = ks + 2.0 * gammas[0] * t_vec
            else:
                k_c, w = _combine(sq)
                ks = pdot(k_c, source_scores)
                t_vec = jnp.stack(
                    [jnp.sum(w * diffs[a], axis=1) for a in range(m)], axis=1
                )
                phi_tile = ks + 2.0 * t_vec
            acc = jax.lax.dynamic_update_slice_in_dim(
                acc, phi_tile, t * row_tile, 0
            )
            return acc, counts + _counts(sq, t)

        acc0 = jnp.zeros((num_tiles * row_tile, m), targets.dtype)
        counts0 = jnp.zeros(n_thresh, count_dtype)
        if axis_name is not None:
            acc0 = jax.lax.pcast(acc0, (axis_name,), to="varying")
            counts0 = jax.lax.pcast(counts0, (axis_name,), to="varying")
        acc, counts = jax.lax.fori_loop(0, num_tiles, tile_body, (acc0, counts0))
        return acc[:n_t] / n_s, counts.astype(jnp.float32)

    def tile_body(t, carry):
        acc, counts = carry
        rows = jax.lax.dynamic_slice_in_dim(targets_pad, t * row_tile, row_tile, 0)
        q_rows = jax.lax.dynamic_slice_in_dim(q_tgt_pad, t * row_tile, row_tile)
        gram = pdot(rows, sources.T)
        sq = jnp.maximum(q_rows[:, None] + q_src[None, :] - 2.0 * gram, 0.0)
        if single:
            k_tile = jnp.exp(-gammas[0] * sq)
            a_tile = pdot(k_tile, b)  # K S, K X, rowsum in one contraction
        else:
            k_c, w = _combine(sq)
            a_tile = jnp.concatenate(
                [pdot(k_c, source_scores), pdot(w, xs1)], axis=1
            )
        acc = jax.lax.dynamic_update_slice_in_dim(acc, a_tile, t * row_tile, 0)
        return acc, counts + _counts(sq, t)

    acc0 = jnp.zeros((num_tiles * row_tile, 2 * m + 1), targets.dtype)
    counts0 = jnp.zeros(n_thresh, count_dtype)
    if axis_name is not None:
        acc0 = jax.lax.pcast(acc0, (axis_name,), to="varying")
        counts0 = jax.lax.pcast(counts0, (axis_name,), to="varying")
    acc, counts = jax.lax.fori_loop(0, num_tiles, tile_body, (acc0, counts0))
    counts = counts.astype(jnp.float32)
    a = acc[:n_t]
    ks = a[:, :m]
    mid = a[:, m : 2 * m]
    last = a[:, 2 * m]
    if single:
        phi = (ks - 2.0 * gammas[0] * (mid - last[:, None] * targets)) / n_s
    else:
        # mid/last already carry the gamma weights (w = sum sign*gamma*k).
        phi = (ks - 2.0 * (mid - last[:, None] * targets)) / n_s
    return phi, counts


def phi_rbf_terms_fused_counts(
    coords: jnp.ndarray,
    scores: jnp.ndarray,
    gammas,
    signs,
    thresholds_sq: jnp.ndarray,
    row_tile: int = 1024,
):
    """Single-set multi-term fused sweep (see the cross form)."""
    return phi_rbf_terms_cross_fused_counts(
        coords, coords, scores, gammas, signs, thresholds_sq, row_tile
    )


def phi_rbf_fused_counts(
    coords: jnp.ndarray,
    scores: jnp.ndarray,
    gamma,
    thresholds_sq: jnp.ndarray,
    row_tile: int = 1024,
):
    """Single-set single-term fused sweep: ONE O(n^2) pass producing both
    the RBF phi (P = gamma I) and the median-selection counts — the
    primary-metric hot path (see phi_rbf_terms_cross_fused_counts)."""
    return phi_rbf_terms_cross_fused_counts(
        coords, coords, scores, [gamma], [1], thresholds_sq, row_tile
    )
