"""Ring (ppermute) multi-chip SVGD primitives — gather-free scale-out.

The gather-based sharded step (sharded.py) all-gathers the (n, m) coords and
scores once per step: fine up to millions of particles, but its per-device
memory is O(n m). The ring mode never materializes the global particle set:
each device's source block rotates around the mesh axis with
``jax.lax.ppermute`` while every device accumulates its local targets'
contributions — the ring-attention-shaped schedule for the O(n^2) kernel
sum (SURVEY.md §5), with per-device memory O((n/D) m) and the same total
interconnect traffic as the all-gather, overlapped with compute by XLA.

Used by ShardedSVGD when ``phi_mode='ring'``. The median in ring mode uses
pure count-bisection (no pair-sampling bracket — sampling needs global
random access, which is exactly what ring mode avoids).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..ops.median import kth_smallest_bisect
from ..ops.pairwise import pdot


def _rotate(x, axis_name):
    """Send to the next device on the ring (cyclic ppermute)."""
    size = jax.lax.axis_size(axis_name)
    perm = [(i, (i + 1) % size) for i in range(size)]
    return jax.lax.ppermute(x, axis_name, perm)


def ring_phi_rbf(
    coords_local: jnp.ndarray,
    scores_local: jnp.ndarray,
    p_matrix: jnp.ndarray,
    axis_name: str,
    n_global: int,
    psd: bool = True,
    row_tile: int = 256,
) -> jnp.ndarray:
    """phi for local targets with sources streamed around the ring.

    Per rotation the local targets stream in ``row_tile`` bands against the
    rotating (n_loc, .) source block, so the largest live intermediate is
    the (row_tile, n_loc) kernel tile — per-device memory stays
    O(row_tile * n/D + n m / D). (Round 4: a full (n_loc, n_loc) block per
    rotation measured 17.7 GB/device of XLA temporaries at n=256k, D=8 —
    scripts/measure_sharded_memory.py; tiled it is ~row_tile/n_loc of
    that.) D rotations cover all sources exactly once. ``psd=False`` skips
    the clamp-at-zero guard on the quadratic form (algebraic division
    terms carry an indefinite effective P — see kernels/algebra.py).
    """
    n_loc, m = coords_local.shape
    size = jax.lax.axis_size(axis_name)
    # Global-mean centering (translation-invariant; protects the Gram
    # identity from f32 cancellation for off-origin clusters).
    center = jax.lax.psum(jnp.sum(coords_local, axis=0), axis_name) / n_global
    coords_local = coords_local - center
    p_sym = p_matrix + p_matrix.T
    q_tgt = jnp.sum(pdot(coords_local, p_matrix) * coords_local, axis=1)  # (n_loc,)

    # Rotating source-block state, derived once locally then streamed.
    src_ps0 = pdot(coords_local, p_sym)  # rows s_j^T (P+P^T)
    q_src0 = q_tgt  # same quadratic form values
    b0 = jnp.concatenate(
        [scores_local, coords_local, jnp.ones((n_loc, 1), coords_local.dtype)],
        axis=1,
    )

    row_tile = min(row_tile, n_loc)
    num_tiles = -(-n_loc // row_tile)
    pad = num_tiles * row_tile - n_loc
    x_pad = jnp.pad(coords_local, ((0, pad), (0, 0)))
    q_pad = jnp.pad(q_tgt, (0, pad))  # padded rows: junk phi, trimmed below
    bw = 2 * m + 1

    def body(_, carry):
        src_ps, q_src, b, acc = carry

        def tile_body(t, acc):
            x_i = jax.lax.dynamic_slice_in_dim(x_pad, t * row_tile, row_tile, 0)
            q_i = jax.lax.dynamic_slice_in_dim(q_pad, t * row_tile, row_tile, 0)
            cross = pdot(x_i, src_ps.T)  # (row_tile, n_loc)
            quad = q_i[:, None] + q_src[None, :] - cross
            if psd:
                quad = jnp.maximum(quad, 0.0)
            k_tile = jnp.exp(-quad)
            contrib = pdot(k_tile, b).astype(acc.dtype)
            prev = jax.lax.dynamic_slice_in_dim(acc, t * row_tile, row_tile, 0)
            return jax.lax.dynamic_update_slice_in_dim(
                acc, prev + contrib, t * row_tile, 0
            )

        acc = jax.lax.fori_loop(0, num_tiles, tile_body, acc)
        return (_rotate(src_ps, axis_name), _rotate(q_src, axis_name),
                _rotate(b, axis_name), acc)

    acc0 = jnp.zeros((num_tiles * row_tile, bw), coords_local.dtype)
    acc0 = jax.lax.pcast(acc0, (axis_name,), to="varying")
    _, _, _, acc = jax.lax.fori_loop(0, size, body, (src_ps0, q_src0, b0, acc0))

    acc = acc[:n_loc]
    ks = acc[:, :m]
    kx = acc[:, m : 2 * m]
    rowsum = acc[:, 2 * m]
    return (ks - pdot(kx - rowsum[:, None] * coords_local, p_sym)) / n_global


def ring_phi_rbf_terms(
    coords_local: jnp.ndarray,
    scores_local: jnp.ndarray,
    kernel_params,
    terms,
    axis_name: str,
    n_global: int,
    psd_flags=None,
    row_tile: int = 256,
) -> jnp.ndarray:
    """Gather-free phi for a composed kernel flattened to signed RBF terms.

    phi is linear in k, so each algebraic term (kernels/algebra.py) runs its
    own closed-form ring sweep and the signed results sum — T Gram-identity
    ring passes instead of one VJP-replaying generic pass per rotation.
    ``psd_flags`` as in ops/phi.phi_rbf_terms_cross."""
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
        t_phi = ring_phi_rbf(
            coords_local, scores_local, p, axis_name, n_global, psd=t_psd,
            row_tile=row_tile,
        )
        t_phi = t_phi if sign > 0 else -t_phi
        phi = t_phi if phi is None else phi + t_phi
    return phi


def ring_phi_generic(
    coords_local: jnp.ndarray,
    scores_local: jnp.ndarray,
    kernel_fn,
    kernel_params,
    axis_name: str,
    n_global: int,
    row_tile: int = 128,
) -> jnp.ndarray:
    """Gather-free phi for an arbitrary composed/user kernel.

    The (source block, score block) pair rotates around the ring; each
    rotation contributes one tile-streamed cross phi (VJP-based, see
    ops/phi.phi_generic_cross). D rotations cover every source exactly
    once. Generic kernels evaluate on absolute coordinates (explicit
    differences inside the kernel fn), so no centering is needed.
    """
    from ..ops.phi import phi_generic_cross

    n_loc, m = coords_local.shape
    size = jax.lax.axis_size(axis_name)

    def body(_, carry):
        src, sc, acc = carry
        # phi_generic_cross normalizes by its OWN source count; scale back
        # to raw sums and normalize once by n_global at the end.
        contrib = phi_generic_cross(
            coords_local, src, sc, kernel_fn, kernel_params,
            row_tile, axis_name=axis_name,
        ) * src.shape[0]
        return _rotate(src, axis_name), _rotate(sc, axis_name), acc + contrib

    acc0 = jnp.zeros((n_loc, m), coords_local.dtype)
    acc0 = jax.lax.pcast(acc0, (axis_name,), to="varying")
    _, _, acc = jax.lax.fori_loop(
        0, size, body, (coords_local, scores_local, acc0)
    )
    return acc / n_global


def ring_count_le(
    coords_local: jnp.ndarray,
    thresholds: jnp.ndarray,
    axis_name: str,
    n_global: int = None,
    row_tile: int = 256,
) -> jnp.ndarray:
    """Global pair counts (sq dist <= t per threshold) via ring rotations.

    Each device counts its local rows against every rotating column block
    (covering its disjoint row-band of the global n x n pair matrix), then a
    psum totals the bands. Coordinates are global-mean centered first (see
    ring_phi_rbf). Rows stream in ``row_tile`` bands and the T thresholds
    reduce sequentially over the shared sq tile, so the largest live
    intermediate is one (row_tile, n_loc) tile — NOT the
    (T, n_loc, n_loc) broadcast a vectorized compare would materialize.
    """
    if n_global is None:
        n_global = coords_local.shape[0] * jax.lax.axis_size(axis_name)
    center = jax.lax.psum(jnp.sum(coords_local, axis=0), axis_name) / n_global
    coords_local = coords_local - center
    q_loc = jnp.sum(coords_local * coords_local, axis=1)
    num_t = thresholds.shape[0]

    n_loc = coords_local.shape[0]
    row_tile = min(row_tile, n_loc)
    num_tiles = -(-n_loc // row_tile)
    pad = num_tiles * row_tile - n_loc
    big = float(jnp.finfo(jnp.float32).max / 4)
    x_pad = jnp.pad(coords_local, ((0, pad), (0, 0)))
    # padded rows carry q = +big -> sq explodes -> never counted
    q_pad = jnp.pad(q_loc, (0, pad), constant_values=big)

    def body(_, carry):
        cols, q_cols, acc = carry

        def tile_body(t, acc):
            x_i = jax.lax.dynamic_slice_in_dim(x_pad, t * row_tile, row_tile, 0)
            q_i = jax.lax.dynamic_slice_in_dim(q_pad, t * row_tile, row_tile, 0)
            cross = pdot(x_i, cols.T)
            sq = jnp.maximum(q_i[:, None] + q_cols[None, :] - 2.0 * cross, 0.0)
            c = jnp.stack(
                [
                    jnp.sum((sq <= thresholds[e]).astype(jnp.float32))
                    for e in range(num_t)
                ]
            )
            return acc + c

        return (
            _rotate(cols, axis_name),
            _rotate(q_cols, axis_name),
            jax.lax.fori_loop(0, num_tiles, tile_body, acc),
        )

    size = jax.lax.axis_size(axis_name)
    acc0 = jax.lax.pcast(
        jnp.zeros(num_t, jnp.float32), (axis_name,), to="varying"
    )
    _, _, local_counts = jax.lax.fori_loop(
        0, size, body, (coords_local, q_loc, acc0)
    )
    return jax.lax.psum(local_counts, axis_name)


def ring_pairwise_median(
    coords_local: jnp.ndarray,
    axis_name: str,
    n_global: int,
    *,
    bins: int = 16,
    passes: int = 6,
    row_tile: int = 256,
) -> jnp.ndarray:
    """Gather-free global median of all n^2 pairwise distances."""
    from ..ops.median import centered_count_env

    total = n_global * n_global
    # hi0 from CENTERED norms (one home for the guard: centered_count_env);
    # ring mode supplies its own count_fn (ring_count_le centers itself).
    _, hi0 = centered_count_env(
        coords_local, None, axis_name=axis_name, n_global=n_global
    )
    count_fn = lambda thr: ring_count_le(
        coords_local, thr, axis_name, n_global, row_tile=row_tile
    )
    ks = (total // 2, total // 2 + 1) if total % 2 == 0 else ((total + 1) // 2,)
    mids = kth_smallest_bisect(count_fn, ks, 0.0, hi0, bins=bins, passes=passes)
    return jnp.mean(jnp.sqrt(mids))


def ring_median_scale(coords_local, axis_name, n_global, **kwargs):
    """P = log(n)/median^2 * I with the ring median."""
    from ..kernels.gaussian_rbf import scale_from_median

    m = coords_local.shape[1]
    med = ring_pairwise_median(coords_local, axis_name, n_global, **kwargs)
    return scale_from_median(med, n_global, m, coords_local.dtype)
