"""Kernel Stein discrepancy (KSD) — convergence diagnostic for SVGD.

The reference library offers no quality metric beyond eyeballing particle
scatters (its notebooks); production deployment needs a scalar that answers
"how close is the particle set to the target?". The (squared, V-statistic)
KSD with kernel k and score s(x) = grad log p(x) is

    KSD^2 = (1/n^2) sum_{ij} u_p(x_i, x_j)
    u_p(x, y) = s(x)^T k s(y) + s(x)^T grad_y k + grad_x k^T s(y)
                + trace(grad_x grad_y k)

For the Gaussian RBF k = exp(-(x-y)^T P (x-y)) every term is closed form:

    grad_x k = -k P_s (x - y),  grad_y k = +k P_s (x - y)
    trace(grad_x grad_y k) = k (tr(P_s) - d^T d),  d = P_s (x - y)

with P_s = P + P^T. Computed tile-streamed, so it scales like one phi pass
and never materializes the n x n matrix. Validated against a jax.grad
oracle in tests/test_ksd.py.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def ksd_squared_rbf(
    coords: jnp.ndarray,
    scores: jnp.ndarray,
    p_matrix: jnp.ndarray,
    row_tile: int = 1024,
    ustat: bool = False,
    psd: bool = True,
) -> jnp.ndarray:
    """Squared KSD for the RBF kernel, tile-streamed.

    coords (n, m); scores (n, m) = grad log p at each particle;
    p_matrix (m, m) inverse-scale. Per-pair cost is O(m^2) elementwise work (the
    Stein kernel needs the d = P_s diff vectors anyway) — a diagnostic, not
    a hot path; fine up to m ~ 100. ``ustat=True`` removes the diagonal
    u_p(x, x) = |s(x)|^2 + tr(P_s) terms (the V-statistic's positive bias,
    which does NOT vanish at the target) and normalizes by n(n-1) — use the
    U-statistic for convergence diagnostics, the V-statistic for theory
    parity.
    """
    from .pairwise import auto_row_tile

    coords = jnp.asarray(coords)
    scores = jnp.asarray(scores)
    n, m = coords.shape
    row_tile = auto_row_tile(n, row_tile)
    p_sym = p_matrix + p_matrix.T
    tr_psym = jnp.trace(p_sym)

    num_tiles = -(-n // row_tile)
    pad = num_tiles * row_tile - n
    x_pad = jnp.pad(coords, ((0, pad), (0, 0)))
    s_pad = jnp.pad(scores, ((0, pad), (0, 0)))
    row_valid = jnp.pad(jnp.ones(n, coords.dtype), (0, pad))

    def tile_body(t, acc):
        x_i = jax.lax.dynamic_slice_in_dim(x_pad, t * row_tile, row_tile, 0)
        s_i = jax.lax.dynamic_slice_in_dim(s_pad, t * row_tile, row_tile, 0)
        v_i = jax.lax.dynamic_slice_in_dim(row_valid, t * row_tile, row_tile, 0)
        # pairwise pieces for the (row_tile, n) block
        diffs = [x_i[:, a, None] - coords[None, :, a] for a in range(m)]
        quad = jnp.zeros((row_tile, n), coords.dtype)
        for a in range(m):
            for b in range(a, m):
                w = p_sym[a, b] if a != b else p_matrix[a, a]
                quad = quad + w * diffs[a] * diffs[b]
        if psd:
            quad = jnp.maximum(quad, 0.0)
        k = jnp.exp(-quad)

        # s(x_i)^T s(x_j) * k
        ss = s_i @ scores.T
        term1 = ss * k

        # d = P_s (x_i - x_j) with P_s = P + P^T (the symmetrization absorbs
        # the 2 from differentiating the quadratic): grad_y k = k d,
        # grad_x k = -k d.
        d = [
            sum(p_sym[a, b] * diffs[b] for b in range(m)) for a in range(m)
        ]  # list of (row_tile, n)
        s_i_dot_d = sum(s_i[:, a, None] * d[a] for a in range(m))
        s_j_dot_d = sum(scores[None, :, a] * d[a] for a in range(m))
        # s(x)^T grad_y k + grad_x k^T s(y) = k (s_i . d) - k (s_j . d)
        term2 = k * (s_i_dot_d - s_j_dot_d)

        # trace(grad_x grad_y k) = k (tr(P_s) - d^T d) with d = P_s diff
        dd = sum(di * di for di in d)
        term3 = k * (tr_psym - dd)

        contrib = (term1 + term2 + term3) * v_i[:, None]
        return acc + jnp.sum(contrib)

    total = jax.lax.fori_loop(0, num_tiles, tile_body, jnp.asarray(0.0, coords.dtype))
    if ustat:
        diag = jnp.sum(scores * scores) + n * tr_psym  # u_p(x_i, x_i) summed
        # float divisor: the Python int n*(n-1) exceeds int32 weak typing
        # once n > ~46k (the f64 parity lane masks this; the f32 path
        # would fail at trace time).
        return (total - diag) / (float(n) * float(n - 1))
    return total / (float(n) * float(n))


def ksd_squared_rbf_terms(
    coords: jnp.ndarray,
    scores: jnp.ndarray,
    kernel_params,
    terms,
    row_tile: int = 1024,
    ustat: bool = False,
    psd_flags=None,
) -> jnp.ndarray:
    """Squared KSD for a composed kernel flattened to signed RBF terms.

    The Stein kernel u_p is LINEAR in k (every term is k or a derivative of
    k), so the composed kernel's KSD^2 is the signed sum of each algebraic
    term's closed-form RBF KSD^2 (kernels/algebra.py flattening; effective
    P = signed sum of parameter slots). Division terms carry an indefinite
    effective P, so their quadratic-form clamp is skipped (psd=False), like
    the phi path.
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
    total = None
    for (sign, plist), t_psd in zip(terms, psd_flags):
        p = term_precision(plist, kernel_params)
        t_ksd2 = ksd_squared_rbf(
            coords, scores, p, row_tile, ustat=ustat, psd=t_psd
        )
        t_ksd2 = t_ksd2 if sign > 0 else -t_ksd2
        total = t_ksd2 if total is None else total + t_ksd2
    return total


def ksd_squared_generic(
    coords: jnp.ndarray,
    scores: jnp.ndarray,
    kernel_fn,
    params,
    row_tile: int = 256,
    ustat: bool = False,
) -> jnp.ndarray:
    """Squared KSD for an ARBITRARY kernel via autodiff (the diagnostic twin
    of the generic phi path, ops/phi.phi_generic_cross).

    ``kernel_fn(x, params, location) -> scalar`` is the Kernel-class
    contract (kernels/kernel.py:11); every Stein-kernel piece comes from AD:
    both first gradients in one reverse pass each, and the mixed-Hessian
    trace from jacfwd over the y-gradient (m forward-over-reverse passes —
    O(m) kernel evaluations per pair, so this is strictly a diagnostic).
    Tile-streamed over row blocks like the closed-form RBF path: the (n, n)
    Stein matrix never materializes. Validated against the closed-form RBF
    KSD and the composed-terms sum in tests/test_ksd.py.
    """
    from .pairwise import auto_row_tile

    coords = jnp.asarray(coords)
    scores = jnp.asarray(scores)
    n, m = coords.shape
    row_tile = auto_row_tile(n, row_tile)
    params = tuple(jnp.asarray(p) for p in params)

    def k_xy(x, y):
        return jnp.squeeze(jnp.asarray(kernel_fn(x, params, y)))

    grad_x = jax.grad(k_xy, argnums=0)
    grad_y = jax.grad(k_xy, argnums=1)

    def u_p(x, sx, y, sy):
        mixed = jax.jacfwd(lambda xx: grad_y(xx, y))(x)  # (m, m)
        return (
            (sx @ sy) * k_xy(x, y)
            + sx @ grad_y(x, y)
            + grad_x(x, y) @ sy
            + jnp.trace(mixed)
        )

    num_tiles = -(-n // row_tile)
    pad = num_tiles * row_tile - n
    x_pad = jnp.pad(coords, ((0, pad), (0, 0)))
    s_pad = jnp.pad(scores, ((0, pad), (0, 0)))
    row_valid = jnp.pad(jnp.ones(n, coords.dtype), (0, pad))

    pair_rows = jax.vmap(
        jax.vmap(u_p, in_axes=(None, None, 0, 0)), in_axes=(0, 0, None, None)
    )

    def tile_body(t, acc):
        x_i = jax.lax.dynamic_slice_in_dim(x_pad, t * row_tile, row_tile, 0)
        s_i = jax.lax.dynamic_slice_in_dim(s_pad, t * row_tile, row_tile, 0)
        v_i = jax.lax.dynamic_slice_in_dim(row_valid, t * row_tile, row_tile, 0)
        contrib = pair_rows(x_i, s_i, coords, scores)  # (row_tile, n)
        return acc + jnp.sum(contrib * v_i[:, None])

    total = jax.lax.fori_loop(
        0, num_tiles, tile_body, jnp.asarray(0.0, coords.dtype)
    )
    if ustat:
        diag = jnp.sum(jax.vmap(u_p)(coords, scores, coords, scores))
        return (total - diag) / (float(n) * float(n - 1))
    return total / (float(n) * float(n))


def ksd_rbf(model, coords, p_matrix=None, row_tile: int = 1024,
            ustat: bool = True, kernel=None):
    """Convenience: KSD of a particle set against a model's target density.

    Uses the model's score and, when ``p_matrix`` is None, the median
    bandwidth (like the SVGD run itself). Pass ``kernel=<Kernel>`` to
    evaluate the KSD under any kernel object: a `+ - * /` tree of pure RBF
    kernels uses the closed-form signed-term sum (kernels/algebra.py);
    anything else (custom kernel_fn leaves, non-flattenable trees) falls
    back to the autodiff Stein kernel (ksd_squared_generic).
    """
    from ..kernels.gaussian_rbf import median_scale

    coords = jnp.asarray(coords)
    scores = jax.vmap(
        lambda x: model.grad_log_density_pure(x, tuple(model.parameters))
    )(coords)
    if kernel is not None:
        if p_matrix is not None:
            raise ValueError(
                "ksd_rbf: pass either p_matrix or kernel, not both (the "
                "composed kernel's own parameters define its bandwidths)."
            )
        from ..kernels.algebra import flatten_rbf_terms, term_psd_flags

        terms = flatten_rbf_terms(kernel)
        if terms is None:
            ksd2 = ksd_squared_generic(
                coords, scores, kernel._kernel_fn,
                tuple(kernel.parameters), row_tile, ustat=ustat,
            )
            return jnp.sqrt(jnp.maximum(ksd2, 0.0))
        ksd2 = ksd_squared_rbf_terms(
            coords, scores, tuple(kernel.parameters), terms, row_tile,
            ustat=ustat,
            psd_flags=term_psd_flags(
                terms, kernel.adaptive_slots(), kernel.parameters
            ),
        )
        return jnp.sqrt(jnp.maximum(ksd2, 0.0))
    if p_matrix is None:
        p_matrix = median_scale(coords)
    ksd2 = ksd_squared_rbf(coords, scores, p_matrix, row_tile, ustat=ustat)
    return jnp.sqrt(jnp.maximum(ksd2, 0.0))
