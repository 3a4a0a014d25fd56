"""Pairwise distance computations (Gram-matrix identity).

Mirrors the reference's squared-distance construction
``diag + diag^T - 2 X^T X`` (reference: GaussianRBFKernel.hpp:179-183) with
the (n, m) layout: the Gram matrix ``X X^T`` is a single matmul.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

#: Precision of every f32 dot on the phi and pairwise-distance paths. On an
#: NVIDIA H100, XLA runs an f32 dot at DEFAULT or HIGH precision in TF32
#: (operands rounded to a 10-bit mantissa, ~2^-11 relative). A squared
#: distance or quadratic form built that way carries that rounding into
#: exp(-gamma * sq), where it grows by gamma * sq; the contraction dots add
#: it to phi directly. HIGHEST keeps the operands f32 (exact on the CPU
#: anyway). The dots are thin — depth m or width 2m+1 — so they are bound
#: by memory traffic, not by the f32 rate.
DOT_PRECISION = jax.lax.Precision.HIGHEST


def pdot(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """``a @ b`` at :data:`DOT_PRECISION`."""
    return jnp.matmul(a, b, precision=DOT_PRECISION)


def squared_pairwise_distances(coords: jnp.ndarray) -> jnp.ndarray:
    """All-pairs squared Euclidean distances for (n, m) coords -> (n, n).

    Uses the Gram identity ||x_i - x_j||^2 = q_i + q_j - 2 x_i.x_j
    (reference GaussianRBFKernel.hpp:179-183). Clamped at zero: the identity
    can go slightly negative in floating point, and the reference's
    subsequent sqrt of an exact-arithmetic nonnegative value must not NaN.
    """
    coords = coords - jnp.mean(coords, axis=0)  # translation-invariant;
    # centering keeps the Gram-identity cancellation at O(eps * spread^2)
    # instead of O(eps * |x|^2) for clusters far from the origin
    gram = pdot(coords, coords.T)
    sq_norms = jnp.diagonal(gram)
    sq = sq_norms[:, None] + sq_norms[None, :] - 2.0 * gram
    return jnp.maximum(sq, 0.0)


def weighted_quadratic_pairwise(
    coords: jnp.ndarray, p_matrix: jnp.ndarray, psd: bool = True
) -> jnp.ndarray:
    """All-pairs (x_i - x_j)^T P (x_i - x_j) for (n, m) coords -> (n, n).

    For symmetric-part P: q_i + q_j - x_i^T (P + P^T) x_j, one matmul
    chain. Standalone utility (the phi hot paths build their quadratic
    forms inline, tile-streamed — see ops/phi.py). ``psd=False`` disables
    the clamp-at-zero f32-noise guard: an indefinite P (Hessian scale on a
    non-log-concave model, algebraic division terms) has legitimately
    negative quadratic forms.
    """
    coords = coords - jnp.mean(coords, axis=0)  # translation-invariant
    p_sym = p_matrix + p_matrix.T
    xp = pdot(coords, p_matrix)  # (n, m)
    q = jnp.sum(xp * coords, axis=1)  # x_i^T P x_i
    cross = pdot(pdot(coords, p_sym), coords.T)
    quad = q[:, None] + q[None, :] - cross
    if psd:
        quad = jnp.maximum(quad, 0.0)
    return quad


def auto_row_tile(n_cols: int, requested: int, elem_bytes: int = 4,
                  budget_bytes: int = 1 << 28) -> int:
    """Clamp a row-tile so tile x n_cols buffers stay within ``budget_bytes``.

    The tile-streamed O(n^2) ops materialize (row_tile, n_cols) working
    tiles; at n = 1M a requested tile of 1024 would be a 4 GB buffer. The
    default 256 MB budget keeps several live tiles well inside HBM while
    keeping tiles large enough to amortise each loop step (tile >= 8 rows).
    """
    cap = max(8, budget_bytes // max(1, n_cols * elem_bytes))
    tile = max(8, min(int(requested), cap))
    return (tile // 8) * 8
