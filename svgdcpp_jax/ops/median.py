"""Median / order-statistic selection for the RBF bandwidth heuristic.

The reference computes the median of all n^2 pairwise distances (INCLUDING
the n zero self-distances — reference GaussianRBFKernel.hpp:66) with an
in-place ``std::nth_element`` partial sort, averaging the two middle values
for even counts (GaussianRBFKernel.hpp:222-254).

There are two regimes:

  * exact     — full device sort of the n^2 values. Bit-parity with the
                reference semantics; fine up to n of a few thousand.
  * histogram — deterministic multi-pass histogram refinement that never
                materializes the n^2 distance matrix (tile-streamed) and
                needs no data-dependent control flow, so it jits and shards
                (psum over the counts). This is the distributed-median design
                called out in SURVEY.md §5/§7: the analog of the reference's
                nth_element for 100k+ particles.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from .pairwise import DOT_PRECISION, squared_pairwise_distances

# ----------------------------------------------------------------------
# Exact path
# ----------------------------------------------------------------------


def median_exact(values: jnp.ndarray) -> jnp.ndarray:
    """Median of a 1-D array with the reference's even/odd semantics.

    Even count: average of the two middle values
    (reference GaussianRBFKernel.hpp:224-245); odd: middle value (:246-253).
    """
    values = jnp.ravel(values)
    n = values.shape[0]
    s = jnp.sort(values)
    if n % 2 == 0:
        return 0.5 * (s[n // 2 - 1] + s[n // 2])
    return s[n // 2]


def pairwise_distance_median_exact(coords: jnp.ndarray) -> jnp.ndarray:
    """Exact median of all n^2 pairwise distances (self-zeros included)."""
    sq = squared_pairwise_distances(coords)
    return median_exact(jnp.sqrt(sq))


# ----------------------------------------------------------------------
# Histogram-refinement selection (scalable, jittable, shardable)
# ----------------------------------------------------------------------


def _count_dtype(total: int):
    """Histogram accumulator dtype.

    int64 under x64; otherwise int32 when n^2 ranks fit, else float32 (rank
    resolution ~600 out of 1e10 at n=100k — invisible to a bandwidth median,
    documented trade-off of the no-x64 f32 fast path).
    """
    if jax.config.jax_enable_x64:
        return jnp.int64
    if total < 2**31 - 1:
        return jnp.int32
    return jnp.float32


def kth_smallest_hist(hist_fn, k, lo, hi, *, bins: int = 1024, passes: int = 3,
                      count_dtype=None):
    """Approximate the k-th smallest value (1-indexed rank) by histogram
    refinement.

    ``hist_fn(lo, hi) -> (bins,) counts`` must count how many values fall in
    each of ``bins`` equal-width buckets of [lo, hi); values outside [lo, hi)
    must not be counted. For a sharded input, ``hist_fn`` psums its local
    counts — the refinement logic is then identical on every shard.

    After ``passes`` rounds the value is localized to a bucket of width
    (hi - lo) / bins**passes; the bucket midpoint is returned. With the
    defaults that is a ~1e-9 relative localization — far below what the
    bandwidth heuristic can feel.
    """
    if count_dtype is None:
        count_dtype = jnp.int64 if jax.config.jax_enable_x64 else jnp.int32
    k = jnp.asarray(k, count_dtype)
    lo = jnp.asarray(lo, jnp.float32 if not jax.config.jax_enable_x64 else jnp.float64)
    hi = jnp.asarray(hi, lo.dtype)
    for _ in range(passes):
        counts = hist_fn(lo, hi)
        cum = jnp.cumsum(counts)
        # first bucket where cumulative count reaches rank k
        b = jnp.argmax(cum >= k)
        width = (hi - lo) / bins
        below = jnp.where(b > 0, cum[b - 1], 0)
        k = k - below
        lo = lo + b.astype(lo.dtype) * width
        hi = lo + width
    return 0.5 * (lo + hi)


def cross_sq_hist(rows_coords: jnp.ndarray, cols_coords: jnp.ndarray, lo, hi, *,
                  bins: int, row_tile: int, count_dtype=jnp.int32):
    """Histogram of ||r_i - c_j||^2 over all (rows x cols) pairs in [lo, hi).

    Tile-streamed over row blocks: memory O(row_tile * n_cols), never
    O(n^2) (the ring-attention-shaped requirement from SURVEY.md §5).
    Inputs are shifted by the column mean like count_le_cross (f32
    Gram-identity cancellation guard; exact for the distances).
    """
    from .pairwise import auto_row_tile

    center = jnp.mean(cols_coords, axis=0)
    rows_coords = rows_coords - center
    cols_coords = cols_coords - center
    n_r = rows_coords.shape[0]
    n_c = cols_coords.shape[0]
    row_tile = auto_row_tile(n_c, row_tile)
    num_tiles = -(-n_r // row_tile)
    pad = num_tiles * row_tile - n_r
    padded = jnp.pad(rows_coords, ((0, pad), (0, 0)))
    row_norms_all = jnp.pad(jnp.sum(rows_coords * rows_coords, axis=1), (0, pad))
    col_norms = jnp.sum(cols_coords * cols_coords, axis=1)
    width = (hi - lo) / bins

    def body(t, hist):
        rows = jax.lax.dynamic_slice_in_dim(padded, t * row_tile, row_tile, axis=0)
        row_norms = jax.lax.dynamic_slice_in_dim(row_norms_all, t * row_tile, row_tile)
        gram = jnp.matmul(rows, cols_coords.T,
                          precision=DOT_PRECISION)  # (row_tile, n_c)
        sq = jnp.maximum(row_norms[:, None] + col_norms[None, :] - 2.0 * gram, 0.0)
        v = sq.ravel()
        # mask out padded rows
        row_ids = jax.lax.broadcasted_iota(jnp.int32, (row_tile, n_c), 0) + t * row_tile
        valid = (row_ids.ravel() < n_r) & (v >= lo) & (v < hi)
        idx = jnp.clip(jnp.floor((v - lo) / width), 0, bins - 1).astype(jnp.int32)
        return hist.at[idx].add(valid.astype(count_dtype))

    hist0 = jnp.zeros(bins, count_dtype)
    return jax.lax.fori_loop(0, num_tiles, body, hist0)


def _pairwise_sq_hist(coords: jnp.ndarray, lo, hi, *, bins: int, row_tile: int,
                      count_dtype=jnp.int32):
    """Histogram of all n^2 pairwise SQUARED distances in [lo, hi)."""
    return cross_sq_hist(
        coords, coords, lo, hi, bins=bins, row_tile=row_tile, count_dtype=count_dtype
    )


@partial(jax.jit, static_argnames=("bins", "passes", "row_tile"))
def pairwise_distance_median_histogram(
    coords: jnp.ndarray,
    *,
    bins: int = 1024,
    passes: int = 3,
    row_tile: int = 512,
) -> jnp.ndarray:
    """CPU/parity-only median of all n^2 pairwise distances.

    Uses a device scatter-add histogram; every hot path uses the
    compare/reduce bisect or warm selection instead. Kept for
    cross-validation of the selection algorithms.

    Selection runs on squared distances (monotone in distance, so order
    statistics map 1:1); the two middle order statistics are sqrt'ed and
    averaged exactly like the reference's even-count rule
    (GaussianRBFKernel.hpp:224-245).
    """
    coords = jnp.asarray(coords)
    coords = coords - jnp.mean(coords, axis=0)  # translation-invariant
    n = coords.shape[0]
    total = n * n
    cdt = _count_dtype(total)
    sq_norms = jnp.sum(coords * coords, axis=1)
    hi0 = 4.0 * jnp.max(sq_norms) * (1.0 + 1e-6) + 1e-30

    hist_fn = lambda lo, hi: _pairwise_sq_hist(
        coords, lo, hi, bins=bins, row_tile=row_tile, count_dtype=cdt
    )
    if total % 2 == 0:
        # Two independent refinements (2*passes full sweeps); fine for this
        # parity-only cross-validation path — the hot paths batch both
        # middle ranks per pass (kth_smallest_bisect).
        a = kth_smallest_hist(hist_fn, total // 2, 0.0, hi0, bins=bins,
                              passes=passes, count_dtype=cdt)
        b = kth_smallest_hist(hist_fn, total // 2 + 1, 0.0, hi0, bins=bins,
                              passes=passes, count_dtype=cdt)
        return 0.5 * (jnp.sqrt(a) + jnp.sqrt(b))
    mid = kth_smallest_hist(hist_fn, (total + 1) // 2, 0.0, hi0, bins=bins,
                            passes=passes, count_dtype=cdt)
    return jnp.sqrt(mid)


# ----------------------------------------------------------------------
# Count-bisection selection (scatter-free)
# ----------------------------------------------------------------------
#
# The selection below needs no scatter-add histogram, only compare+reduce
# elementwise work, by counting, for a vector of E thresholds, how many squared distances fall at
# or below each. The counts are GLOBAL cumulative ranks, so the target rank
# stays fixed across refinement passes (no per-interval rank rebasing).


def count_le_cross(rows_coords, cols_coords, thresholds, *, row_tile: int = 2048,
                   axis_name=None):
    """For each threshold t: count of ||r_i - c_j||^2 <= t over all pairs.

    Tile-streamed (memory O(row_tile * n_cols)); counts accumulate in f32 —
    at n=100k the ~2^-24 relative rounding is a rank slop of a few hundred
    out of 1e10, invisible to a bandwidth median.

    Both inputs are shifted by the COLUMN mean internally (distances are
    translation-invariant; the shared shift preserves them exactly): the
    Gram-identity squared distances lose ~eps * |x|^2 in f32, so an
    off-origin cluster at offset 1e4 would otherwise produce garbage counts.
    Under shard_map, pass the gathered GLOBAL set as ``cols_coords`` so the
    shift is identical on every shard.
    """
    from .pairwise import auto_row_tile

    center = jnp.mean(cols_coords, axis=0)
    rows_coords = rows_coords - center
    cols_coords = cols_coords - center
    n_r = rows_coords.shape[0]
    n_c = cols_coords.shape[0]
    row_tile = auto_row_tile(n_c, row_tile)
    num_tiles = -(-n_r // row_tile)
    pad = num_tiles * row_tile - n_r
    padded = jnp.pad(rows_coords, ((0, pad), (0, 0)))
    row_norms_all = jnp.pad(jnp.sum(rows_coords * rows_coords, axis=1), (0, pad))
    col_norms = jnp.sum(cols_coords * cols_coords, axis=1)
    n_thresh = thresholds.shape[0]

    def body(t, acc):
        rows = jax.lax.dynamic_slice_in_dim(padded, t * row_tile, row_tile, axis=0)
        row_norms = jax.lax.dynamic_slice_in_dim(row_norms_all, t * row_tile, row_tile)
        gram = jnp.matmul(rows, cols_coords.T,
                          precision=DOT_PRECISION)  # (row_tile, n_c)
        sq = jnp.maximum(row_norms[:, None] + col_norms[None, :] - 2.0 * gram, 0.0)
        row_ids = jax.lax.broadcasted_iota(jnp.int32, (row_tile, n_c), 0) + t * row_tile
        valid = row_ids < n_r
        c = jnp.sum(
            (sq[None, :, :] <= thresholds[:, None, None]) & valid[None, :, :],
            axis=(1, 2),
            dtype=jnp.float32,
        )
        return acc + c

    acc0 = jnp.zeros(n_thresh, jnp.float32)
    if axis_name is not None:
        acc0 = jax.lax.pcast(acc0, (axis_name,), to="varying")
    return jax.lax.fori_loop(0, num_tiles, body, acc0)


def kth_smallest_bisect(count_le_fn, ks, lo, hi, *, bins: int = 16,
                        passes: int = 6):
    """Localize the k-th smallest value(s) by threshold-count bisection.

    ``ks`` is a sequence of R (1-indexed) ranks selected JOINTLY: every
    refinement pass issues one flattened (R * bins,) threshold batch, so
    selecting both middle order statistics of an even count costs the same
    number of data passes as one rank.

    ``count_le_fn(thresholds (E,)) -> (E,) f32`` returns GLOBAL cumulative
    counts (values <= threshold over the whole data set; psum'ed when
    sharded) — the target rank therefore stays fixed across passes. After
    ``passes`` rounds each value sits in an interval of width
    (hi - lo) / bins**passes; midpoints are returned, shape (R,)
    (defaults: ~6e-8 relative).
    """
    mids, _, _ = kth_smallest_bisect_intervals(
        count_le_fn, ks, lo, hi, bins=bins, passes=passes
    )
    return mids


def kth_smallest_bisect_intervals(count_le_fn, ks, lo, hi, *, bins: int = 16,
                                  passes: int = 6):
    """kth_smallest_bisect also returning the final PER-RANK intervals.

    Returns (midpoints (R,), lo (R,), hi (R,)): each rank's value is
    guaranteed inside its own [lo_r, hi_r] — the seed for warm-started
    per-rank bracket tracking (each rank refines independently, so a
    distance gap between two ranks never stalls the refinement).
    """
    fdt = jnp.float64 if jax.config.jax_enable_x64 else jnp.float32
    ks = jnp.atleast_1d(jnp.asarray(ks, jnp.float32))
    r = ks.shape[0]
    lo = jnp.full((r,), lo, fdt)
    hi = jnp.full((r,), hi, fdt)
    edges = jnp.arange(1, bins + 1, dtype=fdt)
    for _ in range(passes):
        width = (hi - lo) / bins  # (R,)
        thresholds = lo[:, None] + width[:, None] * edges[None, :]  # (R, bins)
        cum = count_le_fn(thresholds.reshape(-1)).reshape(r, bins)
        b = jnp.argmax(cum >= ks[:, None], axis=1)  # first edge with rank >= k
        lo = lo + b.astype(fdt) * width
        hi = lo + width
    return 0.5 * (lo + hi), lo, hi


# ----------------------------------------------------------------------
# Two-rank bracket tracking (the median's k1 = total//2 and k2 = k1 + 1)
# ----------------------------------------------------------------------
#
# The two middle order statistics are ADJACENT ranks, yet their VALUES can
# straddle an arbitrarily wide distance gap (two equal clusters: s[k1] is
# the largest within-cluster distance, s[k2] the smallest cross-cluster
# one). A single shared bracket can therefore never shrink below the gap —
# a joint-hull refinement silently returns gap-scale-biased "medians" while
# its containment check keeps passing. Every selector below tracks ONE
# bracket PER RANK instead: overlapping brackets share uniform edges over
# their hull (the unimodal common case, cost identical to a single
# bracket); disjoint brackets spend the same edge budget refining the WIDER
# bracket (the other is kept, padded by the movement bound), so both shrink
# geometrically across steps/passes with a fixed per-pass edge count.


def two_rank_edges(lo1, hi1, lo2, hi2, num_edges: int, dtype):
    """Monotone squared-distance edge vector covering both rank brackets.

    Returns (edges (num_edges,), upd1, upd2) where upd_r says whether
    bracket r should be updated from this round's first-crossing selection:

    * overlapping brackets — uniform edges over the hull [lo1, hi2], both
      updated (the unimodal common case; identical cost to a single
      bracket);
    * disjoint, num_edges >= 7 — the edge budget splits between the two
      brackets (~half each), both updated;
    * disjoint, small budget — all refinement edges go to the WIDER
      bracket (the other keeps its current, movement-padded interval,
      whose containment the pad guarantees); the far end of the kept
      bracket still gets one edge so the global containment check
      (count(edges[0]) < k1 <= k2 <= count(edges[-1])) always holds.

    Requires num_edges >= 3.
    """
    e = num_edges
    idx = jnp.arange(e, dtype=dtype)
    hull = lo1 + (hi2 - lo1) * idx / (e - 1)
    merged = lo2 <= hi1
    if e >= 7:
        # split-both: h edges (h-1 bins) on bracket 1, the rest on bracket 2
        h = (e + 1) // 2
        e_1 = lo1 + (hi1 - lo1) * idx / (h - 1)
        e_2 = lo2 + (hi2 - lo2) * (idx - h) / (e - 1 - h)
        split_edges = jnp.where(idx < h, e_1, e_2)
        edges = jnp.where(merged, hull, split_edges)
        always = jnp.asarray(True)
        return edges, always, always
    width1 = hi1 - lo1
    width2 = hi2 - lo2
    refine1 = width1 >= width2
    # refine bracket 1: [lo1 .. hi1] uniformly, last edge at hi2
    e_a = jnp.where(idx <= e - 2, lo1 + (hi1 - lo1) * idx / (e - 2), hi2)
    # refine bracket 2: first edge at lo1, [lo2 .. hi2] uniformly
    e_b = jnp.where(idx == 0, lo1, lo2 + (hi2 - lo2) * (idx - 1) / (e - 2))
    split_edges = jnp.where(refine1, e_a, e_b)
    edges = jnp.where(merged, hull, split_edges)
    return edges, merged | refine1, merged | ~refine1


def _rank_interval(edges, cum, kf):
    """First-crossing interval (edges[i-1], edges[i]] containing rank kf.

    ``edges`` monotone, ``cum`` the cumulative counts at them. Only valid
    when cum[0] < kf <= cum[-1] (checked by the caller)."""
    i = jnp.argmax(cum >= kf)
    lo = edges[jnp.maximum(i - 1, 0)]
    return lo, edges[i]


def _select_two_ranks(edges, cum, k1f, k2f, upd1, upd2,
                      lo1, hi1, lo2, hi2):
    """Per-rank interval update from one count pass over ``edges``.

    A bracket with upd_r False keeps its current (movement-padded)
    interval — see two_rank_edges."""
    s1_lo, s1_hi = _rank_interval(edges, cum, k1f)
    s2_lo, s2_hi = _rank_interval(edges, cum, k2f)
    new1 = (jnp.where(upd1, s1_lo, lo1), jnp.where(upd1, s1_hi, hi1))
    new2 = (jnp.where(upd2, s2_lo, lo2), jnp.where(upd2, s2_hi, hi2))
    return new1[0], new1[1], new2[0], new2[1]


def _refine_two_ranks(count_fn, k1, k2, lo1, hi1, lo2, hi2, *, bins: int,
                      passes: int):
    """Localize ranks k1 <= k2 with per-rank intervals (squared space).

    Each pass issues bins + 1 thresholds built by :func:`two_rank_edges`
    and shrinks the refined bracket(s) by the available bin count — a
    distance gap between the two ranks splits the brackets instead of
    stalling the refinement (the old joint-hull scheme never shrank across
    a gap). Returns (v1, v2, valid, (lo1, hi1, lo2, hi2)) with v_r the
    final interval midpoints; ``valid`` confirms both ranks were inside
    the initial brackets.
    """
    fdt = lo1.dtype
    k1f = jnp.asarray(k1, jnp.float32)
    k2f = jnp.asarray(k2, jnp.float32)
    valid = (hi1 > lo1) & (hi2 >= lo2) & (lo2 >= lo1)
    for p in range(passes):
        edges, upd1, upd2 = two_rank_edges(
            lo1, hi1, lo2, hi2, bins + 1, fdt
        )
        cum = count_fn(edges)
        if p == 0:
            # containment: k-th values must lie inside (edges[0], edges[-1]]
            valid = valid & (cum[0] < k1f) & (cum[-1] >= k2f)
        lo1, hi1, lo2, hi2 = _select_two_ranks(
            edges, cum, k1f, k2f, upd1, upd2, lo1, hi1, lo2, hi2
        )
    v1 = 0.5 * (lo1 + hi1)
    v2 = 0.5 * (lo2 + hi2)
    return v1, v2, valid, (lo1, hi1, lo2, hi2)


@partial(jax.jit, static_argnames=("bins", "passes", "row_tile"))
def pairwise_distance_median_bisect(
    coords: jnp.ndarray,
    *,
    bins: int = 16,
    passes: int = 6,
    row_tile: int = 2048,
) -> jnp.ndarray:
    """Scalable near-exact median of all n^2 pairwise distances.

    Selection runs on squared distances (monotone, so order statistics map
    1:1); each selected order statistic is localized to bins**-passes of the
    value range (~6e-8 relative by default). Even counts select BOTH middle
    ranks jointly and average the sqrt'ed values — the reference's
    even-count rule (GaussianRBFKernel.hpp:224-245).
    """
    coords = jnp.asarray(coords)
    n = coords.shape[0]
    total = n * n
    count_fn, hi0 = centered_count_env(coords, row_tile=row_tile)
    ks = (total // 2, total // 2 + 1) if total % 2 == 0 else ((total + 1) // 2,)

    mids = kth_smallest_bisect(count_fn, ks, 0.0, hi0, bins=bins, passes=passes)
    return jnp.mean(jnp.sqrt(mids))


# ----------------------------------------------------------------------
# Hybrid sample-bracket + count-verify selection (fastest near-exact path)
# ----------------------------------------------------------------------
#
# Every full-data count pass costs ~milliseconds at n=10k (elementwise-bound), so
# the cheapest near-exact strategy minimizes full passes: a deterministic
# low-discrepancy subsample of pairs brackets the median to ~1e-3 of the
# value range almost for free, then 1-2 full count passes localize the true
# global order statistics inside the bracket. Counts VERIFY the bracket: if
# sampling error ever exceeded the margin (probability ~1e-9 at the default
# margin), a lax.cond falls back to the full-range bisection, so the result
# is never silently wrong.


def _sampled_pair_sq_dists(coords: jnp.ndarray, num_samples: int) -> jnp.ndarray:
    """Squared distances of a deterministic low-discrepancy pair subsample.

    Index pairs follow two odd golden-ratio strides mod n — cheap,
    reproducible, and shard-replicable (no RNG state). Indices are built
    host-side in uint64 at trace time (num_samples and n are static), so
    there is no 32-bit wraparound at large n.
    """
    import numpy as _np

    coords = jnp.asarray(coords)
    n = coords.shape[0]
    ks = _np.arange(num_samples, dtype=_np.uint64)
    stride_i = _np.uint64(int(n * 0.6180339887498949) | 1)
    stride_j = _np.uint64(int(n * 0.7548776662466927) | 1)
    i = jnp.asarray(((ks * stride_i) % _np.uint64(n)).astype(_np.int32))
    j = jnp.asarray(
        ((ks * stride_j + ks // _np.uint64(max(n, 1))) % _np.uint64(n)).astype(
            _np.int32
        )
    )
    diff = coords[i] - coords[j]
    return jnp.sum(diff * diff, axis=1)


def median_sq_bracket_from_sample(coords: jnp.ndarray, num_samples: int,
                                  margin_sigmas: float = 8.0):
    """[lo, hi] squared-distance bracket believed to contain the median.

    The global median's sample rank is Binomial(M, 1/2); bracketing at
    +/- margin_sigmas * sqrt(M)/2 sample ranks misses with probability
    ~erfc(margin_sigmas/sqrt(2)) (~1e-15 at 8 sigma).
    """
    sq = _sampled_pair_sq_dists(coords, num_samples)
    s = jnp.sort(sq)
    half_width = int(margin_sigmas * (num_samples ** 0.5) / 2.0) + 1
    r_lo = max(num_samples // 2 - half_width, 0)
    r_hi = min(num_samples // 2 + half_width, num_samples - 1)
    return s[r_lo], s[r_hi]


def _middle_ranks(total: int):
    """The reference's even/odd median ranks (GaussianRBFKernel.hpp:224-253):
    (total//2, total//2 + 1) averaged for even counts, the single middle
    rank twice for odd ones."""
    k1 = total // 2 if total % 2 == 0 else (total + 1) // 2
    k2 = total // 2 + 1 if total % 2 == 0 else k1
    return k1, k2


def _full_bisect_two_ranks(count_fn, total: int, hi0, *, bins: int,
                           passes: int):
    """Cold-start fallback: full-range per-rank bisection of both middle
    order statistics. Returns (median_distance, (lo1, hi1, lo2, hi2)) with
    the brackets in DISTANCE space, slack-expanded so they genuinely
    contain the order statistics (else the next warm containment check
    could fail forever once the movement pad ~ 0)."""
    k1, k2 = _middle_ranks(total)
    ks = (k1, k2) if k2 != k1 else (k1,)
    mids, lo_sq, hi_sq = kth_smallest_bisect_intervals(
        count_fn, ks, 0.0, hi0, bins=bins, passes=passes
    )
    med = jnp.mean(jnp.sqrt(mids))
    slack = hi0 / (float(bins) ** passes)
    lo_d = jnp.sqrt(jnp.maximum(lo_sq - slack, 0.0))
    hi_d = jnp.sqrt(hi_sq + slack)
    return med, (lo_d[0], hi_d[0], lo_d[-1], hi_d[-1])


def pairwise_distance_median_hybrid(
    coords: jnp.ndarray,
    *,
    num_samples: int = 1 << 16,
    bins: int = 16,
    passes: int = 2,
    row_tile: int = 2048,
    fallback_bins: int = 16,
    fallback_passes: int = 6,
) -> jnp.ndarray:
    """Near-exact scalable median: sample-bracket + count-verified refine.

    Cost: one ~2^18 sort (cheap) + ``passes`` full count passes, vs.
    ``fallback_passes`` full passes for pure bisection. Falls back to the
    full-range bisection inside a lax.cond if the bracket check fails.
    """
    coords = jnp.asarray(coords)
    n = coords.shape[0]
    total = n * n
    k1, k2 = _middle_ranks(total)

    # count_fn/hi0 guards live in centered_count_env; the pair subsample
    # shares the same centered array (translation-invariant, f32-accurate
    # off origin).
    count_fn, hi0, centered = centered_count_env(
        coords, row_tile=row_tile, return_centered=True
    )
    lo_s, hi_s = median_sq_bracket_from_sample(centered, min(num_samples, total))
    fdt = jnp.float64 if jax.config.jax_enable_x64 else jnp.float32
    lo_s = lo_s.astype(fdt)
    hi_s = jnp.maximum(hi_s.astype(fdt), lo_s * (1 + 1e-6) + 1e-30)

    v1, v2, valid, (r1l, r1h, r2l, r2h) = _refine_two_ranks(
        count_fn, k1, k2, lo_s, hi_s, lo_s, hi_s, bins=bins, passes=passes
    )
    # Resolution quality gate: when the median straddles a distance gap
    # (balanced bimodal data) the low pass count can leave one rank's
    # interval coarse — take the exact per-rank bisection instead of
    # returning a bucket-midpoint guess.
    valid = valid & ((r1h - r1l) <= 2e-3 * v1 + 1e-30)
    valid = valid & ((r2h - r2l) <= 2e-3 * v2 + 1e-30)
    fast = 0.5 * (jnp.sqrt(v1) + jnp.sqrt(v2))

    def fallback(_):
        med, _ = _full_bisect_two_ranks(
            count_fn, total, hi0, bins=fallback_bins, passes=fallback_passes
        )
        return med

    return jax.lax.cond(valid, lambda _: fast, fallback, operand=None)


# ----------------------------------------------------------------------
# Warm-started selection (temporal coherence across SVGD steps)
# ----------------------------------------------------------------------


def warm_median_select(
    count_fn,
    total: int,
    hi0,
    lo1_d,
    hi1_d,
    lo2_d,
    hi2_d,
    max_disp,
    *,
    sample_bracket_fn=None,
    bins: int = 16,
    passes: int = 2,
    warm_bins: int = 8,
    warm_passes: int = 1,
    fallback_bins: int = 16,
    fallback_passes: int = 6,
):
    """count_fn-generic warm-started median selection.

    Between consecutive steps every particle moves by at most ``max_disp``,
    so every pairwise DISTANCE — and hence every order statistic, including
    the median — changes by at most 2 * max_disp. Expanding the previous
    step's PER-RANK localization intervals by that guaranteed bound gives
    tight, deterministic brackets with no per-step pair sampling or sorting
    (one bracket per middle order statistic: a distance gap between them —
    two balanced clusters — would stall a shared bracket forever, see
    two_rank_edges); the count pass itself verifies containment, chaining
    to the sample bracket (when ``sample_bracket_fn`` is given) and then
    the full [0, hi0] bisection on (rare) failure. ``count_fn`` may psum
    over a mesh axis — the selection is then replicated on every shard.

    Returns (median_distance, lo1, hi1, lo2, hi2); brackets live in
    DISTANCE space (the movement bound is additive there). Pass empty
    brackets (hi < lo, e.g. (0, -1, 0, -1)) on the first step.
    """
    k1, k2 = _middle_ranks(total)
    fdt = jnp.float64 if jax.config.jax_enable_x64 else jnp.float32

    # Sentinel check BEFORE any arithmetic: an uninitialized bracket is
    # hi < lo in DISTANCE space; squaring a negative hi would otherwise
    # manufacture a plausible-looking [0, ~1] squared bracket that the
    # count verification can wrongly accept when the median happens to lie
    # inside it.
    bracket_initialized = (hi1_d >= lo1_d) & (hi2_d >= lo2_d)
    pad = 2.0 * max_disp + 1e-12
    lo1 = jnp.maximum(lo1_d - pad, 0.0).astype(fdt)
    hi1 = jnp.maximum(hi1_d + pad, 0.0).astype(fdt)
    lo2 = jnp.maximum(lo2_d - pad, 0.0).astype(fdt)
    hi2 = jnp.maximum(hi2_d + pad, 0.0).astype(fdt)
    # The warm brackets are only a few displacement-bounds wide, so a single
    # refinement pass already localizes to ~(bracket/bins); the cold branch
    # (sample bracket ~1e-3 of range) keeps the deeper refinement.
    v1, v2, warm_valid, (f1l, f1h, f2l, f2h) = _refine_two_ranks(
        count_fn, k1, k2, lo1 * lo1, hi1 * hi1, lo2 * lo2, hi2 * hi2,
        bins=warm_bins, passes=warm_passes,
    )
    warm_valid = warm_valid & bracket_initialized

    def full(_):
        return _full_bisect_two_ranks(
            count_fn, total, hi0, bins=fallback_bins, passes=fallback_passes
        )

    if sample_bracket_fn is not None:

        def cold(_):
            lo_s, hi_s = sample_bracket_fn()
            lo_s = lo_s.astype(fdt)
            hi_s = jnp.maximum(hi_s.astype(fdt), lo_s * (1 + 1e-6) + 1e-30)
            c_v1, c_v2, c_valid, (c1l, c1h, c2l, c2h) = _refine_two_ranks(
                count_fn, k1, k2, lo_s, hi_s, lo_s, hi_s,
                bins=bins, passes=passes,
            )
            # Same resolution gate as the hybrid one-shot: a gap-straddling
            # cold start takes the exact bisection instead of a coarse
            # bucket midpoint (the warm per-step branch is instead bounded
            # by the movement pad, so it needs no gate).
            c_valid = c_valid & ((c1h - c1l) <= 2e-3 * c_v1 + 1e-30)
            c_valid = c_valid & ((c2h - c2l) <= 2e-3 * c_v2 + 1e-30)

            def ok(_):
                med = 0.5 * (jnp.sqrt(c_v1) + jnp.sqrt(c_v2))
                return med, (
                    jnp.sqrt(jnp.maximum(c1l, 0.0)), jnp.sqrt(c1h),
                    jnp.sqrt(jnp.maximum(c2l, 0.0)), jnp.sqrt(c2h),
                )

            return jax.lax.cond(c_valid, ok, full, operand=None)

    else:
        cold = full

    def warm(_):
        med = 0.5 * (jnp.sqrt(v1) + jnp.sqrt(v2))
        return med, (
            jnp.sqrt(jnp.maximum(f1l, 0.0)), jnp.sqrt(f1h),
            jnp.sqrt(jnp.maximum(f2l, 0.0)), jnp.sqrt(f2h),
        )

    med, (b1l, b1h, b2l, b2h) = jax.lax.cond(
        warm_valid, warm, cold, operand=None
    )
    return med, b1l, b1h, b2l, b2h


def pairwise_distance_median_warm(
    coords: jnp.ndarray,
    lo1_d: jnp.ndarray,
    hi1_d: jnp.ndarray,
    lo2_d: jnp.ndarray,
    hi2_d: jnp.ndarray,
    max_disp: jnp.ndarray,
    *,
    num_samples: int = 1 << 16,
    bins: int = 16,
    passes: int = 2,
    warm_passes: int = 1,
    warm_bins: int = 8,
    row_tile: int = 2048,
):
    """Single-device warm-started pairwise-distance median (see
    :func:`warm_median_select`)."""
    coords = jnp.asarray(coords)
    n = coords.shape[0]
    total = n * n

    # count_fn/hi0 guards live in centered_count_env; the pair subsample
    # shares the same centered array (translation-invariant, f32-accurate
    # off origin).
    count_fn, hi0, centered = centered_count_env(
        coords, row_tile=row_tile, return_centered=True
    )
    sample_bracket_fn = lambda: median_sq_bracket_from_sample(
        centered, min(num_samples, total)
    )
    return warm_median_select(
        count_fn, total, hi0, lo1_d, hi1_d, lo2_d, hi2_d, max_disp,
        sample_bracket_fn=sample_bracket_fn,
        bins=bins, passes=passes, warm_bins=warm_bins, warm_passes=warm_passes,
    )


def fused_median_from_counts(
    counts,
    sel,
    total: int,
    count_fn,
    hi0,
    *,
    initialized,
    fallback_bins: int = 16,
    fallback_passes: int = 6,
):
    """Median update from the counts a fused phi sweep already produced.

    ``counts`` are cumulative pair counts at the squared-distance edges a
    :func:`fused_lag1_plan` built (``sel`` is that plan) — exactly what ONE
    warm refinement pass would have measured (see warm_median_select); this
    function is the post-processing half of that pass, split out so the
    count sweep can ride inside the phi tile loop. Verification is
    identical: if the brackets did not contain both middle order
    statistics, a full count-bisection on the current coordinates recovers
    exactly (``count_fn`` as in kth_smallest_bisect).

    Returns (median_distance, lo1, hi1, lo2, hi2) in DISTANCE space.
    """
    k1, k2 = _middle_ranks(total)
    fdt = jnp.float64 if jax.config.jax_enable_x64 else jnp.float32
    # Ranks as f32 like every other selector here (kth_smallest_bisect,
    # _refine_two_ranks): a raw Python int rank overflows int32 weak
    # typing once n^2/2 > 2^31 (n > ~65k, hit by the fused auto path).
    k1f = jnp.asarray(k1, jnp.float32)
    k2f = jnp.asarray(k2, jnp.float32)
    cum = counts
    edges = sel["edges"]
    valid = (
        jnp.asarray(initialized)
        & (edges[-1] > edges[0])
        & (cum[0] < k1f)
        & (cum[-1] >= k2f)
    )
    lo1, hi1, lo2, hi2 = _select_two_ranks(
        edges, cum, k1f, k2f, sel["upd1"], sel["upd2"],
        sel["lo1_sq"], sel["hi1_sq"], sel["lo2_sq"], sel["hi2_sq"],
    )

    def ok(_):
        med = 0.5 * (jnp.sqrt(0.5 * (lo1 + hi1)) + jnp.sqrt(0.5 * (lo2 + hi2)))
        return med.astype(fdt), (
            jnp.sqrt(jnp.maximum(lo1, 0.0)).astype(fdt),
            jnp.sqrt(hi1).astype(fdt),
            jnp.sqrt(jnp.maximum(lo2, 0.0)).astype(fdt),
            jnp.sqrt(hi2).astype(fdt),
        )

    def full(_):
        med, (b1l, b1h, b2l, b2h) = _full_bisect_two_ranks(
            count_fn, total, hi0, bins=fallback_bins, passes=fallback_passes
        )
        return med.astype(fdt), (
            b1l.astype(fdt), b1h.astype(fdt),
            b2l.astype(fdt), b2h.astype(fdt),
        )

    med, (b1l, b1h, b2l, b2h) = jax.lax.cond(valid, ok, full, operand=None)
    return med, b1l, b1h, b2l, b2h


# ----------------------------------------------------------------------
# Dispatch
# ----------------------------------------------------------------------

#: Above this particle count the exact full-sort median switches to the
#: scalable selection path: the n^2 device sort dominates whole SVGD steps
#: well before memory does.
#: Force ``median_method='exact'`` for strict reference-parity at any n.
EXACT_MEDIAN_MAX_PARTICLES = 512


def pairwise_distance_median(coords: jnp.ndarray, method: str = "auto") -> jnp.ndarray:
    """Median pairwise distance with automatic exact/hybrid dispatch.

    'warm' is accepted for one-shot calls (kernel construction, manual
    ComputeScale) and behaves like 'auto' — the warm bracket only exists
    inside the driver loop, which calls compute_scale_with_aux directly.
    """
    if method == "warm":
        method = "auto"
    n = coords.shape[0]
    if method == "exact" or (method == "auto" and n <= EXACT_MEDIAN_MAX_PARTICLES):
        return pairwise_distance_median_exact(coords)
    if method in ("hybrid", "auto"):
        return pairwise_distance_median_hybrid(coords)
    if method == "bisect":
        return pairwise_distance_median_bisect(coords)
    if method == "histogram":
        return pairwise_distance_median_histogram(coords)
    raise ValueError(f"unknown median method: {method!r}")


def fused_median_seed(coords: jnp.ndarray, method: str = "auto") -> dict:
    """{med, lo1, hi1, lo2, hi2, disp} seed for the fused phi+median sweep.

    The INITIAL positions' median (a one-time cost, honoring the owning
    kernel's ``median_method``) with tight per-rank brackets that the
    per-step movement bound then expands. Single definition shared by
    GaussianRBFKernel.init_fused_aux, the driver's fused_terms seeding and
    ShardedSVGD._init_scale_aux so the lag-1 contract cannot drift.
    """
    med = pairwise_distance_median(coords, method)
    fdt = jnp.float64 if jax.config.jax_enable_x64 else jnp.float32
    med = jnp.asarray(med, fdt)
    return {
        "med": med,
        "lo1": med * (1.0 - 1e-3),
        "hi1": med * (1.0 + 1e-3),
        "lo2": med * (1.0 - 1e-3),
        "hi2": med * (1.0 + 1e-3),
        "disp": jnp.asarray(0.0, fdt),
    }


def fused_lag1_plan(aux, n_total, fused_bins, compute_dtype):
    """Lag-1 scale + selection-edge plan for the fused phi+median sweep.

    ``aux`` carries {med, lo1, hi1, lo2, hi2, disp} — the previous step's
    verified median (this step's bandwidth, gamma = log(n)/med^2) and the
    PER-RANK distance brackets of the two middle order statistics. Each
    bracket is expanded by the movement bound (every particle moved at most
    ``disp``, so any pairwise distance changed by at most 2*disp) and the
    ``fused_bins + 1`` squared-distance selection edges are laid over them
    by :func:`two_rank_edges`. Returns ``(gamma, sel)`` where
    ``sel["edges"]`` is the threshold vector for the sweep and the rest is
    the state :func:`fused_median_from_counts` needs. Single definition
    shared by the driver step and ShardedSVGD.local_step so the
    bracket/threshold numerics cannot drift between the two.
    """
    med = aux["med"]
    fdt = med.dtype
    gamma = (jnp.log(float(n_total)) / (med * med)).astype(compute_dtype)
    pad_d = 2.0 * aux["disp"] + 1e-12
    lo1 = jnp.maximum(aux["lo1"] - pad_d, 0.0)
    hi1 = jnp.maximum(aux["hi1"] + pad_d, 0.0)
    lo2 = jnp.maximum(aux["lo2"] - pad_d, 0.0)
    hi2 = jnp.maximum(aux["hi2"] + pad_d, 0.0)
    lo1_sq, hi1_sq = lo1 * lo1, hi1 * hi1
    lo2_sq, hi2_sq = lo2 * lo2, hi2 * hi2
    edges, upd1, upd2 = two_rank_edges(
        lo1_sq, hi1_sq, lo2_sq, hi2_sq, fused_bins + 1, fdt
    )
    sel = {
        "edges": edges,
        "upd1": upd1,
        "upd2": upd2,
        "lo1_sq": lo1_sq,
        "hi1_sq": hi1_sq,
        "lo2_sq": lo2_sq,
        "hi2_sq": hi2_sq,
    }
    return gamma, sel


def centered_count_env(coords, sources_global=None, *, axis_name=None,
                       n_global=None, row_tile: int = 2048,
                       return_centered: bool = False):
    """(count_fn, hi0) for pairwise-distance selection on ``coords``.

    Single definition of two safety-critical f32 guards (see
    count_le_cross): global-mean centering of the Gram identity and the
    full-range squared-distance bound
    ``hi0 = 4 * max||x - mean||^2 * (1 + 1e-6) + 1e-30`` (computed on the
    CENTERED norms — the uncentered bound explodes for off-origin
    clusters). Shared by the driver's fused step, the sharded fused/warm
    medians and sharded_pairwise_median so the guards cannot drift.

    Single-device: ``coords`` is the full set. Sharded (``axis_name``
    given): ``coords`` is the local row shard, ``sources_global`` the
    all-gathered global set (pass None for ring mode — the returned
    count_fn is then None and the caller supplies its own, e.g.
    ring_count_le, which centers itself); counts psum over the axis and
    hi0 is pmax-stamped so downstream selection stays replication-typed.
    """
    if axis_name is None:
        centered = coords - jnp.mean(coords, axis=0)
        hi0 = (
            4.0 * jnp.max(jnp.sum(centered * centered, axis=1))
            * (1.0 + 1e-6) + 1e-30
        )
        count_fn = lambda thr: count_le_cross(
            centered, centered, thr, row_tile=row_tile
        )
        # return_centered: single-device callers that also subsample pairs
        # reuse the same centered array instead of re-centering.
        if return_centered:
            return count_fn, hi0, centered
        return count_fn, hi0
    center = jax.lax.psum(jnp.sum(coords, axis=0), axis_name) / n_global
    centered_local = coords - center
    local_max = jnp.max(jnp.sum(centered_local * centered_local, axis=1))
    hi0 = 4.0 * jax.lax.pmax(local_max, axis_name) * (1.0 + 1e-6) + 1e-30
    if sources_global is None:
        return None, hi0
    sources_centered = sources_global - center

    def count_fn(thr):
        return jax.lax.psum(
            count_le_cross(
                centered_local, sources_centered, thr,
                row_tile=row_tile, axis_name=axis_name,
            ),
            axis_name,
        )

    return count_fn, hi0
