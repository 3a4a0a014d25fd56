"""Fused phi + median-count sweep as one Pallas kernel for the GPU (Triton).

One O(n^2) pass over (target, source) pairs produces both the RBF phi of a
signed sum of isotropic terms and the median-selection threshold counts —
the same contract as the XLA tile loop
``ops/phi.phi_rbf_terms_cross_fused_counts`` (its "twin" and the plain
reference this kernel is tested against). The twin writes (row_tile, n)
squared-distance and kernel tiles to device memory and reads them back each
tile; here a block of target rows walks the source columns with sq, K and
the count compares held in registers, so only X, S and the thresholds are
read from memory.

Layout:

* grid ``(row_blocks, col_splits)``: program (i, j) owns ``block_r`` target
  rows and a contiguous range of ``block_c``-wide source blocks, looped
  inside the program (nothing is carried between programs). The second axis
  splits the column loop so that small n still fills the card; the
  per-split partial sums are added after the kernel.
* squared distances: for m <= 4 the cancellation-free difference form
  (sum_a (x_ia - x_ja)^2, f32 FMAs); for m > 4 the Gram form
  q_i + q_j - 2 x_i.x_j with the dot at ``precision=HIGHEST`` (IEEE f32 —
  never TF32, whose ~2^-11 operand rounding exp(-gamma sq) amplifies).
* contraction: the diff form accumulates K S and sum_j w (x_i - x_j) with
  f32 FMAs (a 2m+1-wide dot is below Triton's 16-wide minimum; padded to
  16 it measured slower); the Gram form contracts K against [S | X | 1]
  with ``pl.dot(precision=HIGHEST)`` (IEEE f32).
* counts: int32 accumulators of ``sq <= threshold`` over valid pairs,
  written as per-program partials and summed outside the kernel — exact
  and deterministic, no atomics.
* padding: padded target rows and source columns are masked (no padding
  coordinate and no sign requirement on the term gammas, so division
  terms work).

Off the GPU the kernel runs only with an explicit ``interpret=True`` (the
tests' route); otherwise calling it raises.
"""

from __future__ import annotations

import functools
from typing import Sequence

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

#: Up to this dimension sq is built from explicit differences (f32-exact,
#: cancellation-free), as in the XLA twin (ops/phi.py).
DIFF_FORM_MAX_M = 4

#: Programs per card the column split aims for: two waves of an H100's 132
#: SMs, so that n ~ 1k still fills the card.
TARGET_PROGRAMS = 264

#: (block_r, block_c, num_warps) per sq form, tuned on an H100 at N=10k
#: (PERF.md): 32 x 32 for the difference form (its 2m + E elementwise
#: accumulators hold the registers), 64 x 32 for the Gram form.
DIFF_BLOCKS = (32, 32, 4)
GRAM_BLOCKS = (64, 32, 4)

_HIGHEST = jax.lax.Precision.HIGHEST


def _next_pow2(x: int) -> int:
    return 1 << max(0, int(x) - 1).bit_length()


def block_plan(n_t: int, n_s: int, m: int):
    """Static tiling of a (n_t targets) x (n_s sources) sweep.

    Returns a dict with the row/column block sizes and warps, padded
    extents, grid and the number of column blocks per split, plus the
    padded coordinate width ``mp`` (>= 16: Triton's dot needs every operand
    dimension >= 16) and the width ``w`` of the per-row output block.
    """
    diff = m <= DIFF_FORM_MAX_M
    block_r, block_c, num_warps = DIFF_BLOCKS if diff else GRAM_BLOCKS
    block_r = min(block_r, max(16, _next_pow2(n_t)))
    block_c = min(block_c, max(16, _next_pow2(n_s)))
    row_blocks = -(-n_t // block_r)
    col_blocks = -(-n_s // block_c)
    want = -(-TARGET_PROGRAMS // row_blocks)
    splits = max(1, min(col_blocks, want))
    per_split = -(-col_blocks // splits)
    splits = -(-col_blocks // per_split)  # drop empty trailing splits
    return {
        "block_r": block_r,
        "block_c": block_c,
        "num_warps": num_warps,
        "n_t_pad": row_blocks * block_r,
        "n_s_pad": col_blocks * block_c,
        "grid": (row_blocks, splits),
        "per_split": per_split,
        "col_blocks": col_blocks,
        "diff": diff,
        "mp": max(16, _next_pow2(m)),
        "w": _next_pow2(2 * m) if diff else max(16, _next_pow2(2 * m + 1)),
    }


def _combine(sq, gammas, signs):
    """(k_c, w): sum_t sign_t exp(-g_t sq) and sum_t sign_t g_t exp(-g_t sq).
    For one positive term w is None (the gamma factor is applied after the
    kernel)."""
    if len(signs) == 1 and signs[0] == 1.0:
        return jnp.exp(-gammas[0] * sq), None
    k_c = None
    w = None
    for s, g in zip(signs, gammas):
        k_t = jnp.exp(-g * sq)
        k_term = k_t if s > 0 else -k_t
        w_term = g * k_term
        k_c = k_term if k_c is None else k_c + k_term
        w = w_term if w is None else w + w_term
    return k_c, w


def _sweep_kernel(gam_ref, thr_ref, xt_ref, xs_ref, ss_ref, b_ref,
                  out_ref, cnt_ref, *, m, n_t, n_s, signs, n_thr, plan):
    """One program: ``block_r`` target rows x its share of source blocks.

    Diff form: ``xt_ref``/``xs_ref``/``ss_ref`` are transposed (m, n) so a
    dimension's coordinates load as one contiguous vector. Gram form:
    ``xt_ref`` is (n_t_pad, mp), ``xs_ref`` (mp, n_s_pad) and ``b_ref`` the
    (n_s_pad, w) contraction operand [S | X | 1 | 0...] (multi-term:
    [0 | X | 1 | 0...], with S in ``ss_ref``).

    Row sums (counts; diff form: K S and sum_j w (x_i - x_j)) accumulate
    elementwise in (block_r, block_c) registers across the column loop and
    are reduced once after it: a reduction across a block's columns costs
    shuffles, an elementwise add does not (about 2x on the d=2 sweep,
    PERF.md).
    """
    br, bc = plan["block_r"], plan["block_c"]
    i = pl.program_id(0)
    j = pl.program_id(1)
    rows = pl.ds(i * br, br)
    row_ok = i * br + jnp.arange(br, dtype=jnp.int32) < n_t
    gammas = [gam_ref[t] for t in range(len(signs))]
    thrs = [thr_ref[e] for e in range(n_thr)]
    single = len(signs) == 1 and signs[0] == 1.0
    c0 = j * plan["per_split"]
    c1 = jnp.minimum(c0 + plan["per_split"], plan["col_blocks"])

    if plan["diff"]:
        x_i = [xt_ref[a, rows] for a in range(m)]
    else:
        x_i = xt_ref[rows, :]
        q_i = jnp.sum(x_i * x_i, axis=1)

    def body(c, carry):
        acc, counts = carry
        cols = pl.ds(c * bc, bc)
        col_ok = c * bc + jnp.arange(bc, dtype=jnp.int32) < n_s
        valid = row_ok[:, None] & col_ok[None, :]
        if plan["diff"]:
            d = [x_i[a][:, None] - xs_ref[a, cols][None, :] for a in range(m)]
            sq = d[0] * d[0]
            for a in range(1, m):
                sq = sq + d[a] * d[a]
        else:
            x_j = xs_ref[:, cols]
            q_j = jnp.sum(x_j * x_j, axis=0)
            gram = pl.dot(x_i, x_j, precision=_HIGHEST)
            sq = jnp.maximum(q_i[:, None] + q_j[None, :] - 2.0 * gram, 0.0)
        k_c, w = _combine(sq, gammas, signs)
        k_c = jnp.where(col_ok[None, :], k_c, 0.0)
        w = k_c if w is None else jnp.where(col_ok[None, :], w, 0.0)
        if plan["diff"]:
            parts = [k_c * ss_ref[a, cols][None, :] for a in range(m)]
            parts += [w * d[a] for a in range(m)]
            acc = tuple(u + v for u, v in zip(acc, parts))
        elif single:
            acc = acc + pl.dot(k_c, b_ref[cols, :], precision=_HIGHEST)
        else:
            acc = (acc + pl.dot(k_c, ss_ref[cols, :], precision=_HIGHEST)
                   + pl.dot(w, b_ref[cols, :], precision=_HIGHEST))
        counts = tuple(
            cnt + (valid & (sq <= thr)).astype(jnp.int32)
            for cnt, thr in zip(counts, thrs)
        )
        return acc, counts

    if plan["diff"]:
        acc0 = tuple(jnp.zeros((br, bc), jnp.float32) for _ in range(2 * m))
    else:
        acc0 = jnp.zeros((br, plan["w"]), jnp.float32)
    cnt0 = tuple(jnp.zeros((br, bc), jnp.int32) for _ in range(n_thr))
    acc, counts = jax.lax.fori_loop(c0, c1, body, (acc0, cnt0))

    if plan["diff"]:
        lane = jnp.arange(plan["w"], dtype=jnp.int32)[None, :]
        block = jnp.zeros((br, plan["w"]), jnp.float32)
        for a, v in enumerate(acc):
            block = jnp.where(lane == a, jnp.sum(v, axis=1)[:, None], block)
        acc = block
    out_ref[j, rows, :] = acc
    lane = jnp.arange(cnt_ref.shape[-1], dtype=jnp.int32)
    total = jnp.zeros(cnt_ref.shape[-1:], jnp.int32)
    for e, cnt in enumerate(counts):
        total = jnp.where(lane == e, jnp.sum(cnt), total)
    cnt_ref[i, j, :] = total


def _pvary(x, axis):
    """pcast to varying over ``axis`` unless already varying (a pallas_call
    under shard_map's check_vma needs every operand to share one type)."""
    if axis is None or axis in getattr(jax.typeof(x), "vma", frozenset()):
        return x
    return jax.lax.pcast(x, (axis,), to="varying")


def _out_struct(shape, dtype, vma_axis):
    if vma_axis is None:
        return jax.ShapeDtypeStruct(shape, dtype)
    return jax.ShapeDtypeStruct(shape, dtype, vma=frozenset({vma_axis}))


@functools.partial(
    jax.jit,
    static_argnames=("signs", "interpret", "axis_name"),
)
def _sweep(targets, sources, source_scores, gammas, thresholds_sq, *, signs,
           interpret, axis_name):
    n_t, m = targets.shape
    n_s = sources.shape[0]
    plan = block_plan(n_t, n_s, m)
    n_thr = int(thresholds_sq.shape[0])
    single = len(signs) == 1 and signs[0] == 1.0

    center = jnp.mean(sources, axis=0)
    xt = (targets - center).astype(jnp.float32)
    xs = (sources - center).astype(jnp.float32)
    ss = source_scores.astype(jnp.float32)
    pad_t = plan["n_t_pad"] - n_t
    pad_s = plan["n_s_pad"] - n_s
    xt_p = jnp.pad(xt, ((0, pad_t), (0, 0)))
    xs_p = jnp.pad(xs, ((0, pad_s), (0, 0)))
    ss_p = jnp.pad(ss, ((0, pad_s), (0, 0)))
    if plan["diff"]:
        operands = (xt_p.T, xs_p.T, ss_p.T, jnp.zeros((1,), jnp.float32))
    else:
        mp, w = plan["mp"], plan["w"]
        ones = jnp.ones((plan["n_s_pad"], 1), jnp.float32)
        xs1 = jnp.concatenate([xs_p, ones], axis=1)
        if single:
            b = jnp.pad(jnp.concatenate([ss_p, xs1], axis=1),
                        ((0, 0), (0, w - 2 * m - 1)))
            s_op = jnp.zeros((1,), jnp.float32)
        else:
            b = jnp.pad(xs1, ((0, 0), (m, w - 2 * m - 1)))
            s_op = jnp.pad(ss_p, ((0, 0), (0, w - m)))
        operands = (
            jnp.pad(xt_p, ((0, 0), (0, mp - m))),
            jnp.pad(xs_p, ((0, 0), (0, mp - m))).T,
            s_op,
            b,
        )
    gam = jnp.stack([jnp.asarray(g, jnp.float32) for g in gammas])
    thr = thresholds_sq.astype(jnp.float32)
    args = [_pvary(v, axis_name) for v in (gam, thr, *operands)]
    g0, g1 = plan["grid"]
    kernel = functools.partial(
        _sweep_kernel, m=m, n_t=n_t, n_s=n_s, signs=signs, n_thr=n_thr,
        plan=plan,
    )
    partial_acc, partial_cnt = pl.pallas_call(
        kernel,
        grid=plan["grid"],
        out_shape=(
            _out_struct((g1, plan["n_t_pad"], plan["w"]), jnp.float32,
                        axis_name),
            _out_struct((g0, g1, _next_pow2(n_thr)), jnp.int32, axis_name),
        ),
        compiler_params=plgpu.CompilerParams(num_warps=plan["num_warps"],
                                             num_stages=2),
        interpret=interpret,
        name="svgd_fused_phi_counts",
    )(*args)

    a = jnp.sum(partial_acc, axis=0)[:n_t]
    cnt = partial_cnt[..., :n_thr].reshape(-1, n_thr)
    # int32 is exact while the pair total fits; past that sum the
    # (exact, per-program) partials in f32.
    if n_t * n_s < 2**31:
        counts = jnp.sum(cnt, axis=0).astype(jnp.float32)
    else:
        counts = jnp.sum(cnt.astype(jnp.float32), axis=0)
    scale = gam[0] if single else 1.0
    if plan["diff"]:
        phi = (a[:, :m] + 2.0 * scale * a[:, m:2 * m]) / n_s
    else:
        grad = a[:, m:2 * m] - a[:, 2 * m:2 * m + 1] * xt
        phi = (a[:, :m] - 2.0 * scale * grad) / n_s
    return phi.astype(targets.dtype), counts


def phi_rbf_terms_fused_pallas_cross(
    targets: jnp.ndarray,
    sources: jnp.ndarray,
    source_scores: jnp.ndarray,
    gammas: Sequence,
    signs: Sequence,
    thresholds_sq: jnp.ndarray,
    *,
    axis_name=None,
    interpret: bool = False,
):
    """Fused sweep, cross form: ``targets`` rows against ``sources``.

    Same contract as ``ops/phi.phi_rbf_terms_cross_fused_counts``: returns
    (phi (n_t, m) normalized by n_src, counts (E,) f32) where the counts are
    this row band's pairs with ``sq <= thresholds_sq[e]``. ``axis_name``
    types the outputs device-varying when called inside shard_map (psum the
    counts over it). Runs compiled on a GPU backend; anywhere else only
    with ``interpret=True``.
    """
    if not interpret and jax.default_backend() != "gpu":
        raise ValueError(
            "the fused Pallas sweep compiles only for a GPU backend (found "
            f"{jax.default_backend()!r}); use the XLA sweep "
            "(phi_impl='fused'/'fused_terms') or pass interpret=True."
        )
    signs = tuple(1.0 if float(s) > 0 else -1.0 for s in signs)
    if len(signs) != len(gammas):
        raise ValueError(f"{len(gammas)} gammas for {len(signs)} signs")
    return _sweep(
        targets, sources, source_scores, tuple(gammas),
        jnp.asarray(thresholds_sq), signs=signs, interpret=bool(interpret),
        axis_name=axis_name,
    )


def phi_rbf_terms_fused_pallas(coords, scores, gammas, signs, thresholds_sq,
                               **kwargs):
    """Single-set multi-term fused sweep (see the cross form)."""
    return phi_rbf_terms_fused_pallas_cross(
        coords, coords, scores, gammas, signs, thresholds_sq, **kwargs
    )
