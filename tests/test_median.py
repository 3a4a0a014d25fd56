"""Median / bandwidth tests.

Validates the reference parity details: median over ALL n^2 pairwise
distances including the n self-zeros (GaussianRBFKernel.hpp:66), even-count
averaging (:224-245), the log(n)/median^2 scale (:187), the Hessian scale
(:199-209), and the scalable histogram selection against the exact sort.
"""

import numpy as np
import pytest

from svgdcpp_jax import GaussianRBFKernel, MultivariateNormal, ScaleMethod, UnsetError
from svgdcpp_jax.kernels.gaussian_rbf import hessian_scale, median_scale
from svgdcpp_jax.ops.median import (
    median_exact,
    pairwise_distance_median_exact,
    pairwise_distance_median_histogram,
)


def np_pairwise_median(coords):
    """NumPy oracle: reference ComputeScale median path (incl. self-zeros)."""
    n = coords.shape[0]
    d = np.sqrt(
        np.maximum(
            ((coords[:, None, :] - coords[None, :, :]) ** 2).sum(-1), 0.0
        )
    ).ravel()
    d.sort()
    total = n * n
    if total % 2 == 0:
        return 0.5 * (d[total // 2 - 1] + d[total // 2])
    return d[total // 2]


def test_median_exact_even_odd():
    np.testing.assert_allclose(float(median_exact(np.array([3.0, 1.0, 2.0]))), 2.0)
    np.testing.assert_allclose(
        float(median_exact(np.array([4.0, 1.0, 3.0, 2.0]))), 2.5
    )


@pytest.mark.parametrize("n", [4, 5, 10, 33])
def test_pairwise_median_vs_oracle(rng, n):
    coords = rng.normal(size=(n, 3))
    np.testing.assert_allclose(
        float(pairwise_distance_median_exact(coords)),
        np_pairwise_median(coords),
        rtol=1e-12,
    )


@pytest.mark.parametrize("n", [10, 100, 257])
def test_histogram_median_matches_exact(rng, n):
    coords = rng.normal(size=(n, 4))
    exact = float(pairwise_distance_median_exact(coords))
    approx = float(
        pairwise_distance_median_histogram(coords, bins=512, passes=3, row_tile=64)
    )
    assert abs(approx - exact) <= 1e-6 * max(exact, 1.0)


def test_median_scale_formula(rng):
    coords = rng.normal(size=(12, 2))
    med = np_pairwise_median(coords)
    p = np.asarray(median_scale(coords, "exact"))
    np.testing.assert_allclose(p, np.log(12) / med**2 * np.eye(2), rtol=1e-10)


def test_hessian_scale_formula(rng):
    mean = np.array([0.5, -0.5])
    cov = np.array([[1.0, 0.3], [0.3, 2.0]])
    mvn = MultivariateNormal(mean, cov)
    coords = rng.normal(size=(7, 2))
    p = np.asarray(
        hessian_scale(coords, mvn.hessian_log_density_pure, mvn.parameters)
    )
    # -hess log p = inv(cov) per particle; sum = n * inv(cov);
    # P = 1/(2 d n) * sum (reference GaussianRBFKernel.hpp:199-209)
    expected = 7 * np.linalg.inv(cov) / (2.0 * 2 * 7)
    np.testing.assert_allclose(p, expected, rtol=1e-10)


def test_rbf_kernel_initial_scale(rng):
    # The RBF kernel computes its initial bandwidth at construction
    # (reference GaussianRBFKernel.hpp:84).
    coords = rng.normal(size=(9, 2))
    k = GaussianRBFKernel(coords, ScaleMethod.MEDIAN)
    med = np_pairwise_median(coords)
    np.testing.assert_allclose(
        np.asarray(k.parameters[0]), np.log(9) / med**2 * np.eye(2), rtol=1e-10
    )


def test_rbf_kernel_value(rng):
    coords = rng.normal(size=(6, 2))
    k = GaussianRBFKernel(coords, ScaleMethod.MEDIAN)
    p = np.asarray(k.parameters[0])
    loc = rng.normal(size=2)
    x = rng.normal(size=2)
    k.update_location(loc)
    diff = x - loc
    assert np.isclose(float(k.evaluate_kernel(x)), np.exp(-diff @ p @ diff))


def test_hessian_method_requires_model(rng):
    with pytest.raises(UnsetError):
        GaussianRBFKernel(rng.normal(size=(5, 2)), ScaleMethod.HESSIAN)


def test_constant_scale(rng):
    p0 = np.array([[2.0, 0.0], [0.0, 3.0]])
    k = GaussianRBFKernel(
        rng.normal(size=(5, 2)), ScaleMethod.CONSTANT, constant_scale=p0
    )
    assert not k.adaptive
    np.testing.assert_array_equal(np.asarray(k.parameters[0]), p0)


@pytest.mark.parametrize("n", [300, 1111])
def test_hybrid_median_matches_exact(rng, n):
    from svgdcpp_jax.ops.median import pairwise_distance_median_hybrid

    coords = rng.normal(size=(n, 3))
    exact = float(pairwise_distance_median_exact(coords))
    approx = float(
        pairwise_distance_median_hybrid(
            coords, num_samples=1 << 14, passes=3, row_tile=128
        )
    )
    assert abs(approx - exact) <= 1e-4 * max(exact, 1.0)


def test_hybrid_fallback_on_bad_bracket(rng):
    """Force the bracket check to fail and confirm the bisect fallback."""
    import jax.numpy as jnp
    from svgdcpp_jax.ops.median import (
        _refine_two_ranks,
        count_le_cross,
        pairwise_distance_median_exact,
    )

    coords = rng.normal(size=(64, 2))
    count_fn = lambda thr: count_le_cross(coords, coords, thr, row_tile=16)
    # Bracket far below the true median: validity flag must be False
    lo = jnp.asarray(1e-8)
    hi = jnp.asarray(2e-8)
    _, _, valid, _ = _refine_two_ranks(
        count_fn, 64 * 64 // 2, 64 * 64 // 2 + 1,
        lo, hi, lo, hi, bins=16, passes=1,
    )
    assert not bool(valid)


def test_warm_median_tracks_moving_particles(rng):
    """Warm-started selection stays exact across simulated SVGD steps."""
    import jax.numpy as jnp
    from svgdcpp_jax.ops.median import pairwise_distance_median_warm

    n = 256
    coords = rng.normal(size=(n, 3))
    lo1, hi1 = jnp.asarray(0.0), jnp.asarray(-1.0)  # cold start
    lo2, hi2 = jnp.asarray(0.0), jnp.asarray(-1.0)
    disp = jnp.asarray(0.0)
    for step in range(5):
        med, lo1, hi1, lo2, hi2 = pairwise_distance_median_warm(
            coords, lo1, hi1, lo2, hi2, disp,
            num_samples=1 << 12, passes=2, row_tile=64,
        )
        exact = np_pairwise_median(coords)
        # Warm single-pass error bound: (bracket width + 4*disp) /
        # warm_bins (=8), with 2x safety; cold start (step 0) ~1e-4.
        width = max(float(hi2 - lo1), 0.0)
        bound = max(2e-4 * exact, (width + 4.0 * float(disp) + 1e-6) / 8 * 2)
        err = abs(float(med) - exact)
        assert err <= bound, (step, err, bound)
        # the per-rank brackets must genuinely contain the exact median
        # (median = avg of the two bracketed order statistics)
        mlo = 0.5 * (float(lo1) + float(lo2))
        mhi = 0.5 * (float(hi1) + float(hi2))
        assert mlo - 1e-9 <= exact <= mhi + 1e-9
        # move particles like an SVGD update would
        delta = 0.02 * rng.normal(size=(n, 3))
        coords = coords + delta
        disp = jnp.asarray(np.sqrt((delta**2).sum(1)).max())


def test_warm_median_fallback_when_bracket_stale(rng):
    """A wildly wrong bracket with zero claimed displacement must still
    produce the right answer (containment check -> cold path)."""
    import jax.numpy as jnp
    from svgdcpp_jax.ops.median import pairwise_distance_median_warm

    coords = rng.normal(size=(128, 2))
    med, *_ = pairwise_distance_median_warm(
        coords, jnp.asarray(95.0), jnp.asarray(100.0),
        jnp.asarray(95.0), jnp.asarray(100.0), jnp.asarray(0.0),
        num_samples=1 << 12, row_tile=64,
    )
    exact = np_pairwise_median(coords)
    assert abs(float(med) - exact) <= 2e-4 * exact


def test_auto_row_tile_clamps():
    from svgdcpp_jax.ops.pairwise import auto_row_tile

    assert auto_row_tile(10_000, 1024) == 1024  # fits the budget
    assert auto_row_tile(1_000_000, 1024) == 64  # 256MB / (1M * 4B) = 64
    assert auto_row_tile(10_000_000, 1024) == 8  # floor
    assert auto_row_tile(100, 13) == 8  # rounds to a multiple of 8


def test_warm_median_cold_start_small_scale(rng):
    """Sentinel (hi < lo) must force the cold path even when the bogus
    squared bracket would contain the median (review finding: particles
    with median < 1 were 50% off on the first warm step)."""
    import jax.numpy as jnp
    from svgdcpp_jax.ops.median import pairwise_distance_median_warm

    coords = rng.normal(size=(300, 2)) * 0.1  # median << 1
    med, lo1, hi1, lo2, hi2 = pairwise_distance_median_warm(
        coords, jnp.asarray(0.0), jnp.asarray(-1.0),
        jnp.asarray(0.0), jnp.asarray(-1.0), jnp.asarray(0.0),
        num_samples=1 << 14, row_tile=64,
    )
    exact = np_pairwise_median(coords)
    assert abs(float(med) - exact) <= 1e-3 * exact, (float(med), exact)
    # and the returned brackets contain the exact median
    mlo = 0.5 * (float(lo1) + float(lo2))
    mhi = 0.5 * (float(hi1) + float(hi2))
    assert mlo - 1e-12 <= exact <= mhi + 1e-12


class TestOffCenterF32:
    """f32 accuracy for clusters far from the origin (review finding): the
    Gram identity loses O(eps * |x|^2) absolutely; mean-centering restores
    full precision. Arrays are explicitly float32 — the x64 test config
    does not promote them."""

    def _cluster(self, rng, n=400, center=(50.0, -30.0), sigma=1e-3):
        return (np.asarray(center) + sigma * rng.normal(size=(n, 2))).astype(
            np.float32
        )

    def test_bisect_median_off_center(self, rng):
        from svgdcpp_jax.ops.median import pairwise_distance_median_bisect

        coords = self._cluster(rng)
        exact = np_pairwise_median(coords.astype(np.float64))
        approx = float(pairwise_distance_median_bisect(coords, row_tile=128))
        assert abs(approx - exact) <= 1e-3 * exact, (approx, exact)

    def test_hybrid_median_off_center(self, rng):
        from svgdcpp_jax.ops.median import pairwise_distance_median_hybrid

        coords = self._cluster(rng)
        exact = np_pairwise_median(coords.astype(np.float64))
        approx = float(
            pairwise_distance_median_hybrid(coords, num_samples=1 << 14,
                                            row_tile=128)
        )
        assert abs(approx - exact) <= 1e-3 * exact, (approx, exact)

    def test_phi_blocked_off_center_large_m(self, rng):
        """Gram-branch phi (m > 4) with centered coords matches f64."""
        from svgdcpp_jax.ops.phi import phi_rbf_blocked

        n, m = 128, 6
        coords64 = 100.0 + 1e-2 * rng.normal(size=(n, m))
        scores64 = rng.normal(size=(n, m))
        p64 = np.eye(m) * 1e4  # bandwidth matched to the tiny spread
        # f64 truth via explicit differences
        d = coords64[:, None, :] - coords64[None, :, :]
        quad = np.einsum("ijk,kl,ijl->ij", d, p64, d)
        K = np.exp(-quad)
        Psym = p64 + p64.T
        phi64 = (K @ scores64 + np.einsum("ij,ijk->ik", K, d @ Psym)) / n
        out = np.asarray(
            phi_rbf_blocked(coords64.astype(np.float32),
                            scores64.astype(np.float32),
                            p64.astype(np.float32), row_tile=32)
        )
        rel = np.abs(out - phi64).max() / np.abs(phi64).max()
        assert rel < 2e-2, rel


def test_hybrid_fallback_end_to_end(rng, monkeypatch):
    """Force a bogus sample bracket and confirm the hybrid still returns
    the correct median via its bisection fallback (review finding: the
    fallback closure was only tested via the validity flag)."""
    import jax.numpy as jnp
    import svgdcpp_jax.ops.median as med

    coords = rng.normal(size=(700, 3))
    exact = np_pairwise_median(coords)
    monkeypatch.setattr(
        med, "median_sq_bracket_from_sample",
        lambda *a, **k: (jnp.asarray(1e-12), jnp.asarray(2e-12)),
    )
    approx = float(med.pairwise_distance_median_hybrid(coords, row_tile=128))
    assert abs(approx - exact) <= 1e-4 * exact, (approx, exact)


def test_warm_full_fallback_end_to_end(rng):
    """warm_median_select with no sampler and an invalid bracket must take
    the full bisection and return a correct, containing bracket."""
    import jax.numpy as jnp
    from svgdcpp_jax.ops.median import count_le_cross, warm_median_select

    coords = rng.normal(size=(256, 2))
    centered = coords - coords.mean(0)
    count_fn = lambda thr: count_le_cross(coords, coords, thr, row_tile=64)
    hi0 = 4.0 * (centered ** 2).sum(1).max() * (1 + 1e-6)
    med, lo1, hi1, lo2, hi2 = warm_median_select(
        count_fn, 256 * 256, jnp.asarray(hi0),
        jnp.asarray(0.0), jnp.asarray(-1.0),
        jnp.asarray(0.0), jnp.asarray(-1.0), jnp.asarray(0.0),
    )
    exact = np_pairwise_median(coords)
    assert abs(float(med) - exact) <= 1e-4 * exact
    mlo = 0.5 * (float(lo1) + float(lo2))
    mhi = 0.5 * (float(hi1) + float(hi2))
    assert mlo - 1e-9 <= exact <= mhi + 1e-9


def test_count_le_cross_off_center_f32(rng):
    """count_le_cross centers internally (column mean), so counts at the
    exact median stay correct for an offset-1e4 f32 cluster — regression for
    the uncentered Gram identity destroying the sharded/warm medians."""
    import jax.numpy as jnp
    from svgdcpp_jax.ops.median import count_le_cross

    n = 400
    coords = (rng.normal(size=(n, 2)) + 1e4).astype(np.float32)
    exact = np_pairwise_median(coords.astype(np.float64))
    c = float(
        count_le_cross(
            jnp.asarray(coords), jnp.asarray(coords),
            jnp.asarray([exact * exact], jnp.float32), row_tile=128,
        )[0]
    )
    # The exact median's rank among all n^2 squared distances.
    assert abs(c - n * n / 2) <= n, c


def test_histogram_median_off_center_f32(rng):
    """The scatter-histogram (parity) median centers like every other path."""
    from svgdcpp_jax.ops.median import pairwise_distance_median_histogram

    coords = (rng.normal(size=(300, 2)) + 1e4).astype(np.float32)
    exact = np_pairwise_median(coords.astype(np.float64))
    approx = float(pairwise_distance_median_histogram(coords, row_tile=128))
    assert abs(approx - exact) <= 1e-3 * exact, (approx, exact)


def _two_clusters(rng, n_half=300, gap=10.0, sigma=0.1, m=2):
    """Balanced bimodal set: the two middle order statistics of the n^2
    pairwise distances straddle the within/cross-cluster gap (s[k1] = max
    within-cluster, s[k2] = min cross-cluster)."""
    a = sigma * rng.normal(size=(n_half, m))
    b = sigma * rng.normal(size=(n_half, m)) + np.array([gap] + [0.0] * (m - 1))
    return np.concatenate([a, b])


def test_hybrid_median_two_balanced_clusters(rng):
    """The median of two balanced clusters sits in the distance gap: a
    joint-hull refinement stalls there (8.6% bias measured before the
    per-rank fix); per-rank brackets must stay near-exact."""
    from svgdcpp_jax.ops.median import pairwise_distance_median_hybrid

    coords = _two_clusters(rng)
    exact = np_pairwise_median(coords)
    approx = float(pairwise_distance_median_hybrid(coords, row_tile=128))
    assert abs(approx - exact) <= 1e-3 * exact, (approx, exact)


def test_warm_median_tracks_two_clusters(rng):
    """Warm per-rank tracking across steps on bimodal data: each bracket
    refines inside its own cluster mode; the gap never stalls it."""
    import jax.numpy as jnp
    from svgdcpp_jax.ops.median import pairwise_distance_median_warm

    coords = _two_clusters(rng, n_half=256)
    lo1 = lo2 = jnp.asarray(0.0)
    hi1 = hi2 = jnp.asarray(-1.0)
    disp = jnp.asarray(0.0)
    errs = []
    for step in range(6):
        med, lo1, hi1, lo2, hi2 = pairwise_distance_median_warm(
            coords, lo1, hi1, lo2, hi2, disp,
            num_samples=1 << 12, passes=2, row_tile=128,
        )
        exact = np_pairwise_median(coords)
        errs.append(abs(float(med) - exact) / exact)
        mlo = 0.5 * (float(lo1) + float(lo2))
        mhi = 0.5 * (float(hi1) + float(hi2))
        assert mlo - 1e-9 <= exact <= mhi + 1e-9, (step, mlo, exact, mhi)
        delta = 0.002 * rng.normal(size=coords.shape)
        coords = coords + delta
        disp = jnp.asarray(np.sqrt((delta**2).sum(1)).max())
    # per-rank tracking holds every step at pad-scale error (the old joint
    # hull stalled at the gap width: ~8% error regardless of disp)
    assert max(errs) <= 1e-2, errs


def test_fused_median_two_clusters_driver(rng):
    """End-to-end fused sweep on a balanced two-mode GMM: the lag-1 median
    must track the exact median within the movement bound + per-rank
    resolution (the old joint hull held a permanent gap-scale bias)."""
    import svgdcpp_jax as sv
    from svgdcpp_jax.ops.median import pairwise_distance_median_exact
    import jax.numpy as jnp

    n, dim = 600, 2
    x0 = _two_clusters(rng, n_half=n // 2, gap=8.0, sigma=0.5)
    m1 = sv.MultivariateNormal(np.array([0.0, 0.0]), np.eye(dim))
    m2 = sv.MultivariateNormal(np.array([8.0, 0.0]), np.eye(dim))
    gmm = m1 + m2
    kernel = sv.GaussianRBFKernel(x0, sv.ScaleMethod.MEDIAN, gmm)
    svgd = sv.SVGD(
        sv.SVGDOptions(
            dimension=dim, num_iterations=1, coordinate_matrix=x0.copy(),
            kernel=kernel, model=gmm, optimizer=sv.AdaGrad(dim, n, 0.05),
            phi_impl="fused",
        )
    )
    svgd.initialize()
    prev = x0.copy()
    rel_errs = []
    for _ in range(10):
        cur = np.asarray(svgd.run())
        med = float(svgd._scale_aux[0]["med"])
        exact_prev = float(
            pairwise_distance_median_exact(jnp.asarray(prev))
        )
        disp = np.sqrt(((cur - prev) ** 2).sum(1)).max()
        rel_errs.append(abs(med - exact_prev) / exact_prev)
        assert abs(med - exact_prev) <= 2 * disp + 0.3 * exact_prev, rel_errs
        prev = cur
    # Steady-state error bound (holds for fused_bins >= 2; the default is
    # now 2 — see SVGDOptions.fused_bins) in refine-the-wider-bracket
    # mode): each bracket is refined every other step (2x shrink) and grows
    # by the 2*disp movement pad between refinements, so widths equilibrate
    # near 4*pad and the midpoint error near 4*disp — the same order as the
    # lag itself. The joint hull was ~9% biased forever regardless of disp.
    assert rel_errs[-1] <= (5 * disp + 1e-2 * exact_prev) / exact_prev, rel_errs


def test_hessian_scale_honors_score_override(rng):
    """HESSIAN bandwidth routes through grad_log_density_pure: a model with
    a stable closed-form score must give a finite scale even where the raw
    log(density) underflows to -inf (CLAUDE.md: all hot paths route scores
    through the override)."""
    import jax.numpy as jnp
    from svgdcpp_jax.models.model import Model

    class StableGaussian(Model):
        def __init__(self):
            # density underflows to exp(-large) = 0 far in the tail
            super().__init__(
                2, density_fn=lambda x, p: jnp.exp(-0.5 * jnp.sum(x * x))
            )

        def grad_log_density_pure(self, x, params):
            return -x  # closed form, finite everywhere

    model = StableGaussian()
    coords = np.array([[60.0, 0.0], [0.0, 60.0], [50.0, 50.0]])  # deep tail
    p = np.asarray(
        hessian_scale(coords, model.hessian_log_density_pure, model.parameters)
    )
    assert np.isfinite(p).all(), p
    # -hess log p = I per particle; P = 3*I / (2*2*3)
    np.testing.assert_allclose(p, np.eye(2) / 4.0, rtol=1e-6)
    # ... and the raw-log route really does NaN there (the bug this guards)
    import jax

    raw = np.asarray(
        hessian_scale(
            coords,
            lambda x, par: jax.hessian(model.log_density_pure)(x, par),
            model.parameters,
        )
    )
    assert not np.isfinite(raw).all()
