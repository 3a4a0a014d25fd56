"""Fused phi + median-count sweep (phi_impl='fused').

One O(n^2) tile sweep per step produces both the phi contraction and the
next step's median-selection counts; the scale lags one step (within the
2*max-displacement movement bound of exact). These tests pin the op against
the separate dense/count implementations and the driver's median tracking
against the exact median.
"""

import jax.numpy as jnp
import numpy as np
import pytest

import svgdcpp_jax as sv
from svgdcpp_jax.ops.median import (
    count_le_cross,
    pairwise_distance_median_exact,
)
from svgdcpp_jax.ops.phi import phi_rbf, phi_rbf_fused_counts


@pytest.mark.parametrize("m", [2, 7])
def test_fused_op_matches_separate_passes(rng, m):
    """phi == dense closed form; counts == count_le_cross, both diff-form
    (m<=4) and Gram-form (m>4) branches."""
    n = 50
    coords = jnp.asarray(rng.normal(size=(n, m)) + 3.0)  # off-origin
    scores = jnp.asarray(rng.normal(size=(n, m)))
    gamma = 0.7
    thresholds = jnp.asarray(np.linspace(0.0, 30.0, 9))

    phi, counts = phi_rbf_fused_counts(
        coords, scores, gamma, thresholds, row_tile=16
    )
    expect_phi = phi_rbf(coords, scores, gamma * jnp.eye(m))
    np.testing.assert_allclose(np.asarray(phi), np.asarray(expect_phi), rtol=1e-9)

    # Counts vs brute force: ranks may differ by boundary-tie noise (the
    # diff-form computes exact zeros for self-pairs where the Gram identity
    # leaves ~eps residue) — a few ranks out of n^2 is invisible to the
    # verified median selection.
    c = np.asarray(coords)
    sq = ((c[:, None, :] - c[None, :, :]) ** 2).sum(-1)
    brute = np.array(
        [(sq <= t).sum() for t in np.asarray(thresholds)], dtype=np.float64
    )
    assert np.abs(np.asarray(counts) - brute).max() <= n

    centered = coords - jnp.mean(coords, axis=0)
    expect_counts = count_le_cross(centered, centered, thresholds, row_tile=16)
    assert np.abs(np.asarray(counts) - np.asarray(expect_counts)).max() <= n


def _mvn_svgd(x0, impl, iters, lr=0.1):
    n, dim = x0.shape
    model = sv.MultivariateNormal(np.zeros(dim), np.eye(dim))
    kernel = sv.GaussianRBFKernel(x0, sv.ScaleMethod.MEDIAN, model)
    svgd = sv.SVGD(
        sv.SVGDOptions(
            dimension=dim, num_iterations=iters, coordinate_matrix=x0.copy(),
            kernel=kernel, model=model, optimizer=sv.AdaGrad(dim, n, lr),
            phi_impl=impl,
        )
    )
    svgd.initialize()
    return svgd


def test_fused_first_step_median_is_exact(rng):
    """After one fused step the tracked median equals the exact median of
    the step's input positions (counts verified the seeded bracket)."""
    n, dim = 600, 2
    x0 = rng.normal(size=(n, dim)) * 2
    svgd = _mvn_svgd(x0, "fused", 1)
    svgd.run()
    med = float(svgd._scale_aux[0]["med"])
    exact = float(pairwise_distance_median_exact(jnp.asarray(x0)))
    assert abs(med - exact) < 2e-3 * exact


def test_fused_median_tracks_across_steps(rng):
    """Across a multi-step run the tracked median stays within the
    movement-bound bracket of the true median of the PREVIOUS positions."""
    n, dim, iters = 600, 2, 12
    x0 = rng.normal(size=(n, dim)) * 2
    svgd = _mvn_svgd(x0, "fused", 1)
    prev_coords = np.asarray(x0)
    for _ in range(iters):
        svgd.run()
        cur = np.asarray(svgd.store.value)
        med = float(svgd._scale_aux[0]["med"])
        # med localizes the median of the positions the sweep saw (= prev
        # run's final coords, i.e. this run's input).
        exact_prev = float(pairwise_distance_median_exact(jnp.asarray(prev_coords)))
        disp = np.sqrt(((cur - prev_coords) ** 2).sum(1)).max()
        # Steady-state bound at fused_bins=B: the bracket equilibrates at
        # width ~4*disp*B/(B-1) (refined by 1/B per pass, padded by 2*disp
        # per side between passes), so the verified median sits within
        # ~2*disp*B/(B-1) of exact (B=3: 3*disp; B=2 default: 4*disp).
        bins = svgd.options.fused_bins
        bound = 2.0 * disp * bins / (bins - 1)
        assert abs(med - exact_prev) <= bound + 2e-3 * exact_prev + 1e-9
        prev_coords = cur


def test_fused_posterior_matches_blocked(rng):
    """Lag-1 bandwidth is a heuristic-level change: posterior moments match
    the exact-every-step blocked path within MC slop."""
    n, dim, iters = 640, 2, 120
    x0 = rng.normal(size=(n, dim)) * 3 + 1.0
    fused = np.asarray(_mvn_svgd(x0, "fused", iters).run())
    blocked = np.asarray(_mvn_svgd(x0, "blocked", iters).run())
    np.testing.assert_allclose(
        fused.mean(0), blocked.mean(0), atol=5e-2
    )
    np.testing.assert_allclose(
        np.cov(fused.T), np.cov(blocked.T), atol=5e-2
    )


def test_fused_fallback_on_stale_bracket(rng):
    """A poisoned (uninitialized) bracket triggers the in-graph full
    bisection fallback and recovers the exact median."""
    n, dim = 600, 2
    x0 = rng.normal(size=(n, dim)) * 2
    svgd = _mvn_svgd(x0, "fused", 1)
    svgd.initialize = None  # guard: already initialized
    fdt = svgd._current_scale_aux(jnp.asarray(x0))[0]["med"].dtype
    svgd._scale_aux = (
        {
            "med": jnp.asarray(1.0, fdt),   # wrong but finite scale
            "lo1": jnp.asarray(0.0, fdt),
            "hi1": jnp.asarray(-1.0, fdt),  # hi < lo => uninitialized
            "lo2": jnp.asarray(0.0, fdt),
            "hi2": jnp.asarray(-1.0, fdt),
            "disp": jnp.asarray(0.0, fdt),
        },
    )
    svgd.run()
    med = float(svgd._scale_aux[0]["med"])
    exact = float(pairwise_distance_median_exact(jnp.asarray(x0)))
    assert abs(med - exact) < 1e-4 * exact


def test_auto_selects_fused_for_median_at_scale(rng):
    x0 = rng.normal(size=(1100, 2))
    svgd = _mvn_svgd(x0, "auto", 1)
    assert svgd._phi_impl == "fused"

    # CONSTANT scale cannot fuse -> blocked
    model = sv.MultivariateNormal(np.zeros(2), np.eye(2))
    kernel = sv.GaussianRBFKernel(
        x0, sv.ScaleMethod.CONSTANT, constant_scale=np.eye(2)
    )
    svgd2 = sv.SVGD(
        sv.SVGDOptions(
            dimension=2, num_iterations=1, coordinate_matrix=x0.copy(),
            kernel=kernel, model=model, optimizer=sv.AdaGrad(2, 1100, 0.1),
        )
    )
    svgd2.initialize()
    assert svgd2._phi_impl == "blocked"

    with pytest.raises(ValueError):
        svgd3 = sv.SVGD(
            sv.SVGDOptions(
                dimension=2, num_iterations=1, coordinate_matrix=x0.copy(),
                kernel=sv.GaussianRBFKernel(
                    x0, sv.ScaleMethod.CONSTANT, constant_scale=np.eye(2)
                ),
                model=model, optimizer=sv.AdaGrad(2, 1100, 0.1),
                phi_impl="fused",
            )
        )
        svgd3.initialize()


def test_fused_median_from_counts_huge_total(rng):
    """Rank comparisons must not overflow int32 weak typing when
    n^2/2 > 2^31 (n > ~65k) — the fused auto path at N=100k+ (regression:
    OverflowError at trace time). Counts are synthetic; no O(n^2) work."""
    import jax

    from svgdcpp_jax.ops.median import fused_lag1_plan, fused_median_from_counts

    n = 100_000
    total = n * n  # 10^10; k1 = 5*10^9 > int32 max
    bins = 8
    lo_sq, hi_sq = 1.0, 2.0
    fdt = jnp.float64 if jax.config.jax_enable_x64 else jnp.float32
    aux = {
        "med": jnp.asarray(np.sqrt(1.5), fdt),
        "lo1": jnp.asarray(1.0, fdt), "hi1": jnp.asarray(np.sqrt(2.0), fdt),
        "lo2": jnp.asarray(1.0, fdt), "hi2": jnp.asarray(np.sqrt(2.0), fdt),
        "disp": jnp.asarray(0.0, fdt),
    }
    _, sel = fused_lag1_plan(aux, n, bins, jnp.float32)
    # Re-pin the plan's edges to the exact [1, 2] squared bracket (the pad
    # is 1e-12-scale); monotone cumulative counts straddle k1 = 5e9 between
    # edges 4 and 5 -> both middle ranks in bucket index 4.
    sel = dict(sel)
    sel["edges"] = jnp.linspace(lo_sq, hi_sq, bins + 1).astype(sel["edges"].dtype)
    sel["lo1_sq"] = jnp.asarray(lo_sq, fdt)
    sel["hi1_sq"] = jnp.asarray(hi_sq, fdt)
    sel["lo2_sq"] = jnp.asarray(lo_sq, fdt)
    sel["hi2_sq"] = jnp.asarray(hi_sq, fdt)
    cum = jnp.asarray(
        [0.0, 1e9, 2e9, 3e9, 4e9, 6e9, 7e9, 8e9, float(total)], jnp.float32
    )
    called = []

    def count_fn(thr):
        called.append(True)
        return jnp.full(thr.shape, float(total), jnp.float32)

    med, lo1_b, hi1_b, lo2_b, hi2_b = jax.jit(
        lambda c: fused_median_from_counts(
            c, sel, total, count_fn, 10.0,
            initialized=jnp.asarray(True),
        )
    )(cum)
    width = (hi_sq - lo_sq) / bins
    expect = np.sqrt(lo_sq + 4.5 * width)  # midpoint of bucket 4
    np.testing.assert_allclose(float(med), expect, rtol=1e-6)
    assert float(lo1_b) ** 2 <= lo_sq + 4 * width + 1e-6
    assert float(hi2_b) ** 2 >= lo_sq + 5 * width - 1e-6


# ----------------------------------------------------------------------
# Fused multi-term sweep (phi_impl='fused_terms', composed isotropic RBFs)
# ----------------------------------------------------------------------


def _hier_kernel(x0, model, const_gamma=0.1, anisotropic=False):
    dim = x0.shape[1]
    p = const_gamma * np.eye(dim)
    if anisotropic:
        p = p + 0.03 * (np.ones((dim, dim)) - np.eye(dim))
    return sv.GaussianRBFKernel(
        x0, sv.ScaleMethod.MEDIAN, model
    ) + sv.GaussianRBFKernel(x0, sv.ScaleMethod.CONSTANT, constant_scale=p)


def _composed_svgd(x0, impl, iters, anisotropic=False, lr=0.1):
    n, dim = x0.shape
    model = sv.MultivariateNormal(np.zeros(dim), np.eye(dim))
    svgd = sv.SVGD(
        sv.SVGDOptions(
            dimension=dim, num_iterations=iters, coordinate_matrix=x0.copy(),
            kernel=_hier_kernel(x0, model, anisotropic=anisotropic),
            model=model, optimizer=sv.AdaGrad(dim, n, lr),
            phi_impl=impl,
        )
    )
    svgd.initialize()
    return svgd


@pytest.mark.parametrize("m", [2, 7])
def test_fused_terms_op_matches_term_sweeps(rng, m):
    """phi == signed sum of per-term closed-form sweeps; counts ==
    count_le_cross — both diff-form (m<=4) and Gram-form (m>4) branches."""
    from svgdcpp_jax.ops.phi import phi_rbf_terms, phi_rbf_terms_fused_counts

    n = 60
    coords = jnp.asarray(rng.normal(size=(n, m)) + 2.0)  # off-origin
    scores = jnp.asarray(rng.normal(size=(n, m)))
    gammas = [0.7, 0.05]
    signs = [1, -1]
    # Edges start above the f32 Gram-identity noise floor: at exactly 0.0
    # the diff-form branch counts the n exact self-zeros while the
    # Gram-form oracle's self-distances carry ~1e-6 rounding noise.
    thresholds = jnp.asarray(np.linspace(0.5, 40.0, 9))

    phi, counts = phi_rbf_terms_fused_counts(
        coords, scores, gammas, signs, thresholds, row_tile=16
    )
    # reference: two independent closed-form term sweeps with sign
    kparams = tuple(g * jnp.eye(m) for g in gammas)
    terms = [(signs[t], ((t, 1),)) for t in range(2)]
    expect = phi_rbf_terms(coords, scores, kparams, terms, row_tile=16)
    np.testing.assert_allclose(np.asarray(phi), np.asarray(expect), rtol=1e-10)
    centered = coords - jnp.mean(coords, axis=0)
    expect_counts = count_le_cross(centered, centered, thresholds, row_tile=16)
    np.testing.assert_allclose(np.asarray(counts), np.asarray(expect_counts))


def test_fused_terms_auto_selection_and_eligibility(rng):
    x0 = rng.normal(size=(1100, 2))
    assert _composed_svgd(x0, "auto", 1)._phi_impl == "fused_terms"
    # anisotropic constant slot -> shared-sq trick unavailable
    assert (
        _composed_svgd(x0, "auto", 1, anisotropic=True)._phi_impl
        == "rbf_terms"
    )
    with pytest.raises(ValueError, match="fused_terms"):
        _composed_svgd(x0, "fused_terms", 1, anisotropic=True)
    # small n: plain term sweeps (no fused machinery below dense threshold)
    assert _composed_svgd(rng.normal(size=(64, 2)), "auto", 1)._phi_impl == "rbf_terms"


def test_fused_terms_median_tracks_exact(rng):
    """The lag-1 fused median stays within the movement bound of the exact
    median of the PREVIOUS coordinates, step by step."""
    n, dim, iters = 1100, 2, 8
    x0 = rng.normal(size=(n, dim)) * 2
    svgd = _composed_svgd(x0, "fused_terms", 1)
    prev_coords = x0.copy()
    for _ in range(iters):
        svgd.options.num_iterations = 1
        cur = np.asarray(svgd.run())
        med = float(svgd._scale_aux[0]["med"])
        exact_prev = float(
            pairwise_distance_median_exact(jnp.asarray(prev_coords))
        )
        disp = np.sqrt(((cur - prev_coords) ** 2).sum(1)).max()
        # Steady-state bound at fused_bins=B: the bracket equilibrates at
        # width ~4*disp*B/(B-1) (refined by 1/B per pass, padded by 2*disp
        # per side between passes), so the verified median sits within
        # ~2*disp*B/(B-1) of exact (B=3: 3*disp; B=2 default: 4*disp).
        bins = svgd.options.fused_bins
        bound = 2.0 * disp * bins / (bins - 1)
        assert abs(med - exact_prev) <= bound + 2e-3 * exact_prev + 1e-9
        prev_coords = cur


def test_fused_terms_posterior_matches_rbf_terms(rng):
    """Lag-1 bandwidth on the composed kernel: posterior moments match the
    exact-every-step term-sweep path within MC slop."""
    n, dim, iters = 1100, 2, 120
    x0 = rng.normal(size=(n, dim)) * 3 + 1.0
    fused = np.asarray(_composed_svgd(x0, "fused_terms", iters).run())
    exact = np.asarray(_composed_svgd(x0, "rbf_terms", iters).run())
    np.testing.assert_allclose(fused.mean(0), exact.mean(0), atol=5e-2)
    np.testing.assert_allclose(np.cov(fused.T), np.cov(exact.T), atol=5e-2)


def test_fused_terms_hot_swap_validation(rng):
    """Isotropic swaps keep running; an anisotropic swap is rejected
    (the sweep reads constant slots as gamma = P[0, 0])."""
    x0 = rng.normal(size=(1100, 2))
    svgd = _composed_svgd(x0, "fused_terms", 2)
    svgd.run()
    params = [np.asarray(p) for p in svgd.kernel.parameters]
    params[1] = 0.2 * np.eye(2)
    svgd.update_kernel_parameters(params)  # isotropic: fine
    svgd.run()
    bad = [np.asarray(p) for p in svgd.kernel.parameters]
    bad[1] = np.array([[0.2, 0.1], [0.1, 0.2]])
    with pytest.raises(ValueError, match="isotropic"):
        svgd.update_kernel_parameters(bad)


def test_sharded_fused_terms_matches_driver(rng):
    """ShardedSVGDConfig(fused_phi=True) with a composed kernel == the
    single-chip driver's phi_impl='fused_terms' trajectory (same lag-1
    median semantics, same initial exact-median seed)."""
    from svgdcpp_jax.parallel import (
        ShardedSVGD,
        ShardedSVGDConfig,
        make_particle_mesh,
    )

    n, dim, iters = 32, 2, 6
    x0 = rng.normal(size=(n, dim)) * 2
    single = np.asarray(_composed_svgd(x0, "fused_terms", iters).run())

    model = sv.MultivariateNormal(np.zeros(dim), np.eye(dim))
    sharded = ShardedSVGD(
        model, sv.AdaGrad(dim, n, 0.1), num_particles=n, dimension=dim,
        mesh=make_particle_mesh(),
        kernel=_hier_kernel(x0, model),
        config=ShardedSVGDConfig(fused_phi=True, row_tile=4),
    )
    out = np.asarray(sharded.run(x0.copy(), iters))
    np.testing.assert_allclose(out, single, rtol=1e-5, atol=1e-7)


def test_sharded_fused_terms_rejects_anisotropic(rng):
    from svgdcpp_jax.parallel import (
        ShardedSVGD,
        ShardedSVGDConfig,
        make_particle_mesh,
    )

    n, dim = 16, 2
    x0 = rng.normal(size=(n, dim))
    model = sv.MultivariateNormal(np.zeros(dim), np.eye(dim))
    with pytest.raises(ValueError, match="isotropic"):
        ShardedSVGD(
            model, sv.AdaGrad(dim, n, 0.1), num_particles=n, dimension=dim,
            mesh=make_particle_mesh(),
            kernel=_hier_kernel(x0, model, anisotropic=True),
            config=ShardedSVGDConfig(fused_phi=True, row_tile=4),
        )


def test_fused_terms_seed_honors_exact_median_method(rng):
    """A composed kernel whose adaptive leaves were built with
    median_method='exact' must get the EXACT median as the lag-1 fused
    seed, not the 'auto' (hybrid-at-scale) one — regression for the seed
    drift between init_fused_aux and the driver's fused_terms branch."""
    from svgdcpp_jax.ops.median import (
        EXACT_MEDIAN_MAX_PARTICLES,
        pairwise_distance_median_exact,
        pairwise_distance_median_hybrid,
    )

    n, dim = 600, 2
    assert n > EXACT_MEDIAN_MAX_PARTICLES  # 'auto' would pick hybrid here
    x0 = rng.normal(size=(n, dim))
    exact = float(pairwise_distance_median_exact(jnp.asarray(x0)))
    hybrid = float(pairwise_distance_median_hybrid(jnp.asarray(x0)))
    assert exact != hybrid  # the drift is observable at this n

    model = sv.MultivariateNormal(np.zeros(dim), np.eye(dim))
    kernel = sv.GaussianRBFKernel(
        x0, sv.ScaleMethod.MEDIAN, model, median_method="exact"
    ) + sv.GaussianRBFKernel(
        x0, sv.ScaleMethod.CONSTANT, constant_scale=0.25 * np.eye(dim)
    )
    svgd = sv.SVGD(
        sv.SVGDOptions(
            dimension=dim, num_iterations=1, coordinate_matrix=x0.copy(),
            kernel=kernel, model=model, optimizer=sv.AdaGrad(dim, n, 0.1),
            phi_impl="fused_terms",
        )
    )
    svgd.initialize()
    seed = svgd._current_scale_aux(jnp.asarray(x0))[0]
    assert float(seed["med"]) == exact


def test_sharded_fused_pallas_validation(rng):
    """fused_pallas resolution: explicit True raises off the GPU; auto
    stays off on CPU."""
    import pytest

    import svgdcpp_jax as sv
    from svgdcpp_jax.parallel.sharded import ShardedSVGD, ShardedSVGDConfig

    n, dim = 64, 2
    x0 = rng.normal(size=(n, dim)).astype(np.float32)
    model = sv.MultivariateNormal(np.zeros(dim), np.eye(dim))

    auto = ShardedSVGD(
        model, sv.AdaGrad(dim, n, 0.1), n, dim,
        config=ShardedSVGDConfig(fused_phi=True),
    )
    assert auto._fused_pallas is False  # CPU backend -> auto off

    with pytest.raises(ValueError, match="GPU backend"):
        ShardedSVGD(
            model, sv.AdaGrad(dim, n, 0.1), n, dim,
            config=ShardedSVGDConfig(fused_phi=True, fused_pallas=True),
        )


def test_fused_pallas_without_fused_phi_rejected():
    """fused_pallas=True with fused_phi=False is a config error, not a
    silent no-op."""
    import pytest

    from svgdcpp_jax.parallel.sharded import ShardedSVGDConfig

    with pytest.raises(ValueError, match="fused_phi"):
        ShardedSVGDConfig(fused_pallas=True)

def test_mesh_pallas_validation(rng):
    """SVGDOptions.mesh + Pallas sweeps: off the GPU, 'auto' keeps the XLA
    fused sweep under a mesh while explicit Pallas impls raise with
    guidance (the kernel compiles only for a GPU; the Pallas interpreter
    is a test route); the GSPMD run still matches the no-mesh
    trajectory."""
    from svgdcpp_jax.parallel import make_particle_mesh

    n, dim, iters = 2048, 2, 2
    x0 = rng.normal(size=(n, dim))
    mesh = make_particle_mesh()

    def build(impl):
        model = sv.MultivariateNormal(np.zeros(dim), np.eye(dim))
        kernel = sv.GaussianRBFKernel(x0, sv.ScaleMethod.MEDIAN, model)
        return sv.SVGD(
            sv.SVGDOptions(
                dimension=dim, num_iterations=iters,
                coordinate_matrix=x0.copy(), kernel=kernel, model=model,
                optimizer=sv.AdaGrad(dim, n, 0.1), phi_impl=impl, mesh=mesh,
            )
        )

    svgd = build("auto")
    svgd.initialize()
    assert svgd._phi_impl == "fused"  # CPU backend: XLA sweep under the mesh

    with pytest.raises(ValueError, match="GPU kernel"):
        build("fused_pallas").initialize()
    with pytest.raises(ValueError, match="unknown phi_impl"):
        build("pallas").initialize()

    out_mesh = np.asarray(svgd.run())
    out_single = np.asarray(_mvn_svgd(x0, "auto", iters).run())
    np.testing.assert_allclose(out_mesh, out_single, rtol=1e-6, atol=1e-9)
