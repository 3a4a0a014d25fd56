"""Driver execution-path tests: eager hook fallback, pallas phi_impl,
RMSProp end-to-end, ctor overloads."""

import jax.numpy as jnp
import numpy as np
import pytest

import svgdcpp_jax as sv


def build(x0, model, kernel, opt, **extra):
    n, dim = x0.shape
    return sv.SVGD(
        sv.SVGDOptions(
            dimension=dim, num_iterations=5, coordinate_matrix=x0.copy(),
            kernel=kernel, model=model, optimizer=opt, **extra,
        )
    )


def mvn_parts(rng, n=10, dim=2):
    model = sv.MultivariateNormal(np.zeros(dim), np.eye(dim))
    x0 = rng.normal(size=(n, dim))
    kernel = sv.GaussianRBFKernel(x0, sv.ScaleMethod.MEDIAN, model)
    return x0, model, kernel


class CountingModel(sv.MultivariateNormal):
    """Model with a custom per-step hook — forces the eager path."""

    def __init__(self, *a):
        super().__init__(*a)
        self.hook_calls = 0

    def step(self):
        self.hook_calls += 1


def test_custom_model_hook_runs_eagerly(rng):
    dim, n = 2, 10
    model = CountingModel(np.zeros(dim), np.eye(dim))
    x0 = rng.normal(size=(n, dim))
    kernel = sv.GaussianRBFKernel(x0, sv.ScaleMethod.MEDIAN, model)
    svgd = build(x0, model, kernel, sv.AdaGrad(dim, n, 0.1))
    svgd.initialize()
    assert svgd._has_custom_hooks()
    svgd.run()
    assert model.hook_calls == 5  # hook fired once per iteration

    # A no-op hook must not change the trajectory vs the scan path
    x0b = x0.copy()
    model2 = sv.MultivariateNormal(np.zeros(dim), np.eye(dim))
    kernel2 = sv.GaussianRBFKernel(x0b, sv.ScaleMethod.MEDIAN, model2)
    svgd2 = build(x0b, model2, kernel2, sv.AdaGrad(dim, n, 0.1))
    svgd2.initialize()
    assert not svgd2._has_custom_hooks()
    np.testing.assert_allclose(
        np.asarray(svgd.store.value), np.asarray(svgd2.run()), rtol=1e-12
    )


@pytest.mark.parametrize("impl", ["fused_pallas", "fused_terms_pallas"])
def test_explicit_pallas_impl_raises_off_gpu(rng, impl):
    """An explicit Pallas impl off the GPU raises instead of silently
    running the Pallas interpreter."""
    x0, model, kernel = mvn_parts(rng, n=24)
    if impl == "fused_terms_pallas":
        kernel = kernel + sv.GaussianRBFKernel(
            x0, sv.ScaleMethod.CONSTANT, constant_scale=0.5 * np.eye(2)
        )
    drv = build(x0, model, kernel, sv.AdaGrad(2, 24, 0.1), phi_impl=impl)
    with pytest.raises(ValueError, match="GPU kernel"):
        drv.initialize()


@pytest.mark.parametrize(
    "impl", ["pallas", "fused_aniso_terms_pallas", "triton", ""]
)
def test_unknown_phi_impl_raises(rng, impl):
    x0, model, kernel = mvn_parts(rng, n=24)
    drv = build(x0, model, kernel, sv.AdaGrad(2, 24, 0.1), phi_impl=impl)
    with pytest.raises(ValueError, match="unknown phi_impl"):
        drv.initialize()


def test_rmsprop_end_to_end(rng):
    x0, model, kernel = mvn_parts(rng)
    svgd = build(x0, model, kernel, sv.RMSProp(2, 10, 0.1, 0.9))
    svgd.initialize()
    out = np.asarray(svgd.run())
    assert np.isfinite(out).all()
    assert not np.allclose(out, x0)


def test_positional_ctor_overload(rng):
    """Reference-style positional ctor (SVGD.hpp:118-134)."""
    x0, model, kernel = mvn_parts(rng)
    svgd = sv.SVGD(2, 5, x0.copy(), kernel, model, sv.AdaGrad(2, 10, 0.1))
    svgd.Initialize()
    out = np.asarray(svgd.Run())
    assert out.shape == x0.shape


def test_scalar_bound_broadcast(rng):
    """Scalar (1-element) bounds broadcast to all dims (SVGD.hpp:193-216)."""
    x0, model, kernel = mvn_parts(rng)
    svgd = build(
        x0 * 10, model, kernel, sv.AdaGrad(2, 10, 0.1),
        lower_bound=-1.5, upper_bound=1.5,
    )
    svgd.initialize()
    out = np.asarray(svgd.run())
    assert np.abs(out).max() <= 1.5 + 1e-12


def test_bad_bound_dimension_raises(rng):
    x0, model, kernel = mvn_parts(rng)
    with pytest.raises(sv.DimensionMismatchError):
        build(x0, model, kernel, sv.AdaGrad(2, 10, 0.1),
              lower_bound=np.zeros(3))


def test_bounds_with_f32_coords_under_x64(rng):
    """f64 bounds must not promote an f32 scan carry (review finding)."""
    dim, n = 2, 8
    model = sv.MultivariateNormal(np.zeros(dim, np.float32), np.eye(dim, dtype=np.float32))
    x0 = rng.normal(size=(n, dim)).astype(np.float32) * 5
    kernel = sv.GaussianRBFKernel(x0, sv.ScaleMethod.MEDIAN, model)
    svgd = build(
        x0, model, kernel, sv.AdaGrad(dim, n, 0.1),
        lower_bound=np.array([-1.0, -1.0]), upper_bound=np.array([1.0, 1.0]),
    )
    svgd.initialize()
    out = np.asarray(svgd.run())
    assert out.dtype == np.float32
    assert np.abs(out).max() <= 1.0


def test_eager_hooks_with_debug_logging(tmp_path, rng):
    """Custom hooks + log_intermediate_matrices writes the log (review finding)."""
    dim, n = 2, 6

    class Hooked(sv.MultivariateNormal):
        def step(self):
            pass

    model = Hooked(np.zeros(dim), np.eye(dim))
    x0 = rng.normal(size=(n, dim))
    kernel = sv.GaussianRBFKernel(x0, sv.ScaleMethod.MEDIAN, model)
    path = str(tmp_path / "hooklog.txt")
    svgd = build(
        x0, model, kernel, sv.AdaGrad(dim, n, 0.1),
        log_intermediate_matrices=True,
        intermediate_matrices_output_path=path,
    )
    svgd.initialize()
    assert svgd._has_custom_hooks()
    svgd.run()
    text = open(path).read()
    assert text.count("========== Step") == 5


def test_warm_median_method_accepted_at_construction(rng):
    """median_method='warm' must not crash the ctor (review finding)."""
    x0 = rng.normal(size=(16, 2))
    k = sv.GaussianRBFKernel(x0, sv.ScaleMethod.MEDIAN, median_method="warm")
    assert np.isfinite(np.asarray(k.parameters[0])).all()


def test_initialize_distributed_single_process_noop():
    """Single-process call is a no-op returning devices (review finding)."""
    from svgdcpp_jax.parallel import initialize_distributed

    devices = initialize_distributed()
    assert len(devices) >= 1


def test_annealing_schedule(rng):
    """Annealed SVGD: tau=1 schedule matches no annealing; a ramp differs
    but still converges; iteration counter persists across runs."""
    import jax.numpy as jnp

    dim, n, iters = 2, 12, 30
    x0 = rng.normal(size=(n, dim)) * 2

    def run(annealing):
        model = sv.MultivariateNormal(np.zeros(dim), np.eye(dim))
        kernel = sv.GaussianRBFKernel(x0, sv.ScaleMethod.MEDIAN, model)
        svgd = sv.SVGD(
            sv.SVGDOptions(dimension=dim, num_iterations=iters,
                           coordinate_matrix=x0.copy(), kernel=kernel,
                           model=model, optimizer=sv.AdaGrad(dim, n, 0.1),
                           annealing=annealing)
        )
        svgd.initialize()
        return np.asarray(svgd.run()), svgd

    plain, _ = run(None)
    ones, _ = run(np.ones(iters))
    np.testing.assert_allclose(plain, ones, rtol=1e-12)

    ramp, svgd_r = run(np.linspace(0.1, 1.0, iters))
    assert not np.allclose(ramp, plain)
    assert svgd_r._iteration == iters
    # callable schedule form
    ramp2, _ = run(lambda it: 0.1 + 0.9 * it / (iters - 1))
    np.testing.assert_allclose(ramp2, ramp, rtol=1e-9)


def test_camelcase_step_hook_is_honored(rng):
    """A subclass overriding the CamelCase Step (the advertised porting
    surface) must be detected and invoked (review finding)."""
    dim, n = 2, 8

    class CamelModel(sv.MultivariateNormal):
        calls = 0

        def Step(self):
            type(self).calls += 1

    model = CamelModel(np.zeros(dim), np.eye(dim))
    x0 = rng.normal(size=(n, dim))
    kernel = sv.GaussianRBFKernel(x0, sv.ScaleMethod.MEDIAN, model)
    svgd = build(x0, model, kernel, sv.AdaGrad(dim, n, 0.1))
    svgd.initialize()
    assert svgd._has_custom_hooks()
    svgd.run()
    assert CamelModel.calls == 5


def test_too_many_positional_args_raises(rng):
    x0, model, kernel = mvn_parts(rng)
    with pytest.raises(TypeError):
        sv.SVGD(2, 5, x0, kernel, model, sv.AdaGrad(2, 10, 0.1),
                None, None, True, False, "log.txt", "EXTRA")


def test_track_stats(rng):
    """track_stats records per-step phi RMS / step size / bandwidth."""
    x0, model, kernel = mvn_parts(rng, n=20)
    svgd = build(x0 * 3, model, kernel, sv.AdaGrad(2, 20, 0.1),
                 track_stats=True)
    svgd.initialize()
    svgd.run()
    stats = svgd.stats
    assert set(stats) == {"phi_rms", "step_max", "bandwidth"}
    assert all(np.asarray(v).shape == (5,) for v in stats.values())
    assert (np.asarray(stats["bandwidth"]) > 0).all()
    assert (np.asarray(stats["step_max"]) > 0).all()


def test_track_stats_with_custom_hooks(rng):
    """track_stats must survive the eager hook path (advisor finding)."""
    dim, n = 2, 10
    model = CountingModel(np.zeros(dim), np.eye(dim))
    x0 = rng.normal(size=(n, dim))
    kernel = sv.GaussianRBFKernel(x0, sv.ScaleMethod.MEDIAN, model)
    svgd = build(x0, model, kernel, sv.AdaGrad(dim, n, 0.1),
                 track_stats=True)
    svgd.initialize()
    assert svgd._has_custom_hooks()
    svgd.run()
    stats = svgd.stats
    assert set(stats) == {"phi_rms", "step_max", "bandwidth"}
    assert all(np.asarray(v).shape == (5,) for v in stats.values())
    assert model.hook_calls == 5


def test_track_stats_parameterless_kernel(rng):
    """A custom kernel with no (m, m) slot yields NaN bandwidth, not a
    trace-time IndexError (advisor finding)."""
    dim, n = 2, 8
    model = sv.MultivariateNormal(np.zeros(dim), np.eye(dim))
    x0 = rng.normal(size=(n, dim))
    kernel = sv.Kernel(
        dimension=dim,
        kernel_fn=lambda x, params, loc: jnp.exp(-jnp.sum((x - loc) ** 2)),
        parameters=(),
    )
    svgd = build(x0, model, kernel, sv.AdaGrad(dim, n, 0.1),
                 track_stats=True)
    svgd.initialize()
    svgd.run()
    stats = svgd.stats
    assert np.isnan(np.asarray(stats["bandwidth"])).all()
    assert (np.asarray(stats["phi_rms"]) > 0).all()


def test_foreign_model_hessian_slot_hot_swap(rng):
    """A composed kernel's Hessian slot targeting a SECOND model must see
    that model's updated parameters without a driver rebuild (the reference
    lets any kernel hold any model and re-derives the scale each Step,
    GaussianRBFKernel.hpp:52,141-156 + SVGD.hpp:304-332)."""
    dim, n = 2, 12
    model1 = sv.MultivariateNormal(np.zeros(dim), np.eye(dim))
    cov2 = np.array([[2.0, 0.0], [0.0, 2.0]])
    model2 = sv.MultivariateNormal(np.ones(dim), cov2)
    x0 = rng.normal(size=(n, dim))
    kernel = sv.GaussianRBFKernel(
        x0, sv.ScaleMethod.MEDIAN, model1
    ) + sv.GaussianRBFKernel(x0, sv.ScaleMethod.HESSIAN, model2)
    svgd = build(x0, model1, kernel, sv.AdaGrad(dim, n, 0.1))
    svgd.initialize()
    svgd.run()
    # For an MVN, hessian log p = -cov_inv everywhere, so the Hessian-slot
    # scale is cov_inv / (2 d) independent of the particle positions.
    expect1 = np.linalg.inv(cov2) / (2 * dim)
    np.testing.assert_allclose(
        np.asarray(svgd.kernel.parameters[1]), expect1, rtol=1e-6
    )
    # Hot-swap model2's covariance; the next run must pick it up.
    cov2b = np.array([[0.5, 0.1], [0.1, 0.5]])
    model2.update_parameters((np.ones(dim), cov2b))
    svgd.run()
    expect2 = np.linalg.inv(cov2b) / (2 * dim)
    np.testing.assert_allclose(
        np.asarray(svgd.kernel.parameters[1]), expect2, rtol=1e-6
    )


def test_update_kernel_parameters_before_initialize(rng):
    """The reference allows hot-swap any time after construction
    (SVGD.hpp:304-332); pre-init swap must not crash on missing impl flags."""
    n, dim = 16, 2
    x0 = rng.normal(size=(n, dim))
    model = sv.MultivariateNormal(np.zeros(dim), np.eye(dim))
    kernel = sv.GaussianRBFKernel(
        x0, sv.ScaleMethod.CONSTANT, constant_scale=np.eye(dim)
    )
    svgd = sv.SVGD(
        sv.SVGDOptions(
            dimension=dim, num_iterations=2, coordinate_matrix=x0,
            kernel=kernel, model=model, optimizer=sv.AdaGrad(dim, n, 0.1),
        )
    )
    svgd.update_kernel_parameters((2.0 * np.eye(dim),))  # pre-init
    svgd.initialize()
    out = np.asarray(svgd.run())
    assert np.isfinite(out).all()
    np.testing.assert_allclose(np.asarray(kernel.parameters[0]), 2.0 * np.eye(dim))


def test_reinitialize_resets_annealing_and_brackets(rng):
    """initialize() is the full-reset lifecycle (reference SVGD.hpp:268-296):
    a second initialize() must restart the annealing schedule and drop the
    previous run's warm median brackets."""
    n, dim = 600, 2  # > exact threshold so the fused/warm aux is real
    x0 = rng.normal(size=(n, dim))
    model = sv.MultivariateNormal(np.zeros(dim), np.eye(dim))
    kernel = sv.GaussianRBFKernel(x0, sv.ScaleMethod.MEDIAN, model)
    svgd = sv.SVGD(
        sv.SVGDOptions(
            dimension=dim, num_iterations=3, coordinate_matrix=x0.copy(),
            kernel=kernel, model=model, optimizer=sv.AdaGrad(dim, n, 0.1),
            annealing=np.linspace(0.1, 1.0, 3),
        )
    )
    svgd.initialize()
    svgd.run()
    assert svgd._iteration == 3
    svgd.initialize()
    assert svgd._iteration == 0
    assert svgd._scale_aux is None


def test_ctor_duplicate_positional_keyword_raises(rng):
    x0 = rng.normal(size=(8, 2))
    model = sv.MultivariateNormal(np.zeros(2), np.eye(2))
    kernel = sv.GaussianRBFKernel(x0, sv.ScaleMethod.MEDIAN, model)
    with pytest.raises(TypeError, match="multiple values"):
        sv.SVGD(
            2, 5, x0, kernel, model, sv.AdaGrad(2, 8, 0.1),
            np.full(2, -1.0),  # positional lower_bound ...
            lower_bound=np.full(2, -2.0),  # ... AND keyword
        )


def test_optimizer_state_sharding_declaration():
    """Adam declares its (n, m) moments particle-sharded and its step
    counter replicated; the mesh placement reads this instead of a shape
    heuristic (a custom optimizer with an (m, m) state leaf overrides)."""
    import jax

    opt = sv.Adam(2, 16, 0.1, 0.9, 0.999)
    state = opt.init()
    flags = opt.state_is_particle_sharded(state)
    leaves_state = jax.tree.leaves(state)
    leaves_flags = jax.tree.leaves(flags)
    for x, f in zip(leaves_state, leaves_flags):
        assert f == (getattr(x, "shape", None) == (16, 2)), (x, f)
    assert any(leaves_flags) and not all(leaves_flags)


@pytest.mark.parametrize(
    "backend, n, kind, expected",
    [
        ("gpu", 1030, "rbf", "fused_pallas"),
        ("gpu", 1030, "sum", "fused_terms_pallas"),
        ("gpu", 1030, "div", "fused_terms_pallas"),
        ("gpu", 1024, "rbf", "dense"),
        ("gpu", 1024, "sum", "rbf_terms"),
        ("cpu", 1030, "rbf", "fused"),
        ("cpu", 1030, "sum", "fused_terms"),
        ("cpu", 1030, "div", "fused_terms"),
        ("cpu", 1024, "rbf", "dense"),
        ("rocm", 1030, "rbf", "fused"),
    ],
)
def test_fused_auto_selection_table(rng, monkeypatch, backend, n, kind,
                                    expected):
    """phi_impl='auto' reads one table: the Pallas sweep on a GPU backend
    (division terms included — the kernel masks padding, so no sign gate),
    the XLA sweep elsewhere, the exact dense / per-term paths at n <= 1024.
    Selection only: initialize() resolves the impl without running it."""
    import svgdcpp_jax.svgd as svgd_mod

    monkeypatch.setattr(svgd_mod.jax, "default_backend", lambda: backend)
    x0 = rng.normal(size=(n, 2))
    model = sv.MultivariateNormal(np.zeros(2), np.eye(2))
    kernel = sv.GaussianRBFKernel(x0, sv.ScaleMethod.MEDIAN, model)
    const = sv.GaussianRBFKernel(
        x0, sv.ScaleMethod.CONSTANT, constant_scale=0.5 * np.eye(2)
    )
    kernel = {"rbf": kernel, "sum": kernel + const, "div": kernel / const}[
        kind
    ]
    drv = build(x0, model, kernel, sv.AdaGrad(2, n, 0.1))
    drv.initialize()
    assert drv._phi_impl == expected


@pytest.mark.parametrize("kind", ["rbf", "sum", "div"])
def test_driver_pallas_path_matches_xla_sweep(rng, monkeypatch, kind):
    """The driver's Pallas fused path (selected as on a GPU, the kernel in
    interpret mode) follows the XLA fused sweep's trajectory."""
    import functools

    import svgdcpp_jax.ops.pallas_phi as pp
    import svgdcpp_jax.svgd as svgd_mod

    n, iters = 64, 3
    x0 = rng.normal(size=(n, 2)).astype(np.float32)

    def run(impl):
        model = sv.MultivariateNormal(
            np.zeros(2, np.float32), np.eye(2, dtype=np.float32)
        )
        kernel = sv.GaussianRBFKernel(x0, sv.ScaleMethod.MEDIAN, model)
        const = sv.GaussianRBFKernel(
            x0, sv.ScaleMethod.CONSTANT,
            constant_scale=0.3 * np.eye(2, dtype=np.float32),
        )
        kernel = {"rbf": kernel, "sum": kernel + const,
                  "div": kernel / const}[kind]
        drv = sv.SVGD(
            sv.SVGDOptions(
                dimension=2, num_iterations=iters,
                coordinate_matrix=x0.copy(), kernel=kernel, model=model,
                optimizer=sv.AdaGrad(2, n, 0.1), phi_impl=impl,
            )
        )
        with monkeypatch.context() as mp:
            mp.setattr(svgd_mod.jax, "default_backend", lambda: "gpu")
            drv.initialize()
        return np.asarray(drv.run())

    xla = run("fused" if kind == "rbf" else "fused_terms")
    monkeypatch.setattr(
        pp, "phi_rbf_terms_fused_pallas",
        functools.partial(pp.phi_rbf_terms_fused_pallas, interpret=True),
    )
    pallas = run("fused_pallas" if kind == "rbf" else "fused_terms_pallas")
    assert np.isfinite(pallas).all()
    np.testing.assert_allclose(pallas, xla, rtol=1e-5, atol=1e-5)
