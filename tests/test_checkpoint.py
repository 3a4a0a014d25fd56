"""Checkpoint/resume tests (SURVEY.md §5: aux subsystem the reference lacks)."""

import numpy as np

import svgdcpp_jax as sv
from svgdcpp_jax.utils.checkpoint import restore_checkpoint, save_checkpoint


def build(x0, iters):
    n, dim = x0.shape
    model = sv.MultivariateNormal(np.zeros(dim), np.eye(dim))
    kernel = sv.GaussianRBFKernel(x0, sv.ScaleMethod.MEDIAN, model)
    return sv.SVGD(
        sv.SVGDOptions(
            dimension=dim,
            num_iterations=iters,
            coordinate_matrix=x0.copy(),
            kernel=kernel,
            model=model,
            optimizer=sv.Adam(dim, n, 0.1, 0.9, 0.999),
        )
    )


def test_checkpoint_roundtrip_resumes_exactly(tmp_path, rng):
    x0 = rng.normal(size=(12, 2))

    # Uninterrupted 10-step run
    s_full = build(x0, 10)
    s_full.initialize()
    full = np.asarray(s_full.run())

    # 5 steps -> checkpoint -> restore -> 5 more steps
    s_a = build(x0, 5)
    s_a.initialize()
    s_a.run()
    state = s_a.make_state()
    ckpt = save_checkpoint(tmp_path / "ck", state, step=5)

    s_b = build(x0, 5)
    s_b.initialize()
    restored, step = restore_checkpoint(tmp_path / "ck", s_b.make_state())
    assert step == 5
    s_b._absorb_state(restored)
    resumed = np.asarray(s_b.run())

    np.testing.assert_allclose(resumed, full, rtol=1e-12, atol=1e-15)
    assert ckpt.endswith(".npz")


def test_checkpoint_missing_key_raises(tmp_path, rng):
    x0 = rng.normal(size=(8, 2))
    s = build(x0, 1)
    s.initialize()
    state = s.make_state()
    save_checkpoint(tmp_path / "ck", {"coords": state["coords"]}, step=0)
    try:
        restore_checkpoint(tmp_path / "ck", state)
        raise AssertionError("expected KeyError")
    except KeyError:
        pass


def test_native_host_helpers(rng):
    """Native nth_element/median vs NumPy (utils/native.py)."""
    from svgdcpp_jax.utils.native import host_median, kth_element

    v = rng.normal(size=10001)
    assert np.isclose(kth_element(v, 123), np.partition(v.copy(), 123)[123])
    s = np.sort(v)
    assert np.isclose(host_median(v), s[5000])
    v2 = rng.normal(size=10000)
    s2 = np.sort(v2)
    assert np.isclose(host_median(v2), 0.5 * (s2[4999] + s2[5000]))


def test_native_log_writer_matches_python(tmp_path, rng):
    """Native and Python debug-log writers produce identical text."""
    from svgdcpp_jax.utils import logging as svlog
    from svgdcpp_jax.utils.native import native_available

    T, n, m = 2, 3, 2
    logs = {
        "log_model_grad": rng.normal(size=(T, n, m)),
        "kernel": rng.normal(size=(T, n, n)),
        "kernel_grad": rng.normal(size=(T, n, n, m)),
        "coords": rng.normal(size=(T, n, m)),
    }
    p_native = tmp_path / "native.txt"
    p_python = tmp_path / "python.txt"
    svlog.write_intermediate_matrices(str(p_native), logs)

    # Force the pure-Python path
    import svgdcpp_jax.utils.native as nat

    orig = nat.write_intermediate_log_native
    nat.write_intermediate_log_native = lambda *a, **k: False
    try:
        svlog.write_intermediate_matrices(str(p_python), logs)
    finally:
        nat.write_intermediate_log_native = orig

    if native_available():
        assert p_native.read_text() == p_python.read_text()


def test_cpp_oracle_cross_language_trajectory(rng):
    """Cross-language check: the independent C++ per-pair SVGD oracle and
    the JAX engine produce the same trajectory (f64, exact median)."""
    import svgdcpp_jax as sv
    from svgdcpp_jax.utils.native import cpp_oracle_mvn_rbf_adagrad, native_available

    if not native_available():
        import pytest

        pytest.skip("native toolchain unavailable")

    n, dim, iters = 12, 2, 8
    mean = np.array([-0.6871, 0.8010])
    cov = 5 * np.array([[0.2260, 0.1652], [0.1652, 0.6779]])
    x0 = rng.uniform(-3, 3, (n, dim))

    cpp = cpp_oracle_mvn_rbf_adagrad(
        x0, mean, np.linalg.inv(cov), gamma=None, lr=0.1, iters=iters
    )

    model = sv.MultivariateNormal(mean, cov)
    kernel = sv.GaussianRBFKernel(x0, sv.ScaleMethod.MEDIAN, model,
                                  median_method="exact")
    svgd = sv.SVGD(
        sv.SVGDOptions(dimension=dim, num_iterations=iters,
                       coordinate_matrix=x0.copy(), kernel=kernel, model=model,
                       optimizer=sv.AdaGrad(dim, n, 0.1))
    )
    svgd.initialize()
    jax_out = np.asarray(svgd.run())
    np.testing.assert_allclose(jax_out, cpp, rtol=1e-9, atol=1e-12)


def test_native_rebuilds_stale_library(tmp_path):
    """A stale libsvgd_host.so missing newer entry points must be rebuilt,
    not silently disable EVERY native helper (the blanket fallback would
    make cpp_oracle parity checks skip without a trace)."""
    import shutil
    import subprocess

    import pytest

    import svgdcpp_jax.utils.native as nat

    if not nat.native_available():
        pytest.skip("native toolchain unavailable")
    # Overwrite the real library with a stub exporting NONE of the svgd_*
    # symbols, mtime NEWER than svgd_host.cpp — make's mtime check alone
    # sees it as fresh, so only the AttributeError-triggered forced
    # rebuild can recover.
    stub_c = tmp_path / "stub.c"
    stub_c.write_text("int svgd_stub(void) { return 0; }\n")
    subprocess.run(
        ["g++", "-shared", "-fPIC", "-o", str(nat._LIB_PATH), str(stub_c)],
        check=True,
    )
    backup = tmp_path / "stub_installed.so"
    shutil.copy2(nat._LIB_PATH, backup)
    nat._lib = None
    nat._load_failed = False
    try:
        assert nat.native_available(), "stale library was not rebuilt"
        assert nat.host_median(np.array([3.0, 1.0, 2.0])) == 2.0
    finally:
        # On failure the stub may still be installed; force a clean rebuild
        # for subsequent tests either way.
        nat._lib = None
        nat._load_failed = False
        nat._make(force=True)
        nat._load()
