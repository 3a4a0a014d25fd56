"""The fused Pallas sweep (ops/pallas_phi.py) on the CPU, in interpret mode.

The kernel compiles only for a GPU; here it runs through the Pallas
interpreter (the explicit ``interpret=True`` route) and is checked against
its XLA twin (ops/phi.phi_rbf_terms_cross_fused_counts) and a float64 NumPy
reference. Also covered: the wrapper's padding and block plan, the
compile-cache helper every entry point calls, the device peaks table, and
``chip_smoke.py`` refusing to run without a GPU. The compiled kernel's own
parity runs on the card (``gpu`` marker).
"""

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from svgdcpp_jax.ops import pallas_phi as pp
from svgdcpp_jax.ops.phi import phi_rbf_terms_cross_fused_counts

ROOT = Path(__file__).resolve().parent.parent

#: (gammas as multiples of 1/m, signs): one term; two positive terms; three
#: terms with a subtracted term and a negative gamma (a division term).
TERMS = {
    "T1": ([1.0], [1]),
    "T2": ([1.0, 0.3], [1, 1]),
    "T3div": ([1.0, 0.5, -0.2], [1, -1, 1]),
}


def f64_reference(xt, xs, s, gammas, signs, thresholds):
    """(phi, exact counts, ambiguous pairs) in float64 (centered like the
    kernel; ``ambiguous``: pairs within f32 rounding of a threshold)."""
    c = xs.astype(np.float64).mean(0)
    xt = xt.astype(np.float64) - c
    xs = xs.astype(np.float64) - c
    d = xt[:, None, :] - xs[None, :, :]
    sq = (d * d).sum(-1)
    phi = np.zeros_like(xt)
    for g, sg in zip(gammas, signs):
        k = sg * np.exp(-g * sq)
        phi += k @ s + 2.0 * g * np.einsum("ij,ija->ia", k, d)
    counts = np.array([(sq <= t).sum() for t in thresholds])
    qmax = max((xt * xt).sum(1).max(), (xs * xs).sum(1).max())
    amb = sum(
        int((np.abs(sq - t) <= 16 * 2.0**-24 * (t + 2 * qmax)).sum())
        for t in thresholds
    )
    return phi / xs.shape[0], counts, amb


def _inputs(rng, n_t, n_s, m, cross):
    xs = rng.normal(size=(n_s, m)).astype(np.float32)
    xt = rng.normal(size=(n_t, m)).astype(np.float32) if cross else xs
    s = rng.normal(size=(n_s, m)).astype(np.float32)
    thr = np.array([0.5, 1.0, 2.0], np.float32) * 2 * m
    return xt, xs, s, thr


@pytest.mark.parametrize("cross", [False, True], ids=["self", "cross"])
@pytest.mark.parametrize("terms", sorted(TERMS))
@pytest.mark.parametrize("m", [1, 2, 3, 4, 5, 11, 50])
def test_interpret_sweep_matches_twin_and_f64(rng, m, terms, cross):
    """Ragged shapes (no size a multiple of a block): phi within f32
    rounding of the XLA twin and of float64; counts equal to the twin's and
    within the ambiguous pairs of the exact float64 counts."""
    n_t, n_s = (45, 130) if cross else (77, 77)
    xt, xs, s, thr = _inputs(rng, n_t, n_s, m, cross)
    scale, signs = TERMS[terms]
    gammas = [g / m for g in scale]
    pk, ck = pp.phi_rbf_terms_fused_pallas_cross(
        xt, xs, s, gammas, signs, thr, interpret=True
    )
    pt, ct = phi_rbf_terms_cross_fused_counts(xt, xs, s, gammas, signs, thr)
    ref, ref_counts, amb = f64_reference(xt, xs, s, gammas, signs, thr)
    assert pk.shape == (n_t, m) and pk.dtype == jnp.float32
    top = np.abs(ref).max()
    np.testing.assert_allclose(np.asarray(pk), ref, atol=2e-5 * top, rtol=0)
    np.testing.assert_allclose(np.asarray(pk), np.asarray(pt),
                               atol=2e-5 * top, rtol=0)
    np.testing.assert_array_equal(np.asarray(ck), np.asarray(ct))
    assert np.abs(np.asarray(ck) - ref_counts).max() <= amb


def test_twin_counts_are_exact_integers(rng):
    """The XLA twin accumulates counts in int32: past 2^24 pairs an f32
    running sum would round, the integer one does not."""
    n = 4200  # n^2 = 17.6M > 2^24
    # Coordinates on a 1/8 grid: every sq is a multiple of 1/64, so no pair
    # lies within rounding of a threshold at an odd multiple of 1/128.
    x = (rng.integers(-8, 9, size=(n, 2)) / 8).astype(np.float32)
    thr = np.array([19, 45, 71], np.float32) / 128
    _, counts = phi_rbf_terms_cross_fused_counts(
        x, x, x, [1.0], [1], thr, row_tile=1024
    )
    exact = []
    for t in thr:
        c = 0
        for a in range(0, n, 700):
            d = x[a:a + 700, None, :] - x[None, :, :]
            c += int(((d * d).sum(-1) <= t).sum())
        exact.append(c)
    np.testing.assert_array_equal(np.asarray(counts, np.int64), exact)


@pytest.mark.parametrize(
    "n_t, n_s, m",
    [(10, 10, 2), (77, 77, 2), (1000, 1000, 50), (10_000, 10_000, 2),
     (10_000, 10_000, 11), (2500, 10_000, 2), (25_000, 100_000, 2),
     (100_000, 100_000, 2)],
)
def test_block_plan(n_t, n_s, m):
    """Padded extents cover the inputs in whole blocks, the column splits
    cover every column block exactly once with no empty split, small n is
    split to fill the card, and every dot operand is >= 16 wide."""
    plan = pp.block_plan(n_t, n_s, m)
    br, bc = plan["block_r"], plan["block_c"]
    rows, splits = plan["grid"]
    assert plan["n_t_pad"] == rows * br >= n_t > (rows - 1) * br
    assert plan["n_s_pad"] == plan["col_blocks"] * bc >= n_s
    assert (splits - 1) * plan["per_split"] < plan["col_blocks"]
    assert splits * plan["per_split"] >= plan["col_blocks"]
    assert rows * splits >= min(pp.TARGET_PROGRAMS,
                                rows * plan["col_blocks"]) // 2
    assert plan["diff"] == (m <= pp.DIFF_FORM_MAX_M)
    assert plan["mp"] >= max(16, m) and plan["mp"] & (plan["mp"] - 1) == 0
    width = 2 * m if plan["diff"] else 2 * m + 1
    assert plan["w"] >= width and (plan["diff"] or plan["w"] >= 16)
    tuned = pp.DIFF_BLOCKS if plan["diff"] else pp.GRAM_BLOCKS
    assert (br, bc) == tuned[:2] or min(n_t, n_s) < 64
    assert plan["num_warps"] == tuned[2]


def test_sweep_raises_off_gpu_without_interpret(rng):
    xt, xs, s, thr = _inputs(rng, 8, 8, 2, False)
    with pytest.raises(ValueError, match="GPU backend"):
        pp.phi_rbf_terms_fused_pallas(xs, s, [0.5], [1], thr)


def test_sweep_rejects_mismatched_terms(rng):
    xt, xs, s, thr = _inputs(rng, 8, 8, 2, False)
    with pytest.raises(ValueError, match="gammas"):
        pp.phi_rbf_terms_fused_pallas(
            xs, s, [0.5, 0.1], [1], thr, interpret=True
        )


@pytest.mark.gpu
@pytest.mark.parametrize("m", [2, 11])
def test_compiled_sweep_matches_twin_on_card(card, rng, m):
    """The compiled Triton kernel against its twin on the card."""
    xt, xs, s, thr = _inputs(rng, 300, 700, m, True)
    pk, ck = pp.phi_rbf_terms_fused_pallas_cross(
        xt, xs, s, [1.0 / m, 0.3 / m], [1, 1], thr
    )
    pt, ct = phi_rbf_terms_cross_fused_counts(
        xt, xs, s, [1.0 / m, 0.3 / m], [1, 1], thr
    )
    top = float(jnp.abs(pt).max())
    np.testing.assert_allclose(np.asarray(pk), np.asarray(pt),
                               atol=2e-5 * top, rtol=0)
    assert np.abs(np.asarray(ck) - np.asarray(ct)).max() <= 4


def test_sharded_fused_pallas_auto_on_gpu(monkeypatch):
    """ShardedSVGD's fused sweep follows the driver's backend table: the
    Pallas kernel per device on a GPU backend (selection only)."""
    import svgdcpp_jax as sv
    from svgdcpp_jax.parallel.sharded import ShardedSVGD, ShardedSVGDConfig

    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    model = sv.MultivariateNormal(np.zeros(2), np.eye(2))
    sh = ShardedSVGD(model, sv.AdaGrad(2, 64, 0.1), 64, 2,
                     config=ShardedSVGDConfig(fused_phi=True))
    assert sh._fused_pallas is True
    off = ShardedSVGD(model, sv.AdaGrad(2, 64, 0.1), 64, 2,
                      config=ShardedSVGDConfig(fused_phi=True,
                                               fused_pallas=False))
    assert off._fused_pallas is False


# ----------------------------------------------------------------------
# Compile cache, peaks table, chip_smoke
# ----------------------------------------------------------------------


def test_compile_cache_uses_env_var(monkeypatch, tmp_path):
    from svgdcpp_jax.utils import compile_cache

    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert compile_cache.enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before  # nothing set


def test_compile_cache_default_is_fixed_checkout_dir(monkeypatch):
    from svgdcpp_jax.utils import compile_cache

    before = jax.config.jax_compilation_cache_dir
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    try:
        path = compile_cache.enable_compile_cache()
        assert path == str(ROOT / ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == path
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
    assert ".jax_cache/" in (ROOT / ".gitignore").read_text().split()


ENTRY_POINTS = ["chip_smoke.py", "bench.py", "bench_scaling.py"] + sorted(
    str(p.relative_to(ROOT)) for p in (ROOT / "examples").glob("*.py")
)


@pytest.mark.parametrize("entry", ENTRY_POINTS)
def test_entry_point_enables_compile_cache(entry):
    assert "enable_compile_cache()" in (ROOT / entry).read_text()


def test_device_peaks_table():
    from svgdcpp_jax.utils.profiling import device_peaks, speed_of_light

    peaks = device_peaks("NVIDIA H100 80GB HBM3")
    assert peaks["hbm_bytes"] == 3.35e12 and peaks["f32_flops"] == 67e12
    t1 = speed_of_light(10_000, 2, "NVIDIA H100 80GB HBM3")
    t2 = speed_of_light(20_000, 2, "NVIDIA H100 80GB HBM3")
    assert 0 < t1 and t2 == pytest.approx(4 * t1, rel=1e-3)


@pytest.mark.parametrize("kind", ["cpu", "NVIDIA A100-SXM4-40GB", ""])
def test_device_peaks_unknown_device_raises(kind):
    from svgdcpp_jax.utils.profiling import device_peaks

    with pytest.raises(KeyError, match="no published peaks"):
        device_peaks(kind)


def _run_smoke(cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
        capture_output=True, text=True, timeout=120,
    )


def test_chip_smoke_fails_without_gpu():
    r = _run_smoke(ROOT)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout and "no GPU backend" in r.stderr


def test_chip_smoke_fails_alone(tmp_path):
    (tmp_path / "chip_smoke.py").write_text(
        (ROOT / "chip_smoke.py").read_text()
    )
    r = _run_smoke(tmp_path)
    assert r.returncode != 0 and '"ok"' not in r.stdout
