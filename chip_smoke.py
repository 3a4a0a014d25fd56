"""Smoke test of the main SVGD path on one NVIDIA GPU.

    python chip_smoke.py               # phases 1-4 on one card
    python chip_smoke.py --four-cards  # the 4-card sharded phase only

Phases (one process; any failure exits non-zero before the result line):

1. Device: require a GPU backend; print its kind, count, name and power
   limit.
2. Kernel parity at real widths: the fused Pallas sweep
   (ops/pallas_phi.py) against its XLA twin (ops/phi.py) and a float64
   NumPy reference, at the three workloads' shapes plus a cross shape.
3. Main path: ``SVGD(...).initialize().run()`` with ``phi_impl='auto'`` on
   the flagship MVN (1000 iterations, posterior moments checked), the
   hierarchical BLR and the BLR workloads.
4. Timing: the kernel against its XLA twin, alone and per SVGD step.

The last line of stdout is one JSON object:
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

#: max|phi - phi_ref| / max|phi_ref| allowed against the float64 reference
#: (and between kernel and twin). Both f32 paths measure <= 5e-6 at N=10k
#: (f32 rounding of sums over 10^4 sources); TF32 operands (2^-11 relative
#: rounding) in the distance / contraction dots measure >= 7e-5 (PERF.md).
PHI_TOL = 2e-5

#: Posterior bound after 1000 iterations, in Monte-Carlo units of 10^4
#: exact samples (bench.posterior_metrics). First moments are within MC
#: error at this budget; second moments are still converging (SVGD's own
#: finite-iteration error, which the f64 oracle shares), hence the wider
#: cov bound.
MEAN_MC_BOUND = 2.0
COV_MC_BOUND = 3.0

#: max|x_driver - x_f64| over the first 3 flagship steps when the f64
#: reference step is given the bandwidth the driver used: f32 rounding of
#: phi and the AdaGrad update (<= 6e-6 measured at N=4k on the CPU).
STEP_TOL = 1e-4

#: 4-card agreement: after FOUR_STEPS steps, at least FOUR_FRAC of the
#: coordinates within an absolute tolerance of the single-card run.
#: AdaGrad's first step is lr * sign(phi); a component of phi within f32
#: rounding of zero may flip between reduction orders and move by up to
#: 2 * lr, hence a fraction and not a max. Gather mode and the mesh path
#: run the single card's algorithm (fused sweep, lag-1 median):
#: FOUR_ATOL. Ring mode's warm median and the single card's warm median
#: refine with different bins/passes, so their bandwidths agree only to
#: the bracket resolution: RING_ATOL (8e-4 measured at N=2048 on 4
#: simulated CPU devices).
FOUR_STEPS = 5
FOUR_ATOL = 1e-4
RING_ATOL = 2e-3
FOUR_FRAC = 0.9999

#: Workload sizes: the flagship and hierarchical BLR at N=10k, BLR d=50 at
#: N=1k (the reference configs), the 1000-iteration reference budget, and
#: BASELINE config 5's 100k particles for the 4-card phase.
N_MVN = 10_000
N_HIER = 10_000
N_BLR = 1000
MVN_ITERS = 1000
N_FOUR = 100_000


def _fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def _check(cond, msg: str) -> None:
    if not cond:
        _fail(msg)


def _sync(tree):
    import jax

    return jax.block_until_ready(tree)


def _median_ms(fn, reps: int = 30) -> float:
    _sync(fn())
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        _sync(fn())
        times.append(time.perf_counter() - t0)
    return float(np.median(times)) * 1e3


# ----------------------------------------------------------------------
# Phase 1
# ----------------------------------------------------------------------


def phase_device(want_count: int):
    import jax

    if jax.default_backend() != "gpu":
        _fail(f"no GPU backend (JAX found {jax.default_backend()!r})")
    devices = jax.devices()
    _check(
        len(devices) >= want_count,
        f"need {want_count} GPUs, JAX sees {len(devices)}",
    )
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    print(f"[1] device_kind={devices[0].device_kind} count={len(devices)}")
    print(f"[1] nvidia-smi: {smi}", flush=True)
    return devices


# ----------------------------------------------------------------------
# Phase 2: kernel parity
# ----------------------------------------------------------------------


def f64_reference(targets, sources, scores, gammas, signs, thresholds):
    """(phi, counts, ambiguous) in float64, chunked over target rows.

    ``ambiguous`` counts pairs whose squared distance lies within f32
    rounding of a threshold (16 ulps of thr + 2 max|x|^2, which bounds the
    Gram form's cancellation too): an f32 path may classify them either
    way, so |count - ref| <= ambiguous is the exactness bound.
    """
    center = sources.astype(np.float64).mean(0)
    xt = targets.astype(np.float64) - center
    xs = sources.astype(np.float64) - center
    s = scores.astype(np.float64)
    qt = (xt * xt).sum(1)
    qs = (xs * xs).sum(1)
    qmax = max(qt.max(), qs.max())
    phi = np.zeros_like(xt)
    counts = np.zeros(len(thresholds), np.int64)
    ambiguous = 0
    for a in range(0, xt.shape[0], 512):
        x = xt[a:a + 512]
        sq = np.maximum(qt[a:a + 512, None] + qs[None, :] - 2.0 * x @ xs.T,
                        0.0)
        for g, sg in zip(gammas, signs):
            k = sg * np.exp(-g * sq)
            phi[a:a + 512] += k @ s - 2.0 * g * (k @ xs - k.sum(1)[:, None] * x)
        for e, t in enumerate(thresholds):
            counts[e] += int((sq <= t).sum())
            band = 16 * 2.0**-24 * (t + 2 * qmax)
            ambiguous += int((np.abs(sq - t) <= band).sum())
    return phi / xs.shape[0], counts, ambiguous


def _sq_median(x, sample: int = 2000) -> float:
    rng = np.random.default_rng(0)
    pick = x[rng.choice(x.shape[0], min(sample, x.shape[0]), replace=False)]
    pick = pick.astype(np.float64)
    return float(np.median(((pick[:, None, :] - pick[None]) ** 2).sum(-1)))


def parity_cases():
    """(name, targets, sources, scores, gammas, signs, thresholds) at the
    main-path workloads' widths, with their real particles and scores."""
    import jax
    import jax.numpy as jnp

    import bench
    import svgdcpp_jax as sv
    from svgdcpp_jax.utils.workloads import flagship_mvn

    def scores_of(model, x):
        model.initialize()
        return np.asarray(jax.vmap(
            lambda p: model.grad_log_density_pure(p, tuple(model.parameters))
        )(jnp.asarray(x)))

    def thresholds(x):
        med = _sq_median(x)
        return np.array([0.95 * med, med, 1.05 * med], np.float32)

    cases = []
    mean, cov, x = flagship_mvn(N_MVN, dtype=np.float32)
    model = sv.MultivariateNormal(mean, cov)
    s = scores_of(model, x)
    g = float(np.log(x.shape[0]) / _sq_median(x))
    cases.append((f"mvn N={N_MVN} d=2 T=1", x, x, s, [g], [1],
                  thresholds(x)))
    n_t = N_MVN // 4
    cases.append((f"cross {n_t}x{N_MVN} d=2 T=2 (K1 - K2)", x[:n_t], x, s,
                  [g, 0.5 * g], [1, -1], thresholds(x)))
    f, lab, x = bench.make_blr_workload(N_HIER, dim=10, hierarchical=True)
    model = sv.HierarchicalBayesianLogisticRegression(f, lab)
    s = scores_of(model, x)
    g = float(np.log(x.shape[0]) / _sq_median(x))
    cases.append((f"hier N={N_HIER} d=11 T=2", x, x, s, [g, 0.1], [1, 1],
                  thresholds(x)))
    f, lab, x = bench.make_blr_workload(N_BLR, dim=50)
    model = sv.BayesianLogisticRegression(f, lab, 0.1)
    s = scores_of(model, x)
    g = float(np.log(x.shape[0]) / _sq_median(x))
    cases.append((f"blr N={N_BLR} d=50 T=1", x, x, s, [g], [1],
                  thresholds(x)))
    return cases


def phase_parity(cases):
    import jax
    import jax.numpy as jnp

    from svgdcpp_jax.ops import pairwise
    from svgdcpp_jax.ops.pallas_phi import (
        DIFF_FORM_MAX_M,
        phi_rbf_terms_fused_pallas_cross,
    )
    from svgdcpp_jax.ops.phi import phi_rbf_terms_cross_fused_counts

    print("[2] dots: kernel Gram/contraction pl.dot precision=HIGHEST (IEEE "
          "f32); twin pairwise.DOT_PRECISION=HIGHEST; "
          f"tolerance max|dphi|/max|phi| <= {PHI_TOL:g}", flush=True)
    tf32_errs = []
    for name, xt, xs, s, gammas, signs, thr in cases:
        args = (jnp.asarray(xt), jnp.asarray(xs), jnp.asarray(s))
        t = jnp.asarray(thr)
        ref, ref_counts, amb = f64_reference(xt, xs, s, gammas, signs, thr)
        scale = np.abs(ref).max()

        def err(p):
            return float(np.abs(np.asarray(p, np.float64) - ref).max() / scale)

        kern = jax.jit(lambda a, b, c: phi_rbf_terms_fused_pallas_cross(
            a, b, c, gammas, signs, t))
        twin = jax.jit(lambda a, b, c: phi_rbf_terms_cross_fused_counts(
            a, b, c, gammas, signs, t))
        pk, ck = kern(*args)
        pt, ct = twin(*args)
        ck = np.asarray(ck).astype(np.int64)
        ct = np.asarray(ct).astype(np.int64)
        e_k, e_t = err(pk), err(pt)
        e_kt = float(np.abs(np.asarray(pk) - np.asarray(pt)).max() / scale)
        d_kref = (ck - ref_counts).tolist()
        d_kt = (ck - ct).tolist()
        diff = xt.shape[1] <= DIFF_FORM_MAX_M
        print(f"[2] {name}: kernel err {e_k:.3e}, twin err {e_t:.3e}, "
              f"kernel-twin {e_kt:.3e}; counts kernel-f64 {d_kref}, "
              f"kernel-twin {d_kt}, twin-f64 {(ct - ref_counts).tolist()}, "
              f"ambiguous pairs {amb} ({'diff' if diff else 'Gram'} form)",
              flush=True)
        _check(e_k <= PHI_TOL and e_t <= PHI_TOL and e_kt <= PHI_TOL,
               f"{name}: phi error above {PHI_TOL:g}")
        _check(max(abs(d) for d in d_kref) <= amb,
               f"{name}: kernel counts off the f64 reference by more than "
               f"the {amb} ambiguous pairs")
        if diff:
            _check(d_kt == [0] * len(d_kt),
                   f"{name}: diff-form counts differ from the twin")
        else:
            _check(max(abs(d) for d in d_kt) <= amb,
                   f"{name}: Gram-form counts differ from the twin by more "
                   f"than the {amb} ambiguous pairs")
            # Control: the same twin with TF32 dots must fail PHI_TOL.
            saved = pairwise.DOT_PRECISION
            pairwise.DOT_PRECISION = jax.lax.Precision.DEFAULT
            try:
                tw32 = jax.jit(lambda a, b, c: phi_rbf_terms_cross_fused_counts(
                    a, b, c, gammas, signs, t))
                e32 = err(tw32(*args)[0])
            finally:
                pairwise.DOT_PRECISION = saved
            tf32_errs.append(e32)
            print(f"[2] {name}: control, twin with TF32 dots: err {e32:.3e} "
                  f"({'fails' if e32 > PHI_TOL else 'PASSES'} the "
                  f"{PHI_TOL:g} tolerance)", flush=True)
    _check(all(e > PHI_TOL for e in tf32_errs),
           "the phi tolerance does not reject TF32 distance dots")


# ----------------------------------------------------------------------
# Phase 3: main path
# ----------------------------------------------------------------------


def _mvn_svgd(x0, mean, cov, iters, phi_impl="auto", mesh=None):
    import svgdcpp_jax as sv

    n, dim = x0.shape
    model = sv.MultivariateNormal(mean.astype(np.float32),
                                  cov.astype(np.float32))
    kernel = sv.GaussianRBFKernel(x0, sv.ScaleMethod.MEDIAN, model)
    svgd = sv.SVGD(sv.SVGDOptions(
        dimension=dim, num_iterations=iters, coordinate_matrix=x0.copy(),
        kernel=kernel, model=model, optimizer=sv.AdaGrad(dim, n, 0.1),
        phi_impl=phi_impl, mesh=mesh,
    ))
    return svgd.initialize(), model


def _per_step_ms(svgd, steps):
    """Informational wall time per step of a further run() of ``steps``
    (compiled already: the same length as the run before it)."""
    svgd.num_iterations = steps
    t0 = time.perf_counter()
    _sync(svgd.run())
    return (time.perf_counter() - t0) / steps * 1e3


def phase_main():
    import bench
    from svgdcpp_jax.utils.workloads import flagship_mvn

    mean, cov, x0 = flagship_mvn(N_MVN)
    x0 = x0.astype(np.float32)
    n = x0.shape[0]

    # First 3 steps against the f64 reference step, given the bandwidth the
    # driver's lag-1 fused median chose for that step.
    svgd, _ = _mvn_svgd(x0, mean, cov, 1)
    print(f"[3] mvn N={n} d=2: auto chose phi_impl={svgd._phi_impl!r}",
          flush=True)
    med = float(svgd._current_scale_aux(svgd.store.value)[0]["med"])
    x = x0.astype(np.float64)
    acc = np.zeros_like(x)
    cov_inv = np.linalg.inv(cov)
    for step in range(1, 4):
        got = np.asarray(svgd.run(), np.float64)
        x, acc = bench.numpy_reference_step(
            x, acc, mean, cov_inv, gamma=np.log(n) / med**2
        )
        dx = float(np.abs(got - x).max())
        print(f"[3] mvn step {step}: median used {med:.6f}, "
              f"max|x - x_f64| {dx:.3e} (tolerance {STEP_TOL:g})", flush=True)
        _check(dx <= STEP_TOL, f"mvn step {step} off the f64 reference")
        med = float(svgd._scale_aux[0]["med"])

    svgd, model = _mvn_svgd(x0, mean, cov, MVN_ITERS)
    t0 = time.perf_counter()
    out = np.asarray(_sync(svgd.run()))
    wall = time.perf_counter() - t0
    _check(np.isfinite(out).all(), "mvn particles not finite")
    post = bench.posterior_metrics(out, mean, cov, model)
    print(f"[3] mvn {MVN_ITERS} iterations ({wall:.1f} s incl. compile): {post}; "
          f"bounds mean <= {MEAN_MC_BOUND} MC, cov <= {COV_MC_BOUND} MC",
          flush=True)
    _check(post["mean_err_over_mc"] <= MEAN_MC_BOUND, "mvn mean off")
    _check(post["cov_err_over_mc"] <= COV_MC_BOUND, "mvn covariance off")
    print(f"[3] mvn informational: {_per_step_ms(svgd, MVN_ITERS):.4f} "
          "ms/step", flush=True)

    for name, n_p, dim, hier in (
        ("hier BLR", N_HIER, 10, True),
        ("BLR", N_BLR, 50, False),
    ):
        f, lab, x0b = bench.make_blr_workload(n_p, dim=dim, hierarchical=hier)
        svgd = bench.build_blr_svgd(x0b, f, lab, hier, "auto", 100)
        out = np.asarray(_sync(svgd.run()))
        _check(np.isfinite(out).all(), f"{name} particles not finite")
        print(f"[3] {name} N={n_p} d={x0b.shape[1]}: auto chose "
              f"phi_impl={svgd._phi_impl!r}, 100 steps finite; "
              f"informational {_per_step_ms(svgd, 100):.4f} ms/step",
              flush=True)


# ----------------------------------------------------------------------
# Phase 4: timing
# ----------------------------------------------------------------------


def phase_timing(cases):
    import jax
    import jax.numpy as jnp

    import bench
    from svgdcpp_jax.ops.pallas_phi import phi_rbf_terms_fused_pallas_cross
    from svgdcpp_jax.ops.phi import phi_rbf_terms_cross_fused_counts
    from svgdcpp_jax.utils.workloads import flagship_mvn

    for name, xt, xs, s, gammas, signs, thr in cases:
        args = (jnp.asarray(xt), jnp.asarray(xs), jnp.asarray(s))
        t = jnp.asarray(thr)
        kern = jax.jit(lambda a, b, c: phi_rbf_terms_fused_pallas_cross(
            a, b, c, gammas, signs, t))
        twin = jax.jit(lambda a, b, c: phi_rbf_terms_cross_fused_counts(
            a, b, c, gammas, signs, t))
        print(f"[4] sweep alone, {name}: kernel "
              f"{_median_ms(lambda: kern(*args)):.4f} ms, XLA twin "
              f"{_median_ms(lambda: twin(*args)):.4f} ms", flush=True)

    def step_ms(svgd, steps=200):
        state = svgd.make_state()
        _sync(svgd._jit_run(state, steps))
        best = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            _sync(svgd._jit_run(state, steps))
            best = min(best, time.perf_counter() - t0)
        return best / steps * 1e3

    mean, cov, x0 = flagship_mvn(N_MVN)
    x0 = x0.astype(np.float32)
    f, lab, xh = bench.make_blr_workload(N_HIER, dim=10, hierarchical=True)
    fb, lb, xb = bench.make_blr_workload(N_BLR, dim=50)
    rows = (
        (f"mvn N={N_MVN} d=2", lambda i: _mvn_svgd(x0, mean, cov, 1, i)[0],
         ("fused_pallas", "fused")),
        (f"hier N={N_HIER} d=11",
         lambda i: bench.build_blr_svgd(xh, f, lab, True, i, 1),
         ("fused_terms_pallas", "fused_terms")),
        (f"blr N={N_BLR} d=50",
         lambda i: bench.build_blr_svgd(xb, fb, lb, False, i, 1),
         ("fused_pallas", "fused", "dense")),
    )
    for name, build, impls in rows:
        line = ", ".join(f"{i} {step_ms(build(i)):.4f}" for i in impls)
        print(f"[4] per SVGD step (ms), {name}: {line}", flush=True)


# ----------------------------------------------------------------------
# Four cards
# ----------------------------------------------------------------------


def _agree(name, got, ref, atol=FOUR_ATOL):
    got = np.asarray(got, np.float64)
    d = np.abs(got - np.asarray(ref, np.float64))
    frac = float((d <= atol).mean())
    print(f"[4c] {name}: max|dx| {d.max():.3e}, fraction within "
          f"{atol:g}: {frac:.6f} (need >= {FOUR_FRAC})", flush=True)
    _check(np.isfinite(got).all(), f"{name}: not finite")
    _check(frac >= FOUR_FRAC, f"{name}: disagrees with the single card")


def _check_sharded(name, arr, n_dev):
    devs = {s.device for s in arr.addressable_shards}
    shapes = {s.data.shape for s in arr.addressable_shards}
    print(f"[4c] {name}: output on {len(devs)} devices, shard shapes "
          f"{sorted(shapes)}", flush=True)
    _check(len(devs) == n_dev and len(shapes) == 1,
           f"{name}: output not sharded over {n_dev} devices")


def phase_four_cards(n: int = N_FOUR, steps: int = FOUR_STEPS,
                     n_dev: int = 4):
    """N=n, d=2 flagship MVN on a 1-D mesh over ``n_dev`` devices: gather
    mode, ring mode and the SVGDOptions.mesh path, each against the
    single-device SVGD run of the same config and seed."""
    import jax

    import svgdcpp_jax as sv
    from svgdcpp_jax.parallel import (
        ShardedSVGD,
        ShardedSVGDConfig,
        make_particle_mesh,
    )
    from svgdcpp_jax.utils.workloads import flagship_mvn

    mean, cov, x0 = flagship_mvn(n)
    x0 = x0.astype(np.float32)
    mesh = make_particle_mesh(jax.devices()[:n_dev])

    single_fused, _ = _mvn_svgd(x0, mean, cov, steps)
    ref_fused = np.asarray(_sync(single_fused.run()))
    single_warm, _ = _mvn_svgd(x0, mean, cov, steps, phi_impl="blocked")
    ref_warm = np.asarray(_sync(single_warm.run()))
    print(f"[4c] single card N={n}: {single_fused._phi_impl} and "
          f"{single_warm._phi_impl} references", flush=True)

    model = sv.MultivariateNormal(mean.astype(np.float32),
                                  cov.astype(np.float32))
    for mode, cfg, ref, atol in (
        ("gather (fused sweep per device)",
         ShardedSVGDConfig(fused_phi=True), ref_fused, FOUR_ATOL),
        ("ring (ppermute, warm median)",
         ShardedSVGDConfig(phi_mode="ring"), ref_warm, RING_ATOL),
    ):
        sh = ShardedSVGD(model, sv.AdaGrad(2, n, 0.1), n, 2, mesh=mesh,
                         config=cfg)
        out = _sync(sh.run(x0, steps))
        print(f"[4c] ShardedSVGD {mode}: fused_pallas={sh._fused_pallas}",
              flush=True)
        _check_sharded(f"ShardedSVGD {mode}", out, n_dev)
        _agree(f"ShardedSVGD {mode}", out, ref, atol)

    mesh_svgd, _ = _mvn_svgd(x0, mean, cov, steps, mesh=mesh)
    out = _sync(mesh_svgd.run())
    print(f"[4c] SVGDOptions.mesh: phi_impl={mesh_svgd._phi_impl!r}",
          flush=True)
    _check_sharded("SVGDOptions.mesh", out, n_dev)
    _agree("SVGDOptions.mesh", out, ref_fused)


# ----------------------------------------------------------------------


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument(
        "--four-cards", action="store_true",
        help="run only the 4-card sharded phase (needs 4 GPUs)",
    )
    args = ap.parse_args(argv)

    import jax

    devices = phase_device(4 if args.four_cards else 1)
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from svgdcpp_jax.utils.compile_cache import enable_compile_cache

    print(f"[1] compile cache: {enable_compile_cache()}", flush=True)
    t0 = time.perf_counter()
    if args.four_cards:
        phase_four_cards()
    else:
        cases = parity_cases()
        phase_parity(cases)
        phase_main()
        phase_timing(cases)
    print(f"chip_smoke: all phases passed in {time.perf_counter() - t0:.1f} s",
          flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform,
        "kind": devices[0].device_kind,
        "count": len(jax.devices()),
    }}))


if __name__ == "__main__":
    main()
