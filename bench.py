"""Benchmark: particle-updates/sec/chip (BASELINE.json primary metric).

Workload: N=10k particles, d=2, Gaussian-RBF kernel with per-step median
bandwidth, AdaGrad lr=0.1 — the reference's mvn_example configuration
(reference examples/multivariate_normal/mvn_example.cpp:19-35) scaled to the
BASELINE.json measurement size.

Baseline: the C++ reference cannot be built in this image (no Eigen/CppAD),
and it publishes no numbers (BASELINE.md). The stand-in baseline is a
best-case *vectorized NumPy float64* implementation of the reference
algorithm — same per-step math: Gram-identity pairwise distances, full
n^2 median including self-zeros, closed-form RBF phi, AdaGrad update. This
is generous to the reference: its actual CppAD tape-replay per-pair loop
(SVGD.hpp:435-450) is orders of magnitude slower than vectorized NumPy.

Runs only on a GPU backend (exits non-zero otherwise). Prints ONE JSON
line:
  {"metric": ..., "value": N, "unit": "updates/s", "vs_baseline": R,
   "device": {"platform": "gpu", "kind": ..., "count": D}}
"""

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent))


# ----------------------------------------------------------------------
# NumPy reference-equivalent baseline (vectorized, f64)
# ----------------------------------------------------------------------


def _numpy_median_gamma(x):
    """Median bandwidth exactly as the reference computes it (n^2 dists
    including self-zeros, even-count averaging; GaussianRBFKernel.hpp:164-187).

    Memory note: at n=10k each n^2 f64 array is 800 MB, so the distance
    vector is partitioned IN PLACE (no np.partition copy).
    """
    n = x.shape[0]
    sq_norms = (x * x).sum(1)
    sq = np.maximum(sq_norms[:, None] + sq_norms[None, :] - 2.0 * (x @ x.T), 0.0)
    d = np.sqrt(sq.ravel())
    half = d.size // 2
    if d.size % 2 == 0:
        d.partition([half - 1, half])
        med = 0.5 * (d[half - 1] + d[half])
    else:
        # odd count: the single middle element (GaussianRBFKernel.hpp:246-253)
        d.partition(half)
        med = d[half]
    return np.log(n) / med**2, sq


def numpy_reference_step(x, s_accum, mean, cov_inv, lr=0.1, eps=1e-8,
                         gamma=None):
    """One SVGD step exactly as the reference computes it, vectorized.

    ``gamma`` replaces the same-step median bandwidth log(n)/med^2 (e.g. by
    the lag-1 bandwidth a fused driver step used), keeping the rest exact.
    """
    n = x.shape[0]
    if gamma is None:
        gamma, sq = _numpy_median_gamma(x)
    else:
        q = (x * x).sum(1)
        sq = np.maximum(q[:, None] + q[None, :] - 2.0 * (x @ x.T), 0.0)
    # phi (SVGD.hpp:407-454), closed-form RBF; k consumes sq in place (one
    # live n^2 buffer instead of two).
    k = np.multiply(sq, -gamma, out=sq)
    np.exp(k, out=k)
    scores = -(x - mean) @ cov_inv.T
    ks = k @ scores
    kx = k @ x
    rowsum = k.sum(1)
    phi = (ks - 2.0 * gamma * (kx - rowsum[:, None] * x)) / n
    # AdaGrad (AdaGrad.hpp:60-65)
    s_accum += phi * phi
    x = x + lr * phi / (eps + np.sqrt(s_accum))
    return x, s_accum


def _numpy_gmm_scores(x, means, covs):
    """grad log p for a sum-of-unnormalized-gaussians target, f64.

    The reference's GMM example composes two MVN models with `+`
    (gmm_example.cpp:24), i.e. p(x) = exp(-q1) + exp(-q2) with each q the
    MVN quadratic form (MultivariateNormal.hpp:56-61, no normalization
    constant). Score = softmax(-q) weighted component scores.
    """
    qs, grads = [], []
    for mu, cov in zip(means, covs):
        cinv = np.linalg.inv(np.asarray(cov, np.float64))
        diff = x - np.asarray(mu, np.float64)
        qs.append(0.5 * np.einsum("ni,ij,nj->n", diff, cinv, diff))
        grads.append(-diff @ cinv.T)
    q = np.stack(qs, 0)  # (k, n)
    w = np.exp(-(q - q.min(0)))
    w /= w.sum(0)
    return sum(wi[:, None] * gi for wi, gi in zip(w, grads))


def numpy_gmm_oracle(x0, means, covs, iters=1000, lr=0.1, b1=0.9, b2=0.999,
                     eps=1e-8):
    """Reference-semantics f64 trajectory for the GMM example config
    (gmm_example.cpp:9-45): per-step median-RBF phi + Adam in the
    reference's exact `eps + sqrt(v_hat)` form (Adam.hpp:75-96). The parity
    anchor for tests/test_examples.py::test_gmm_example_covers_both_modes
    and anchor_checks()'s oracle-vs-device mode masses."""
    x = np.asarray(x0, np.float64).copy()
    n = x.shape[0]
    m = np.zeros_like(x)
    v = np.zeros_like(x)
    for t in range(1, iters + 1):
        scores = _numpy_gmm_scores(x, means, covs)
        gamma, sq = _numpy_median_gamma(x)
        k = np.multiply(sq, -gamma, out=sq)
        np.exp(k, out=k)
        rowsum = k.sum(1)
        phi = (k @ scores - 2.0 * gamma * (k @ x - rowsum[:, None] * x)) / n
        m = b1 * m + (1 - b1) * phi
        v = b2 * v + (1 - b2) * phi * phi
        m_hat = m / (1 - b1**t)
        v_hat = v / (1 - b2**t)
        x = x + lr * m_hat / (eps + np.sqrt(v_hat))
    return x


def _numpy_blr_scores(x, features, labels, hierarchical, alpha=0.1, a0=1.0, b0=0.01):
    """grad log p for the (hierarchical) BLR target, vectorized f64.

    Mirrors svgdcpp_jax/models/bayesian_logistic_regression.py closed-form:
    sigmoid(-y z) * y weighting of the features plus the prior terms.
    """
    if not hierarchical:
        logits = x @ features.T  # (n, N)
        s = 1.0 / (1.0 + np.exp(labels * logits))  # sigmoid(-y z)
        return (s * labels) @ features - alpha * x
    d = features.shape[1]
    w, log_a = x[:, :d], x[:, d]
    a = np.exp(log_a)
    logits = w @ features.T
    s = 1.0 / (1.0 + np.exp(labels * logits))
    score_w = (s * labels) @ features - a[:, None] * w
    score_la = 0.5 * d - 0.5 * a * (w * w).sum(1) + a0 - b0 * a
    return np.concatenate([score_w, score_la[:, None]], axis=1)


def numpy_blr_step(x, opt, features, labels, hierarchical, lr, b1, b2, eps=1e-8,
                   const_gamma=0.1):
    """One reference-equivalent SVGD step for the BLR configs: median-RBF
    (plus a constant-scale RBF term when hierarchical — the composed kernel
    of bench config 4), Adam update in the reference's exact form."""
    n = x.shape[0]
    scores = _numpy_blr_scores(x, features, labels, hierarchical)
    gamma, sq = _numpy_median_gamma(x)
    # Two n^2 f64 buffers alive at peak (k + sq; the composed term then
    # consumes sq in place) — at the hier config's n=10k each is 800 MB.
    k = np.multiply(sq, -gamma)
    np.exp(k, out=k)
    rowsum = k.sum(1)
    phi = k @ scores + 2.0 * gamma * (rowsum[:, None] * x - k @ x)
    if hierarchical:
        k2 = np.multiply(sq, -const_gamma, out=sq)
        np.exp(k2, out=k2)
        rs2 = k2.sum(1)
        phi += k2 @ scores + 2.0 * const_gamma * (rs2[:, None] * x - k2 @ x)
    phi /= n
    # Adam (Adam.hpp:75-96): eps + sqrt(v_hat) denominator
    m = b1 * opt["m"] + (1 - b1) * phi
    v = b2 * opt["v"] + (1 - b2) * phi * phi
    t = opt["t"] + 1
    m_hat = m / (1 - b1**t)
    v_hat = v / (1 - b2**t)
    x = x + lr * m_hat / (eps + np.sqrt(v_hat))
    return x, {"m": m, "v": v, "t": t}


def bench_numpy_blr_baseline(x0, features, labels, hierarchical, iters,
                             lr=5e-2, b1=0.9, b2=0.999):
    x = x0.astype(np.float64).copy()
    f64 = np.asarray(features, np.float64)
    y64 = np.asarray(labels, np.float64)
    opt = {"m": np.zeros_like(x), "v": np.zeros_like(x), "t": 0}
    x, opt = numpy_blr_step(x, opt, f64, y64, hierarchical, lr, b1, b2)
    best = float("inf")
    for _ in range(iters):
        t0 = time.perf_counter()
        x, opt = numpy_blr_step(x, opt, f64, y64, hierarchical, lr, b1, b2)
        best = min(best, time.perf_counter() - t0)
    assert np.isfinite(x).all()
    return x0.shape[0] / best


def bench_numpy_baseline(x0, mean, cov, iters):
    cov_inv = np.linalg.inv(cov)
    x = x0.astype(np.float64).copy()
    s = np.zeros_like(x)
    # warmup
    x, s = numpy_reference_step(x, s, mean, cov_inv)
    # best-of-N per-iteration time: conservative toward the baseline on a
    # loaded shared host (the device rate is steady; the CPU baseline isn't)
    best = float("inf")
    for _ in range(iters):
        t0 = time.perf_counter()
        x, s = numpy_reference_step(x, s, mean, cov_inv)
        best = min(best, time.perf_counter() - t0)
    return x0.shape[0] / best


# ----------------------------------------------------------------------
# Device path
# ----------------------------------------------------------------------


def _timed_run(svgd, iters, steps_per_call, return_state=False):
    """Warmup-compile then time chained scan segments, ending each timing
    in block_until_ready (JAX returns before the device finishes)."""
    import jax

    state = svgd.make_state()
    out = svgd._jit_run(state, steps_per_call)
    if svgd.mesh is not None:
        # Warm the CHAINED signature too: under a mesh an output state fed
        # back in may carry different shardings than make_state's and would
        # recompile once inside the timed region otherwise. (No mesh: the
        # signatures are identical — skip the extra segment.)
        out = svgd._jit_run(out[0], steps_per_call)
    jax.block_until_ready(out)
    calls = max(1, iters // steps_per_call)
    # Pre-place the initial state on the device: the host->device upload is
    # set-up, not sustained throughput.
    state = jax.block_until_ready(jax.device_put(state))
    t0 = time.perf_counter()
    st = state
    for _ in range(calls):
        st, _ = svgd._jit_run(st, steps_per_call)
    jax.block_until_ready(st)
    dt = time.perf_counter() - t0
    assert np.isfinite(np.asarray(st["coords"])).all()
    rate = calls * steps_per_call / dt  # iterations per second
    if return_state:
        return rate, st
    return rate


def posterior_metrics(coords, mean, cov, model):
    """Posterior-quality evidence from the device run (BASELINE.md
    correctness anchors, on the real f32 path): empirical-moment errors vs the
    target, normalized by the Monte-Carlo error of n exact samples (the
    tolerance class tests/test_examples.py uses), plus the KSD diagnostic.
    """
    from svgdcpp_jax.ops.ksd import ksd_rbf

    coords = np.asarray(coords, np.float64)
    n, d = coords.shape
    emp_mean = coords.mean(axis=0)
    emp_cov = np.cov(coords.T)
    mean = np.asarray(mean, np.float64)
    cov = np.asarray(cov, np.float64)
    # MC error of the mean of n iid samples per coordinate; the max
    # PER-COORDINATE ratio is the headline (ratio ~ O(1) = sampling-
    # quality) — each coordinate's error is normalized by its own MC scale.
    mean_mc = np.sqrt(np.diag(cov) / n)
    mean_err_ratio = float((np.abs(emp_mean - mean) / mean_mc).max())
    cov_rel_err = float(
        np.linalg.norm(emp_cov - cov) / np.linalg.norm(cov)
    )
    # Second moments in MC units: for n iid
    # Gaussian samples Var(emp_cov_ij) = (cov_ii cov_jj + cov_ij^2)/n,
    # so each entry's error is normalized by its own MC scale and the
    # max ratio is the headline (same convention as mean_err_over_mc).
    cov_mc = np.sqrt(
        (np.outer(np.diag(cov), np.diag(cov)) + cov**2) / n
    )
    cov_err_ratio = float((np.abs(emp_cov - cov) / cov_mc).max())
    # V-statistic: strictly positive, so the diagnostic stays informative
    # at convergence (the U-statistic clips to 0 there).
    ksd = float(ksd_rbf(model, coords.astype(np.float32), ustat=False))
    return {
        "mean_err_over_mc": round(mean_err_ratio, 3),
        "cov_rel_err": round(cov_rel_err, 4),
        "cov_err_over_mc": round(cov_err_ratio, 3),
        "ksd": float(f"{ksd:.4g}"),
    }


def bench_mvn(x0, mean, cov, iters, phi_impl="auto", steps_per_call=10,
              check_posterior=False, fused_bins=None):
    import svgdcpp_jax as sv

    n, dim = x0.shape
    model = sv.MultivariateNormal(mean.astype(np.float32), cov.astype(np.float32))
    kernel = sv.GaussianRBFKernel(
        x0.astype(np.float32), sv.ScaleMethod.MEDIAN, model
    )
    opts = dict(
        dimension=dim,
        num_iterations=steps_per_call,
        coordinate_matrix=x0.astype(np.float32),
        kernel=kernel,
        model=model,
        optimizer=sv.AdaGrad(dim, n, 0.1),
        phi_impl=phi_impl,
    )
    if fused_bins is not None:
        opts["fused_bins"] = int(fused_bins)
    svgd = sv.SVGD(sv.SVGDOptions(**opts))
    svgd.initialize()
    if not check_posterior:
        return n * _timed_run(svgd, iters, steps_per_call)
    rate, state = _timed_run(svgd, iters, steps_per_call, return_state=True)
    extras = posterior_metrics(state["coords"], mean, cov, model)
    return n * rate, extras


def anchor_checks():
    """Run the reference's two example anchors (BASELINE.md) on the current
    backend (f32 on the device) and report their pass/fail + moment errors —
    the same criteria as tests/test_examples.py's CPU-f64 lane."""
    import sys as _sys

    _sys.path.insert(0, str(Path(__file__).resolve().parent / "examples"))
    import gmm_example
    import mvn_example

    x0, final, mean, cov = mvn_example.run(verbose=False)
    tol = 2.0 * np.sqrt(np.diag(cov) / x0.shape[0])
    mean_err = np.abs(final.mean(axis=0) - mean)
    mvn_ok = bool(
        np.all(mean_err < tol)
        and np.all(final.std(axis=0) > 0.3 * np.sqrt(np.diag(cov)))
    )

    xg0, fg, (m1, c1), (m2, c2) = gmm_example.run(verbose=False)
    d1 = np.linalg.norm(fg - m1, axis=1)
    d2 = np.linalg.norm(fg - m2, axis=1)
    cl1 = fg[d1 < d2]
    cl2 = fg[d2 <= d1]
    gmm_ok = bool(
        len(cl1) >= 3 and len(cl2) >= 3
        and np.linalg.norm(cl1.mean(axis=0) - m1) < 1.5
        and np.linalg.norm(cl2.mean(axis=0) - m2) < 1.5
    )
    # Parity, not vibes: replay the exact config in the f64 NumPy oracle
    # from the same x0 and compare per-particle mode assignment + final
    # coordinates (the device's mode split must be what the reference
    # algorithm itself produces, not merely "bimodal").
    oracle = numpy_gmm_oracle(xg0, (m1, m2), (c1, c2), iters=1000)
    oracle_assign = (
        np.linalg.norm(oracle - m1, axis=1)
        < np.linalg.norm(oracle - m2, axis=1)
    )
    device_assign = d1 < d2
    return {
        "mvn_anchor_ok": mvn_ok,
        "mvn_anchor_mean_err_over_tol": round(float((mean_err / tol).max()), 3),
        "gmm_anchor_ok": gmm_ok,
        "gmm_anchor_modes": [int(len(cl1)), int(len(cl2))],
        "gmm_oracle_modes": [
            int(oracle_assign.sum()), int((~oracle_assign).sum()),
        ],
        "gmm_assign_matches_oracle": bool(
            np.array_equal(device_assign, oracle_assign)
        ),
        "gmm_max_coord_drift_vs_oracle": round(
            float(np.abs(fg - oracle).max()), 4
        ),
    }


def make_blr_workload(particles, dim=50, n_data=1024, hierarchical=False):
    """Deterministic BLR data + initial particles (shared by the device run
    and the NumPy baseline)."""
    from svgdcpp_jax.models.bayesian_logistic_regression import (
        make_synthetic_classification,
    )

    rng = np.random.default_rng(0)
    features, labels, _ = make_synthetic_classification(rng, n_data=n_data, dim=dim)
    full_dim = dim + 1 if hierarchical else dim
    x0 = rng.normal(size=(particles, full_dim)).astype(np.float32)
    return np.asarray(features), np.asarray(labels), x0


def build_blr_svgd(x0, features, labels, hierarchical=False, phi_impl="auto",
                   steps_per_call=100):
    """Construct the BLR / hierarchical-BLR driver (BASELINE configs 3-4).

    Single home for the workload construction — scripts/capture_trace.py
    traces exactly this object, so the trace cannot drift from the bench."""
    import svgdcpp_jax as sv

    particles, full_dim = x0.shape
    if hierarchical:
        model = sv.HierarchicalBayesianLogisticRegression(features, labels)
    else:
        model = sv.BayesianLogisticRegression(features, labels, 0.1)
    kernel = sv.GaussianRBFKernel(x0, sv.ScaleMethod.MEDIAN, model)
    if hierarchical:
        kernel = kernel + sv.GaussianRBFKernel(
            x0, sv.ScaleMethod.CONSTANT,
            constant_scale=0.1 * np.eye(full_dim, dtype=np.float32),
        )
    svgd = sv.SVGD(
        sv.SVGDOptions(
            dimension=full_dim, num_iterations=steps_per_call,
            coordinate_matrix=x0,
            kernel=kernel, model=model,
            optimizer=sv.Adam(full_dim, particles, 5e-2, 0.9, 0.999),
            phi_impl=phi_impl,
        )
    )
    svgd.initialize()
    return svgd


def bench_blr(x0, features, labels, iters, hierarchical=False, phi_impl="auto",
              steps_per_call=100):
    """BLR / hierarchical-BLR throughput (BASELINE configs 3-4)."""
    svgd = build_blr_svgd(
        x0, features, labels, hierarchical, phi_impl, steps_per_call
    )
    return x0.shape[0] * _timed_run(svgd, iters, steps_per_call)


def _require_gpu():
    """Exit non-zero unless JAX's backend is a GPU; return the device
    fields every result line carries."""
    import jax

    if jax.default_backend() != "gpu":
        sys.exit(
            f"bench.py: no GPU backend (JAX found {jax.default_backend()!r})"
        )
    d = jax.devices()
    return {"platform": d[0].platform, "kind": d[0].device_kind,
            "count": len(d)}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--particles", type=int, default=10_000)
    # Default is config-aware: 1000 iterations (the reference example
    # count) for mvn/hier; 4000 for the short-stepped BLR config so the
    # fixed per-run dispatch and sync stay a small part of the window.
    ap.add_argument("--iters", type=int, default=None)
    ap.add_argument("--baseline-iters", type=int, default=5)
    ap.add_argument("--impl", default="auto")
    ap.add_argument(
        "--steps-per-call", type=int, default=1000,
        help="scan-segment length; the reference's Run() contract is ONE "
        "call for a whole run, so long segments (amortized dispatch) are "
        "the faithful comparison; small segments re-pay the per-call "
        "dispatch and sync",
    )
    ap.add_argument("--quick", action="store_true", help="small fast run")
    ap.add_argument(
        "--check-posterior", action="store_true",
        help="after the timed run, report posterior-quality evidence in "
        "the JSON line: flagship moment errors + KSD (f32, lag-1 fused "
        "median) and the reference MVN/GMM anchor checks",
    )
    ap.add_argument(
        "--fused-bins", type=int, default=None,
        help="override SVGDOptions.fused_bins for the mvn config",
    )
    ap.add_argument(
        "--config",
        default="mvn",
        choices=["mvn", "blr", "hier"],
        help="mvn = primary metric (default); blr / hier = BASELINE configs 3-4",
    )
    args = ap.parse_args()
    if args.config != "mvn" and (
        args.check_posterior or args.fused_bins is not None
    ):
        # Fail loudly instead of silently skipping the check: the blr/hier
        # targets have no closed-form moments to compare against.
        ap.error(
            "--check-posterior/--fused-bins are only supported for "
            "--config mvn (the MVN target has closed-form moments)."
        )
    if args.fused_bins is not None and args.fused_bins < 2:
        ap.error("--fused-bins must be >= 2 (the two-rank selection plan "
                 "needs at least 3 edges).")
    device = _require_gpu()

    if args.iters is None:
        args.iters = 4000 if args.config == "blr" else 1000
    if args.quick:
        args.particles, args.iters, args.baseline_iters = 2048, 20, 2
    args.steps_per_call = min(args.steps_per_call, args.iters)

    if args.config == "blr":
        blr_n = 200 if args.quick else 1000
        blr_d = 10 if args.quick else 50
        features, labels, x0 = make_blr_workload(blr_n, dim=blr_d)
        rate = bench_blr(
            x0, features, labels, args.iters, phi_impl=args.impl,
            steps_per_call=args.steps_per_call,
        )
        vs = None
        if args.baseline_iters > 0:
            base = bench_numpy_blr_baseline(
                x0, features, labels, False, args.baseline_iters
            )
            vs = round(rate / base, 2)
        print(json.dumps({
            "metric": f"particle-updates/sec/chip (BLR d={blr_d}, N={blr_n}, RBF-median, Adam)",
            "value": round(rate, 1), "unit": "updates/s", "vs_baseline": vs,
            "device": device,
        }))
        return
    if args.config == "hier":
        # The composed-kernel config runs at the SAME particle count as the
        # primary metric — the tile-streamed generic phi has no O(n^2 m)
        # intermediate (ops/phi.py phi_generic_cross).
        hier_n = 512 if args.quick else 10_000
        features, labels, x0 = make_blr_workload(
            hier_n, dim=10, hierarchical=True
        )
        rate = bench_blr(
            x0, features, labels, args.iters, hierarchical=True,
            phi_impl=args.impl, steps_per_call=args.steps_per_call,
        )
        vs = None
        if args.baseline_iters > 0:
            base = bench_numpy_blr_baseline(
                x0, features, labels, True, args.baseline_iters
            )
            vs = round(rate / base, 2)
        print(json.dumps({
            "metric": f"particle-updates/sec/chip (hierarchical BLR, composed adaptive kernel, N={hier_n})",
            "value": round(rate, 1), "unit": "updates/s", "vs_baseline": vs,
            "device": device,
        }))
        return

    from svgdcpp_jax.utils.workloads import flagship_mvn

    dim = 2
    mean, cov, x0 = flagship_mvn(args.particles)

    extras = None
    if args.check_posterior:
        rate, extras = bench_mvn(
            x0, mean, cov, args.iters, args.impl,
            steps_per_call=args.steps_per_call, check_posterior=True,
            fused_bins=args.fused_bins,
        )
    else:
        rate = bench_mvn(
            x0, mean, cov, args.iters, args.impl,
            steps_per_call=args.steps_per_call, fused_bins=args.fused_bins,
        )
    if args.baseline_iters > 0:
        base_rate = bench_numpy_baseline(x0, mean, cov, args.baseline_iters)
        vs = round(rate / base_rate, 2)
    else:
        vs = None  # the NumPy O(n^2) baseline is infeasible at this size

    line = {
        "metric": f"particle-updates/sec/chip (N={args.particles}, d={dim}, RBF-median, AdaGrad)",
        "value": round(rate, 1),
        "unit": "updates/s",
        "vs_baseline": vs,
        "device": device,
    }
    if extras is not None:
        line["posterior"] = extras
        line["anchors"] = anchor_checks()
    print(json.dumps(line))


if __name__ == "__main__":
    from svgdcpp_jax.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    main()
