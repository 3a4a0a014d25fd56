"""Large-scale SVGD: the fused single-sweep production path.

The reference's examples stop at tens of particles (mvn_example.cpp:19 uses
10); this example runs the same MVN workload at 10k-1M+ particles, where
each step is ONE fused O(n^2) sweep computing phi and the median-selection
counts together (phi_impl='auto' picks the fused Pallas kernel on an
NVIDIA GPU, the XLA tile loop elsewhere — see PERF.md). Prints per-step
timing, throughput, and the kernel Stein discrepancy before/after as the
convergence check.

    python examples/large_scale_example.py [num_particles] [num_iterations]

Defaults are sized for one GPU (100k particles); on CPU pass a smaller
count (e.g. 4096). run() continues in place (the reference's
SVGD.hpp:393 contract), so a long run can be split into several calls.
"""

import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import svgdcpp_jax as sv
from svgdcpp_jax.utils.workloads import flagship_mvn


def run(num_particles=100_000, num_iterations=100, seed=0, verbose=True):
    mean, cov, x0 = flagship_mvn(num_particles, seed=seed, dtype=np.float32)
    dim = x0.shape[1]

    model = sv.MultivariateNormal(mean, cov)
    kernel = sv.GaussianRBFKernel(x0, sv.ScaleMethod.MEDIAN, model)
    svgd = sv.SVGD(
        sv.SVGDOptions(
            dimension=dim,
            num_iterations=num_iterations,
            coordinate_matrix=x0.copy(),
            kernel=kernel,
            model=model,
            optimizer=sv.AdaGrad(dim, num_particles, 0.1),
        )
    )
    svgd.initialize()
    if verbose:
        print(f"phi_impl={svgd._phi_impl}  n={num_particles}  d={dim}")

    ksd_before = float(sv.ksd_rbf(model, x0))

    # First run compiles the whole-run device program and IS the advertised
    # num_iterations trajectory: convergence stats come from its output. The
    # second run (continuing in place, reference in-place contract
    # SVGD.hpp:393) is timed for steady-state throughput only — it excludes
    # compile time, and per-step cost is shape- not value-dependent. Sync via
    # host transfer: this transport's block_until_ready can return before
    # remote completion.
    out = np.asarray(svgd.run())
    ksd_after = float(sv.ksd_rbf(model, out))

    t0 = time.perf_counter()
    np.asarray(svgd.run())
    dt = time.perf_counter() - t0
    rate = num_particles * num_iterations / dt
    if verbose:
        print(
            f"{1e3 * dt / num_iterations:.3f} ms/step, "
            f"{rate:,.0f} particle-updates/s"
        )
        print(f"KSD before {ksd_before:.4f} -> after {ksd_after:.4f}")
        print(f"particle mean: {out.mean(0)}  (target {mean})")
    assert np.isfinite(out).all()
    return out, ksd_before, ksd_after


if __name__ == "__main__":
    from svgdcpp_jax.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 100_000
    iters = int(sys.argv[2]) if len(sys.argv) > 2 else 100
    run(n, iters)
