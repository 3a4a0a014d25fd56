"""Capture a jax.profiler trace of the flagship step on the GPU.

Evidence of where a step's time goes: writes a perfetto/xplane trace
directory plus a one-line summary of the measured step time.

    python scripts/capture_trace.py [outdir=build/traces] [n=10000] [impl=auto] [config=mvn]

config=hier traces the composed-adaptive-kernel workload (the
fused_terms_pallas path) instead of the flagship MVN. The trace directory
can be opened with xprof/tensorboard or perfetto.
"""

import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def main(outdir="build/traces", n="10000", impl="auto", config="mvn"):
    import jax

    import svgdcpp_jax as sv

    n = int(n)
    out = Path(outdir)
    out.mkdir(parents=True, exist_ok=True)

    if config == "hier":
        # The hierarchical-BLR bench workload: EXACTLY bench.py --config
        # hier's construction (single-homed in bench.build_blr_svgd so
        # the trace cannot drift from the benchmark it represents).
        import bench as bench_mod

        features, labels, x0 = bench_mod.make_blr_workload(
            n, dim=10, hierarchical=True
        )
        svgd = bench_mod.build_blr_svgd(
            x0, features, labels, hierarchical=True, phi_impl=impl,
            steps_per_call=10,
        )
    elif config == "blr":
        # BASELINE config 3's shape family (d=50): the small-n regime.
        import bench as bench_mod

        features, labels, x0 = bench_mod.make_blr_workload(n, dim=50)
        svgd = bench_mod.build_blr_svgd(
            x0, features, labels, hierarchical=False, phi_impl=impl,
            steps_per_call=10,
        )
    else:
        from svgdcpp_jax.utils.workloads import flagship_mvn

        mean, cov, x0 = flagship_mvn(n, dtype=np.float32)
        dim = 2
        model = sv.MultivariateNormal(mean, cov)
        kernel = sv.GaussianRBFKernel(x0, sv.ScaleMethod.MEDIAN, model)
        svgd = sv.SVGD(
            sv.SVGDOptions(
                dimension=dim, num_iterations=10, coordinate_matrix=x0,
                kernel=kernel, model=model,
                optimizer=sv.AdaGrad(dim, n, 0.1), phi_impl=impl,
            )
        )
    svgd.initialize()
    state = svgd.make_state()

    # Warm up (compile) outside the trace.
    jax.block_until_ready(svgd._jit_run(state, 10))

    steps = 50
    with jax.profiler.trace(str(out)):
        t0 = time.perf_counter()
        st = state
        for _ in range(steps // 10):
            st, _ = svgd._jit_run(st, 10)
        jax.block_until_ready(st)
        dt = time.perf_counter() - t0
    per_step_ms = 1e3 * dt / steps
    summary = (
        f"impl={svgd._phi_impl} n={n}: {per_step_ms:.3f} ms/step "
        f"({n / (dt / steps):,.0f} updates/s) over {steps} traced steps\n"
    )
    (out / "SUMMARY.txt").write_text(summary)
    print(summary.strip())
    print(f"trace written to {out}")


if __name__ == "__main__":
    from svgdcpp_jax.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    main(*sys.argv[1:])
