"""Compiled per-device memory proof: ring vs gather sharded step.

Ring mode claims an O(n*m/D) per-device working set (parallel/ring.py)
where gather mode materializes the full O(n*m) gathered coordinate/score
buffers per device. This script compiles BOTH steps at a large-n shape on the 8-device simulated
mesh and records `compiled.memory_analysis()` (XLA's own buffer
assignment): argument/output/temp bytes per device.

    python scripts/measure_sharded_memory.py [n_global] [--json out]
"""

import json
import os
import sys
from pathlib import Path

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402

import svgdcpp_jax as sv  # noqa: E402
from svgdcpp_jax.parallel import (  # noqa: E402
    ShardedSVGD,
    ShardedSVGDConfig,
    make_particle_mesh,
)


def analyze(mode, n, mesh, x0, mean, cov):
    dim = x0.shape[1]
    model = sv.MultivariateNormal(mean, cov)
    config = ShardedSVGDConfig(
        scale_method=sv.ScaleMethod.MEDIAN, phi_mode=mode,
        median_bins=16, median_passes=3, row_tile=256,
    )
    sharded = ShardedSVGD(
        model, sv.AdaGrad(dim, n, 0.1), num_particles=n, dimension=dim,
        mesh=mesh, config=config,
    )
    state = sharded.init_state(x0)
    step = jax.jit(sharded.step_fn)
    ma = step.lower(state).compile().memory_analysis()
    return {
        "metric": f"sharded step memory ({mode}, {len(mesh.devices.flat)} "
                  f"devices, n={n}, m={dim})",
        "argument_bytes": int(ma.argument_size_in_bytes),
        "output_bytes": int(ma.output_size_in_bytes),
        "temp_bytes": int(ma.temp_size_in_bytes),
        "temp_bytes_per_device": int(
            ma.temp_size_in_bytes // len(mesh.devices.flat)
        ),
    }


def main():
    args = [a for a in sys.argv[1:] if not a.startswith("--")]
    n = int(args[0]) if args else 262144
    json_path = None
    if "--json" in sys.argv:
        json_path = sys.argv[sys.argv.index("--json") + 1]
    devices = jax.devices()
    mesh = make_particle_mesh(devices)
    from svgdcpp_jax.utils.workloads import flagship_mvn

    mean, cov, x0 = flagship_mvn(n, dtype=np.float32)
    lines = []
    for mode in ("gather", "ring"):
        line = analyze(mode, n, mesh, x0, mean, cov)
        # context: the gathered global buffers are n*m*4 bytes each and, on
        # the simulated mesh, appear in EVERY device's temp allocation.
        line["global_coords_bytes"] = int(n * x0.shape[1] * 4)
        line["local_shard_bytes"] = int(
            n * x0.shape[1] * 4 // len(devices)
        )
        print(json.dumps(line), flush=True)
        lines.append(line)
    if json_path:
        with open(json_path, "a") as f:
            for line in lines:
                f.write(json.dumps(line) + "\n")


if __name__ == "__main__":
    main()
