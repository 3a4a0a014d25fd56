"""Multi-device SVGD example: particle-axis sharding over a device mesh.

The reference's only parallelism is OpenMP threads over particles
(reference SVGD.hpp:418-431, doc/instructions.md:385-398); the multi-device
generalization shards the particle axis over a ``jax.sharding.Mesh`` —
each device owns a block of particles, and the two globally coupled
computations (cross-shard kernel blocks of φ̂, the global pairwise-distance
median) run over collectives (see docs/instructions.md "Multi-chip
execution" and svgdcpp_jax/parallel/sharded.py).

Runs anywhere: on a real multi-chip slice the mesh spans the chips (call
``sv.initialize_distributed(...)`` first on each host); on a single-device
or CPU environment it demonstrates the same program on whatever devices
exist. To simulate 8 devices on CPU:

    XLA_FLAGS=--xla_force_host_platform_device_count=8 \
        JAX_PLATFORMS=cpu python examples/sharded_example.py

    python examples/sharded_example.py [num_particles] [num_iterations]
"""

import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import svgdcpp_jax as sv
from svgdcpp_jax.ops.ksd import ksd_rbf
from svgdcpp_jax.parallel import (
    ShardedSVGD,
    ShardedSVGDConfig,
    make_particle_mesh,
)
from svgdcpp_jax.utils.workloads import flagship_mvn


def run(num_particles=4096, num_iterations=200, seed=0, verbose=True):
    import jax

    mesh = make_particle_mesh()
    n_dev = mesh.devices.size
    if num_particles < n_dev:
        raise ValueError(
            f"num_particles ({num_particles}) must be >= the device count "
            f"({n_dev}): each device owns at least one particle row."
        )
    # The particle count must split evenly over the mesh.
    n = (num_particles // n_dev) * n_dev
    mean, cov, x0 = flagship_mvn(n, seed=seed, dtype=np.float32)
    dim = x0.shape[1]

    model = sv.MultivariateNormal(mean, cov)
    sharded = ShardedSVGD(
        model,
        sv.AdaGrad(dim, n, 0.1),
        num_particles=n,
        dimension=dim,
        mesh=mesh,
        # fused_phi: ONE cross-shard O(n^2/D) sweep per step computes φ̂
        # and the (psum'ed) median-selection counts; on a GPU backend it
        # runs as the per-device fused Pallas kernel.
        config=ShardedSVGDConfig(fused_phi=True),
    )

    ksd0 = float(ksd_rbf(model, x0))
    if verbose:
        print(
            f"mesh: {n_dev} device(s) on {jax.default_backend()}, "
            f"{n // n_dev} particles/device"
        )
    final = np.asarray(sharded.run(x0, num_iterations))
    ksd1 = float(ksd_rbf(model, final))
    if verbose:
        shards = sharded._state["coords"].sharding
        print(f"coords sharding: {shards}")
        print(f"KSD before: {ksd0:.4f}  after: {ksd1:.4f}")
        print(f"posterior mean: {final.mean(axis=0)}  (target {mean})")
    return x0, final, ksd0, ksd1


if __name__ == "__main__":
    from svgdcpp_jax.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    run(
        int(sys.argv[1]) if len(sys.argv) > 1 else 4096,
        int(sys.argv[2]) if len(sys.argv) > 2 else 200,
    )
