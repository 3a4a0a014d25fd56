"""Isolate the collective (communication) cost of the sharded SVGD step.

A measured compute-vs-collective split on the simulated 8-device CPU mesh
(instead of a cores/D ceiling guess): run the
identical shard_map step twice, once real and once with every cross-device
collective stubbed to a local, shape/type-preserving surrogate, and report

    comm_fraction = (t_real - t_stub) / t_real

per phi mode. Stubs (patched at jax.lax before TRACING, so the stubbed
program simply contains no collective ops):

    all_gather(x)  -> tile/stack of the LOCAL shard (the output buffer is
                      still written, so only the transfer is removed)
    ppermute(x)    -> identity

psum/pmax stay REAL: (a) their payloads are O(bins) histograms and scalars
— bytes, not the O(n*m) bulk the gathers move — and (b) their outputs are
replicated-VMA-typed, which no local surrogate can produce under
check_vma. The measured comm_fraction is therefore the BULK-collective
fraction (gather/stream transfers), the part that scales with n.

Writes one JSON line per (mode, D): t_real_ms, t_stub_ms, comm_fraction.

    python scripts/measure_collective_cost.py [gather ring fused] [--json out]
"""

import json
import os
import sys
import time
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
import jax.numpy as jnp  # noqa: E402

import svgdcpp_jax as sv  # noqa: E402
from svgdcpp_jax.parallel import (  # noqa: E402
    ShardedSVGD,
    ShardedSVGDConfig,
    make_particle_mesh,
)

N_PER_DEVICE = int(os.environ.get("COLLECTIVE_COST_N_PER_DEVICE", 4096))
ITERS = int(os.environ.get("COLLECTIVE_COST_ITERS", 5))

_real_all_gather = jax.lax.all_gather
_real_ppermute = jax.lax.ppermute


def _axis_size(axis_name):
    return jax.lax.axis_size(axis_name)


def _stub_all_gather(x, axis_name, *, axis=0, tiled=False, **kw):
    d = _axis_size(axis_name)
    reps = [1] * x.ndim
    if tiled:
        reps[axis] = d
        out = jnp.tile(x, reps)
    else:
        out = jnp.broadcast_to(
            jnp.expand_dims(x, axis),
            x.shape[:axis] + (d,) + x.shape[axis:],
        )
    return out


def _stub_ppermute(x, axis_name, perm, **kw):
    return x


def build(mode, n_devices):
    devices = jax.devices()[:n_devices]
    mesh = make_particle_mesh(devices)
    from svgdcpp_jax.utils.workloads import flagship_mvn

    n = N_PER_DEVICE * n_devices
    dim = 2
    mean, cov, x0 = flagship_mvn(n, dtype=np.float32)
    model = sv.MultivariateNormal(mean, cov)
    if mode == "fused":
        config = ShardedSVGDConfig(
            scale_method=sv.ScaleMethod.MEDIAN, fused_phi=True, row_tile=256,
        )
    else:
        config = ShardedSVGDConfig(
            scale_method=sv.ScaleMethod.MEDIAN, phi_mode=mode,
            median_bins=16, median_passes=3, row_tile=256,
        )
    sharded = ShardedSVGD(
        model, sv.AdaGrad(dim, n, 0.1), num_particles=n, dimension=dim,
        mesh=mesh, config=config,
    )
    return sharded, sharded.init_state(x0)


def time_run(sharded, state):
    out, _ = sharded.run_fn(state, ITERS)
    np.asarray(out["coords"])  # warm/compile
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        out, _ = sharded.run_fn(state, ITERS)
        np.asarray(out["coords"])
        best = min(best, time.perf_counter() - t0)
    return best / ITERS * 1e3  # ms/step


def main():
    args = [a for a in sys.argv[1:] if not a.startswith("--")]
    modes = args or ["gather", "ring", "fused"]
    json_path = None
    if "--json" in sys.argv:
        json_path = sys.argv[sys.argv.index("--json") + 1]
    d = len(jax.devices())
    lines = []
    for mode in modes:
        sharded, state = build(mode, d)
        t_real = time_run(sharded, state)

        # Patch BEFORE tracing the stubbed program: a fresh engine re-traces.
        jax.lax.all_gather = _stub_all_gather
        jax.lax.ppermute = _stub_ppermute
        try:
            sharded_s, state_s = build(mode, d)
            t_stub = time_run(sharded_s, state_s)
        finally:
            jax.lax.all_gather = _real_all_gather
            jax.lax.ppermute = _real_ppermute

        line = {
            "metric": f"collective cost ({mode}, {d} simulated devices, "
                      f"{N_PER_DEVICE}/dev)",
            "t_real_ms_per_step": round(t_real, 3),
            "t_stub_ms_per_step": round(t_stub, 3),
            "comm_fraction": round(max(0.0, (t_real - t_stub) / t_real), 4),
        }
        print(json.dumps(line), flush=True)
        lines.append(line)
    if json_path:
        with open(json_path, "a") as f:
            for line in lines:
                f.write(json.dumps(line) + "\n")


if __name__ == "__main__":
    main()
