"""Worker for the 2-process distributed test (run as a subprocess).

Usage: python multiproc_worker.py <process_id> <num_processes> <port> <outdir>

Each process owns 4 simulated CPU devices; jax.distributed.initialize joins
them into one 8-device mesh spanning process boundaries. One ShardedSVGD
run executes with real cross-process collectives (all-gather of the coords,
psum'ed median histograms); each process writes its addressable row shards
to <outdir>/shard_<pid>.npz for the parent to reassemble and verify.

This is the executable proof of the multi-host path (SURVEY.md §7 slice 3,
generalizing the reference's process-wide OpenMP runtime setup,
Core.hpp:83-106).
"""

import os
import sys
from pathlib import Path

pid, nproc, port, outdir = (
    int(sys.argv[1]),
    int(sys.argv[2]),
    sys.argv[3],
    Path(sys.argv[4]),
)

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import jax  # noqa: E402

# Platform + x64 must be pinned BEFORE the first device query (which would
# otherwise initialize whatever accelerator backend is present).
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
jax.distributed.initialize(
    coordinator_address=f"localhost:{port}",
    num_processes=nproc,
    process_id=pid,
)

import numpy as np  # noqa: E402

import svgdcpp_jax as sv  # noqa: E402
from svgdcpp_jax.parallel import (  # noqa: E402
    ShardedSVGD,
    ShardedSVGDConfig,
    make_particle_mesh,
)

assert jax.process_count() == nproc, jax.process_count()
assert len(jax.devices()) == 4 * nproc, len(jax.devices())

n, dim, iters = 16, 2, 3
rng = np.random.default_rng(0)
x0 = rng.normal(size=(n, dim)) * 2
mean, cov = np.zeros(dim), np.eye(dim)

model = sv.MultivariateNormal(mean, cov)
sharded = ShardedSVGD(
    model,
    sv.AdaGrad(dim, n, 0.1),
    num_particles=n,
    dimension=dim,
    mesh=make_particle_mesh(),
    config=ShardedSVGDConfig(
        scale_method=sv.ScaleMethod.MEDIAN,
        median_bins=16,
        median_passes=10,
        row_tile=4,
        warm_start=False,
    ),
)
state = sharded.run_state(sharded.init_state(x0), iters)
coords = state["coords"]
assert not coords.sharding.is_fully_addressable  # genuinely cross-process

# Cross-process checkpoint roundtrip: 2 steps -> save -> restore -> 1 step
# must equal the straight 3-step run (per-process shard comparison).
from svgdcpp_jax.utils.checkpoint import restore_checkpoint, save_checkpoint

mid = sharded.run_state(sharded.init_state(x0), 2)
save_checkpoint(outdir / "mp_ck", mid, step=2)
# process 0 writes the file; all processes read it back — barrier first
from jax.experimental import multihost_utils

multihost_utils.sync_global_devices("ckpt_written")
restored, step = restore_checkpoint(outdir / "mp_ck", sharded.init_state(x0))
assert step == 2
resumed = sharded.run_state(restored, 1)
for s_a, s_b in zip(
    coords.addressable_shards, resumed["coords"].addressable_shards
):
    np.testing.assert_allclose(
        np.asarray(s_a.data), np.asarray(s_b.data), rtol=1e-12, atol=1e-15
    )
print(f"worker {pid}: ckpt OK", flush=True)

# Ring mode across process boundaries: the ppermute rotation schedule and
# the gather-free ring median must produce the SAME trajectory as the
# gather run above (collectives ride the cross-process transport).
ring = ShardedSVGD(
    sv.MultivariateNormal(mean, cov),
    sv.AdaGrad(dim, n, 0.1),
    num_particles=n,
    dimension=dim,
    mesh=make_particle_mesh(),
    config=ShardedSVGDConfig(
        scale_method=sv.ScaleMethod.MEDIAN,
        phi_mode="ring",
        median_bins=16,
        median_passes=10,
        row_tile=4,
        warm_start=False,
    ),
)
rstate = ring.run_state(ring.init_state(x0), iters)
for s_a, s_b in zip(
    coords.addressable_shards, rstate["coords"].addressable_shards
):
    np.testing.assert_allclose(
        np.asarray(s_a.data), np.asarray(s_b.data), rtol=1e-9, atol=1e-12
    )
print(f"worker {pid}: ring OK", flush=True)

# Fused single-sweep mode across process boundaries: the lag-1 fused
# median's psum'ed selection counts ride the cross-process transport.
fused = ShardedSVGD(
    sv.MultivariateNormal(mean, cov),
    sv.AdaGrad(dim, n, 0.1),
    num_particles=n,
    dimension=dim,
    mesh=make_particle_mesh(),
    config=ShardedSVGDConfig(
        scale_method=sv.ScaleMethod.MEDIAN,
        fused_phi=True,
        row_tile=4,
    ),
)
fstate = fused.run_state(fused.init_state(x0), iters)
f_rows, f_starts = [], []
for shard in fstate["coords"].addressable_shards:
    f_starts.append(shard.index[0].start or 0)
    f_rows.append(np.asarray(shard.data))
np.savez(
    outdir / f"fused_shard_{pid}.npz",
    starts=np.asarray(f_starts), rows=np.asarray(f_rows),
)
print(f"worker {pid}: fused OK", flush=True)

# Driver GSPMD mesh path across process boundaries (SVGDOptions.mesh):
# make_state's multi-process-safe placement (parallel/mesh.place_sharded)
# + the XLA fused sweep partitioned by GSPMD. Each process's addressable
# row shards must equal the corresponding rows of a process-LOCAL no-mesh
# run of the identical problem (deterministic in f64).


def _build_driver(mesh_opt):
    model_d = sv.MultivariateNormal(mean, cov)
    kernel_d = sv.GaussianRBFKernel(x0, sv.ScaleMethod.MEDIAN, model_d)
    return sv.SVGD(
        sv.SVGDOptions(
            dimension=dim, num_iterations=iters,
            coordinate_matrix=x0.copy(), kernel=kernel_d, model=model_d,
            optimizer=sv.AdaGrad(dim, n, 0.1), phi_impl="fused",
            mesh=mesh_opt,
        )
    )


drv = _build_driver(make_particle_mesh())
drv.initialize()
out_mesh = drv.run()
assert not out_mesh.sharding.is_fully_addressable  # genuinely cross-process
local_drv = _build_driver(None)
local_drv.initialize()
ref_local = np.asarray(local_drv.run())
for shard in out_mesh.addressable_shards:
    start = shard.index[0].start or 0
    rows_d = np.asarray(shard.data)
    np.testing.assert_allclose(
        rows_d, ref_local[start : start + rows_d.shape[0]],
        rtol=1e-9, atol=1e-12,
    )
print(f"worker {pid}: driver-mesh OK", flush=True)

# Chained run: the reference's Run() continues in place (SVGD.hpp:338-366,
# usage contract doc/instructions.md:86-93), so a SECOND run() must work
# with the first run's COMMITTED cross-process output as input
# (make_state -> place_sharded on non-addressable arrays) and match a
# local 2x run. Also exercises step() once (same placement path).
drv.run()
drv.step()
local_drv.run()
local_drv.step()
ref_local2 = np.asarray(local_drv.store.value)
for shard in drv.store.value.addressable_shards:
    start = shard.index[0].start or 0
    rows_d = np.asarray(shard.data)
    np.testing.assert_allclose(
        rows_d, ref_local2[start : start + rows_d.shape[0]],
        rtol=1e-9, atol=1e-12,
    )
print(f"worker {pid}: driver-mesh-chained OK", flush=True)

rows = []
starts = []
for shard in coords.addressable_shards:
    starts.append(shard.index[0].start or 0)
    rows.append(np.asarray(shard.data))
np.savez(outdir / f"shard_{pid}.npz", starts=np.asarray(starts), rows=np.asarray(rows))
print(f"worker {pid}: OK", flush=True)
