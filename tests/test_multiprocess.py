"""Two-process distributed execution proof (SURVEY.md §7 slice 3).

Spawns two subprocesses, each owning 4 simulated CPU devices, joined by
``jax.distributed.initialize`` over a localhost coordinator into one
8-device mesh. The sharded SVGD run executes with REAL cross-process
collectives; the reassembled trajectory must match the same run on this
process's single-process 8-device mesh.

The reference analog being generalized is the process-wide parallel runtime
setup (reference Core.hpp:83-106 — OpenMP/CppAD thread registration).
"""

import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import svgdcpp_jax as sv
from svgdcpp_jax.parallel import ShardedSVGD, ShardedSVGDConfig, make_particle_mesh


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_two_process_sharded_run(tmp_path):
    port = _free_port()
    worker = Path(__file__).parent / "multiproc_worker.py"
    procs = [
        subprocess.Popen(
            [sys.executable, str(worker), str(pid), "2", str(port), str(tmp_path)],
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
            text=True,
        )
        for pid in range(2)
    ]
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=150)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        outs.append(out)
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {pid} failed:\n{out}"
        assert f"worker {pid}: OK" in out
        # cross-process checkpoint roundtrip resumed exactly
        assert f"worker {pid}: ckpt OK" in out
        # ppermute ring schedule matched the gather trajectory
        assert f"worker {pid}: ring OK" in out
        # fused single-sweep (psum'ed lag-1 selection counts) ran
        assert f"worker {pid}: fused OK" in out
        # driver SVGDOptions.mesh path (GSPMD + multi-process placement)
        assert f"worker {pid}: driver-mesh OK" in out
        # second run()/step() chained the committed cross-process output
        # back through make_state (place_sharded on non-addressable arrays)
        assert f"worker {pid}: driver-mesh-chained OK" in out

    # Reassemble the global (16, 2) result from both processes' row shards.
    n, dim, iters = 16, 2, 3
    result = np.full((n, dim), np.nan)
    for pid in range(2):
        data = np.load(tmp_path / f"shard_{pid}.npz")
        for start, rows in zip(data["starts"], data["rows"]):
            result[int(start) : int(start) + rows.shape[0]] = rows
    assert np.isfinite(result).all()

    # Single-process reference on this process's own 8-device mesh,
    # identical config and inputs (worker uses rng seed 0).
    rng = np.random.default_rng(0)
    x0 = rng.normal(size=(n, dim)) * 2
    model = sv.MultivariateNormal(np.zeros(dim), np.eye(dim))
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
    expect = np.asarray(sharded.run(x0, iters))
    np.testing.assert_allclose(result, expect, rtol=1e-9, atol=1e-12)

    # Fused-mode cross-process trajectory == the same fused run on this
    # process's single-process 8-device mesh (identical device count and
    # reduction layout, so f64 trajectories match tightly).
    f_result = np.full((n, dim), np.nan)
    for pid in range(2):
        data = np.load(tmp_path / f"fused_shard_{pid}.npz")
        for start, rows in zip(data["starts"], data["rows"]):
            f_result[int(start) : int(start) + rows.shape[0]] = rows
    assert np.isfinite(f_result).all()
    fused = ShardedSVGD(
        sv.MultivariateNormal(np.zeros(dim), np.eye(dim)),
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
    f_expect = np.asarray(fused.run(x0, iters))
    np.testing.assert_allclose(f_result, f_expect, rtol=1e-9, atol=1e-12)
