"""Device-mesh helpers for particle-axis sharding.

The reference's only parallelism is OpenMP shared-memory threading over
particles (reference SVGD.hpp:276-285, 380-390, 418-431; Core.hpp:83-106).
The multi-device generalization (SURVEY.md §2) is particle-axis sharding
over a 1-D ``jax.sharding.Mesh``: each device owns a contiguous block of particles and
the globally-coupled computations (n x n kernel blocks, the pairwise-distance
median) run over collectives (NCCL between GPUs) — see ``sharded.py``.
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec

PARTICLE_AXIS = "particles"


def make_particle_mesh(
    devices: Optional[Sequence] = None, axis_name: str = PARTICLE_AXIS
) -> Mesh:
    """A 1-D mesh over all (or the given) devices, named for particles."""
    if devices is None:
        devices = jax.devices()
    import numpy as np

    return Mesh(np.asarray(devices), (axis_name,))


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None):
    """Multi-host initialization for real pod slices.

    Thin wrapper over ``jax.distributed.initialize`` (no-op if already
    initialized or single-process): call once per host before building a
    mesh; afterwards ``jax.devices()`` spans the whole slice and
    :func:`make_particle_mesh` shards particles across hosts — collectives
    ride the intra-host interconnect and the network across hosts,
    scheduled by XLA.
    """
    try:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
    except (RuntimeError, ValueError):
        if (coordinator_address is not None or num_processes is not None
                or process_id is not None):
            # ANY explicitly configured multi-host init that fails must NOT
            # silently degrade to single-process (each host would run the
            # full problem independently) — including env/pod-metadata-based
            # configs where only num_processes/process_id were passed.
            raise
        # no-op cases: already initialized, or single-process without any
        # distributed configuration
    return jax.devices()


def particle_sharding(mesh: Mesh) -> NamedSharding:
    """Row-sharded (n, m) placement: particles split, coordinates replicated."""
    return NamedSharding(mesh, PartitionSpec(mesh.axis_names[0], None))


def place_sharded(x, sharding: NamedSharding, exact: bool = False):
    """Place a logically-global array under ``sharding``.

    On a fully-addressable (single-process) mesh this is a plain
    device_put; in a multi-process mesh remote shards are NOT addressable,
    so each process contributes its local rows via
    make_array_from_callback — every process passes the same logical
    global array. Single home shared by ShardedSVGD.init_state and the
    driver's make_state (SVGDOptions.mesh).

    ``exact=True`` keeps an array only when its sharding EQUALS the
    target (jit caches on the sharding object's spec, so
    equivalent-but-differently-spec'ed leaves — GSPMD output drift —
    would recompile a chained call); the default keeps any equivalent
    NamedSharding placement.
    """
    if isinstance(x, jax.Array) and (
        x.sharding == sharding
        if exact
        else (
            isinstance(x.sharding, NamedSharding)
            and x.sharding.is_equivalent_to(sharding, x.ndim)
        )
    ):
        # Already placed (e.g. a previous run/step's output chained back in
        # on a multi-process mesh) — np.asarray on it would raise because
        # remote shards are not addressable, and re-placing is wasted work.
        # NamedSharding only: a merely-EQUIVALENT SingleDeviceSharding (a
        # device_put'ed array on a 1-device mesh) must still be normalized,
        # or the jit signature of a fresh state differs from a chained
        # output state and the second run_state call recompiles (the
        # sharded mirror of the driver's chained-run fix).
        return x
    if sharding.is_fully_addressable:
        return jax.device_put(x, sharding)
    if isinstance(x, jax.Array) and not x.is_fully_addressable:
        # Differently-sharded distributed array: reshard with a jitted
        # identity (XLA inserts the cross-process collectives); host
        # fetch is impossible here.
        return jax.jit(lambda a: a, out_shardings=sharding)(x)
    import numpy as np

    host = np.asarray(x)
    return jax.make_array_from_callback(
        host.shape, sharding, lambda idx: host[idx]
    )


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, PartitionSpec())
