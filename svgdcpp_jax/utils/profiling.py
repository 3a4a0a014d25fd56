"""Profiling / timing harness.

The reference has no tracing or profiling (SURVEY.md §5). Here:

  * ``step_timer`` — wall-clock per-step timing, synced by blocking on
    every leaf of the state.
  * ``trace`` — context manager around ``jax.profiler`` emitting an xplane
    trace directory viewable in TensorBoard/XProf.
  * ``speed_of_light`` — roofline estimate for the RBF phi step against the
    device's published peaks (``PEAKS``, keyed by ``device_kind``), so
    measured throughput can be judged against hardware limits.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Callable

import jax
import numpy as np


def sync(tree):
    """Block until every leaf of ``tree`` is computed.

    Blocking on a single leaf is not enough: a passthrough leaf (e.g. a
    constant carried through the state pytree) can already be ready while
    the leaf produced by the final dispatch is still executing.
    """
    jax.block_until_ready(jax.tree.leaves(tree))
    return tree


@dataclasses.dataclass
class StepTiming:
    mean_s: float
    p50_s: float
    p90_s: float
    steps: int

    @property
    def steps_per_s(self) -> float:
        return 1.0 / self.mean_s if self.mean_s else float("inf")


def step_timer(step_fn: Callable, state, *, steps: int = 20, warmup: int = 2,
               chunk: int = 5) -> StepTiming:
    """Time a state->state step function with chunked sync.

    Runs ``chunk`` dependent steps per measurement to amortize the host
    dispatch, syncing after each chunk.
    """
    for _ in range(warmup):
        state = step_fn(state)
    sync(state)
    times = []
    done = 0
    while done < steps:
        t0 = time.perf_counter()
        for _ in range(chunk):
            state = step_fn(state)
        sync(state)
        times.append((time.perf_counter() - t0) / chunk)
        done += chunk
    arr = np.asarray(times)
    return StepTiming(float(arr.mean()), float(np.percentile(arr, 50)),
                      float(np.percentile(arr, 90)), done)


@contextlib.contextmanager
def trace(log_dir: str = "/tmp/svgd-trace"):
    """jax.profiler trace context; view with TensorBoard/XProf."""
    jax.profiler.start_trace(log_dir)
    try:
        yield log_dir
    finally:
        jax.profiler.stop_trace()


#: Published dense peaks per ``jax.devices()[0].device_kind`` (NVIDIA H100
#: SXM data sheet): FLOP/s for f32 outside the tensor cores, TF32 and bf16
#: tensor-core rates, and HBM bytes/s. Assumes the card's full 700 W power
#: limit; a card set lower cannot hold its top clock under load.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "f32_flops": 67e12,
        "tf32_flops": 495e12,
        "bf16_flops": 989e12,
        "hbm_bytes": 3.35e12,
    },
}


def device_peaks(device_kind: str) -> dict:
    """The PEAKS entry for ``device_kind``; an unknown device is an error
    (a default would put a wrong roofline under a real measurement)."""
    try:
        return PEAKS[device_kind]
    except KeyError:
        raise KeyError(
            f"no published peaks for device_kind {device_kind!r}; add it to "
            "svgdcpp_jax.utils.profiling.PEAKS with its source"
        ) from None


def speed_of_light(n: int, m: int, device_kind: str) -> float:
    """Roofline estimate (seconds) for one fused RBF phi sweep at (n, m).

    Every dot on the phi path runs at f32 (ops/pairwise.DOT_PRECISION), so
    the n^2 x (2m+1) contraction, the n^2 x m distance work and ~6
    elementwise ops per pair (quad assembly, exp, compares) are all
    counted at the f32 rate; I/O is O(n m).
    """
    peaks = device_peaks(device_kind)
    flops = 2.0 * n * n * (2 * m + 1) + 2.0 * n * n * m + 6.0 * n * n
    t_compute = flops / peaks["f32_flops"]
    t_mem = (n * m * 4.0 * 6.0) / peaks["hbm_bytes"]
    return max(t_compute, t_mem)
