"""True f32 (non-x64) production-regime tests.

The main suite enables jax_enable_x64 for oracle parity, which changes
scalar promotion rules; the GPU perf path runs without it. This lane runs a
small subprocess with x64 OFF and validates the f32 behavior end-to-end:
warm/hybrid median accuracy (including off-origin clusters), a converging
SVGD run on the warm path, and dtype stability of the scan carry.
"""

import json
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent

SCRIPT = r"""
import json
import sys

sys.path.insert(0, %(repo)r)
import jax

jax.config.update("jax_platforms", "cpu")
# NOTE: x64 deliberately NOT enabled — this is the production regime.

import numpy as np

import svgdcpp_jax as sv
from svgdcpp_jax.ops.median import pairwise_distance_median_hybrid

out = {}

# 1. off-center f32 median accuracy (mean-centering regression guard)
rng = np.random.default_rng(0)
coords = (np.array([50.0, -30.0]) + 1e-3 * rng.normal(size=(400, 2))).astype(
    np.float32
)
d = np.sqrt(((coords[:, None, :].astype(np.float64)
              - coords[None, :, :].astype(np.float64)) ** 2).sum(-1)).ravel()
d.sort()
exact = 0.5 * (d[d.size // 2 - 1] + d[d.size // 2])
approx = float(pairwise_distance_median_hybrid(coords, num_samples=1 << 14,
                                               row_tile=128))
out["median_rel_err"] = abs(approx - exact) / exact

# 2. warm-path SVGD run converges and keeps f32
n, dim = 600, 2
mean = np.array([-0.6871, 0.8010], np.float32)
cov = (5 * np.array([[0.2260, 0.1652], [0.1652, 0.6779]])).astype(np.float32)
x0 = (3 * rng.uniform(-1, 1, (n, dim))).astype(np.float32)
model = sv.MultivariateNormal(mean, cov)
kernel = sv.GaussianRBFKernel(x0, sv.ScaleMethod.MEDIAN, model)
svgd = sv.SVGD(sv.SVGDOptions(
    dimension=dim, num_iterations=200, coordinate_matrix=x0,
    kernel=kernel, model=model, optimizer=sv.AdaGrad(dim, n, 0.1),
))
svgd.initialize()
res = np.asarray(svgd.run())
out["dtype"] = str(res.dtype)
out["finite"] = bool(np.isfinite(res).all())
out["mean_err"] = float(np.abs(res.mean(0) - mean).max())
print("RESULT " + json.dumps(out))
"""


def test_f32_production_regime():
    proc = subprocess.run(
        [sys.executable, "-c", SCRIPT % {"repo": str(REPO)}],
        capture_output=True,
        text=True,
        timeout=420,
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    line = [l for l in proc.stdout.splitlines() if l.startswith("RESULT ")][-1]
    out = json.loads(line[len("RESULT "):])
    assert out["median_rel_err"] < 1e-3, out
    assert out["dtype"] == "float32"
    assert out["finite"]
    # n=600 particles: empirical mean within a few MC standard errors
    assert out["mean_err"] < 0.2, out
