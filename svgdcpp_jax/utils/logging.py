"""Intermediate-matrix debug logging.

Equivalent of the reference's per-iteration matrix snapshots
(reference: SVGD.hpp:346-366, 460-476): when enabled, the jitted scan stacks
LogModelGrad / Kernel / KernelGrad / CoordMat per iteration and this module
writes them to a text file in the reference's layout (matrices printed in
the reference's m x n / (m n) x n orientation) after the run.
"""

from __future__ import annotations

import numpy as np

from ..core.exceptions import SVGD_LOG_PREFIX


def _format_matrix(mat: np.ndarray) -> str:
    return "\n".join(" ".join(f"{v:.9g}" for v in row) for row in np.atleast_2d(mat))


def write_intermediate_matrices(path: str, logs: dict, *,
                                start_step: int = 1, append: bool = False):
    """Write stacked per-iteration matrices in the reference's text format.

    ``logs`` holds arrays stacked over iterations in (n, m) layout:
      log_model_grad (T, n, m), kernel (T, n, n) with K[i, j] = k(x_j, x_i),
      kernel_grad (T, n, n, m) with G[i, j] = grad_{x_j} k(x_j, x_i),
      coords (T, n, m).
    Orientation is converted to the reference's column-major conventions:
    LogModelGrad/CoordMat as m x n, Kernel as n x n with (j, i) indexing,
    KernelGrad as the (m n) x n stacked blocks (SVGD.hpp:498-504).
    ``start_step``/``append`` extend an existing dump with only the new
    iterations (per-step drivers stay O(new steps) in file I/O).
    """
    lmg = np.asarray(logs["log_model_grad"])
    ker = np.asarray(logs["kernel"])
    kgrad = np.asarray(logs["kernel_grad"])
    coords = np.asarray(logs["coords"])
    num_steps = lmg.shape[0]
    n, m = lmg.shape[1], lmg.shape[2]

    # Fast path: the native C++ writer (utils/native.py); identical format.
    from .native import write_intermediate_log_native

    try:
        wrote = write_intermediate_log_native(
            path,
            lmg.transpose(0, 2, 1),
            ker.transpose(0, 2, 1),
            kgrad.transpose(0, 2, 3, 1).reshape(num_steps, n * m, n),
            coords.transpose(0, 2, 1),
            start_step=start_step,
            append=append,
        )
    except RuntimeError as e:
        # Preserve the native writer's failure mode instead of reporting
        # every error as an open failure; rc=1 (fopen) keeps the reference's
        # exact message (SVGD.hpp:466).
        if getattr(e, "rc", 1) == 1:
            raise RuntimeError(
                SVGD_LOG_PREFIX
                + f"[Runtime Error] Cannot open {path} for writing."
            ) from e
        raise RuntimeError(SVGD_LOG_PREFIX + f"[Runtime Error] {e}") from e
    if wrote:
        return

    try:
        out = open(path, "a" if append else "w")
    except OSError as e:
        raise RuntimeError(
            SVGD_LOG_PREFIX + f"[Runtime Error] Cannot open {path} for writing."
        ) from e
    with out:
        for t in range(num_steps):
            # reference kernel_matrix_(j, i) = ours kernel[i, j] -> transpose
            # reference kernel_grad block (j*m:(j+1)*m, i) = ours kernel_grad[i, j, :]
            kg_ref = kgrad[t].transpose(1, 2, 0).reshape(n * m, n)
            out.write(
                f"========== Step {start_step + t} =========="
                f"\nLogModelGrad=\n{_format_matrix(lmg[t].T)}"
                f"\n\nKernel=\n{_format_matrix(ker[t].T)}"
                f"\n\nKernelGrad=\n{_format_matrix(kg_ref)}"
                f"\n\nCoordMat=\n{_format_matrix(coords[t].T)}"
                "\n\n"
            )
