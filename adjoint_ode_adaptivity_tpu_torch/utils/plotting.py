"""Iteration plots and animation.

Counterpart of the JAX package's ``utils/plotting.py`` (host NumPy and
matplotlib; nothing here touches torch). Reference parity: the
per-iteration bar+line plot (error contributions per step, exact/discrete
primal and adjoint overlays — python/Main_finite_difference.py:282-333,
factory.py:399-464) and the PNG-frames→mp4 assembly (python/animate.py,
factory.py:287-301). matplotlib is imported, under the Agg backend, only
when a frame is drawn. The video writer prefers imageio/ffmpeg and falls
back to OpenCV, both optional.
"""
from __future__ import annotations

import os
from pathlib import Path

import numpy as np

__all__ = ["plot_iteration", "animate_case", "fresh_case_dir"]


def fresh_case_dir(case: str) -> Path:
    """(Re)create the per-case plot directory — same convention as the
    reference (rm -rf case/ then case/case_{it}.png)."""
    import shutil

    p = Path(case)
    if p.is_dir():
        shutil.rmtree(p)
    p.mkdir(parents=True)
    return p


def plot_iteration(
    case: str,
    it: int,
    times: np.ndarray,
    u: np.ndarray,
    times_fine: np.ndarray,
    v: np.ndarray,
    err_steps: np.ndarray,
    exact_t: np.ndarray | None = None,
    exact_fwd: np.ndarray | None = None,
    exact_adj: np.ndarray | None = None,
    bar_ylim: tuple | None = None,
):
    """Bar chart of per-step error contributions + primal/adjoint overlays.

    Returns the bar y-limits from the first iteration so later frames share
    a fixed scale (the reference's ``bar_ylim`` dance).
    """
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    times = np.asarray(times)
    dt = np.diff(times)
    fig, ax1 = plt.subplots()
    ax1.bar(times[:-1] + dt / 2, np.asarray(err_steps), dt, color="darkseagreen",
            label="Error Estimate")
    if bar_ylim is None:
        bar_ylim = ax1.get_ylim()
    else:
        ax1.set_ylim(*bar_ylim)
    ax1.set_ylabel("Error Contribution")

    ax2 = ax1.twinx()
    if exact_t is not None and exact_fwd is not None:
        ax2.plot(exact_t, exact_fwd, "-", color="k", label="Exact Primal", linewidth=4)
    if exact_t is not None and exact_adj is not None:
        ax2.plot(exact_t, exact_adj, "-", color="saddlebrown", label="Exact Adjoint",
                 linewidth=4)
    ax2.plot(times, np.asarray(u), "-", marker=".", color="tab:blue",
             label="FD Primal", linewidth=1.25)
    ax2.plot(np.asarray(times_fine), np.asarray(v), "-", marker=".",
             color="tab:orange", label="FD Adjoint", linewidth=1.25)
    ax2.set_ylabel("Solution")
    ax2.set_xlabel("Time")
    fig.legend(bbox_to_anchor=(0.65, 1), bbox_transform=ax2.transAxes)
    fig.savefig(os.path.join(case, f"{case}_{it:d}.png"))
    plt.close(fig)
    return bar_ylim


def animate_case(case: str, fps: int = 12, keep_first_last: bool = True) -> Path:
    """Assemble case/*.png (sorted by iteration index) into case/case.mp4."""
    p = Path(case)
    frames = sorted(
        p.glob("*.png"), key=lambda f: int(f.stem.rsplit("_", 1)[-1])
    )
    if not frames:
        raise FileNotFoundError(f"no frames in {case}/")
    out = p / f"{Path(case).name}.mp4"
    try:
        import imageio.v2 as imageio

        with imageio.get_writer(out, fps=fps) as writer:
            for f in frames:
                writer.append_data(imageio.imread(f))
    except Exception:
        import cv2

        first = cv2.imread(str(frames[0]))
        h, w, _ = first.shape
        video = cv2.VideoWriter(
            str(out), cv2.VideoWriter_fourcc("m", "p", "4", "v"), fps, (w, h)
        )
        for f in frames:
            video.write(cv2.imread(str(f)))
        video.release()
    if keep_first_last:
        for f in frames[1:-1]:
            f.unlink()
    return out
