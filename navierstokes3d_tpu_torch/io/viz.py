"""Slice-plane visualization with the reference's conventions.

The reference renders 5 fields x 2 slice planes per frame as PNG heatmaps
(xy-plane at z = nz/2, xz-plane at y = ny/2) plus a Poisson-convergence
log plot, with fixed clims in the multi variant
(NavierStokes3D_multi_gpu.jl:416-443,486-513). File naming:
  viz3D_out/3D_NavierStokes_{xy,xz}_{field}_%04d.png
  viz3D_out/3D_NavierStokes_iter_%04d.png
Needs matplotlib (and PIL for make_animation), imported at first use.
"""

from __future__ import annotations

import math
import os
from typing import Dict, Optional, Sequence

import numpy as np

# Fixed color limits of the multi script (:422-432)
CLIMS = {
    "Pr": (-1.5, 1.5),
    "C": (0.0, 1.0),
    "Vx": (-0.25, 1.5),
    "Vy": (-1.0, 1.0),
    "Vz": (-1.0, 1.0),
}


def _plt():
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def _heatmap(plt, ax, x, y, data2d, title, clims, xlabel, ylabel):
    im = ax.pcolormesh(x, y, data2d.T, shading="auto",
                       vmin=clims[0] if clims else None,
                       vmax=clims[1] if clims else None)
    ax.set_aspect("equal")
    ax.set_xlabel(xlabel)
    ax.set_ylabel(ylabel)
    ax.set_title(title)
    plt.colorbar(im, ax=ax)


def save_frame(viz_dir: str, iframe: int, grid, fields: Dict[str, np.ndarray],
               t: float = 0.0, fixed_clims: bool = True):
    """Write the 10 slice PNGs for one frame. `fields` maps
    {"Pr","C","Vx","Vy","Vz"} to *global inner* numpy arrays (as
    gathered)."""
    plt = _plt()
    os.makedirs(viz_dir, exist_ok=True)
    nz_mid = math.ceil(fields["Pr"].shape[2] / 2) - 1
    ny_mid = math.ceil(fields["Pr"].shape[1] / 2) - 1
    paths = []
    for name, arr in fields.items():
        clims = CLIMS.get(name) if fixed_clims else None
        for plane in ("xy", "xz"):
            fig, ax = plt.subplots(figsize=(5, 4), constrained_layout=True)
            if plane == "xy":
                data = arr[:, :, min(nz_mid, arr.shape[2] - 1)]
                x = np.arange(arr.shape[0])
                y = np.arange(arr.shape[1])
                _heatmap(plt, ax, x, y, data, f"{name}  t = {t:.3f} s",
                         clims, "x [cells]", "y [cells]")
            else:
                data = arr[:, min(ny_mid, arr.shape[1] - 1), :]
                x = np.arange(arr.shape[0])
                y = np.arange(arr.shape[2])
                _heatmap(plt, ax, x, y, data, f"{name}  t = {t:.3f} s",
                         clims, "x [cells]", "z [cells]")
            p = os.path.join(
                viz_dir, f"3D_NavierStokes_{plane}_{name}_{iframe:04d}.png")
            fig.savefig(p, dpi=100)
            plt.close(fig)
            paths.append(p)
    return paths


def make_animation(viz_dir: str, field: str = "Vx", plane: str = "xy",
                   out_path: Optional[str] = None, fps: int = 8,
                   frames: Optional[Sequence[str]] = None) -> str:
    """Assemble the per-frame slice PNGs into an animated GIF (the
    reference README's showcase animations, README.md:58-93) with PIL.

    frames: explicit ordered file list; default = every
    `3D_NavierStokes_{plane}_{field}_*.png` in viz_dir, sorted.
    Returns the written path (default: `{viz_dir}/{field}_{plane}.gif`).
    """
    from PIL import Image

    if frames is None:
        import glob
        frames = sorted(glob.glob(os.path.join(
            viz_dir, f"3D_NavierStokes_{plane}_{field}_*.png")))
    if not frames:
        raise FileNotFoundError(
            f"no {plane}/{field} frames found in {viz_dir}")
    if out_path is None:
        out_path = os.path.join(viz_dir, f"{field}_{plane}.gif")
    imgs = [Image.open(p).convert("P", palette=Image.ADAPTIVE)
            for p in frames]
    imgs[0].save(out_path, save_all=True, append_images=imgs[1:],
                 duration=max(1, round(1000 / fps)), loop=0)
    for im in imgs:
        im.close()
    return out_path


def save_convergence(viz_dir: str, iframe: int,
                     iter_evo: Sequence[float], err_evo: Sequence[float]):
    """Poisson-convergence log plot (NavierStokes3D_multi_gpu.jl:488)."""
    plt = _plt()
    os.makedirs(viz_dir, exist_ok=True)
    fig, ax = plt.subplots(figsize=(5, 4), constrained_layout=True)
    ax.semilogy(iter_evo, err_evo, marker="o", ms=3)
    ax.set_xlabel("iter / ny")
    ax.set_ylabel("err")
    p = os.path.join(viz_dir, f"3D_NavierStokes_iter_{iframe:04d}.png")
    fig.savefig(p, dpi=100)
    plt.close(fig)
    return p
