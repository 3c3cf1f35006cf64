"""Plotting and logging utilities (counterpart of
``differender_tpu/plotting.py``): TF plots, render-and-TF comparison
figures, histograms, PNG images and GIFs, written through matplotlib's Agg
backend and PIL, no window system required.  Every input may be a tensor on
any device or an array; it comes to the host first and is converted there
as the JAX package converts it.  matplotlib and PIL are imported when a
function needs them.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np

from .interop import to_numpy


def _plt():
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def plot_tf(tf, ax=None, title: Optional[str] = None):
    """Plot one (R, 4) RGBA transfer function: alpha as a curve, color as a
    band underneath (the ``torchvtk.rendering.plot_tf`` idea)."""
    plt = _plt()
    tf = to_numpy(tf)
    if ax is None:
        _, ax = plt.subplots(figsize=(4, 2.2))
    xs = np.linspace(0, 1, tf.shape[0])
    ax.plot(xs, tf[:, 3], color="black", lw=1.5, label="alpha")
    rgb = np.clip(tf[:, :3], 0, 1)
    band = np.broadcast_to(rgb[None, :, :], (12, tf.shape[0], 3))
    ax.imshow(band, extent=(0, 1, -0.18, -0.02), aspect="auto")
    ax.set_xlim(0, 1)
    ax.set_ylim(-0.2, 1.05)
    ax.set_xlabel("intensity")
    if title:
        ax.set_title(title, fontsize=9)
    return ax


def plot_tfs(tfs_and_names: Sequence[Tuple[object, str]], path=None):
    """Side-by-side TF comparison (the reference's ``plot_tfs``)."""
    plt = _plt()
    n = len(tfs_and_names)
    fig, axes = plt.subplots(1, n, figsize=(4 * n, 2.4))
    if n == 1:
        axes = [axes]
    for ax, (tf, name) in zip(axes, tfs_and_names):
        plot_tf(tf, ax=ax, title=name)
    fig.tight_layout()
    if path:
        fig.savefig(path, dpi=100)
        plt.close(fig)
    return fig


def plot_comp_render_tf(entries, path=None, suptitle: Optional[str] = None):
    """Render+TF comparison grid, the reference's
    ``plot_comp_render_tf([(img, tf, name), ...])``.

    ``entries``: sequence of (image (4, H, W) or (H, W, 4), tf (R, 4), name).
    """
    plt = _plt()
    n = len(entries)
    fig, axes = plt.subplots(2, n, figsize=(4 * n, 5.5),
                             gridspec_kw={"height_ratios": [3, 1]})
    if n == 1:
        axes = axes.reshape(2, 1)
    for i, (img, tf, name) in enumerate(entries):
        img = to_numpy(img)
        if img.ndim == 3 and img.shape[0] in (3, 4):
            img = np.transpose(img, (1, 2, 0))
        axes[0, i].imshow(np.clip(img[..., :3], 0, 1))
        axes[0, i].set_title(name)
        axes[0, i].axis("off")
        plot_tf(tf, ax=axes[1, i])
    if suptitle:
        fig.suptitle(suptitle, fontsize=14)
    fig.tight_layout()
    if path:
        fig.savefig(path, dpi=100)
        plt.close(fig)
    return fig


def save_image(img, path: str):
    """Save an RGBA image ((4, H, W), (H, W, 4) or (H, W, 3)) as PNG —
    replaces ``torchvision.utils.save_image``."""
    plt = _plt()
    img = to_numpy(img)
    if img.ndim == 3 and img.shape[0] in (3, 4):
        img = np.transpose(img, (1, 2, 0))
    plt.imsave(path, np.clip(img, 0.0, 1.0))


def save_histogram(values, path: str, bins: int = 128,
                   value_range=(0.0, 1.0)):
    """Intensity histogram PNG (the reference's volume-fitting log)."""
    plt = _plt()
    hist, _ = np.histogram(to_numpy(values).ravel(), bins=bins,
                           range=value_range)
    f, ax = plt.subplots()
    ax.bar(np.arange(bins), hist, width=1.0)
    f.savefig(path, dpi=200)
    plt.close(f)


def save_gif(frames, path: str, fps: int = 10):
    """Write frames ((H, W, 3/4) uint8 or float) to a GIF, for previews
    (:class:`~differender_tpu_torch.video.VideoWriter` writes a video)."""
    from PIL import Image
    imgs = []
    for fr in frames:
        fr = to_numpy(fr)
        if fr.ndim == 3 and fr.shape[0] in (3, 4):
            fr = np.transpose(fr, (1, 2, 0))
        if fr.dtype != np.uint8:
            fr = (np.clip(fr, 0, 1) * 255).astype(np.uint8)
        imgs.append(Image.fromarray(fr[..., :3]))
    imgs[0].save(path, save_all=True, append_images=imgs[1:],
                 duration=int(1000 / fps), loop=0)
