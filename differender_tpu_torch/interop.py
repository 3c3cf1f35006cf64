"""Carry renderer state from the numpy arrays the JAX package works on into
the port's tensors, and tensors back to the host (:func:`to_numpy`).  The
renderer has no weights; its state is the volume, the transfer function
and the camera, and for the inference march an occupancy grid."""
from __future__ import annotations

import numpy as np
import torch

from .occupancy import OccupancyGrid


def state_from_numpy(volume, tf, look_from, *, layout: str = "internal",
                     device="cuda"):
    """Contiguous f32 tensors on ``device`` from numpy arrays, layouts kept.

    ``layout="internal"``: volume ``(X, Y, Z)``, tf ``(R, 4)``, camera
    ``(3,)``, as :func:`~differender_tpu_torch.render.render` takes them.
    ``layout="reference"``: volume ``([BS,] 1, D, H, W)``, tf
    ``([BS,] 4, R)``, camera ``([BS,] 3)``, as
    :class:`~differender_tpu_torch.raycaster.Raycaster` takes them.
    Returns ``(volume, tf, look_from)``; raises ``ValueError`` on a shape
    that does not fit the layout.
    """
    vol = np.asarray(volume, np.float32)
    tf_ = np.asarray(tf, np.float32)
    lf = np.asarray(look_from, np.float32)
    if layout == "internal":
        ok = (vol.ndim == 3 and tf_.ndim == 2 and tf_.shape[1] == 4
              and lf.shape == (3,))
    elif layout == "reference":
        ok = (vol.ndim in (4, 5) and vol.shape[-4] == 1
              and tf_.ndim in (2, 3) and tf_.shape[-2] == 4
              and lf.ndim in (1, 2) and lf.shape[-1] == 3)
    else:
        raise ValueError(f"layout must be 'internal' or 'reference'; got "
                         f"{layout!r}")
    if not ok:
        raise ValueError(
            f"shapes volume {vol.shape}, tf {tf_.shape}, look_from "
            f"{lf.shape} do not fit layout {layout!r}")
    return tuple(torch.from_numpy(np.array(a, order="C")).to(device)
                 for a in (vol, tf_, lf))


def to_numpy(x) -> np.ndarray:
    """``x`` on the host as a numpy array: a tensor on any device (detached
    and copied to the host), or anything ``np.asarray`` takes."""
    if torch.is_tensor(x):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def occupancy_from_numpy(dist, shape, cell, cell_world, *, device="cuda"):
    """An :class:`~differender_tpu_torch.occupancy.OccupancyGrid` on
    ``device`` from a grid's fields as numpy data (for instance a grid the
    JAX package built: ``np.asarray(grid.dist), grid.shape, grid.cell,
    grid.cell_world``).  ``dist`` must hold ``nx*ny*nz`` distances."""
    shape = tuple(int(s) for s in shape)
    d = np.asarray(dist).reshape(-1)
    if len(shape) != 3 or d.size != shape[0] * shape[1] * shape[2]:
        raise ValueError(f"dist of {d.size} cells does not fit a grid of "
                         f"shape {shape}")
    d = d.astype(np.int32)
    far = np.array([d.max() if d.size else 0], np.int32)
    return OccupancyGrid(
        dist=torch.from_numpy(d).to(device), shape=shape, cell=int(cell),
        cell_world=float(cell_world), far=torch.from_numpy(far).to(device))


__all__ = ["state_from_numpy", "occupancy_from_numpy", "to_numpy"]
