"""The benchmark's inputs, made on the device from the seed: transfer
functions, volumes from a traffic file's layers, camera poses and jitter.

Both the program and the reference are handed these tensors; neither
derives them.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

# Control points (position, r, g, b, alpha) of the upstream presets.
TF_POINTS = {
    "tf1": [
        [0.0000, 0.0000, 0.0000, 0.0000, 0.0000],
        [0.0840, 0.8510, 0.7230, 0.4672, 0.0000],
        [0.0850, 0.8510, 0.7230, 0.4672, 0.0831],
        [0.1844, 0.8510, 0.7230, 0.4672, 0.0801],
        [0.1890, 0.8510, 0.7230, 0.4672, 0.0000],
        [0.2444, 0.8667, 0.5166, 0.6566, 0.0000],
        [0.2528, 0.7176, 0.0675, 0.3276, 0.0782],
        [0.2621, 0.8667, 0.5166, 0.6566, 0.0000],
        [0.3407, 0.9843, 0.9843, 0.9843, 0.0000],
        [0.3601, 0.9843, 0.9843, 0.9843, 0.3904],
        [0.4475, 0.9843, 0.9843, 0.9843, 0.3917],
        [0.4655, 0.9843, 0.9843, 0.9843, 0.0000],
        [1.0000, 0.0000, 0.0000, 0.0000, 0.0000],
    ],
    "tf5": [
        [0.0000, 0.0000, 0.0000, 0.0000, 0.0000],
        [0.1300, 0.5000, 0.5000, 0.5000, 0.0000],
        [0.1350, 0.5000, 0.5000, 0.5000, 0.7500],
        [0.1600, 0.5000, 0.5000, 0.5000, 0.7500],
        [0.1700, 0.5000, 0.5000, 0.5000, 0.0000],
        [1.0000, 0.0000, 0.0000, 0.0000, 0.0000],
    ],
}


def transfer_function(name: str, resolution: int, device) -> torch.Tensor:
    """The preset rasterised at ``linspace(0, 1, R)``, channel-major ``(4,
    R)`` as the user API takes it."""
    pts = np.asarray(TF_POINTS[name], np.float64)
    xs = np.linspace(0.0, 1.0, resolution)
    tex = np.stack([np.interp(xs, pts[:, 0], pts[:, 1 + c])
                    for c in range(4)])
    return torch.tensor(tex.astype(np.float32), device=device)


def syncer(dev: torch.device):
    """Waits for the device's queue (nothing to wait for on the CPU)."""
    if dev.type == "cuda":
        return torch.cuda.synchronize
    return lambda: None


def generator(seed: int, stream: int, device) -> torch.Generator:
    """A generator for one stream of draws (volume, poses, ...) of a seed,
    so that adding draws to one stream moves no other."""
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 1000003 + stream) % (1 << 63))
    return g


def _grid(n: int, device):
    xs = torch.linspace(-1.0, 1.0, n, device=device)
    return torch.meshgrid(xs, xs, xs, indexing="ij")


def _unit_vectors(gen, count, device):
    v = torch.randn((count, 3), generator=gen, device=device)
    return v / torch.linalg.vector_norm(v, dim=-1, keepdim=True)


def _rotation(gen, device) -> torch.Tensor:
    """A rotation uniform over SO(3): a unit quaternion from 4 normal
    draws."""
    q = torch.randn(4, generator=gen, device=device)
    w, x, y, z = (q / torch.linalg.vector_norm(q)).tolist()
    return torch.tensor([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]],
        dtype=torch.float32, device=device)


def _layer(vol, spec, gen, grid):
    """Applies one layer of a traffic file to ``vol`` (in place)."""
    gx, gy, gz = grid
    kind = spec["kind"]
    if kind == "sigmoid_ball":
        rr = torch.sqrt(gx * gx + gy * gy + gz * gz)
        vol += spec["density"] * torch.sigmoid(
            (spec["radius"] - rr) * spec["sharpness"])
    elif kind == "shell":
        rr = torch.sqrt(gx * gx + gy * gy + gz * gz)
        vol += spec["density"] * ((rr > spec["inner"])
                                  & (rr < spec["outer"])).to(vol.dtype)
    elif kind == "inclusions":
        # A fixed constellation of spheres, turned as a whole by a rotation
        # drawn from the seed: every seed holds the same sizes, densities
        # and distances, so the same work over random views.
        rot = _rotation(gen, vol.device)
        centres = torch.tensor(spec["centres"], dtype=torch.float32,
                               device=vol.device) @ rot.T
        for (cx, cy, cz), r, d in zip(centres.tolist(), spec["radii"],
                                      spec["densities"]):
            inside = (gx - cx) ** 2 + (gy - cy) ** 2 + (gz - cz) ** 2 < r * r
            vol[inside] = d
    elif kind == "band_noise":
        c = spec["coarse"]
        lo, hi = spec["low"], spec["high"]
        coarse = lo + (hi - lo) * torch.rand((1, 1, c, c, c), generator=gen,
                                             device=vol.device)
        vol += F.interpolate(coarse, size=tuple(vol.shape), mode="trilinear",
                             align_corners=True)[0, 0]
    else:
        raise ValueError(f"unknown volume layer kind {kind!r}")


def volume(traffic: dict, size: int, gen: torch.Generator) -> torch.Tensor:
    """The clean volume ``(size,) * 3`` of a traffic file: its layers in
    order, then clipped to its range."""
    dev = gen.device
    vol = torch.zeros((size,) * 3, dtype=torch.float32, device=dev)
    grid = _grid(size, dev)
    for spec in traffic["layers"]:
        _layer(vol, spec, gen, grid)
    lo, hi = traffic["clip"]
    return vol.clamp_(lo, hi)


def corrupt(vol: torch.Tensor, share: float, gen: torch.Generator
            ) -> torch.Tensor:
    """A copy of ``vol`` with a ``share`` of its voxels drawn anew,
    uniform in [0, 1)."""
    mask = torch.rand(vol.shape, generator=gen, device=vol.device) < share
    fresh = torch.rand(vol.shape, generator=gen, device=vol.device)
    return torch.where(mask, fresh, vol)


def orbit(angle, y: float, dist: float, device) -> torch.Tensor:
    """Camera(s) on a horizontal circle: ``(cos a * dist, y, sin a *
    dist)``."""
    a = torch.as_tensor(angle, dtype=torch.float32, device=device)
    return torch.stack([torch.cos(a) * dist, torch.full_like(a, y),
                        torch.sin(a) * dist], dim=-1)


def random_poses(gen: torch.Generator, count: int, dist: float
                 ) -> torch.Tensor:
    """Cameras uniform on the sphere of radius ``dist``."""
    return _unit_vectors(gen, count, gen.device) * dist


def start_angle(gen: torch.Generator) -> float:
    return float(torch.rand((), generator=gen, device=gen.device)) \
        * 2.0 * math.pi
