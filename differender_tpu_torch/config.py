"""Static render configuration (counterpart of ``differender_tpu/config.py``).

``RenderConfig`` keeps every field of the JAX package's dataclass so that one
keyword dict builds both.  The semantic fields drive the port, among them
``analytic_normals`` (the marches take the analytic in-cell gradient of the
centre's 8 corners in place of the 7-point stencil), and so do the
occupancy fields (``occupancy_skip``, ``occupancy_cell``,
``occupancy_max_dist``, ``occupancy_jump_every``): the inference march K3
jumps over empty space through the grid of
:mod:`~differender_tpu_torch.occupancy`.  ``camera_grads`` declares the
intent to differentiate the camera, as in the JAX package; ``render`` gives
``look_from`` a gradient wherever it requires grad, and
:class:`~differender_tpu_torch.raycaster.Raycaster` takes the flag.  The
fields that tune the TPU march (tables, remat blocks, compaction, VJP
modes) are accepted and ignored, because the CUDA kernels march each ray on
its own thread and none of those knobs changes the rendered values.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """All static knobs of the renderer.

    Attributes:
        volume_shape: internal volume grid shape ``(X, Y, Z)``.  The
            user-facing :class:`~differender_tpu_torch.raycaster.Raycaster`
            takes ``([BS,] 1, D, H, W)`` and converts.
        image_shape: output image shape ``(H, W)``.
        tf_resolution: texel count R of the 1D RGBA transfer function.
        sampling_rate: default Nyquist multiplier of the differentiable path.
        max_samples: cap on the differentiable march depth.
        fov: field of view in degrees; the near plane is ``2*tan(fov)*near``
            high (the reference's ``tan(fov)``, not ``tan(fov/2)``).
        near/far: near/far plane distances (far is kept for API parity).
        jitter: default for jittering ray starts.
        ambient/diffuse/specular/shininess/light_color: headlight shading.
        ert_threshold: early-ray-termination opacity.
        alpha_skip: TF alpha at or below which the inference march skips a
            sample.
        normal_delta: central-difference step of the gradient stencil, in
            normalized [-1, 1] coordinates; with ``analytic_normals`` the
            analytic gradient is scaled to the stencil's magnitude by it.
        analytic_normals: take each sample's gradient from the in-cell
            derivative of its 8 corners (one fetch) instead of the 7-point
            central-difference stencil.
        camera_grads: the declared intent to differentiate ``look_from``
            (``Raycaster`` returns a camera gradient only with it).
        occupancy_skip: the inference render builds an occupancy grid when
            none is passed, and K3 jumps over empty space (the image does
            not change).
        occupancy_cell/occupancy_max_dist: macrocell edge in voxels and
            distance-field saturation; 0 = auto (:meth:`resolved_occupancy`).
        occupancy_jump_every: look up a jump at most every Nth sample
            (values below 1 mean 1, as in the JAX package).

    The remaining fields tune the JAX package's TPU march and are ignored
    here (see the module docstring).
    """

    volume_shape: Tuple[int, int, int]
    image_shape: Tuple[int, int]
    tf_resolution: int = 128
    sampling_rate: float = 1.0
    max_samples: int = 512
    fov: float = 30.0
    near: float = 0.1
    far: float = 100.0
    jitter: bool = True
    ambient: float = 0.4
    diffuse: float = 0.8
    specular: float = 0.3
    shininess: float = 32.0
    light_color: Tuple[float, float, float] = (1.0, 1.0, 1.0)
    ert_threshold: float = 0.99
    alpha_skip: float = 1e-3
    normal_delta: float = 1e-3
    analytic_normals: bool = False
    camera_grads: bool = False
    # TPU performance knobs: accepted, ignored, except the four occupancy_*
    # fields, which drive the inference march's empty-space skip.
    block_size: int = 32
    unroll: int = 1
    cell_gather: bool = True
    march_table: str = "auto"
    super64_max_bytes: int = 6 << 30
    march_vjp: str = "ad"
    vjp_tile: int = 16
    vjp_box: int = 32
    vjp_box_rows: int = 1 << 18
    vjp_window_rows: int = 1 << 16
    vjp_check: bool = False
    occupancy_skip: bool = True
    occupancy_cell: int = 0
    occupancy_max_dist: int = 0
    nondiff_compaction: bool = True
    compaction_min: int = 4096
    occupancy_jump_every: int = 1
    ert_block_skip: bool = True
    compact_after: int = 0
    compact_prefix: float = 0.25

    @property
    def height(self) -> int:
        return self.image_shape[0]

    @property
    def width(self) -> int:
        return self.image_shape[1]

    @property
    def aspect(self) -> float:
        """W/H."""
        return self.width / self.height

    @property
    def fov_rad(self) -> float:
        return math.radians(self.fov)

    @property
    def vol_diag(self) -> float:
        """``‖volume_shape − 1‖₂``, the Nyquist sample-count scale."""
        x, y, z = self.volume_shape
        return math.sqrt((x - 1.0) ** 2 + (y - 1.0) ** 2 + (z - 1.0) ** 2)

    def max_steps_for(self, sampling_rate: float) -> int:
        """Upper bound of per-ray sample counts at ``sampling_rate``: the
        longest chord through the [-1, 1]^3 box is 2*sqrt(3)."""
        return int(math.floor(
            sampling_rate * 2.0 * math.sqrt(3.0) * self.vol_diag)) + 1

    def diff_march_steps(self, sampling_rate: float) -> int:
        """Trip-count bound of the differentiable march."""
        return min(self.max_samples, self.max_steps_for(sampling_rate))

    def use_blockwise_grad(self) -> bool:
        """Always False.  The JAX package splits its 512^3-class backward
        into host-level blocks; the port's backward kernel K2 keeps only
        O(H*W) state beside the volume, so one strategy serves every size.
        Kept so code written for the JAX package's config still runs."""
        return False

    def resolved_march_table(self) -> str:
        """The JAX package's march table for this config, its ``"auto"``
        resolved as there: ``super64`` where the 64-wide supercell table
        fits ``super64_max_bytes`` and the parity stencil fits one 4x4x4
        row, else ``super64s2`` (the stride-2 table) for even parity
        volumes, else ``cell8`` or ``flat``.  The port marches no table;
        :func:`~differender_tpu_torch.render.value_and_grad_blockwise`
        refuses what the JAX package refuses with it."""
        if self.march_table != "auto":
            return self.march_table
        x, y, z = self.volume_shape
        bytes64 = x * y * z * 64 * 4
        stencil_ok = (self.analytic_normals
                      or 2.0 * self.normal_delta
                      * (max(self.volume_shape) - 1.0) < 1.0)
        if bytes64 <= self.super64_max_bytes and stencil_ok:
            return "super64"
        if (not self.analytic_normals
                and bytes64 // 8 <= self.super64_max_bytes
                and self.normal_delta * (max(self.volume_shape) - 1.0) < 1.0
                and all(s % 2 == 0 for s in self.volume_shape)):
            return "super64s2"
        return "cell8" if self.cell_gather else "flat"

    def resolved_occupancy(self) -> Tuple[int, int]:
        """``(cell, max_dist)`` with the auto (0) defaults resolved, as the
        JAX package resolves them.  Cell: the smallest edge in
        {2, 4, 8, 16, 32} whose macrocell grid has at most 2^21 cells (a
        distance field of at most 8 MB).  Max_dist: about 96 voxels of jump
        reach whatever the cell."""
        cell = self.occupancy_cell
        if cell == 0:
            for cell in (2, 4, 8, 16, 32):
                n_cells = 1
                for s in self.volume_shape:
                    n_cells *= -(-s // cell)
                if n_cells <= 1 << 21:
                    break
        md = self.occupancy_max_dist
        if md == 0:
            md = max(2, 96 // cell)
        return cell, md

    def replace(self, **kw) -> "RenderConfig":
        return dataclasses.replace(self, **kw)
