"""Static render configuration (counterpart of ``differender_tpu/config.py``).

``RenderConfig`` keeps every field of the JAX package's dataclass so that one
keyword dict builds both.  The semantic fields drive the port; the fields
that tune the TPU march (tables, remat blocks, compaction, VJP modes,
occupancy) are accepted and ignored, because the CUDA kernels march each ray
on its own thread and none of those knobs changes the rendered values.
Fields that would change the result and that the port does not implement yet
raise ``NotImplementedError``.
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
            normalized [-1, 1] coordinates.

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
    # Result-changing options not ported yet: True raises.
    analytic_normals: bool = False
    camera_grads: bool = False
    # TPU performance knobs: accepted, ignored.
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

    def __post_init__(self):
        if self.analytic_normals:
            raise NotImplementedError(
                "analytic_normals=True is not ported; the port samples the "
                "7-point central-difference stencil")
        if self.camera_grads:
            raise NotImplementedError(
                "camera_grads=True is not ported: the backward march K2 "
                "returns no camera gradient yet")

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

    def replace(self, **kw) -> "RenderConfig":
        return dataclasses.replace(self, **kw)
