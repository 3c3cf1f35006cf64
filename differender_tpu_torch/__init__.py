"""differender_tpu_torch: the PyTorch and CUDA port of ``differender_tpu``.

The renderer runs on hand-written CUDA kernels for Hopper (``csrc/``, built
with ``nvcc`` at first use): ``tf_lookup_fwd`` (K0) and ``tf_lookup_bwd``
(K0b) behind :func:`tf_lookup`; ``march_diff_fwd`` (K1) and
``march_diff_bwd`` (K2) behind :func:`render`, :meth:`Raycaster.forward`
and their gradients (:func:`value_and_grad_render`), also marched in row
strips (:func:`render_strips`) or depth-sorted chunks
(:func:`render_depth_sorted`, chosen per scene by
:func:`choose_diff_renderer`); ``march_nondiff`` (K3) behind
:func:`render_nondiff`, :func:`render_nondiff_strips` and
:meth:`Raycaster.raycast_nondiff`, which jumps over empty space through the
occupancy grid that ``cell_minmax`` (K6) and ``cell_distance`` (K7) build
(:func:`build_occupancy`); ``brick_sums`` (K4) and ``brick_rows`` (K5), the
box sums of the TPU DMA probe.  The shear-warp fast path
(:func:`render_fast`, :meth:`Raycaster.raycast_fast`) marches its slabs
through ``shear_warp_fwd`` (K8) and ``shear_warp_bwd`` (K9)
(:mod:`.ops.shear_warp`).  :mod:`.parallel` spreads views, the fast
path's intermediate rows or a volume sharded along X over the ranks of a
``torch.distributed`` group; a shard marches its slab through the segment
instantiations of K1 and K2 (``march_segment_fwd``,
``march_segment_bwd``).
``RenderConfig(analytic_normals=True)`` takes each sample's
gradient from its 8 corners in K1, K2 and K3; a camera that requires grad
gets its gradient through K2's camera instantiation
(``march_diff_bwd.camera_launches`` counts it), also in a sharded render
(``march_segment_bwd.camera_launches``).  CPU tensors go to plain torch
versions of the same functions.  Importing the package needs neither a GPU
nor ``nvcc``.

Beside the renderer: :class:`TorchRaycaster` (the JAX package's torch
bridge, over :class:`Raycaster`), :mod:`.io` (raw and NIfTI volumes,
checkpoints), :mod:`.profiling` (``torch.profiler`` traces),
:mod:`.video` (:class:`VideoWriter`, :func:`save_video`) and
:mod:`.plotting`; the example scripts run as ``python -m
differender_tpu_torch.examples.<name>``.
"""
from typing import Dict

from .config import RenderConfig
from .fastpath import (FastRenderOutput, choose_fast_params, render_fast,
                       render_fast_auto, render_fast_plain,
                       render_fast_sharded)
from .geometry import (MarchParams, RayBundle, make_rays, march_params,
                       ray_aabb, ray_directions)
from .interop import occupancy_from_numpy, state_from_numpy
from .losses import dssim_mse_loss, mse_loss, ssim
from .occupancy import (OccupancyGrid, build_occupancy, jump_steps,
                        tf_alpha_range_max)
from .ops import (brick_rows, brick_rows_reference, brick_sums,
                  brick_sums_reference, cell_distance,
                  cell_distance_reference, cell_minmax, cell_minmax_reference,
                  shear_warp_bwd, shear_warp_fwd, tf_lookup, tf_lookup_bwd,
                  tf_lookup_bwd_reference, tf_lookup_fwd,
                  tf_lookup_reference)
from . import parallel
from .parallel.volume_sharding import march_segment_bwd, march_segment_fwd
from .optim import (adamw_onecycle, nan_to_num_grads, project_nonneg,
                    project_unit, tf_momentum, value_and_clean_grad)
from .raycaster import (Raycaster, tf_from_internal, tf_to_internal,
                        volume_from_internal, volume_to_internal)
from .render import (RenderOutput, choose_diff_renderer, march_diff,
                     march_diff_bwd, march_diff_bwd_plain, march_diff_fwd,
                     march_diff_plain, march_nondiff, march_nondiff_plain,
                     ray_cotangents, render, render_depth_sorted, render_jit,
                     render_nondiff, render_nondiff_jit,
                     render_nondiff_strips, render_strips,
                     value_and_grad_blockwise, value_and_grad_render)
from .shading import premultiply_alpha
from .transfer import (get_tf, get_tf_torch_layout, random_peaks_tf,
                       tex_from_pts)
from .torch_interop import TorchRaycaster
from .utils.camera import get_rand_pos, in_circles
from .utils.scenes import ct_phantom, noise_volume, synthetic_volume
from .video import VideoWriter, save_video

__version__ = "0.1.0"

# Kernel name -> the wrapper that launches it and counts its launches.
KERNEL_WRAPPERS = {
    "tf_lookup_fwd": tf_lookup_fwd,
    "tf_lookup_bwd": tf_lookup_bwd,
    "march_diff_fwd": march_diff_fwd,
    "march_diff_bwd": march_diff_bwd,
    "march_nondiff": march_nondiff,
    "brick_sums": brick_sums,
    "brick_rows": brick_rows,
    "cell_minmax": cell_minmax,
    "cell_distance": cell_distance,
    "march_segment_fwd": march_segment_fwd,
    "march_segment_bwd": march_segment_bwd,
    "shear_warp_fwd": shear_warp_fwd,
    "shear_warp_bwd": shear_warp_bwd,
}


def launch_counts() -> Dict[str, int]:
    """Launches of each kernel since the last :func:`reset_launch_counts`."""
    return {name: fn.launches for name, fn in KERNEL_WRAPPERS.items()}


def reset_launch_counts() -> None:
    """Zeroes every wrapper's count, and K2's counts of its camera
    instantiations (``march_diff_bwd.camera_launches``,
    ``march_segment_bwd.camera_launches``)."""
    for fn in KERNEL_WRAPPERS.values():
        fn.launches = 0
    march_diff_bwd.camera_launches = 0
    march_segment_bwd.camera_launches = 0


__all__ = [
    "RenderConfig", "RayBundle", "MarchParams", "make_rays",
    "march_params", "ray_aabb", "ray_directions", "state_from_numpy",
    "tf_lookup", "tf_lookup_fwd", "tf_lookup_bwd", "tf_lookup_reference",
    "tf_lookup_bwd_reference", "Raycaster", "tf_from_internal",
    "tf_to_internal", "volume_from_internal", "volume_to_internal",
    "RenderOutput", "march_diff", "march_diff_fwd", "march_diff_bwd",
    "march_diff_plain", "march_diff_bwd_plain", "ray_cotangents",
    "march_nondiff", "march_nondiff_plain", "render", "render_nondiff",
    "render_jit", "render_nondiff_jit", "value_and_grad_render",
    "render_nondiff_strips", "render_strips", "render_depth_sorted",
    "choose_diff_renderer", "value_and_grad_blockwise", "render_fast",
    "render_fast_plain", "render_fast_sharded", "choose_fast_params",
    "render_fast_auto", "FastRenderOutput", "parallel",
    "march_segment_fwd", "march_segment_bwd",
    "premultiply_alpha", "mse_loss", "ssim", "dssim_mse_loss",
    "tf_momentum", "project_nonneg", "project_unit", "nan_to_num_grads",
    "value_and_clean_grad", "adamw_onecycle", "in_circles", "get_rand_pos",
    "get_tf", "get_tf_torch_layout", "random_peaks_tf", "tex_from_pts",
    "ct_phantom", "noise_volume",
    "synthetic_volume", "OccupancyGrid", "build_occupancy",
    "jump_steps", "tf_alpha_range_max",
    "occupancy_from_numpy", "brick_sums", "brick_rows", "cell_minmax",
    "brick_sums_reference", "brick_rows_reference", "cell_minmax_reference",
    "cell_distance", "cell_distance_reference",
    "KERNEL_WRAPPERS", "launch_counts", "reset_launch_counts",
    "shear_warp_fwd", "shear_warp_bwd",
    "TorchRaycaster", "VideoWriter", "save_video",
]
