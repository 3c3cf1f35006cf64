"""differender_tpu_torch: the PyTorch and CUDA port of ``differender_tpu``.

The renderer's forward paths run on hand-written CUDA kernels for Hopper
(``csrc/``, built with ``nvcc`` at first use): ``tf_lookup_fwd`` (K0),
``march_diff_fwd`` (K1, behind :func:`render` and :meth:`Raycaster.forward`)
and ``march_nondiff`` (K3, behind :func:`render_nondiff` and
:meth:`Raycaster.raycast_nondiff`).  CPU tensors go to plain torch versions of
the same functions.  Importing the package needs neither a GPU nor ``nvcc``.
"""
from typing import Dict

from .config import RenderConfig
from .geometry import (MarchParams, RayBundle, make_rays, march_params,
                       ray_aabb, ray_directions)
from .interop import state_from_numpy
from .ops import tf_lookup, tf_lookup_reference
from .raycaster import (Raycaster, tf_from_internal, tf_to_internal,
                        volume_from_internal, volume_to_internal)
from .render import (RenderOutput, march_diff, march_diff_plain,
                     march_nondiff, march_nondiff_plain, render,
                     render_nondiff)
from .transfer import get_tf, get_tf_torch_layout, tex_from_pts
from .utils.scenes import ct_phantom, noise_volume

__version__ = "0.1.0"

# Kernel name -> the wrapper that launches it and counts its launches.
KERNEL_WRAPPERS = {
    "tf_lookup_fwd": tf_lookup,
    "march_diff_fwd": march_diff,
    "march_nondiff": march_nondiff,
}


def launch_counts() -> Dict[str, int]:
    """Launches of each kernel since the last :func:`reset_launch_counts`."""
    return {name: fn.launches for name, fn in KERNEL_WRAPPERS.items()}


def reset_launch_counts() -> None:
    for fn in KERNEL_WRAPPERS.values():
        fn.launches = 0


__all__ = [
    "RenderConfig", "RayBundle", "MarchParams", "make_rays",
    "march_params", "ray_aabb", "ray_directions", "state_from_numpy",
    "tf_lookup", "tf_lookup_reference", "Raycaster", "tf_from_internal",
    "tf_to_internal", "volume_from_internal", "volume_to_internal",
    "RenderOutput", "march_diff", "march_diff_plain", "march_nondiff",
    "march_nondiff_plain", "render", "render_nondiff", "get_tf",
    "get_tf_torch_layout", "tex_from_pts", "ct_phantom", "noise_volume",
    "KERNEL_WRAPPERS", "launch_counts", "reset_launch_counts",
]
