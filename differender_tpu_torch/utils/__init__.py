"""Scene and camera helpers."""
from .camera import get_rand_pos, in_circles
from .scenes import ct_phantom, noise_volume

__all__ = ["ct_phantom", "noise_volume", "in_circles", "get_rand_pos"]
