"""Scene helpers."""
from .scenes import ct_phantom, noise_volume

__all__ = ["ct_phantom", "noise_volume"]
