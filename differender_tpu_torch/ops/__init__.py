"""Standalone kernels."""
from .tf_lookup import tf_lookup, tf_lookup_reference

__all__ = ["tf_lookup", "tf_lookup_reference"]
