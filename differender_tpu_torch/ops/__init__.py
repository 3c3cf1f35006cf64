"""Standalone kernels."""
from .tf_lookup import (tf_lookup, tf_lookup_bwd, tf_lookup_bwd_reference,
                        tf_lookup_fwd, tf_lookup_reference)

__all__ = ["tf_lookup", "tf_lookup_fwd", "tf_lookup_bwd",
           "tf_lookup_reference", "tf_lookup_bwd_reference"]
