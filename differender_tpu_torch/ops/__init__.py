"""Standalone kernels."""
from .bricks import (brick_rows, brick_rows_reference, brick_sums,
                     brick_sums_reference, cell_minmax, cell_minmax_reference)
from .distance import cell_distance, cell_distance_reference
from .shear_warp import shear_warp_bwd, shear_warp_fwd
from .tf_lookup import (tf_lookup, tf_lookup_bwd, tf_lookup_bwd_reference,
                        tf_lookup_fwd, tf_lookup_reference)

__all__ = ["tf_lookup", "tf_lookup_fwd", "tf_lookup_bwd",
           "tf_lookup_reference", "tf_lookup_bwd_reference", "brick_sums",
           "brick_rows", "cell_minmax", "brick_sums_reference",
           "brick_rows_reference", "cell_minmax_reference", "cell_distance",
           "cell_distance_reference", "shear_warp_fwd", "shear_warp_bwd"]
