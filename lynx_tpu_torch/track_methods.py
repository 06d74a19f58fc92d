"""Alias module for the reference's ``lynx.track_methods`` (counterpart of
``lynx_tpu.track_methods``): the transfer-map functions live in
``lynx_tpu_torch.ops.rmatrix``."""

from lynx_tpu_torch.constants import REST_ENERGY_EV as REST_ENERGY  # noqa: F401
from lynx_tpu_torch.ops.rmatrix import (  # noqa: F401
    base_rmatrix,
    misalignment_matrix,
    rotation_matrix,
)
