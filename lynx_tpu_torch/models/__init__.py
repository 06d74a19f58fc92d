from lynx_tpu_torch.models.ares import ares_ea_segment, ares_lattice  # noqa: F401
from lynx_tpu_torch.models.fodo import fodo_cell, fodo_lattice  # noqa: F401
