from lynx_tpu_torch.models.ares import ares_ea_segment, ares_lattice  # noqa: F401
