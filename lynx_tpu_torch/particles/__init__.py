from lynx_tpu_torch.particles.beam import Beam  # noqa: F401
from lynx_tpu_torch.particles.parameter_beam import ParameterBeam  # noqa: F401
from lynx_tpu_torch.particles.particle_beam import ParticleBeam  # noqa: F401
