from lynx_tpu_torch.converters import astra  # noqa: F401
from lynx_tpu_torch.converters import bmad  # noqa: F401
from lynx_tpu_torch.converters import latticejson  # noqa: F401
from lynx_tpu_torch.converters import nxtables  # noqa: F401
from lynx_tpu_torch.converters import ocelot  # noqa: F401
from lynx_tpu_torch.converters import ocelot_shim  # noqa: F401
from lynx_tpu_torch.converters.latticejson import (  # noqa: F401
    from_jax_arrays,
    load_cheetah_model,
)
