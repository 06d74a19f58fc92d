from lynx_tpu_torch.converters.latticejson import (  # noqa: F401
    from_jax_arrays,
    load_cheetah_model,
)
