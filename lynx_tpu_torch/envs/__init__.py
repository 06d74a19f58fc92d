from lynx_tpu_torch.envs.ares_ea import (  # noqa: F401
    AresEATransverseTuning,
    EnvParams,
    EnvState,
    default_params,
    make_env,
)
