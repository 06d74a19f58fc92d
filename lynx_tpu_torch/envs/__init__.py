from lynx_tpu_torch.envs import ares_ea as _ares_ea
from lynx_tpu_torch.envs.ares_ea import (  # noqa: F401
    AresEATransverseTuning,
    EnvParams,
    EnvState,
    default_params,
    make_env,
)


def __getattr__(name: str):
    """``AresEAGymEnv``, where gymnasium imports (see ``ares_ea``)."""
    if name == "AresEAGymEnv":
        return _ares_ea.AresEAGymEnv
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
