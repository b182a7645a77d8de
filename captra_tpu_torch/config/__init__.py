from captra_tpu_torch.config.schema import (  # noqa: F401
    Config,
    NetworkCfg,
    ObjCfg,
    OptimCfg,
    PerturbCfg,
    PointNetCfg,
    SAMsgCfg,
    TrackCfg,
)
from captra_tpu_torch.config.loader import get_config, load_obj_config  # noqa: F401
