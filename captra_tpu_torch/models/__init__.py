from captra_tpu_torch.models.backbone import PointNet2Msg  # noqa: F401
from captra_tpu_torch.models.coordnet import CoordNet  # noqa: F401
from captra_tpu_torch.models.rotnet import RotNet  # noqa: F401
