from tpufusion.models.fcn import apply_fcn, init_fcn
from tpufusion.models.losses import weighted_pose_loss
from tpufusion.models.metrics import batch_metrics

__all__ = ["apply_fcn", "init_fcn", "weighted_pose_loss", "batch_metrics"]
