"""Online inference facade.

Replaces the ROS-node serving stack (`modules/team_sf_rosnode/scripts/
lidar_predict.py` + `modules/lidar/pipeline.py`): one fused jitted graph
(projection + FCN + decode) behind a `predict_position(points)` call. No
ROS hop — the host hands a raw point array straight to the device.

Also carries the reference node's `fake_model` fallback (point-cloud mean,
`lidar_predict.py:25-26`) for smoke-testing transports without weights.
"""

from __future__ import annotations

import jax
import numpy as np

from tpufusion.config import PipelineConfig, DEFAULT
from tpufusion.models.fcn import init_fcn
from tpufusion.predict import make_e2e_step


class LidarPipeline:
    def __init__(
        self,
        cfg: PipelineConfig = DEFAULT,
        variables: dict | None = None,
        checkpoint_dir: str | None = None,
        max_points: int | None = None,
    ):
        """`variables` (e.g. models/io.load_detector_asset's) default to
        a seeded random init, or to the latest checkpoint under
        `checkpoint_dir`."""
        self.cfg = cfg
        self.max_points = max_points or cfg.max_points
        self.variables = variables or init_fcn(
            cfg.model, jax.random.PRNGKey(0), in_channels=3
        )
        if checkpoint_dir is not None:
            from tpufusion.train.checkpoint import CheckpointManager

            _, self.variables, _ = CheckpointManager(checkpoint_dir).restore(
                self.variables
            )
        self._step = make_e2e_step(
            cfg.model, cfg.range_view, cfg.decode, cfg.projection_method,
            head=cfg.model.head,
        )

    def _pad(self, points: np.ndarray):
        n = self.max_points
        pts = np.zeros((n, 4), np.float32)
        valid = np.zeros((n,), bool)
        m = min(len(points), n)
        pts[:m, : points.shape[1]] = points[:m, :4]
        valid[:m] = True
        return pts, valid

    def predict_position(self, points: np.ndarray) -> tuple[np.ndarray, bool]:
        """points (N, >=3[+intensity]) -> (pose (7,), found)."""
        pts, valid = self._pad(np.asarray(points, np.float32))
        pose, found = self._step(self.variables, pts[None], valid[None])
        return np.asarray(pose[0]), bool(found[0])

    @staticmethod
    def fake_predict(points: np.ndarray) -> np.ndarray:
        """Mean of the cloud — the node's fake_model."""
        return np.asarray(points, np.float64)[:, :3].mean(axis=0)
