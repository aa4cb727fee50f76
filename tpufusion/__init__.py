"""tpufusion — sensor-fusion pose estimation on a GPU, in JAX.

A from-scratch JAX/XLA rebuild of the capabilities of the Didi-challenge
pipeline `J-Rojas/Sensor-Fusion-Pose-Estimation-Challenge`: lidar point
clouds are projected on-device into a 360-degree cylindrical range view
and a bird's-eye-view density raster, a fully convolutional segmentation +
corner-regression network predicts per-pixel obstacle pose encodings,
and a jit-fused decode (heatmap clustering -> 2D->3D back-projection ->
corner voting) recovers the 6-DoF pose + size of the obstacle vehicle.

Subpackages
-----------
geometry   pure-JAX projection / box / SE3 math           (ref: modules/lidar/process, train/encoder.py)
ops        device ops: nearest-wins scatter, binning, connected components
models     plain-JAX FCN + fusion head, losses, metrics  (ref: modules/lidar/train/model.py, train_fcn.py)
data       host-side dataset registry, readers, feeding    (ref: modules/lidar/train/loader.py)
train      jitted train step, npz checkpoints, stats     (ref: modules/lidar/train/train.py, pretrain.py)
decode     jit-fused pose decode                           (ref: modules/lidar/train/predict.py)
eval       tracklet XML io, interpolation, pose scoring    (ref: modules/lidar/common/tracklet_generator.py)
serve      streaming replay harness, latency accounting    (ref: modules/team_sf_rosnode)
parallel   device-mesh / sharding helpers
tools      calibration optimizer, dataset diff, analyzers  (ref: modules/camera-lidar-calibration, rosdiff)
"""

__version__ = "0.1.0"

from tpufusion import config as config  # noqa: F401
