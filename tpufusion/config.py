"""Typed configuration tree for tpufusion.

The reference scatters configuration across three tiers (constants modules,
argparse CLIs, and env vars — see `modules/lidar/process/globals.py:1-16`,
`modules/lidar/train/globals.py:1-24`). Here everything lives in frozen
dataclasses so configs are hashable (usable as jit static args) and
serializable.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass


@dataclass(frozen=True)
class RangeViewSpec:
    """Cylindrical 360-degree range-view geometry.

    Defaults reproduce the reference grid (`modules/lidar/process/globals.py:3-16`):
    resolution (1.33 deg vertical, 0.2 deg horizontal), vertical field of view
    (-30.67, 10.67) deg, giving a 32 x 1801 image.
    """

    res_v_deg: float = 1.33
    res_h_deg: float = 0.2
    vfov_lo_deg: float = -30.67
    vfov_hi_deg: float = 10.67
    min_height: float = -2.0
    max_height: float = 2.0

    @property
    def res_v_rad(self) -> float:
        return self.res_v_deg * math.pi / 180.0

    @property
    def res_h_rad(self) -> float:
        return self.res_h_deg * math.pi / 180.0

    @property
    def x_min(self) -> float:
        # azimuth-pixel origin shift (reference X_MIN = -360/res_h/2 = -900)
        return -360.0 / self.res_h_deg / 2.0

    @property
    def y_min(self) -> float:
        # elevation-pixel origin shift (reference Y_MIN = vfov_lo/res_v ~ -23.06)
        return self.vfov_lo_deg / self.res_v_deg

    @property
    def x_max(self) -> int:
        return int(360.0 / self.res_h_deg)  # 1800

    @property
    def y_max(self) -> int:
        return int(abs(self.vfov_lo_deg - self.vfov_hi_deg) / self.res_v_deg)  # 31

    @property
    def width(self) -> int:
        return self.x_max + 1  # 1801

    @property
    def height(self) -> int:
        return self.y_max + 1  # 32


@dataclass(frozen=True)
class BevSpec:
    """Bird's-eye-view rasterization grid.

    Defaults reproduce `modules/lidar/common/birds_eye_view_generator.py:41-46`:
    +-120 m extent, bin edges arange(-max_range, max_range, res) with x binned
    by res_x (reference passes RES=(1.33, 0.2) so res[1]=0.2 bins x and
    res[0]=1.33 bins y), MV3D log-density normalization with log base 64.
    """

    max_range: float = 120.0
    res_x: float = 0.2
    res_y: float = 1.33
    density_log_base: float = 64.0
    # Extra MV3D-style channels (max height / max intensity) beyond the
    # reference's density-only raster (the MV3D input encoding).
    with_height_channel: bool = True
    with_intensity_channel: bool = True

    def _nbins(self, res: float) -> int:
        # number of edges is ceil(2*max_range/res); bins = edges - 1
        n_edges = int(math.ceil((2.0 * self.max_range - 1e-12) / res))
        return n_edges - 1

    @property
    def nx(self) -> int:
        return self._nbins(self.res_x)

    @property
    def ny(self) -> int:
        return self._nbins(self.res_y)


@dataclass(frozen=True)
class ModelConfig:
    """FCN encoder-decoder geometry (`modules/lidar/train/model.py:93-192`)."""

    num_classes: int = 2
    num_corner_outputs: int = 24  # 8 corners x xyz
    use_regression: bool = True
    vertical_stride: int = 1  # 1 for lidar, 2 for camera
    batch_norm: bool = True  # feature-wise BN on the input
    # per-pixel-position BN over the flattened image (the reference's
    # USE_SAMPLE_WISE_BATCH_NORMALIZATION variant, model.py:110-113; the
    # shipped lidar_model.h5 uses this flavor)
    sample_wise_bn: bool = False
    # compute dtype of the conv stack; params stay float32 and the
    # outputs are cast to float32 ("bfloat16" halves activation bytes)
    dtype: str = "float32"
    # Output activation of the corner-regression head. The reference uses
    # relu (model.py:171-181) — but its targets c' = R^T(corners - pixel)
    # are SIGNED (measured: 56% of foreground target components are
    # negative, mean |c'| 2.7 m), so a relu head cannot represent them and
    # collapses to ~0; the reference never noticed because its uint8 label
    # cast (loader.py:251) had already destroyed the targets. "linear"
    # makes the corner vote work as designed (deliberate divergence,
    # PARITY.md #7); "relu" remains the reference-compat default and is
    # what the imported lidar_model.h5 uses.
    reg_output_activation: str = "relu"
    # Regression head family. "corner" = the reference's 24-dim per-pixel
    # corner-offset field consumed by the voting decode (predict.py:94-199).
    # "direct" = an 8-channel (center offset, l w h, sin/cos yaw) head
    # decoded by masked cluster averaging — the corner field does not
    # converge at this model scale (NOTES.md round-2 session 3); the
    # direct head is the framework's working-pose-regression extension.
    head: str = "corner"
    # Channel-width multiplier for the conv trunk (1 = the reference's
    # 4/6/12/16/8 geometry). The reference's widths bottleneck the
    # 24-dim corner-offset field (measured: predicted offsets collapse to
    # ~0.2x the target std at width 1); widen for assets that need a
    # working regression head. Output/head channel counts are unchanged.
    width_multiplier: int = 1
    # Direct head's yaw channel layout. "single" = one sin/cos pair in
    # the frame DecodeConfig.direct_yaw_frame names. "dual" = BOTH codecs
    # (sin/cos local then sin/cos global, 10 regression channels): each
    # codec is learnable only on the surface family whose observability
    # matches it (local on oriented, global on symmetric — NOTES.md
    # round-3 sessions B/D), and on the mismatched family the L2-optimal
    # prediction collapses toward the zero vector, so the DECODE can
    # gate per cluster on the mean predicted vector's magnitude
    # (direct_yaw_frame="auto") — one asset across surface families.
    yaw_codec: str = "single"


@dataclass(frozen=True)
class LossConfig:
    """Class-balanced weighted loss (`modules/lidar/train/model.py:26-91`)."""

    use_w1: bool = True
    use_w2: bool = True
    obj_to_bkg_ratio: float = 0.00016
    avg_obj_size: float = 1000.0
    weight_bb: float = 0.01
    loss_scaler: float = 1000.0
    # When set, regression loss is masked to pixels whose target 24-dim
    # corner-offset norm is below this bound. The reference supervises the
    # whole footprint RECT (encoder.py:164-168), which includes pixels
    # whose ray passes the rect but hits distant clutter — their targets
    # c' = R^T(corners - p) span tens of meters (measured std 6.4 m vs
    # <= the box diagonal on surface pixels) and drown the learnable
    # signal. ~15.0 keeps every true surface pixel (sqrt(8)*diag ~ 13).
    # None = reference-compat (supervise the whole rect).
    reg_target_norm_clip: float | None = None
    # The reference computes `tf.norm` over the whole batch regression diff
    # (a scalar) instead of per pixel (`model.py:77-80`). We default to the
    # fixed per-pixel norm; set reference_compat=True to reproduce the quirk.
    reference_compat: bool = False
    # Per-channel multipliers on the regression diff, length = number of
    # regression channels (24 corner / 8 direct). The per-pixel L2 norm is
    # taken over ALL channels jointly, so small-magnitude channels (the
    # direct head's sin/cos yaw, <= 0.43) are gradient-starved next to
    # meter-scale dc channels — measured: 12k wide-yaw steps left
    # corr(yaw_pred, yaw_gt) at 0.07 while dc converged to 0.77 m. None =
    # uniform (reference semantics).
    reg_channel_weights: tuple[float, ...] | None = None
    epsilon: float = 1e-7  # keras K.epsilon()


@dataclass(frozen=True)
class TrainConfig:
    batch_size: int = 64
    epochs: int = 100
    learning_rate: float = 1e-3
    k_negative_sample_ratio_weight: float = 4.0
    augment: bool = True
    seed: int = 0
    checkpoint_every_epochs: int = 1
    keep_checkpoints: int = 5
    log_every_steps: int = 10
    # accumulate gradients over N micro-batches before applying the update
    # (effective batch = batch_size * grad_accum_steps); 1 = off
    grad_accum_steps: int = 1
    # pull metrics/loss to host only every N steps: the train loop stays
    # async (no per-step device round-trip) and divergence is still
    # detected within N steps of the event
    divergence_check_every: int = 25
    # learning-rate schedule: "constant" (reference lidar trainer,
    # `modules/lidar/train/model.py:186`) or "cosine" (decay to
    # lr_final_fraction * learning_rate over lr_decay_steps optimizer
    # steps — device-side, no host feedback loop; the plateau-feedback
    # alternative lives in the fusion trainer)
    lr_schedule: str = "constant"
    lr_decay_steps: int = 0  # 0 with "cosine" = epochs * 100 heuristic
    lr_final_fraction: float = 0.01


@dataclass(frozen=True)
class DecodeConfig:
    """Pose decode thresholds (`modules/lidar/train/predict.py:28-31`)."""

    min_prob: float = 0.5
    min_bbox_area: float = 100.0
    min_heat: float = 2.0
    max_bbox_dist: float = 5.0
    # nearest-surface -> centroid range correction (`predict.py:283`)
    range_offset: float = 0.75
    # candidate-pixel scan margins around the 2D bbox (`predict.py:103-104`)
    margin_x: int = 100
    margin_y: int = 2
    # is_far rejection deltas (`predict.py:85`)
    far_delta: tuple[float, float, float] = (9.0, 3.0, 3.0)
    # fixed candidate budget for the corner vote (the reference uses an
    # unbounded python list; we cap for static shapes — overflow is
    # reported per frame in decode_frame's 'vote_overflow' output)
    max_candidates: int = 2048
    # static column window extracted around the 2D bbox for the vote; covers
    # the reference's scan span (bbox +- margin_x) for bboxes up to
    # vote_window - 2*margin_x columns wide
    vote_window: int = 512
    # upper bound on connected-component label propagation sweeps
    max_cc_iters: int = 128
    # Direct-head center estimator (decode_frame_direct):
    #   backproject — surface pixel + the fixed range_offset (reference
    #                 semantics, predict.py:283)
    #   geometric   — surface pixel pushed outward by half the box's radial
    #                 extent computed from the head's own l/w/yaw: the
    #                 visible face of a beam-structured scan sits a
    #                 size-dependent distance in front of the center, so
    #                 the fixed 0.75 m is the wrong constant
    #   surface     — prob-weighted mean of the cluster's raw surface
    #                 points + the same geometric push: averaging tens of
    #                 returns cuts the lateral error that dominates box
    #                 IoU vs the single bbox-center pixel
    #   head        — probability-weighted average of the per-pixel decoded
    #                 centers (exact inverse of encode_direct_label)
    #   fit         — consensus seed + model-based surface fit: Gauss-
    #                 Newton fit of the box's boundary curve (known size
    #                 from the head) to the cluster's raw 3D surface
    #                 points, jointly refining center AND yaw (ellipse
    #                 boundary; yaw is where the conv head is weakest —
    #                 see decode._fit_pose_to_surface). The largest
    #                 measured accuracy win of round 3: IoU 0.50 -> 0.66
    #                 (flagship) / 0.42 -> 0.66 (wide-yaw) on the
    #                 config-4 protocol.
    # Detector assets ship the mode they validated best with.
    direct_center: str = "backproject"
    # "fit" mode's boundary model: "ellipse" fits an oriented ellipse
    # with semi-axes fit_surface_scale*(l/2, w/2) — orientation becomes
    # observable from arc shape; "box" fits the l x w RECTANGLE outline
    # (scaled-Chebyshev residual, active-face Gauss-Newton) — the actual
    # task geometry the reference's decode assumed
    # (predict.py:166-197 derives l/w/h/yaw from a rectangle) and the
    # right model for real vehicles' L-shaped silhouettes; "circle" fits
    # a circle of radius fit_surface_scale*0.5*sqrt(l^2+w^2)
    # (rotationally symmetric obstacles — yaw stays the head's
    # estimate). The scale is the inset of the visible surface relative
    # to the box hull (real vehicles return off body panels inside the
    # bbox; the synthetic rounded-box scenes use 0.9 ellipse /
    # 0.8 circle; box scenes render the true rectangle, scale 1.0 —
    # asset jsons pin the value they were validated at).
    # "auto" (dual-codec assets): per cluster, fit BOTH the symmetric
    # circle boundary (scale fit_symmetric_scale) and the oriented
    # fit_boundary_oriented (scale fit_surface_scale), and keep the one
    # matching the codec the yaw gate picked (direct_yaw_frame="auto").
    fit_boundary: str = "ellipse"
    fit_surface_scale: float = 0.9
    fit_boundary_oriented: str = "ellipse"  # the oriented arm of "auto"
    fit_symmetric_scale: float = 0.8  # circle-arm scale in "auto" mode
    # Frame of the direct head's sin/cos yaw channels:
    #   local  — sin/cos(yaw - theta_pixel), the pixel's viewing-ray frame.
    #            A conv net is translation-equivariant along azimuth and the
    #            visible surface arc only encodes yaw RELATIVE to the ray,
    #            so global-yaw targets cannot generalize (measured: one
    #            batch overfits to corr 0.99, held-out scenes stay at 0.07).
    #            Local targets are learnable AND roll-invariant.
    #   global — raw sin/cos(yaw): the pre-round-3 codec, kept for shipped
    #            assets trained with it (their jsons pin this).
    #   auto   — dual-codec heads (ModelConfig.yaw_codec="dual", 12-channel
    #            output) only: per cluster, decode BOTH codecs and keep the
    #            one whose weighted-mean predicted vector has the larger
    #            magnitude. The targets are unit vectors; on the surface
    #            family where a codec is unobservable the L2-optimal
    #            prediction is the conditional mean over a near-uniform
    #            angle distribution ~ the zero vector, so magnitude IS the
    #            codec's own confidence signal.
    direct_yaw_frame: str = "local"


@dataclass(frozen=True)
class CameraConfig:
    """Camera input geometry (`modules/lidar/train/globals.py:19-21`,
    `modules/lidar/process/globals.py:15-16`)."""

    width: int = 1368
    height: int = 512
    channels: int = 1
    crop_top: int = 430
    crop_bottom: int = 942


@dataclass(frozen=True)
class MeshConfig:
    """Device-mesh layout for multi-chip execution.

    n_spatial > 1 adds a second mesh axis that partitions the range-view
    image width across chips (GSPMD spatial partitioning of the convs);
    the data axis then gets n_devices / n_spatial chips.
    """

    data_axis: str = "data"
    spatial_axis: str = "spatial"
    n_devices: int = 0  # 0 = use all available
    n_spatial: int = 1  # 1 = pure data parallelism


@dataclass(frozen=True)
class PipelineConfig:
    """Root config."""

    range_view: RangeViewSpec = RangeViewSpec()
    bev: BevSpec = BevSpec()
    model: ModelConfig = ModelConfig()
    loss: LossConfig = LossConfig()
    train: TrainConfig = TrainConfig()
    decode: DecodeConfig = DecodeConfig()
    camera: CameraConfig = CameraConfig()
    mesh: MeshConfig = MeshConfig()
    # fixed per-frame point budget (clouds are padded/truncated to this)
    max_points: int = 65536
    # "exact" reproduces the reference's nearest-wins collision rule
    # bit-for-bit; "packed" takes one fewer pass with a quantized winner
    # key (99.96% identical pixels on 32k-pt clouds; differing pixels pick
    # a point <=0.2% farther in L2) — see ops/scatter.py
    projection_method: str = "exact"

    def replace(self, **kw) -> "PipelineConfig":
        return dataclasses.replace(self, **kw)


DEFAULT = PipelineConfig()
