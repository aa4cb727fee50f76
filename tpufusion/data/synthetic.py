"""Synthetic scene generation for tests, benchmarks, and training demos.

The Didi challenge bags are not redistributable, so the framework ships a
deterministic scene synthesizer: a ground ring + uniform clutter + a dense
box-shaped cluster for the obstacle vehicle, with the ground-truth pose
expressed in the reference's corner convention (the box footprint orbits the
sensor origin by yaw — `modules/lidar/train/encoder.py:47-60` — so the
cluster is placed at Rz(yaw) @ center).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np


def synthesize_points_batch(
    key: jax.Array,
    batch: int,
    n_points: int = 16384,
    max_range: float = 60.0,
    max_yaw: float = 0.6,
    vary_size: bool = False,
) -> tuple[jax.Array, dict[str, jax.Array]]:
    """Returns (points (B, N, 4), gt dict with center/size/yaw (B, ...)).

    vary_size=True draws l/w/h from vehicle-like ranges instead of the
    fixed (4.2, 1.6, 1.5) — used to train size-predicting heads so the
    network must measure the cluster rather than memorise a constant.

    NB on max_yaw: the reference's corner convention orbits the box about
    the SENSOR ORIGIN by yaw (encoder.py:47-60), so the physical cluster
    sits at Rz(yaw) @ center while gt center stays unrotated. The cluster
    itself is axis-aligned, so yaw is UNOBSERVABLE from the image — with
    large |yaw| the pose-regression target is unlearnable and any decoded
    pose lands ~2 sin(|yaw|/2) * dist from gt (measured: that term alone
    explains 0.7-20 m "errors"). Detector training/eval scenes should use
    max_yaw ~ 0 (the reference's own real-data regime: the lead vehicle's
    rz was near zero); the default 0.6 keeps the historical distribution
    for geometry/projection tests, where yaw only moves the cluster."""
    keys = jax.random.split(key, 8)
    b, n = batch, n_points

    az = jax.random.uniform(keys[0], (b, n), minval=-np.pi, maxval=np.pi)
    rng_r = jax.random.uniform(keys[1], (b, n), minval=2.0, maxval=max_range)
    z = jax.random.uniform(keys[2], (b, n), minval=-1.9, maxval=0.5)
    intensity = jax.random.uniform(keys[3], (b, n), minval=0.0, maxval=100.0)
    x = rng_r * jnp.cos(az)
    y = rng_r * jnp.sin(az)

    # ground-truth pose
    dist = jax.random.uniform(keys[4], (b,), minval=8.0, maxval=30.0)
    angle = jax.random.uniform(keys[5], (b,), minval=-np.pi, maxval=np.pi)
    center = jnp.stack(
        [
            dist * jnp.cos(angle),
            dist * jnp.sin(angle),
            jnp.full((b,), -0.7),
        ],
        axis=-1,
    )
    yaw = jax.random.uniform(keys[6], (b,), minval=-max_yaw, maxval=max_yaw)
    if vary_size:
        lo = jnp.asarray([3.5, 1.4, 1.2])
        hi = jnp.asarray([5.5, 2.1, 1.9])
        size = jax.random.uniform(
            jax.random.fold_in(key, 11), (b, 3), minval=lo, maxval=hi
        )
    else:
        size = jnp.broadcast_to(jnp.asarray([4.2, 1.6, 1.5]), (b, 3))

    # dense vehicle cluster at the rotated spot, occupying the last n//8 slots
    m = n // 8
    c, s = jnp.cos(yaw), jnp.sin(yaw)
    spot = jnp.stack(
        [
            c * center[:, 0] - s * center[:, 1],
            s * center[:, 0] + c * center[:, 1],
            center[:, 2],
        ],
        axis=-1,
    )
    offs = jax.random.uniform(keys[7], (b, m, 3), minval=-1.0, maxval=1.0)
    half = size[:, None, :] / 2.0 * jnp.asarray([0.95, 0.95, 0.95])
    vpts = spot[:, None, :] + offs * half

    x = x.at[:, -m:].set(vpts[..., 0])
    y = y.at[:, -m:].set(vpts[..., 1])
    z = z.at[:, -m:].set(vpts[..., 2])

    points = jnp.stack([x, y, z, intensity], axis=-1).astype(jnp.float32)
    gt = {"center": center, "size": size, "yaw": yaw}
    return points, gt


def _clutter_with_clusters(
    kclutter: jax.Array,
    koffs: jax.Array,
    batch: int,
    n_points: int,
    centers: jax.Array,  # (B, V, 3) physical cluster centers
    sizes: jax.Array,  # (B, V, 3)
    max_range: float,
) -> jax.Array:
    """Shared scene assembly: uniform clutter ring + one dense box cluster
    per (frame, vehicle) stamped into the last V*m point slots. Returns
    points (B, N, 4)."""
    b, n = batch, n_points
    v = centers.shape[1]
    ks = jax.random.split(kclutter, 4)
    az = jax.random.uniform(ks[0], (b, n), minval=-np.pi, maxval=np.pi)
    rng_r = jax.random.uniform(ks[1], (b, n), minval=2.0, maxval=max_range)
    z = jax.random.uniform(ks[2], (b, n), minval=-1.9, maxval=0.5)
    intensity = jax.random.uniform(ks[3], (b, n), minval=0.0, maxval=100.0)
    x = rng_r * jnp.cos(az)
    y = rng_r * jnp.sin(az)

    m = (n // 8) // v  # points per vehicle cluster
    offs = jax.random.uniform(koffs, (b, v, m, 3), minval=-1.0, maxval=1.0)
    half = sizes[:, :, None, :] / 2.0 * 0.95
    vpts = centers[:, :, None, :] + offs * half  # (B, V, m, 3)
    vflat = vpts.reshape(b, v * m, 3)

    x = x.at[:, -v * m:].set(vflat[..., 0])
    y = y.at[:, -v * m:].set(vflat[..., 1])
    z = z.at[:, -v * m:].set(vflat[..., 2])
    return jnp.stack([x, y, z, intensity], axis=-1).astype(jnp.float32)


def synthesize_multi_vehicle_batch(
    key: jax.Array,
    batch: int,
    n_points: int = 16384,
    n_vehicles: int = 2,
    max_range: float = 60.0,
) -> tuple[jax.Array, dict[str, jax.Array]]:
    """Multi-obstacle scenes: V dense box clusters per frame at distinct
    azimuths (>= 0.7 rad apart so clusters never merge in the range
    view). Returns (points (B, N, 4), gt with center (B, V, 3), size
    (B, V, 3), yaw (B, V)). Feeds the top-K decode + multi-object
    tracking paths (the reference's decode could only ever emit its
    largest cluster, predict.py:58-71)."""
    assert 1 <= n_vehicles <= 5, (
        "slot spacing 2*pi/v with +-0.3 jitter keeps clusters disjoint "
        f"only for v <= 5 (got {n_vehicles})"
    )
    keys = jax.random.split(key, 4)
    b, v = batch, n_vehicles

    # vehicle angular slots: evenly spaced base angles + small jitter keep
    # every pair >= ~0.7 rad apart after the per-frame random rotation
    base = jnp.linspace(0.0, 2.0 * np.pi, v, endpoint=False)
    frame_rot = jax.random.uniform(
        keys[0], (b, 1), minval=-np.pi, maxval=np.pi
    )
    jitter = jax.random.uniform(keys[1], (b, v), minval=-0.3, maxval=0.3)
    angle = base[None, :] + frame_rot + jitter
    dist = jax.random.uniform(keys[2], (b, v), minval=8.0, maxval=30.0)
    center = jnp.stack(
        [dist * jnp.cos(angle), dist * jnp.sin(angle),
         jnp.full((b, v), -0.7)], axis=-1,
    )  # (B, V, 3)
    yaw = jnp.zeros((b, v))  # keep clusters axis-aligned at their spot
    size = jnp.broadcast_to(jnp.asarray([4.2, 1.6, 1.5]), (b, v, 3))

    points = _clutter_with_clusters(
        keys[3], jax.random.fold_in(key, 99), b, n_points, center, size,
        max_range,
    )
    return points, {"center": center, "size": size, "yaw": yaw}


def synthesize_tracking_sequence(
    key: jax.Array,
    frames: int,
    n_points: int = 16384,
    n_vehicles: int = 2,
    dt: float = 0.1,
    max_range: float = 60.0,
) -> tuple[jax.Array, dict[str, jax.Array]]:
    """Temporal sequence for multi-object tracking: V vehicles follow
    constant-velocity paths (per-axis speed <= 2 m/s, so planar speed up
    to 2*sqrt(2)) while background clutter is resampled every frame. Returns (points (F, N, 4), gt with center
    (F, V, 3), size (F, V, 3), yaw (F, V)). This is what BASELINE
    config 5's "multi-frame temporal tracking" actually needs — frames
    that are a coherent sequence, not independent scenes."""
    kframe, klayout, kvel = jax.random.split(key, 3)
    f, v = frames, n_vehicles

    # one layout + per-vehicle velocity, advanced over frames
    _, gt0 = synthesize_multi_vehicle_batch(klayout, 1, 64, v, max_range)
    c0 = gt0["center"][0]  # (V, 3)
    vel = jax.random.uniform(kvel, (v, 3), minval=-2.0, maxval=2.0)
    vel = vel.at[:, 2].set(0.0)
    t = jnp.arange(f, dtype=jnp.float32)[:, None, None] * dt
    centers = c0[None] + vel[None] * t  # (F, V, 3)

    # per-frame clutter + clusters at the advanced centers
    k1, k2 = jax.random.split(kframe)
    b = f
    size = jnp.broadcast_to(jnp.asarray([4.2, 1.6, 1.5]), (b, v, 3))
    points = _clutter_with_clusters(
        k1, k2, b, n_points, centers, size, max_range
    )
    return points, {"center": centers, "size": size, "yaw": jnp.zeros((b, v))}


def synthesize_dataset(
    seed: int, num_frames: int, n_points: int = 16384
) -> dict[str, np.ndarray]:
    """Host-side arrays for a whole synthetic sequence."""
    pts, gt = synthesize_points_batch(
        jax.random.PRNGKey(seed), num_frames, n_points
    )
    return {
        "points": np.asarray(pts),
        "center": np.asarray(gt["center"]),
        "size": np.asarray(gt["size"]),
        "yaw": np.asarray(gt["yaw"]),
        "timestamp": np.arange(num_frames, dtype=np.int64) * 100_000_000
        + 1_490_000_000_000_000_000,
    }


# ---------------------------------------------------------------------------
# Beam-structured synthetic Velodyne scans
# ---------------------------------------------------------------------------
#
# A real HDL-32E scan is nothing like uniform azimuth x elevation x range
# clutter: it has 32 discrete elevation beams (1.33 deg apart over
# -30.67..+10.67 — exactly the projector's VFOV/row grid,
# `modules/lidar/process/extract_rosbag_lidar.py:18-77`), an azimuthal
# sweep, near-full ground occupancy in the downward rows, range-dependent
# return density, and occlusion shadows behind every object. The
# generators below ray-cast a fixed-shape scene model per (beam, azimuth)
# ray — ground plane, vehicles as rounded boxes, K vertical clutter
# objects — and keep the nearest hit, so all of those structural
# properties emerge from geometry instead of being painted on.
# Rays with no return (or dropped by the range-dependent dropout model)
# are reported via a `valid` mask, matching the projector's padding
# contract (range_view.py: `valid` masks padding).


def surface_fit_params(scenes: str) -> tuple[str, float]:
    """(fit_boundary, fit_surface_scale) for a scene-family name — the
    decode's "fit" boundary model matching _raycast_scene's surface
    insets (ellipse semi-axes are 0.9*(l/2, w/2); the circle radius is
    0.8*0.5*sqrt(l^2+w^2)). Single source of truth: the trainer, the
    asset-json writer, and the operating-point tuner all derive the fit
    parameters here, so changing a ray-cast inset (or adding a scene
    family) cannot silently ship an asset whose boundary no longer
    matches the surface it was validated on.

    The "box" family deliberately shares NO constant with the fit: the
    ray-caster renders the true l x w rectangle (no inset) and the fit
    uses the HEAD's predicted l/w at scale 1.0 — the fit's only inputs
    are the network's size estimate and the raw surface returns, exactly
    the information the reference's decode had (predict.py:166-197
    derives l/w/h/yaw from a rectangle model). This is the
    oracle-sensitivity control."""
    if scenes == "mixed":
        # dual-codec cross-family assets: decode gates the boundary per
        # cluster (DecodeConfig.fit_boundary="auto"); the scale here is
        # the oriented arm's (the symmetric arm uses fit_symmetric_scale)
        return "auto", 0.9
    if scenes.endswith("ellipse"):
        return "ellipse", 0.9
    if scenes.endswith("box"):
        return "box", 1.0
    return "circle", 0.8


def _raycast_scene(
    key: jax.Array,
    batch: int,
    n_beams: int,
    n_azimuth: int,
    centers: jax.Array,  # (B, V, 3) physical cluster centers
    sizes: jax.Array,  # (B, V, 3)
    max_range: float,
    n_clutter: int,
    dropout: float,
    sensor_z: float = 0.0,
    ground_z: float = -1.9,
    vfov_lo_deg: float = -30.67,
    vfov_hi_deg: float = 10.67,
    vehicle_surface: str = "circle",
    yaws: jax.Array | None = None,  # (B, V) physical orientations (ellipse)
) -> tuple[jax.Array, jax.Array]:
    """Ray-cast (points (B, n_beams*n_azimuth, 4), valid (B, N) bool)."""
    if vehicle_surface not in ("circle", "ellipse", "box"):
        raise ValueError(f"unknown vehicle_surface {vehicle_surface!r}")
    if yaws is None:
        yaws = jnp.zeros(centers.shape[:2], centers.dtype)
    b, v = batch, centers.shape[1]
    n = n_beams * n_azimuth
    ks = jax.random.split(key, 8)

    # ray grid: beams exactly on the HDL-32 elevation comb, azimuth sweep
    # with a per-frame phase (real scans never start at the same angle)
    elev = jnp.deg2rad(
        jnp.linspace(vfov_lo_deg + 0.665, vfov_hi_deg - 0.665, n_beams)
    )  # beam centers, one per range-view row
    phase = jax.random.uniform(ks[0], (b, 1), minval=0.0, maxval=2 * np.pi)
    az = (
        jnp.arange(n_azimuth, dtype=jnp.float32)[None, :]
        * (2 * np.pi / n_azimuth)
        + phase
        + np.pi
    ) % (2 * np.pi) - np.pi  # (B, A) in [-pi, pi)
    az = jnp.broadcast_to(az[:, None, :], (b, n_beams, n_azimuth))
    phi = jnp.broadcast_to(elev[None, :, None], (b, n_beams, n_azimuth))
    az = az.reshape(b, n)
    phi = phi.reshape(b, n)
    tan_phi = jnp.tan(phi)

    big = jnp.float32(1e9)

    # --- ground plane: planar distance where the ray reaches ground_z;
    # upward beams never do. Gentle height noise breaks the perfect plane.
    g_noise = jax.random.normal(ks[1], (b, n)) * 0.02
    rho_ground = jnp.where(
        tan_phi < -1e-4, (ground_z + g_noise - sensor_z) / tan_phi, big
    )

    # --- vehicles: rounded-box obstacle per (frame, vehicle). Two surface
    # models:
    #   circle (default): the ray enters the circle of radius r_eff around
    #     the center (rotationally symmetric -> yaw is UNOBSERVABLE; the
    #     regime the reference's real data lived in, rz ~ 0);
    #   ellipse: an oriented ellipse with semi-axes (l/2, w/2) rotated by
    #     `yaws` — the physical orientation the reference's orbit-origin
    #     corner convention implies (encoder.py:47-60 rotates corners
    #     about the sensor origin, orienting the box by yaw as it orbits).
    #     Length/width anisotropy makes yaw and l-vs-w OBSERVABLE.
    #   box: the TRUE l x w rectangle (slab-method ray entry, no inset) —
    #     the L-shaped silhouette real vehicle scans show. This is the
    #     one family whose surface the decode's parametric fits do NOT
    #     generatively know (see surface_fit_params).
    # Either way the hit stands only if its height lands within the box's
    # z extent.
    d_v = jnp.linalg.norm(centers[..., :2], axis=-1)  # (B, V)
    alpha_v = jnp.arctan2(centers[..., 1], centers[..., 0])  # (B, V)
    dalpha = (az[:, None, :] - alpha_v[:, :, None] + np.pi) % (
        2 * np.pi
    ) - np.pi  # (B, V, N)
    if vehicle_surface == "ellipse":
        # ray p(t) = t*d from the origin; in the ellipse frame (rotate by
        # -yaw about the ellipse center, scale axes to a unit circle) it
        # is q(t) = q0 + t*dq with q0 = -S R (c), dq = S R d; entry is the
        # smaller root of |q(t)|^2 = 1.
        th = yaws  # (B, V) physical orientation
        ct, st_ = jnp.cos(th)[:, :, None], jnp.sin(th)[:, :, None]
        a = jnp.maximum(sizes[..., 0] / 2.0, 1e-3)[:, :, None] * 0.9
        bax = jnp.maximum(sizes[..., 1] / 2.0, 1e-3)[:, :, None] * 0.9
        cx, cy = centers[..., 0][:, :, None], centers[..., 1][:, :, None]
        dx, dy = jnp.cos(az)[:, None, :], jnp.sin(az)[:, None, :]
        # R(-th) @ v, then scale by (1/a, 1/b)
        q0x = (ct * -cx + st_ * -cy) / a
        q0y = (-st_ * -cx + ct * -cy) / bax
        dqx = (ct * dx + st_ * dy) / a
        dqy = (-st_ * dx + ct * dy) / bax
        A = dqx**2 + dqy**2
        Bq = q0x * dqx + q0y * dqy
        C = q0x**2 + q0y**2 - 1.0
        under = Bq**2 - A * C
        hit_az = under > 0.0
        rho_vehicle = (-Bq - jnp.sqrt(jnp.where(hit_az, under, 1.0))) / A
    elif vehicle_surface == "box":
        # slab-method ray/oriented-rectangle entry: ray p(t) = t*d from
        # the origin; in the box frame q(t) = t*d' - c' with
        # d' = R(-yaw) d, c' = R(-yaw) c. Entry at t_near =
        # max(axis slab minima), hit iff t_near <= t_far.
        th = yaws  # (B, V) physical orientation
        ct, st_ = jnp.cos(th)[:, :, None], jnp.sin(th)[:, :, None]
        hl = jnp.maximum(sizes[..., 0] / 2.0, 1e-3)[:, :, None]
        hw = jnp.maximum(sizes[..., 1] / 2.0, 1e-3)[:, :, None]
        cx, cy = centers[..., 0][:, :, None], centers[..., 1][:, :, None]
        dx, dy = jnp.cos(az)[:, None, :], jnp.sin(az)[:, None, :]
        dqx = ct * dx + st_ * dy
        dqy = -st_ * dx + ct * dy
        q0x = -(ct * cx + st_ * cy)
        q0y = -(-st_ * cx + ct * cy)

        def _slab(q0, dq, half):
            par = jnp.abs(dq) <= 1e-9
            safe = jnp.where(par, 1.0, dq)
            t1 = (-half - q0) / safe
            t2 = (half - q0) / safe
            tmin = jnp.minimum(t1, t2)
            tmax = jnp.maximum(t1, t2)
            inside = jnp.abs(q0) <= half  # parallel ray: all-or-nothing
            tmin = jnp.where(par, jnp.where(inside, -big, big), tmin)
            tmax = jnp.where(par, jnp.where(inside, big, -big), tmax)
            return tmin, tmax

        tx1, tx2 = _slab(q0x, dqx, hl)
        ty1, ty2 = _slab(q0y, dqy, hw)
        t_near = jnp.maximum(tx1, ty1)
        t_far = jnp.minimum(tx2, ty2)
        hit_az = (t_near <= t_far) & (t_far > 0.0)
        rho_vehicle = t_near
    else:
        r_eff = (
            0.5 * jnp.sqrt(sizes[..., 0] ** 2 + sizes[..., 1] ** 2) * 0.8
        )
        cross = d_v[:, :, None] * jnp.sin(dalpha)
        under = r_eff[:, :, None] ** 2 - cross**2
        hit_az = under > 0.0
        rho_vehicle = d_v[:, :, None] * jnp.cos(dalpha) - jnp.sqrt(
            jnp.where(hit_az, under, 1.0)
        )  # chord entry distance (B, V, N)
    z_at = sensor_z + rho_vehicle * tan_phi[:, None, :]
    zb = centers[..., 2] - sizes[..., 2] / 2.0  # (B, V)
    zt = centers[..., 2] + sizes[..., 2] / 2.0
    hit_veh = (
        hit_az
        & (rho_vehicle > 0.5)
        & (z_at >= zb[:, :, None])
        & (z_at <= zt[:, :, None])
    )
    surf_noise = jax.random.normal(ks[2], (b, v, n)) * 0.03
    rho_vehicle = jnp.where(hit_veh, rho_vehicle + surf_noise, big)
    rho_vehicle = jnp.min(rho_vehicle, axis=1)  # (B, N)

    # --- vertical clutter objects (poles, walls, bushes): azimuth
    # interval + distance + top height each; hit if the ray's height at
    # that distance falls between ground and the object top.
    kc = jax.random.split(ks[3], 4)
    c_az = jax.random.uniform(kc[0], (b, n_clutter), minval=-np.pi, maxval=np.pi)
    c_hw = jax.random.uniform(
        kc[1], (b, n_clutter), minval=0.003, maxval=0.035
    )  # 0.17..2 deg half-width
    c_d = jax.random.uniform(
        kc[2], (b, n_clutter), minval=3.0, maxval=max_range
    )
    c_top = jax.random.uniform(kc[3], (b, n_clutter), minval=-1.0, maxval=2.5)
    dca = (az[:, None, :] - c_az[:, :, None] + np.pi) % (2 * np.pi) - np.pi
    z_c = sensor_z + c_d[:, :, None] * tan_phi[:, None, :]
    hit_c = (
        (jnp.abs(dca) <= c_hw[:, :, None])
        & (z_c >= ground_z)
        & (z_c <= c_top[:, :, None])
    )
    rho_clutter = jnp.where(hit_c, c_d[:, :, None], big)
    # initial: n_clutter=0 (clean scenes) is a legal input
    rho_clutter = jnp.min(rho_clutter, axis=1, initial=big)  # (B, N)

    # --- nearest hit wins: occlusion shadows for free
    rho = jnp.minimum(jnp.minimum(rho_ground, rho_vehicle), rho_clutter)
    hit = rho < jnp.minimum(max_range, big * 0.5)

    # range-dependent dropout: returns fade with distance (absorption,
    # grazing incidence); plus a small uniform dropout floor
    p_drop = dropout * (0.35 + 0.65 * jnp.clip(rho / max_range, 0.0, 1.0))
    drop = jax.random.uniform(ks[4], (b, n)) < p_drop
    valid = hit & ~drop

    x = rho * jnp.cos(az)
    y = rho * jnp.sin(az)
    z = sensor_z + rho * tan_phi
    # intensity: vehicles bright, ground dim, clutter mixed
    base_i = jax.random.uniform(ks[5], (b, n), minval=3.0, maxval=25.0)
    veh_i = jax.random.uniform(ks[6], (b, n), minval=30.0, maxval=95.0)
    is_veh = rho_vehicle <= rho
    clut_i = jax.random.uniform(ks[7], (b, n), minval=5.0, maxval=70.0)
    is_clut = (rho_clutter <= rho) & ~is_veh
    intensity = jnp.where(is_veh, veh_i, jnp.where(is_clut, clut_i, base_i))

    # invalid rays: park at origin with zero intensity (projector drops
    # them via the valid mask; the parked values keep shapes finite)
    zero = jnp.float32(0.0)
    x = jnp.where(valid, x, zero)
    y = jnp.where(valid, y, zero)
    z = jnp.where(valid, z, zero)
    intensity = jnp.where(valid, intensity, zero)
    points = jnp.stack([x, y, z, intensity], axis=-1).astype(jnp.float32)
    return points, valid


def synthesize_beam_scan_batch(
    key: jax.Array,
    batch: int,
    n_points: int = 32768,
    n_beams: int = 32,
    max_range: float = 60.0,
    max_yaw: float = 0.05,
    vary_size: bool = False,
    n_clutter: int = 24,
    dropout: float = 0.12,
    angle_range: tuple[float, float] = (-np.pi, np.pi),
    vehicle_surface: str = "circle",
) -> tuple[jax.Array, dict[str, jax.Array], jax.Array]:
    """Beam-structured single-vehicle scenes.

    vehicle_surface="ellipse" renders an oriented (l/2, w/2) ellipse
    rotated by yaw — the physical orientation the reference's
    orbit-origin convention implies — making yaw and l-vs-w observable
    from geometry; "box" renders the true l x w rectangle (L-shaped
    silhouette, like real vehicle scans — the family no decode fit
    parameterizes exactly); the default "circle" is rotationally
    symmetric (yaw unobservable, the regime the reference's real data
    lived in).

    angle_range restricts the vehicle's spawn azimuth (e.g. a camera-FOV
    wedge for fusion training, where the camera must see the obstacle).

    Returns (points (B, N, 4), gt {center (B,3), size (B,3), yaw (B,)},
    valid (B, N)). N = n_points; the azimuth step count is n_points //
    n_beams (32 beams x 1024 az at the default 32768 — a ~0.35 deg step,
    i.e. an HDL-32 spinning fast; real pixels are 0.2 deg so rows are
    ~57% occupied where returns exist, like a real sparse sweep).

    Same GT conventions as synthesize_points_batch: the physical cluster
    sits at Rz(yaw) @ center (the reference's orbit-origin corner
    convention, encoder.py:47-60) while gt center stays unrotated, and
    max_yaw defaults to ~0 where the pose task is well-posed (NOTES.md
    round-2 session 3)."""
    assert n_points % n_beams == 0, (n_points, n_beams)
    n_azimuth = n_points // n_beams
    kpose, kscene = jax.random.split(key)
    ks = jax.random.split(kpose, 4)
    b = batch

    dist = jax.random.uniform(ks[0], (b,), minval=8.0, maxval=30.0)
    angle = jax.random.uniform(
        ks[1], (b,), minval=angle_range[0], maxval=angle_range[1]
    )
    center = jnp.stack(
        [dist * jnp.cos(angle), dist * jnp.sin(angle), jnp.full((b,), -0.7)],
        axis=-1,
    )
    yaw = jax.random.uniform(ks[2], (b,), minval=-max_yaw, maxval=max_yaw)
    if vary_size:
        lo = jnp.asarray([3.5, 1.4, 1.2])
        hi = jnp.asarray([5.5, 2.1, 1.9])
        size = jax.random.uniform(ks[3], (b, 3), minval=lo, maxval=hi)
    else:
        size = jnp.broadcast_to(jnp.asarray([4.2, 1.6, 1.5]), (b, 3))

    c, s = jnp.cos(yaw), jnp.sin(yaw)
    spot = jnp.stack(
        [
            c * center[:, 0] - s * center[:, 1],
            s * center[:, 0] + c * center[:, 1],
            center[:, 2],
        ],
        axis=-1,
    )
    points, valid = _raycast_scene(
        kscene, b, n_beams, n_azimuth, spot[:, None, :], size[:, None, :],
        max_range, n_clutter, dropout,
        vehicle_surface=vehicle_surface, yaws=yaw[:, None],
    )
    return points, {"center": center, "size": size, "yaw": yaw}, valid


def synthesize_beam_multi_vehicle_batch(
    key: jax.Array,
    batch: int,
    n_points: int = 32768,
    n_vehicles: int = 2,
    n_beams: int = 32,
    max_range: float = 60.0,
    n_clutter: int = 24,
    dropout: float = 0.12,
) -> tuple[jax.Array, dict[str, jax.Array], jax.Array]:
    """Beam-structured multi-obstacle scenes (cf.
    synthesize_multi_vehicle_batch: same slot layout so clusters stay
    disjoint in azimuth). Returns (points, gt with (B, V, ...) fields,
    valid)."""
    assert 1 <= n_vehicles <= 5
    assert n_points % n_beams == 0
    keys = jax.random.split(key, 4)
    b, v = batch, n_vehicles

    base = jnp.linspace(0.0, 2.0 * np.pi, v, endpoint=False)
    frame_rot = jax.random.uniform(keys[0], (b, 1), minval=-np.pi, maxval=np.pi)
    jitter = jax.random.uniform(keys[1], (b, v), minval=-0.3, maxval=0.3)
    angle = base[None, :] + frame_rot + jitter
    dist = jax.random.uniform(keys[2], (b, v), minval=8.0, maxval=30.0)
    center = jnp.stack(
        [dist * jnp.cos(angle), dist * jnp.sin(angle),
         jnp.full((b, v), -0.7)], axis=-1,
    )
    size = jnp.broadcast_to(jnp.asarray([4.2, 1.6, 1.5]), (b, v, 3))
    points, valid = _raycast_scene(
        keys[3], b, n_beams, n_points // n_beams, center, size, max_range,
        n_clutter, dropout,
    )
    return points, {"center": center, "size": size,
                    "yaw": jnp.zeros((b, v))}, valid


def synthesize_beam_tracking_sequence(
    key: jax.Array,
    frames: int,
    n_points: int = 32768,
    n_vehicles: int = 2,
    n_beams: int = 32,
    dt: float = 0.1,
    max_range: float = 60.0,
    n_clutter: int = 24,
    dropout: float = 0.12,
    oriented: bool = False,
) -> tuple[jax.Array, dict[str, jax.Array], jax.Array]:
    """Beam-structured temporal sequence (cf.
    synthesize_tracking_sequence): constant-velocity vehicles, clutter
    and sweep phase resampled per frame. Returns (points (F, N, 4), gt
    (F, V, ...), valid (F, N)).

    oriented=True renders each vehicle as an oriented ellipse heading
    along its velocity vector (the physically sensible orientation for
    a moving vehicle) instead of the rotationally symmetric circle
    surface. The gt dict stays in the reference's orbit convention like
    every other generator here (physical center = Rz(yaw) @ center,
    physical heading = yaw), so per-vehicle yaw is constant and equals
    the velocity heading, and "center" is the orbit tuple Rz(-yaw) of
    the physical path."""
    kframe, klayout, kvel = jax.random.split(key, 3)
    f, v = frames, n_vehicles

    _, gt0 = synthesize_multi_vehicle_batch(klayout, 1, 64, v, max_range)
    c0 = gt0["center"][0]  # (V, 3) physical positions at t=0
    vel = jax.random.uniform(kvel, (v, 3), minval=-2.0, maxval=2.0)
    vel = vel.at[:, 2].set(0.0)
    t = jnp.arange(f, dtype=jnp.float32)[:, None, None] * dt
    centers = c0[None] + vel[None] * t  # (F, V, 3) physical paths
    size = jnp.broadcast_to(jnp.asarray([4.2, 1.6, 1.5]), (f, v, 3))
    if not oriented:
        points, valid = _raycast_scene(
            kframe, f, n_beams, n_points // n_beams, centers, size,
            max_range, n_clutter, dropout,
        )
        return points, {"center": centers, "size": size,
                        "yaw": jnp.zeros((f, v))}, valid

    psi = jnp.arctan2(vel[:, 1], vel[:, 0])  # (V,) physical headings
    yaws = jnp.broadcast_to(psi[None], (f, v))
    points, valid = _raycast_scene(
        kframe, f, n_beams, n_points // n_beams, centers, size,
        max_range, n_clutter, dropout,
        vehicle_surface="ellipse", yaws=yaws,
    )
    # orbit tuple for the gt dict: center = Rz(-psi) @ physical
    c, s = jnp.cos(psi)[None], jnp.sin(psi)[None]  # (1, V)
    orbit = jnp.stack(
        [
            c * centers[..., 0] + s * centers[..., 1],
            -s * centers[..., 0] + c * centers[..., 1],
            centers[..., 2],
        ],
        axis=-1,
    )
    return points, {"center": orbit, "size": size, "yaw": yaws}, valid
