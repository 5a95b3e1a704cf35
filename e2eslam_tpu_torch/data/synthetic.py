"""Procedural synthetic RGB-D sequences (analytic box scene, exact GT).

The test/benchmark workhorse: deterministic ray-cast rendering of the inside
of a textured axis-aligned box with a smooth camera trajectory. Colors are a
bandlimited 3D procedural texture evaluated at the hit point, so photometric
view-synthesis losses behave like real data (view-consistent, smooth
gradients); depth and poses are exact, so metric assertions can be tight.

Emits the reference dataset tuple layout (gradslam datasets, unpacked at
reference ``train_depth.py:254``):
  (colors [L,H,W,3] in 0..255, depths [L,H,W,1], intrinsics [4,4],
   poses [L,4,4] cam-to-world, transforms [L,4,4] relative)
with the same windowing knobs (seqlen / dilation / stride / start).
"""

from __future__ import annotations

import numpy as np

from e2eslam_tpu_torch.data.windowing import make_windows, poses_to_transforms_np

BOX = np.array([4.0, 3.0, 5.0])  # box extents (meters); interior scene
# Interior spheres break the planar degeneracy of a bare box (tangential
# motion along a wall is unobservable to geometry-only ICP). Placed well
# clear of the camera path (x in [1.4,2.6], y in [1.4,1.6], z in [0.8,4.2])
# so the camera never grazes a surface (near-zero depths destabilize
# training — observed as a quality collapse at the graze frames).
SPHERES = (
    (np.array([0.65, 0.65, 3.6]), 0.45),
    (np.array([3.35, 2.35, 2.1]), 0.40),
    (np.array([1.55, 0.55, 4.45]), 0.50),  # near the far wall, in early views
)


def _texture(X: np.ndarray, textureless_frac: float = 0.0) -> np.ndarray:
    """Bandlimited RGB texture of world position X [..., 3] -> [..., 3].

    ``textureless_frac`` > 0 replaces roughly that fraction of the surface
    with flat constant-color patches (a low-frequency world-space mask, so
    the patches are view-consistent like painted walls). Photometric view
    synthesis gets ZERO gradient inside them — the regime where the
    reference's 3D point supervision is supposed to carry the signal
    (VERDICT r2 next-round #3; reference online_adaption.py:638-645).
    """
    x, y, z = X[..., 0], X[..., 1], X[..., 2]
    r = 0.5 + 0.20 * np.sin(3.1 * x + 1.7 * z) + 0.15 * np.sin(7.3 * y)
    g = 0.5 + 0.20 * np.sin(2.3 * y + 1.1 * x) + 0.15 * np.sin(5.9 * z)
    b = 0.5 + 0.20 * np.sin(2.9 * z + 1.3 * y) + 0.15 * np.sin(6.7 * x)
    rgb = np.clip(np.stack([r, g, b], axis=-1), 0.0, 1.0)
    if textureless_frac > 0.0:
        # Low-frequency mask; sin of a linear form is ~uniform on [-1, 1],
        # so the > (1 - 2*frac) cut selects ~frac of the surface in a few
        # large connected patches.
        m = np.sin(0.9 * x + 0.7 * z + 1.1 * y + 0.4)
        flat = m > (1.0 - 2.0 * float(textureless_frac))
        rgb = np.where(flat[..., None], 0.55, rgb)
    return rgb


def _pose_revisit(t: float) -> np.ndarray:
    """Out-and-back trajectory: the camera advances down the box and RETURNS
    through previously mapped space (z period ~12.6 t-units, one full cycle
    in a 60-frame dilation-2 window at dt=0.08). Revisits make the implicit
    one-keyframe index window duplicate surfels unless a second index level
    re-associates them (MODEL.index_levels: 2)."""
    C = np.array(
        [
            2.0 + 0.45 * np.sin(0.9 * t),
            1.5 + 0.10 * np.sin(1.3 * t),
            2.5 + 1.5 * np.sin(0.5 * t),
        ]
    )
    yaw = 0.12 * np.sin(0.7 * t)
    pitch = 0.05 * np.sin(1.1 * t)
    cy, sy = np.cos(yaw), np.sin(yaw)
    cp, sp = np.cos(pitch), np.sin(pitch)
    Ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    Rx = np.array([[1, 0, 0], [0, cp, -sp], [0, sp, cp]])
    T = np.eye(4)
    T[:3, :3] = Ry @ Rx
    T[:3, 3] = C
    return T


def _pose(t: float) -> np.ndarray:
    """Smooth trajectory inside the box: gentle arc + slow yaw. c2w [4,4].

    All coordinates are bounded oscillations so the camera stays strictly
    inside the box for ANY frame index (an unbounded z-drift once walked the
    camera through the far wall, making rays miss every face -> inf depth ->
    NaN textures poisoning downstream training).
    """
    C = np.array(
        [
            2.0 + 0.6 * np.sin(0.9 * t),
            1.5 + 0.10 * np.sin(1.3 * t),
            2.5 + 1.7 * np.sin(0.21 * t),
        ]
    )
    yaw = 0.12 * np.sin(0.7 * t)
    pitch = 0.05 * np.sin(1.1 * t)
    cy, sy = np.cos(yaw), np.sin(yaw)
    cp, sp = np.cos(pitch), np.sin(pitch)
    Ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    Rx = np.array([[1, 0, 0], [0, cp, -sp], [0, sp, cp]])
    R = Ry @ Rx
    T = np.eye(4)
    T[:3, :3] = R
    T[:3, 3] = C
    return T


def _render(pose: np.ndarray, K: np.ndarray, height: int, width: int,
            textureless_frac: float = 0.0,
            textureless_spheres: bool = False):
    """Ray-cast the box interior. Returns (color [H,W,3] in [0,1], depth [H,W,1])."""
    xs, ys = np.meshgrid(np.arange(width), np.arange(height))
    d_cam = np.stack(
        [(xs - K[0, 2]) / K[0, 0], (ys - K[1, 2]) / K[1, 1], np.ones_like(xs, np.float64)],
        axis=-1,
    )  # [H, W, 3], z = 1 so ray parameter == z-depth
    R, C = pose[:3, :3], pose[:3, 3]
    d_w = d_cam @ R.T  # [H, W, 3]

    best_s = np.full((height, width), np.inf)
    # The 6 box faces: axis-aligned planes at 0 and BOX[axis].
    for axis in range(3):
        for value in (0.0, BOX[axis]):
            denom = d_w[..., axis]
            with np.errstate(divide="ignore", invalid="ignore"):
                s = (value - C[axis]) / denom
                hit = C[None, None, :] + s[..., None] * d_w
            ok = (s > 1e-6) & np.isfinite(s)
            for other in range(3):
                if other != axis:
                    ok &= (hit[..., other] >= -1e-6) & (hit[..., other] <= BOX[other] + 1e-6)
            best_s = np.where(ok & (s < best_s), s, best_s)

    # Interior spheres: smallest positive root of |C + s d - O|^2 = r^2.
    for center, radius in SPHERES:
        oc = C - center
        b = np.sum(d_w * oc[None, None, :], axis=-1)
        c0 = np.dot(oc, oc) - radius * radius
        a = np.sum(d_w * d_w, axis=-1)
        disc = b * b - a * c0
        with np.errstate(invalid="ignore", divide="ignore"):
            sq = np.sqrt(np.maximum(disc, 0.0))
            s1 = (-b - sq) / a
            s2 = (-b + sq) / a
        s = np.where(s1 > 1e-6, s1, s2)
        ok = (disc > 0) & (s > 1e-6)
        best_s = np.where(ok & (s < best_s), s, best_s)

    # Defensive clamp: a ray that misses every face (degenerate pose) gets a
    # finite far depth instead of inf (keeps the pipeline NaN-free).
    best_s = np.minimum(best_s, 100.0)
    hit = C[None, None, :] + best_s[..., None] * d_w
    color = _texture(hit, textureless_frac)
    if textureless_spheres:
        # Flat-shade every sphere: CURVED geometry under constant color —
        # photometric view synthesis is blind there and edge-aware
        # smoothness extrapolates the (wrong) planar assumption across the
        # bulge; only multi-view 3D consistency carries a signal.
        on_sphere = np.zeros(best_s.shape, bool)
        for center, radius in SPHERES:
            on_sphere |= (
                np.linalg.norm(hit - center[None, None, :], axis=-1)
                < radius + 1e-3
            )
        color = np.where(on_sphere[..., None], 0.55, color)
    depth = best_s.astype(np.float32)[..., None]  # d_cam z == 1
    assert np.isfinite(depth).all() and np.isfinite(color).all()
    return color.astype(np.float32), depth




class SyntheticDataset:
    """Windowed synthetic RGB-D sequence dataset (gradslam-style args)."""

    def __init__(
        self,
        seqlen: int = 4,
        height: int = 256,
        width: int = 320,
        dilation: int = 0,
        stride: int = 1,
        start: int = 0,
        total_frames: int = 200,
        dt: float = 0.08,
        textureless_frac: float = 0.0,
        photo_jitter: float = 0.0,
        trajectory: str = "arc",
        textureless_spheres: bool = False,
    ):
        """``textureless_frac``/``photo_jitter``/``trajectory`` are the
        hard-mode knobs (VERDICT r2 next-round #3; all default OFF =
        bitwise-identical to the round-2 dataset):

        * textureless_frac: ~fraction of surface rendered as flat patches
          (zero photometric gradient there);
        * photo_jitter: per-frame exposure gain/offset + Gaussian pixel
          noise of this magnitude applied to COLOR ONLY (poses/depth stay
          exact), seeded by frame index — breaks brightness constancy the
          way real auto-exposure video does;
        * trajectory: "arc" (forward motion) or "revisit" (out-and-back
          pass through previously mapped space).
        """
        self.seqlen = seqlen
        self.height = height
        self.width = width
        self.textureless_frac = float(textureless_frac)
        self.textureless_spheres = bool(textureless_spheres)
        self.photo_jitter = float(photo_jitter)
        if trajectory not in ("arc", "revisit"):
            raise ValueError(f"unknown trajectory {trajectory!r}")
        self.trajectory = trajectory
        # gradslam semantics: dilation = frames skipped BETWEEN consecutive
        # extracted frames; stride = frames between window starts.
        self.dilation = dilation or 0
        self.stride = stride or 1
        self.start = start or 0
        self.total_frames = total_frames
        self.dt = dt

        fx = 0.75 * width  # ~55 deg horizontal FoV
        self.intrinsics = np.array(
            [
                [fx, 0, width / 2.0, 0],
                [0, fx, height / 2.0, 0],
                [0, 0, 1, 0],
                [0, 0, 0, 1],
            ],
            np.float32,
        )

        self.windows = make_windows(
            total_frames, seqlen, self.dilation, self.stride, self.start
        )
        if not self.windows:
            raise ValueError(
                f"no complete windows: seqlen={seqlen} dilation={self.dilation} "
                f"start={self.start} exceed total_frames={total_frames}"
            )
        self._cache = {}

    def __len__(self) -> int:
        return len(self.windows)

    def _frame(self, idx: int):
        if idx not in self._cache:
            pose_fn = _pose if self.trajectory == "arc" else _pose_revisit
            pose = pose_fn(idx * self.dt).astype(np.float32)
            color, depth = _render(
                pose, self.intrinsics, self.height, self.width,
                self.textureless_frac, self.textureless_spheres,
            )
            if self.photo_jitter > 0.0:
                # Deterministic per-frame camera-response jitter: exposure
                # gain + offset + pixel noise on color only.
                j = self.photo_jitter
                rng = np.random.default_rng(1000 + idx)
                gain = 1.0 + j * rng.uniform(-1.0, 1.0)
                offset = 0.5 * j * rng.uniform(-1.0, 1.0)
                noise = (0.5 * j) * rng.standard_normal(color.shape)
                color = np.clip(
                    gain * color + offset + noise.astype(np.float32), 0.0, 1.0
                ).astype(np.float32)
            self._cache[idx] = (color, depth, pose)
        return self._cache[idx]

    def __getitem__(self, i: int):
        frames = [self._frame(idx) for idx in self.windows[i]]
        colors = np.stack([f[0] for f in frames]) * 255.0
        depths = np.stack([f[1] for f in frames])
        poses = np.stack([f[2] for f in frames])
        transforms = poses_to_transforms_np(poses)
        return colors, depths, self.intrinsics.copy(), poses, transforms
