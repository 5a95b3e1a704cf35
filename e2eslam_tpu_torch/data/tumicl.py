"""ICL-NUIM and TUM RGB-D sequences from disk, windowed as gradslam windows them.

The reference builds ``gradslam.datasets.ICL/TUM`` (``online_adaption.py:72-87``);
these take the same knobs (basedir, seqlen, height, width, dilation, stride,
start, trajectories) and emit the same tuple as the synthetic dataset:
``(colors 0..255, depths, intrinsics, poses, transforms)``.

Formats:
  * ICL-NUIM "frei_png" exports: ``rgb/`` and ``depth/`` PNG directories
    (files sorted by their numeric names), poses in a TUM-format
    ``*.gt.freiburg`` file, frames aligned by index. Intrinsics 481.20,
    -480.0, 319.5, 239.5 (the renders' negative fy: the image's y axis is
    flipped in backprojection and projection).
  * TUM RGB-D: ``rgb.txt``, ``depth.txt``, ``groundtruth.txt``; each colour
    frame takes the nearest depth frame and pose by timestamp, within 20 ms,
    or is dropped. Intrinsics 525.0, 525.0, 319.5, 239.5.
Depth PNGs are 16-bit, 1/5000 m. Intrinsics are rescaled from the native
image size to (height, width).

Decoding: the native loader (``data/native_loader.py``: libpng, bilinear
colour and nearest depth resize) when it builds, else PIL (the same
filters); ``dataset.decoder`` says which ran. With neither, the dataset
raises and names both causes. Decoded frames are cached (bounded, shared
safely between threads), since overlapping windows hold each frame
``seqlen`` times.
"""

from __future__ import annotations

import glob
import os
import struct
import threading
from typing import List, Optional, Sequence

import numpy as np

from e2eslam_tpu_torch.data.windowing import make_windows, poses_to_transforms_np

DECODERS = ("native", "pil")


def _quat_to_rot(qx, qy, qz, qw) -> np.ndarray:
    n = np.sqrt(qx * qx + qy * qy + qz * qz + qw * qw)
    qx, qy, qz, qw = qx / n, qy / n, qz / n, qw / n
    return np.array([
        [1 - 2 * (qy * qy + qz * qz), 2 * (qx * qy - qz * qw), 2 * (qx * qz + qy * qw)],
        [2 * (qx * qy + qz * qw), 1 - 2 * (qx * qx + qz * qz), 2 * (qy * qz - qx * qw)],
        [2 * (qx * qz - qy * qw), 2 * (qy * qz + qx * qw), 1 - 2 * (qx * qx + qy * qy)],
    ])


def _tum_line_to_pose(vals: Sequence[float]) -> np.ndarray:
    tx, ty, tz, qx, qy, qz, qw = vals
    T = np.eye(4)
    T[:3, :3] = _quat_to_rot(qx, qy, qz, qw)
    T[:3, 3] = [tx, ty, tz]
    return T


def _read_tum_trajectory(path: str):
    """(timestamps [N], poses [N, 4, 4]) from a TUM-format file; lines that
    start with ``#`` are comments."""
    stamps, poses = [], []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            vals = [float(v) for v in line.split()]
            stamps.append(vals[0])
            poses.append(_tum_line_to_pose(vals[1:8]))
    return np.asarray(stamps), np.stack(poses)


def _png_size(path: str):
    """(width, height) from a PNG's header chunk."""
    with open(path, "rb") as f:
        head = f.read(24)
    if head[:8] != b"\x89PNG\r\n\x1a\n" or head[12:16] != b"IHDR":
        raise ValueError(f"{path} is not a PNG file")
    return struct.unpack(">II", head[16:24])


def _pil_image(path: str, height: int, width: int, *, nearest: bool) -> np.ndarray:
    from PIL import Image

    img = Image.open(path)
    if img.size != (width, height):
        img = img.resize((width, height), Image.NEAREST if nearest else Image.BILINEAR)
    return np.asarray(img)


def _pick_decoder(decoder: Optional[str]) -> str:
    """``decoder`` if given, else the native loader when it builds, else
    PIL; raises naming both causes when neither is available."""
    from e2eslam_tpu_torch.data import native_loader

    if decoder is not None and decoder not in DECODERS:
        raise ValueError(f"decoder {decoder!r}: one of {DECODERS}")
    causes = {}
    if decoder in (None, "native"):
        if native_loader.native_available():
            return "native"
        causes["native"] = native_loader.unavailable_reason()
    if decoder in (None, "pil"):
        try:
            import PIL.Image  # noqa: F401
            return "pil"
        except ImportError as exc:
            causes["pil"] = str(exc)
    raise RuntimeError("no PNG decoder available: " + "; ".join(
        f"{k}: {v}" for k, v in causes.items()))


class _RGBDDiskDataset:
    """Frame lists, windowing and the emitted tuple; the formats supply
    ``_find_trajectories``, ``_load_trajectory`` and ``_native_intrinsics``."""

    depth_scale = 5000.0
    _CACHE_FRAMES = 256  # decoded frames kept (~4 MB each at 640x480)

    def __init__(self, basedir: str, seqlen: int, height: int, width: int, dilation: int = 0,
                 stride: int = 1, start: int = 0, trajectories: Optional[Sequence[str]] = None,
                 decoder: Optional[str] = None):
        self.height, self.width = height, width
        self.seqlen = seqlen
        self.decoder = _pick_decoder(decoder)
        self._cache_lock = threading.Lock()
        self._frame_cache = {}
        self.rgb_files: List[str] = []
        self.depth_files: List[str] = []
        self.traj_dirs = list(self._find_trajectories(basedir, trajectories))
        self.windows: List[List[int]] = []
        self.window_traj: List[int] = []  # window -> trajectory
        self.traj_intrinsics: List[np.ndarray] = []  # per trajectory (sizes differ)
        poses_list = []
        offset = 0
        for t_idx, traj in enumerate(self.traj_dirs):
            rgb, depth, poses, native_size = self._load_trajectory(traj)
            self.rgb_files += rgb
            self.depth_files += depth
            poses_list.append(poses)
            for w in make_windows(len(rgb), seqlen, dilation, stride, start):
                self.windows.append([offset + i for i in w])
                self.window_traj.append(t_idx)
            offset += len(rgb)
            K = self._native_intrinsics().copy()
            K[0, :] *= width / float(native_size[0])
            K[1, :] *= height / float(native_size[1])
            K4 = np.eye(4, dtype=np.float32)
            K4[:3, :3] = K
            self.traj_intrinsics.append(K4)
        self.poses = np.concatenate(poses_list) if poses_list else np.zeros((0, 4, 4))
        if not self.windows:
            raise ValueError(
                f"no complete windows: seqlen={seqlen} dilation={dilation} "
                f"start={start} exceed the trajectory length(s) under {basedir}")
        self.intrinsics = self.traj_intrinsics[0]

    def _find_trajectories(self, basedir, trajectories):
        raise NotImplementedError

    def _load_trajectory(self, traj_dir):
        raise NotImplementedError

    def _native_intrinsics(self) -> np.ndarray:
        raise NotImplementedError

    def __len__(self):
        return len(self.windows)

    def _decode(self, idxs):
        """{frame: (colors [H,W,3], depths [H,W,1])} of ``idxs``, decoded."""
        if self.decoder == "native":
            from e2eslam_tpu_torch.data.native_loader import load_rgbd_batch

            out = load_rgbd_batch([self.rgb_files[k] for k in idxs],
                                  [self.depth_files[k] for k in idxs], self.height,
                                  self.width, depth_scale=self.depth_scale)
            if out is None:
                raise RuntimeError(f"the native loader failed to decode frames {idxs} "
                                   f"({self.rgb_files[idxs[0]]}, ...)")
            return {k: (out[0][j], out[1][j]) for j, k in enumerate(idxs)}
        frames = {}
        for k in idxs:
            c = _pil_image(self.rgb_files[k], self.height, self.width, nearest=False)
            d = _pil_image(self.depth_files[k], self.height, self.width, nearest=True)
            frames[k] = (c[..., :3].astype(np.float32),
                         d.astype(np.float32)[..., None] / self.depth_scale)
        return frames

    def _decoded_frames(self, idxs):
        """The window's frames through the bounded cache. Reads and writes of
        the cache hold the lock; decoding runs outside it, so two threads
        that miss the same frame at once both decode it. The returned rows
        are taken before a later eviction can drop them."""
        with self._cache_lock:
            hit = {k: self._frame_cache[k] for k in idxs if k in self._frame_cache}
        missing = [k for k in idxs if k not in hit]
        local = self._decode(missing) if missing else {}
        if local:
            with self._cache_lock:
                cache = self._frame_cache
                cache.update(local)
                needed = set(idxs)
                for k in list(cache):
                    if len(cache) <= self._CACHE_FRAMES:
                        break
                    if k not in needed:
                        cache.pop(k, None)
        frames = {**hit, **local}
        return (np.stack([frames[k][0] for k in idxs]),
                np.stack([frames[k][1] for k in idxs]))

    def __getitem__(self, i: int):
        idxs = self.windows[i]
        colors, depths = self._decoded_frames(idxs)
        poses = self.poses[idxs].astype(np.float32)
        transforms = poses_to_transforms_np(poses)
        K = self.traj_intrinsics[self.window_traj[i]]
        return colors, depths, K.copy(), poses, transforms


class ICLDataset(_RGBDDiskDataset):
    def _find_trajectories(self, basedir, trajectories):
        if trajectories:
            return [os.path.join(basedir, t) for t in trajectories]
        dirs = sorted(d for d in glob.glob(os.path.join(basedir, "*"))
                      if os.path.isdir(os.path.join(d, "rgb")))
        if not dirs and os.path.isdir(os.path.join(basedir, "rgb")):
            dirs = [basedir]
        if not dirs:
            raise FileNotFoundError(f"no ICL trajectories under {basedir}")
        return dirs

    def _load_trajectory(self, traj_dir):
        def numeric_sort(files):
            return sorted(files, key=lambda p: float(os.path.splitext(os.path.basename(p))[0]))

        rgb = numeric_sort(glob.glob(os.path.join(traj_dir, "rgb", "*.png")))
        depth = numeric_sort(glob.glob(os.path.join(traj_dir, "depth", "*.png")))
        gt = (glob.glob(os.path.join(traj_dir, "*.gt.freiburg"))
              + glob.glob(os.path.join(traj_dir, "groundtruth.txt")))
        if not (rgb and depth and gt):
            raise FileNotFoundError(f"incomplete ICL trajectory at {traj_dir}")
        _, poses = _read_tum_trajectory(gt[0])
        n = min(len(rgb), len(depth), len(poses))
        return rgb[:n], depth[:n], poses[:n], _png_size(rgb[0])

    def _native_intrinsics(self):
        return np.array([[481.20, 0, 319.5], [0, -480.0, 239.5], [0, 0, 1]], np.float32)


class TUMDataset(_RGBDDiskDataset):
    assoc_tolerance = 0.02  # seconds

    def _find_trajectories(self, basedir, trajectories):
        if trajectories:
            return [os.path.join(basedir, t) for t in trajectories]
        dirs = sorted(d for d in glob.glob(os.path.join(basedir, "*"))
                      if os.path.isfile(os.path.join(d, "rgb.txt")))
        if not dirs and os.path.isfile(os.path.join(basedir, "rgb.txt")):
            dirs = [basedir]
        if not dirs:
            raise FileNotFoundError(f"no TUM sequences under {basedir}")
        return dirs

    @staticmethod
    def _read_file_list(path):
        stamps, files = [], []
        base = os.path.dirname(path)
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                t, rel = line.split()[:2]
                stamps.append(float(t))
                files.append(os.path.join(base, rel))
        return np.asarray(stamps), files

    def _load_trajectory(self, traj_dir):
        rgb_t, rgb_f = self._read_file_list(os.path.join(traj_dir, "rgb.txt"))
        dep_t, dep_f = self._read_file_list(os.path.join(traj_dir, "depth.txt"))
        gt_t, gt_p = _read_tum_trajectory(os.path.join(traj_dir, "groundtruth.txt"))
        rgb, depth, poses = [], [], []
        for t, f in zip(rgb_t, rgb_f):
            di = int(np.argmin(np.abs(dep_t - t)))
            gi = int(np.argmin(np.abs(gt_t - t)))
            if (abs(dep_t[di] - t) < self.assoc_tolerance
                    and abs(gt_t[gi] - t) < self.assoc_tolerance):
                rgb.append(f)
                depth.append(dep_f[di])
                poses.append(gt_p[gi])
        if not rgb:
            raise FileNotFoundError(f"no associated frames in {traj_dir}")
        return rgb, depth, np.stack(poses), _png_size(rgb[0])

    def _native_intrinsics(self):
        return np.array([[525.0, 0, 319.5], [0, 525.0, 239.5], [0, 0, 1]], np.float32)
