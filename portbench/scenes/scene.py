"""The scene record every generator returns and both sides read."""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch


@dataclass
class Scene:
    """States, measurements and structure of one problem (or of a fused
    fleet of `windows` equal windows), float64 on one device.

    Poses are world-from-vehicle, quaternions [w, x, y, z]; a camera's
    sensor frame is vehicle-from-sensor `tvs`.  Landmarks are world points;
    with `inverse_depth` each has a reference pose and camera, and its
    observation there is `z_ref`, not a row of `obs_*`.  IMU spans join
    poses `imu_pose1` -> `imu_pose2` with M samples each."""

    # poses (P)
    q: torch.Tensor
    t: torch.Tensor
    v: torch.Tensor
    b: torch.Tensor
    time: torch.Tensor
    active: torch.Tensor
    cam_params: torch.Tensor          # (P, 7) per-pose intrinsics or zeros
    # cameras (C)
    cam: torch.Tensor                 # (C, 7) intrinsics
    cam_model: torch.Tensor           # (C,) model id (2: poly3)
    tvs_q: torch.Tensor
    tvs_t: torch.Tensor
    # landmarks (L)
    x_w: torch.Tensor                 # (L, 3) start positions
    ref_pose: torch.Tensor
    ref_cam: torch.Tensor
    z_ref: torch.Tensor               # (L, 2)
    has_z_ref: torch.Tensor
    # projection rows (N)
    obs_z: torch.Tensor
    obs_pose: torch.Tensor
    obs_lm: torch.Tensor
    obs_cam: torch.Tensor
    # IMU spans (Ni, M)
    imu_pose1: torch.Tensor
    imu_pose2: torch.Tensor
    imu_w: torch.Tensor
    imu_a: torch.Tensor
    imu_time: torch.Tensor
    gravity: torch.Tensor             # (3,)
    # layout
    inverse_depth: bool = False
    per_pose_intrinsics: bool = False
    windows: int = 1                  # equal, independent windows

    @property
    def n_poses(self) -> int:
        return self.q.shape[0]

    @property
    def n_lms(self) -> int:
        return self.x_w.shape[0]

    def tensors(self):
        return {f.name: getattr(self, f.name) for f in dataclasses.fields(self)
                if isinstance(getattr(self, f.name), torch.Tensor)}

    def rounded(self, dtype: torch.dtype) -> "Scene":
        """The scene with every float rounded to `dtype` and returned in
        float64: the numbers both sides start from."""
        def r(x):
            return x.to(dtype).to(torch.float64) if x.is_floating_point() \
                else x
        return dataclasses.replace(self, **{k: r(v) for k, v in
                                            self.tensors().items()})
