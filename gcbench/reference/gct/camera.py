# -*- coding: utf-8 -*-
"""Camera model for the rasterizer (upstream conventions, bit-for-bit).

- ``K -> FoV``: fov = 2 * atan2(sensor, 2 * focal)
- OpenGL-style projection matrix from (fx, fy, cx, cy, near, far)
- the pose is (position, quaternion (qx, qy, qz, qw)); the rotation columns
  are permuted [F|R|U] -> [R|U|F] before the w2c matrix is built
- points are transformed by ``P @ w2c`` (column vectors)

Counterpart of ``gaussiancity_tpu/camera.py``.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from gcbench.reference.gct.device import resolve_device


class CameraParams(NamedTuple):
    """Per-render camera: host floats plus three small tensors on the
    render device."""

    img_h: int
    img_w: int
    tan_fovx: float
    tan_fovy: float
    focal_x: float
    focal_y: float
    view_matrix: torch.Tensor  # [4, 4] w2c
    full_proj: torch.Tensor  # [4, 4] == P @ w2c
    cam_pos: torch.Tensor  # [3]


def intrinsic_to_fov(focal_length: float, img_size: float) -> float:
    return 2.0 * np.arctan2(img_size, 2.0 * focal_length)


def projection_matrix(K: np.ndarray, sensor_size: Tuple[int, int],
                      z_near: float, z_far: float) -> np.ndarray:
    """OpenGL-style projection; ``sensor_size`` is (W, H)."""
    fx, fy = K[0, 0], K[1, 1]
    cx, cy = K[0, 2], K[1, 2]
    W, H = sensor_size
    P = np.zeros((4, 4), dtype=np.float32)
    P[0, 0] = 2.0 * fx / W
    P[1, 1] = 2.0 * fy / H
    P[0, 2] = 2.0 * cx / W - 1.0
    P[1, 2] = 2.0 * cy / H - 1.0
    P[2, 2] = -(z_far + z_near) / (z_far - z_near)
    P[3, 2] = -1.0
    P[2, 3] = -2.0 * z_far * z_near / (z_far - z_near)
    return P


def quat_xyzw_to_matrix(q):
    """Rotation matrix from a scipy-convention quaternion (x, y, z, w).

    A numpy input gives a float64 numpy matrix; a tensor input gives a
    tensor of its own dtype and device (the float32 device path)."""
    x, y, z, w = q[0], q[1], q[2], q[3]
    n = x * x + y * y + z * z + w * w
    if isinstance(q, torch.Tensor):
        s = torch.where(n > 0, 2.0 / n, torch.zeros_like(n))
    else:
        s = 2.0 / n if n > 0 else 0.0
    xx, yy, zz = x * x * s, y * y * s, z * z * s
    xy, xz, yz = x * y * s, x * z * s, y * z * s
    wx, wy, wz = w * x * s, w * y * s, w * z * s
    rows = [
        [1.0 - (yy + zz), xy - wz, xz + wy],
        [xy + wz, 1.0 - (xx + zz), yz - wx],
        [xz - wy, yz + wx, 1.0 - (xx + yy)],
    ]
    if isinstance(q, torch.Tensor):
        return torch.stack([torch.stack(r) for r in rows])
    return np.array(rows, dtype=np.float64)


def matrix_to_quat_xyzw(R: np.ndarray) -> np.ndarray:
    """Quaternion (x, y, z, w) from a rotation matrix (Shepperd's method,
    w >= 0 like scipy's ``Rotation.as_quat``)."""
    R = np.asarray(R, np.float64)
    m00, m11, m22 = R[0, 0], R[1, 1], R[2, 2]
    tr = m00 + m11 + m22
    k = int(np.argmax(np.array([tr, m00, m11, m22])))
    if k == 0:
        s = 2.0 * np.sqrt(1.0 + tr)
        q = np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0],
                      R[1, 0] - R[0, 1], 0.25 * s * s]) / s
    else:
        i = k - 1
        j, l = (i + 1) % 3, (i + 2) % 3
        s = 2.0 * np.sqrt(1.0 + R[i, i] - R[j, j] - R[l, l])
        q = np.empty(4)
        q[i] = 0.25 * s
        q[j] = (R[j, i] + R[i, j]) / s
        q[l] = (R[l, i] + R[i, l]) / s
        q[3] = (R[l, j] - R[j, l]) / s
    if q[3] < 0:
        q = -q
    return q


def world_to_camera(cam_position, cam_quaternion) -> np.ndarray:
    """Host float64 w2c matrix with the [F|R|U] -> [R|U|F] column swap,
    returned as float32."""
    R = quat_xyzw_to_matrix(np.asarray(cam_quaternion, dtype=np.float64))
    R = R[:, [1, 2, 0]]
    Rt = np.zeros((4, 4), dtype=np.float64)
    Rt[:3, :3] = R.T
    Rt[:3, 3] = -R.T @ np.asarray(cam_position, dtype=np.float64)
    Rt[3, 3] = 1.0
    return Rt.astype(np.float32)


def world_to_camera_f32(cam_position: torch.Tensor,
                        cam_quaternion: torch.Tensor) -> torch.Tensor:
    """The same matrix computed in float32 on the pose tensors' device."""
    R = quat_xyzw_to_matrix(cam_quaternion.float())[:, [1, 2, 0]]
    Rt = torch.zeros((4, 4), dtype=torch.float32,
                     device=cam_quaternion.device)
    Rt[:3, :3] = R.T
    Rt[:3, 3] = -R.T @ cam_position.float()
    Rt[3, 3] = 1.0
    return Rt


class CameraModel:
    """Shared-intrinsics camera; each pose gives a ``CameraParams``."""

    def __init__(self, K, sensor_size: Tuple[int, int],
                 z_near: float = 0.01, z_far: float = 50000.0):
        self.K = np.asarray(K, dtype=np.float64).reshape(3, 3)
        self.sensor_size = tuple(int(s) for s in sensor_size)  # (W, H)
        self.z_near = z_near
        self.z_far = z_far
        self.fov_x = intrinsic_to_fov(self.K[0, 0], self.sensor_size[0])
        self.fov_y = intrinsic_to_fov(self.K[1, 1], self.sensor_size[1])
        self.P = projection_matrix(self.K, self.sensor_size, z_near, z_far)

    def _params(self, w2c, full, cam_pos) -> CameraParams:
        W, H = self.sensor_size
        return CameraParams(
            img_h=H, img_w=W,
            tan_fovx=float(np.tan(self.fov_x * 0.5)),
            tan_fovy=float(np.tan(self.fov_y * 0.5)),
            focal_x=float(W / (2.0 * np.tan(self.fov_x * 0.5))),
            focal_y=float(H / (2.0 * np.tan(self.fov_y * 0.5))),
            view_matrix=w2c, full_proj=full, cam_pos=cam_pos)

    def params(self, cam_position, cam_quaternion,
               device=None) -> CameraParams:
        """Host (float64) pose math; the matrices land on ``device`` (the
        card unless the caller asks for the CPU, ``resolve_device``)."""
        w2c = world_to_camera(cam_position, cam_quaternion)
        full = self.P @ w2c
        c2w = np.linalg.inv(w2c)
        f32 = dict(dtype=torch.float32, device=resolve_device(device))
        return self._params(torch.as_tensor(w2c, **f32),
                            torch.as_tensor(full, **f32),
                            torch.as_tensor(c2w[:3, 3], **f32))

    def params_f32(self, cam_position: torch.Tensor,
                   cam_quaternion: torch.Tensor) -> CameraParams:
        """Float32 pose math on the pose tensors' device (the JAX
        package's ``params_traced``, used by the inference frame)."""
        w2c = world_to_camera_f32(cam_position, cam_quaternion)
        P = torch.as_tensor(self.P, dtype=torch.float32,
                            device=w2c.device)
        full = P @ w2c
        R, t = w2c[:3, :3], w2c[:3, 3]
        return self._params(w2c, full, -R.T @ t)
