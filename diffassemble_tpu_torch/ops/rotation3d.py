"""Rotation3D — port of the JAX package's ``ops/rotation3d.py``.

The reference's ``Rotation3D`` container: one object holding a rotation as a
quaternion (wxyz), a rotation matrix, a 6D vector or an axis-angle vector,
with conversion between all of them (``ops/so3.py``), zero-quaternion
sanitization and application to point clouds. The JAX package's pytree
methods are plain tensor methods here: ``reshape``, ``__getitem__`` and
``to(device)``.
"""

from __future__ import annotations

import torch

from . import so3

_VALID = ("quat", "rmat", "6d", "axis_angle")
_TRAILING = {"quat": 1, "rmat": 2, "6d": 1, "axis_angle": 1}


class Rotation3D:
    """rot: trailing dims (4,) quat wxyz | (3, 3) rmat | (6,) 6d | (3,) rotvec."""

    def __init__(self, rot: torch.Tensor, rot_type: str = "quat"):
        if rot_type not in _VALID:
            raise ValueError(f"rot_type must be one of {_VALID}")
        rot = torch.as_tensor(rot)
        if rot_type == "quat":
            # zero-quat sanitization: all-zero rows → identity (reference :31-39)
            norm = torch.linalg.vector_norm(rot, dim=-1, keepdim=True)
            identity = torch.zeros_like(rot)
            identity[..., 0] = 1.0
            rot = torch.where(norm < 1e-8, identity, rot / torch.clamp(norm, min=1e-8))
        self._rot = rot
        self._rot_type = rot_type

    @property
    def rot(self) -> torch.Tensor:
        return self._rot

    @property
    def rot_type(self) -> str:
        return self._rot_type

    @property
    def shape(self) -> torch.Size:
        return self._rot.shape

    def to_quat(self) -> torch.Tensor:
        if self._rot_type == "quat":
            return self._rot
        return so3.matrix_to_quaternion(self.to_rmat())

    def to_rmat(self) -> torch.Tensor:
        t = self._rot_type
        if t == "rmat":
            return self._rot
        if t == "quat":
            return so3.quaternion_to_matrix(self._rot)
        if t == "6d":
            return so3.sixdof_to_matrix(self._rot)
        return so3.rotvec_to_rmat(self._rot)

    def to_6d(self) -> torch.Tensor:
        return so3.matrix_to_sixdof(self.to_rmat())

    def to_axis_angle(self) -> torch.Tensor:
        return so3.rmat_to_rotvec(self.to_rmat())

    def to_euler(self, order: str = "zyx", to_degree: bool = True) -> torch.Tensor:
        return so3.quaternion_to_euler(self.to_quat(), order=order, degrees=to_degree)

    def convert(self, rot_type: str) -> "Rotation3D":
        fn = {"quat": self.to_quat, "rmat": self.to_rmat, "6d": self.to_6d, "axis_angle": self.to_axis_angle}[rot_type]
        return Rotation3D(fn(), rot_type)

    def apply_rotation(self, points: torch.Tensor) -> torch.Tensor:
        """Rotate (..., N, 3) points by the (...,)-batched rotation."""
        return torch.einsum("...ij,...nj->...ni", self.to_rmat(), points)

    def compose(self, other: "Rotation3D") -> "Rotation3D":
        return Rotation3D(so3._mm(self.to_rmat(), other.to_rmat()), "rmat")

    def inverse(self) -> "Rotation3D":
        return Rotation3D(self.to_rmat().transpose(-1, -2), "rmat")

    def reshape(self, *shape) -> "Rotation3D":
        trailing = _TRAILING[self._rot_type]
        return Rotation3D(self._rot.reshape(*shape, *self._rot.shape[self._rot.dim() - trailing:]), self._rot_type)

    def __getitem__(self, idx) -> "Rotation3D":
        return Rotation3D(self._rot[idx], self._rot_type)

    def to(self, device) -> "Rotation3D":
        return Rotation3D(self._rot.to(device), self._rot_type)

    def __repr__(self) -> str:
        return f"Rotation3D({self._rot_type}, shape={tuple(self._rot.shape)})"
