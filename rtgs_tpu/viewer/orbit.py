"""Orbit-camera controller — the reference viewer's camera state machine
(``/root/reference/src/rtgs/__main__.py:103-146,189-251``) as a pure,
host-side module: spherical ``(theta, phi, r)`` orbit around a movable 3D
cursor, composed with a global scene rotation quaternion.

The reference drives this from ``ti.GUI`` mouse events; on an accelerator
host there is no windowing, so the same state machine instead serves (a) the offline
``orbit`` CLI (turntable renders) and (b) the HTTP viewer
(``rtgs_tpu/viewer/server.py``), which maps browser drag/scroll events to the
same ``pan / move_cursor / zoom`` transitions.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

from rtgs_tpu.utils import quaternion as quat


@dataclasses.dataclass
class OrbitState:
    """Viewer camera state (reference ``__main__.py:103-109,155-186``)."""

    theta: float = 0.0
    phi: float = math.pi / 2
    r: float = 1.0
    cursor: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(3))
    # Global scene rotation (the three GUI sliders, ``__main__.py:162-187``),
    # stored scalar-last.
    global_quat: np.ndarray = dataclasses.field(
        default_factory=lambda: np.array([0.0, 0.0, 0.0, 1.0]))
    cam_right: np.ndarray = dataclasses.field(
        default_factory=lambda: np.array([1.0, 0.0, 0.0]))
    cam_up: np.ndarray = dataclasses.field(
        default_factory=lambda: np.array([0.0, 0.0, 1.0]))

    pan_sensitivity: float = 2.0
    scroll_sensitivity: float = 0.1
    move_sensitivity: float = 2.0

    def pan(self, dx: float, dy: float) -> None:
        """LMB drag (``__main__.py:236-239``): dx/dy in normalized screen
        units."""
        self.theta -= dx * self.pan_sensitivity
        self.phi += dy * self.pan_sensitivity
        self.phi = max(0.0, min(self.phi, math.pi))

    def zoom(self, wheel_delta: float) -> None:
        """Scroll wheel (``__main__.py:211-212``): multiplicative zoom."""
        self.r += self.scroll_sensitivity * self.r * wheel_delta

    def move_cursor(self, dx: float, dy: float) -> None:
        """RMB drag moves the 3D cursor in the camera plane
        (``__main__.py:117-118,241-246``)."""
        self.cursor = update_cursor(
            self.cursor, dx * self.r * self.move_sensitivity,
            dy * self.r * self.move_sensitivity,
            self.cam_right, self.cam_up)

    def set_global_rotation(self, rx: float, ry: float, rz: float) -> None:
        """The three rotation sliders (``__main__.py:222-226``):
        ``global = qz · qy · qx``."""
        qx = np.asarray(quat.from_axis_angle(np.array([rx, 0.0, 0.0], np.float32)))
        qy = np.asarray(quat.from_axis_angle(np.array([0.0, ry, 0.0], np.float32)))
        qz = np.asarray(quat.from_axis_angle(np.array([0.0, 0.0, rz], np.float32)))
        import jax.numpy as jnp

        self.global_quat = np.asarray(
            quat.mul(jnp.asarray(qz), quat.mul(jnp.asarray(qy), jnp.asarray(qx))))

    def camera_pose(self):
        """Current (position, rotation_quat) for the renderer."""
        pos, rot, right, up = orbit_camera_pose(
            self.theta, self.phi, self.r, self.cursor, self.global_quat)
        self.cam_right, self.cam_up = right, up
        return pos, rot


def update_cursor(cursor, u, v, cam_right, cam_up):
    """``cursor − u·cam_right − v·cam_up`` (reference ``__main__.py:117-118``)."""
    return np.asarray(cursor) - u * np.asarray(cam_right) - v * np.asarray(cam_up)


def orbit_camera_pose(theta, phi, r, cursor, global_quat):
    """The reference's ``update_camera_pose`` (``__main__.py:120-142``):
    camera on the sphere at ``(θ, φ, r)`` looking at the origin (z-up
    spherical), offset by the cursor, then the whole pose rotated by
    ``global_quat``.

    Returns (position (3,), rotation quat scalar-last (4,), cam_right,
    cam_up).
    """
    pos = np.array([
        r * math.cos(theta) * math.sin(phi),
        r * math.sin(theta) * math.sin(phi),
        r * math.cos(phi),
    ])
    look = -pos / np.linalg.norm(pos)
    cam_right = np.array([-math.sin(theta), math.cos(theta), 0.0])
    cam_up = np.cross(cam_right, look)
    # Columns = camera basis vectors (camera looks −z; __main__.py:129-133).
    rot_mat = np.stack([cam_right, cam_up, -look], axis=1)
    q = np.asarray(quat.from_rotation_matrix(rot_mat), dtype=np.float64)

    import jax.numpy as jnp

    gq = np.asarray(global_quat, dtype=np.float64)
    q_world = np.asarray(quat.mul(jnp.asarray(gq, jnp.float32),
                                  jnp.asarray(q, jnp.float32)))
    gmat = np.asarray(quat.as_rotation_mat3(jnp.asarray(gq, jnp.float32)))
    pos_world = gmat @ (pos + np.asarray(cursor))
    return pos_world, q_world, cam_right, cam_up
