"""rtgs_tpu — differentiable ray-traced Gaussian splat renderer in JAX.

A from-scratch JAX/XLA/Pallas framework with the capabilities of the
reference ``fangjunzhou/rt-gaussian-splat-renderer`` (see SURVEY.md):
structure-of-arrays scenes, tile-binned per-pixel top-K selection (a
Pallas-Triton kernel on the GPU), mesh sharding over rays and primitives,
and a differentiable training loop.
"""

__version__ = "0.1.0"

from rtgs_tpu.gaussians import Gaussians, new_gaussians
from rtgs_tpu.rays import Rays, new_rays
from rtgs_tpu.camera import Camera, new_camera, camera_from_fov, generate_ray_grid
from rtgs_tpu.scene import load_scene, save_scene, random_scene, pad_scene

__all__ = [
    "Gaussians",
    "new_gaussians",
    "Rays",
    "new_rays",
    "Camera",
    "new_camera",
    "camera_from_fov",
    "generate_ray_grid",
    "load_scene",
    "save_scene",
    "random_scene",
    "pad_scene",
]
