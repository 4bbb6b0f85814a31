"""A cell's inputs, made from its seed on the device.

- The stand-in for a trained scene: ``rows`` Gaussians on the surfaces of
  a frozen copy of the port's synthetic teacher geometry (a ground
  patch, two tapered towers, an arch, a sphere), scales from each
  surface's sampling spacing with log-normal jitter, random rotations,
  seeded opacities (about 1% below MCMC's relocation threshold) and SH
  degree 3 features.
- The teacher that the views' images are rendered from: 60,000
  Gaussians on the same geometry at the teacher's sizes.
- Fixed camera poses on an orbit around the scene (the seed does not
  move them, so every seed asks for the same work).

Every tensor is drawn by a ``torch.Generator`` on the device in a few
large calls.
"""

from __future__ import annotations

import math
from typing import Dict, List, NamedTuple

import numpy as np
import torch

from .reference import render as ref

SH_C0 = 0.28209479177387814

# (name, share of the points, colour, area in m^2)
SURFACES = (
    ("ground", 0.25, (0.45, 0.42, 0.38), 4.0),
    ("tower_a", 0.125, (0.85, 0.2, 0.15), 0.764),
    ("tower_b", 0.125, (0.15, 0.45, 0.85), 0.764),
    ("arch", 0.25, (0.9, 0.75, 0.2), 0.29),
    ("sphere", 0.25, (0.2, 0.8, 0.35), 0.608),
)


def _split(n: int) -> List[int]:
    sizes = [int(n * s[1]) for s in SURFACES]
    sizes[-1] = n - sum(sizes[:-1])
    return sizes


def surface_points(n: int, gen: torch.Generator):
    """(positions [n, 3], colours [n, 3], spacing [n]) on the teacher's
    surfaces, ``SURFACES``' shares of the points each."""
    dev = gen.device
    sizes = _split(n)

    def u(m, lo=0.0, hi=1.0):
        return torch.rand(m, generator=gen, device=dev) * (hi - lo) + lo

    def nrm(m, s):
        return torch.randn(m, generator=gen, device=dev) * s

    pos = []
    m = sizes[0]                         # ground: y = 0.62
    pos.append(torch.stack([u(m, -1, 1), 0.62 + nrm(m, 0.01),
                            u(m, -1, 1)], 1))
    for m, (cx, cz) in zip(sizes[1:3], ((-0.45, 0.0), (0.45, 0.1))):
        y = u(m, -0.35, 0.6)             # towers: tapered shells
        r = 0.16 * (1.0 - 0.4 * (0.6 - y) / 0.95)
        ang = u(m, 0, 2 * math.pi)
        pos.append(torch.stack([cx + r * torch.cos(ang), y,
                                cz + r * torch.sin(ang)], 1))
    m = sizes[3]                         # arch: a half ellipse ribbon
    th = u(m, 0, math.pi)
    pos.append(torch.stack([0.55 * torch.cos(th) + nrm(m, 0.02),
                            -0.35 - 0.35 * torch.sin(th) + nrm(m, 0.02),
                            nrm(m, 0.05)], 1))
    m = sizes[4]                         # sphere
    d = torch.randn((m, 3), generator=gen, device=dev)
    d = d / torch.clamp(d.norm(dim=1, keepdim=True), min=1e-9)
    pos.append(d * 0.22 + torch.tensor([0.0, -0.05, -0.45], device=dev))
    rgb = torch.cat([torch.tensor(s[2], device=dev).expand(k, 3)
                     for s, k in zip(SURFACES, sizes)])
    rgb = torch.clamp(rgb + torch.randn(rgb.shape, generator=gen,
                                        device=dev) * 0.06, 0.02, 0.98)
    spacing = torch.cat([torch.full((k,), math.sqrt(s[3] / max(k, 1)),
                                    device=dev)
                         for s, k in zip(SURFACES, sizes)])
    return torch.cat(pos), rgb, spacing


def standin_cloud(rows: int, seed: int, device) -> Dict[str, torch.Tensor]:
    """The raw parameters (the port's layout: log scales, logit
    densities, SH DC and 45 higher coefficients) of ``rows`` Gaussians."""
    gen = torch.Generator(device=device).manual_seed(seed)
    pos, rgb, spacing = surface_points(rows, gen)
    jitter = torch.randn((rows, 3), generator=gen, device=device) * 0.3
    quat = torch.randn((rows, 4), generator=gen, device=device)
    density = 0.5 + torch.randn((rows, 1), generator=gen,
                                device=device) * 2.5
    spec = torch.randn((rows, 45), generator=gen, device=device) * 0.05
    return dict(positions=pos, rotation=quat,
                scale=torch.log(spacing)[:, None] + jitter, density=density,
                features_albedo=(rgb - 0.5) / SH_C0,
                features_specular=spec)


def teacher_cloud(seed: int, device, n: int = 60_000
                  ) -> Dict[str, torch.Tensor]:
    """The teacher's raw parameters: the same surfaces at the port's
    teacher sizes (scales 6-16 mm, opacity sigmoid(2), stronger view
    dependence)."""
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    pos, rgb, _ = surface_points(n, gen)
    scale = torch.log(torch.rand((n, 3), generator=gen, device=device)
                      * 0.010 + 0.006)
    return dict(positions=pos,
                rotation=torch.randn((n, 4), generator=gen, device=device),
                scale=scale, density=torch.full((n, 1), 2.0, device=device),
                features_albedo=(rgb - 0.5) / SH_C0,
                features_specular=torch.randn((n, 45), generator=gen,
                                              device=device) * 0.12)


def orbit_c2w(n: int, radius: float, elevations) -> List[np.ndarray]:
    """OpenCV camera-to-world poses (right, down, forward) looking at the
    origin from ``n`` azimuths, ``elevations`` (radians above the ground
    of the y-down world) cycled over them."""
    out = []
    for i in range(n):
        az = 2 * math.pi * i / n
        el = elevations[i % len(elevations)]
        eye = radius * np.asarray([math.cos(el) * math.sin(az), -math.sin(el),
                                   -math.cos(el) * math.cos(az)])
        fwd = -eye / np.linalg.norm(eye)
        right = np.cross(fwd, [0.0, -1.0, 0.0])
        right /= np.linalg.norm(right)
        down = np.cross(fwd, right)
        c2w = np.eye(4)
        c2w[:3, 0], c2w[:3, 1], c2w[:3, 2], c2w[:3, 3] = right, down, fwd, eye
        out.append(c2w)
    return out


def rotmat_to_quat(r: np.ndarray) -> np.ndarray:
    """Rotation matrix -> unit wxyz quaternion (Shepperd's method)."""
    t = np.trace(r)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        q = [0.25 * s, (r[2, 1] - r[1, 2]) / s, (r[0, 2] - r[2, 0]) / s,
             (r[1, 0] - r[0, 1]) / s]
    else:
        i = int(np.argmax(np.diag(r)))
        if i == 0:
            s = np.sqrt(1.0 + r[0, 0] - r[1, 1] - r[2, 2]) * 2
            q = [(r[2, 1] - r[1, 2]) / s, 0.25 * s, (r[0, 1] + r[1, 0]) / s,
                 (r[0, 2] + r[2, 0]) / s]
        elif i == 1:
            s = np.sqrt(1.0 + r[1, 1] - r[0, 0] - r[2, 2]) * 2
            q = [(r[0, 2] - r[2, 0]) / s, (r[0, 1] + r[1, 0]) / s, 0.25 * s,
                 (r[1, 2] + r[2, 1]) / s]
        else:
            s = np.sqrt(1.0 + r[2, 2] - r[0, 0] - r[1, 1]) * 2
            q = [(r[1, 0] - r[0, 1]) / s, (r[0, 2] + r[2, 0]) / s,
                 (r[1, 2] + r[2, 1]) / s, 0.25 * s]
    q = np.asarray(q)
    return q / np.linalg.norm(q)


class ViewPose(NamedTuple):
    """A pinhole view: camera-to-world pose and intrinsics."""
    c2w: np.ndarray
    width: int
    height: int
    focal: float

    @property
    def intrinsics(self):
        return [self.focal, self.focal, self.width / 2, self.height / 2]

    def world_to_camera(self):
        """(t [3], q [4]) float32 of the world -> camera pose."""
        r = self.c2w[:3, :3].T
        return ((-r @ self.c2w[:3, 3]).astype(np.float32),
                rotmat_to_quat(r).astype(np.float32))

    def reference_camera(self, device) -> ref.Camera:
        """The view as the reference's camera (the pose and intrinsics at
        the float32 values the port's camera holds)."""
        t, q = self.world_to_camera()
        fx, fy, cx, cy = (float(np.float32(v)) for v in self.intrinsics)
        return ref.Camera(self.width, self.height, fx, fy, cx, cy,
                          torch.tensor(t, device=device),
                          torch.tensor(q, device=device))


def views(conf: dict, kind: str) -> List[ViewPose]:
    """The configuration's training views (``kind`` "train") or its
    serving orbit ("serve")."""
    cam = conf["camera"]
    w, h = cam["resolution"]
    focal = cam["focal_over_height"] * h
    n = conf["views"] if kind == "train" else cam["serve_orbit_views"]
    els = [math.radians(e) for e in cam["elevations_deg"]]
    return [ViewPose(c, w, h, focal)
            for c in orbit_c2w(n, cam["orbit_radius"], els)]
