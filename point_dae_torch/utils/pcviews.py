"""Point-cloud view and voxel utilities on the host (port of
``point_dae_tpu/utils/pcviews.py``; reference visualizer/pc_utils.py).

The reference's PointNet-derived helpers (visualizer/pc_utils.py:23-209):
point-cloud <-> occupancy-volume conversion, ASCII-PLY read and write, and
the stacked three-view grayscale render (``point_cloud_three_views``).
Rendering goes through the port's native ball rasteriser
(``data/native_io.py:render_balls``, built from the same
``native/pointio.cpp`` as the JAX package's), one C call a view; the
voxelisers are vectorised numpy.
"""
from __future__ import annotations

import numpy as np


# ------------------------------------------------------- voxelization

def point_cloud_to_volume(points: np.ndarray, vsize: int,
                          radius: float = 1.0) -> np.ndarray:
    """Occupancy grid of shape (vsize, vsize, vsize) over
    [-radius, radius]^3 (pc_utils.py:40-53)."""
    vol = np.zeros((vsize, vsize, vsize), dtype=np.float32)
    voxel = 2 * radius / float(vsize)
    # floor before the int cast: astype truncates toward zero, which would
    # wrap points just below -radius into voxel index 0 instead of letting
    # the keep mask drop them
    loc = np.floor((np.asarray(points, np.float64) + radius)
                   / voxel).astype(np.int64)
    keep = ((loc >= 0) & (loc < vsize)).all(axis=1)
    loc = loc[keep]
    vol[loc[:, 0], loc[:, 1], loc[:, 2]] = 1.0
    return vol


def point_cloud_to_volume_batch(point_clouds: np.ndarray, vsize: int = 12,
                                radius: float = 1.0,
                                flatten: bool = True) -> np.ndarray:
    """Batch voxelization (pc_utils.py:23-37): (B,N,3) -> (B, vsize^3) when
    ``flatten`` else (B, vsize, vsize, vsize, 1)."""
    vols = np.stack([point_cloud_to_volume(pc, vsize, radius)
                     for pc in np.asarray(point_clouds)])
    if flatten:
        return vols.reshape(vols.shape[0], -1)
    return vols[..., None]


def volume_to_point_cloud(vol: np.ndarray) -> np.ndarray:
    """Occupied-voxel indices as an (M,3) float cloud (pc_utils.py:56-75)."""
    assert vol.ndim == 3 and len({*vol.shape}) == 1
    return np.argwhere(vol > 0.5).astype(np.float32)


# ------------------------------------------------------------ PLY IO

def write_ply(path: str, pts: np.ndarray) -> None:
    """ASCII PLY vertex dump (pc_utils.py:86-95 role)."""
    pts = np.asarray(pts, np.float32)
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n"
                f"element vertex {len(pts)}\n"
                "property float x\nproperty float y\nproperty float z\n"
                "end_header\n")
        for p in pts:
            f.write(f"{p[0]:.6f} {p[1]:.6f} {p[2]:.6f}\n")


def read_ply(path: str) -> np.ndarray:
    """Read the x/y/z columns of an ASCII PLY written by write_ply
    (pc_utils.py:78-83 role; binary PLY is out of scope)."""
    with open(path) as f:
        line = f.readline()
        assert line.strip() == "ply", f"not a PLY file: {path}"
        n = 0
        while True:
            line = f.readline()
            if not line:
                raise ValueError(f"no end_header in {path}")
            if line.startswith("element vertex"):
                n = int(line.split()[-1])
            if line.strip() == "end_header":
                break
        rows = [f.readline().split()[:3] for _ in range(n)]
    return np.asarray(rows, np.float32)


# ------------------------------------------------------- view renders

def _euler_rotate(pts: np.ndarray, zrot: float, yrot: float,
                  xrot: float) -> np.ndarray:
    """Apply R = Rz(zrot) @ Ry(yrot) @ Rx(xrot) (eulerangles.py:81-134
    convention used by draw_point_cloud, pc_utils.py:109-112)."""
    cz, sz = np.cos(zrot), np.sin(zrot)
    cy, sy = np.cos(yrot), np.sin(yrot)
    cx, sx = np.cos(xrot), np.sin(xrot)
    rz = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
    ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    rx = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
    return np.asarray(pts, np.float64) @ (rz @ ry @ rx).T


def draw_point_cloud(points: np.ndarray, canvas_size: int = 500,
                     zrot: float = 0.0, yrot: float = 0.0, xrot: float = 0.0,
                     normalize: bool = True) -> np.ndarray:
    """Grayscale ortho render after an euler rotation
    (pc_utils.py:98-155): returns (canvas_size, canvas_size) in [0,1]."""
    from ..data.native_io import render_balls

    pts = _euler_rotate(points, zrot, yrot, xrot)
    if normalize:
        pts = pts - pts.mean(0)
        pts = pts / max(np.linalg.norm(pts, axis=1).max(), 1e-6)
    colors = np.ones((pts.shape[0], 3), np.float32)
    img = render_balls(pts.astype(np.float32), colors,
                       h=canvas_size, w=canvas_size, radius=3.0)
    return img.mean(axis=-1)


def point_cloud_three_views(points: np.ndarray,
                            canvas_size: int = 500) -> np.ndarray:
    """Three stacked views (pc_utils.py:158-172): the reference's
    110/70-degree azimuth pair plus a top view, concatenated horizontally
    into one (canvas_size, 3*canvas_size) grayscale image."""
    deg = np.pi / 180.0
    img1 = draw_point_cloud(points, canvas_size,
                            zrot=110 * deg, xrot=45 * deg, yrot=0)
    img2 = draw_point_cloud(points, canvas_size,
                            zrot=70 * deg, xrot=135 * deg, yrot=0)
    img3 = draw_point_cloud(points, canvas_size,
                            zrot=180 * deg, xrot=90 * deg, yrot=0)
    return np.concatenate([img1, img2, img3], axis=1)
