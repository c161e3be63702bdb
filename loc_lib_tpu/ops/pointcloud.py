"""Fixed-shape point-cloud container.

Fixed-shape replacement of the reference's PCL cloud types
(/root/reference/LocUtils/include/LocUtils/common/point_types.h:18-169 and
sensor_data/cloud_data.hpp:13-28). Variable-length `pcl::PointCloud` becomes a
padded `(N, 3)` float32 array plus a validity mask so every downstream kernel
sees static shapes; per-point attributes (intensity, ring, relative time) ride
along as optional fields, standing in for `FullPointType`.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np


class PointCloud(NamedTuple):
    """Padded point cloud. Invalid rows have mask=False and xyz=PAD."""

    xyz: jax.Array               # (N, 3) float32
    mask: jax.Array              # (N,) bool
    intensity: Optional[jax.Array] = None  # (N,) float32
    ring: Optional[jax.Array] = None       # (N,) int32   (FullPointType ring)
    time: Optional[jax.Array] = None       # (N,) float32 (per-point rel. time)
    stamp: Optional[jax.Array] = None      # () float64-as-f32 scan timestamp

    @property
    def capacity(self) -> int:
        return self.xyz.shape[0]

    def count(self) -> jax.Array:
        return jnp.sum(self.mask.astype(jnp.int32))


# Padding coordinate for invalid points: far away so voxel/NN logic can also
# rely on geometry, not only on masks.
PAD_COORD = 1e6


def _pad_to(n_points: int, arr: np.ndarray, fill) -> np.ndarray:
    out = np.full((n_points,) + arr.shape[1:], fill, dtype=arr.dtype)
    out[: arr.shape[0]] = arr
    return out


def from_numpy(
    xyz: np.ndarray,
    capacity: Optional[int] = None,
    intensity: Optional[np.ndarray] = None,
    ring: Optional[np.ndarray] = None,
    time: Optional[np.ndarray] = None,
    stamp: float = 0.0,
) -> PointCloud:
    """Build a padded PointCloud from host arrays, dropping non-finite points
    (the reference's RemoveNanPoint, point_cloud_utils.cpp)."""
    xyz = np.asarray(xyz, dtype=np.float32).reshape(-1, 3)
    finite = np.isfinite(xyz).all(axis=1)
    xyz = xyz[finite]
    if intensity is not None:
        intensity = np.asarray(intensity, dtype=np.float32).reshape(-1)[finite]
    if ring is not None:
        ring = np.asarray(ring, dtype=np.int32).reshape(-1)[finite]
    if time is not None:
        time = np.asarray(time, dtype=np.float32).reshape(-1)[finite]

    n = xyz.shape[0]
    if capacity is None:
        capacity = max(int(2 ** np.ceil(np.log2(max(n, 1)))), 128)
    if n > capacity:
        raise ValueError(f"cloud with {n} points exceeds capacity {capacity}")

    mask = np.zeros((capacity,), dtype=bool)
    mask[:n] = True
    return PointCloud(
        xyz=jnp.asarray(_pad_to(capacity, xyz, PAD_COORD)),
        mask=jnp.asarray(mask),
        intensity=None if intensity is None else jnp.asarray(_pad_to(capacity, intensity, 0.0)),
        ring=None if ring is None else jnp.asarray(_pad_to(capacity, ring, -1)),
        time=None if time is None else jnp.asarray(_pad_to(capacity, time, 0.0)),
        stamp=jnp.float32(stamp),
    )


def to_numpy(pc: PointCloud) -> np.ndarray:
    """Valid points only, as a host (n, 3) array."""
    xyz = np.asarray(pc.xyz)
    mask = np.asarray(pc.mask)
    return xyz[mask]


def transform(pc: PointCloud, R: jax.Array, t: jax.Array) -> PointCloud:
    """Rigid transform of the valid points (padding stays far away)."""
    new_xyz = pc.xyz @ R.T + t
    new_xyz = jnp.where(pc.mask[:, None], new_xyz, pc.xyz)
    return pc._replace(xyz=new_xyz)


def concat(a: PointCloud, b: PointCloud) -> PointCloud:
    """Concatenate two padded clouds (capacity adds; attrs dropped)."""
    return PointCloud(
        xyz=jnp.concatenate([a.xyz, b.xyz], axis=0),
        mask=jnp.concatenate([a.mask, b.mask], axis=0),
    )


def compact(pc: PointCloud) -> PointCloud:
    """Move valid points to the front (stable), padding to the back.

    Keeps capacity; useful after filters so gathers touch a dense prefix.
    """
    order = jnp.argsort(~pc.mask, stable=True)
    take = lambda x: None if x is None else x[order]
    return PointCloud(
        xyz=pc.xyz[order],
        mask=pc.mask[order],
        intensity=take(pc.intensity),
        ring=take(pc.ring),
        time=take(pc.time),
        stamp=pc.stamp,
    )
