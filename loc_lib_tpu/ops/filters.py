"""Cloud filters as mask transforms.

Fixed-shape equivalents of the reference `cloud_filter/` module
(/root/reference/LocUtils/src/model/cloud_filter/): `pcl::VoxelGrid` becomes
`voxel.voxel_downsample`, `pcl::CropBox` becomes a pure mask update (the box
filter is how localization crops its 150 m local map, box_filter.cpp:25-57),
and NoFilter is the identity. Filters never change array shapes — they only
flip mask bits — so pipelines stay shape-static under jit.
"""

from __future__ import annotations

import jax.numpy as jnp

from .pointcloud import PointCloud
from .voxel import voxel_downsample  # re-export for symmetry  # noqa: F401


def box_filter(pc: PointCloud, origin, size) -> PointCloud:
    """Keep points inside the axis-aligned box centered at `origin` with edge
    lengths `size` (the reference's origin+size -> min/max edge logic,
    box_filter.hpp:10-50)."""
    origin = jnp.asarray(origin, dtype=jnp.float32)
    size = jnp.asarray(size, dtype=jnp.float32)
    lo = origin - 0.5 * size
    hi = origin + 0.5 * size
    inside = jnp.all((pc.xyz >= lo) & (pc.xyz <= hi), axis=-1)
    return pc._replace(mask=pc.mask & inside)


def range_filter(pc: PointCloud, min_range: float = 0.0, max_range: float = jnp.inf) -> PointCloud:
    """Drop points closer than min_range / farther than max_range from the
    sensor (the subscribers' 4 m min-range cull, cloud_subscriber.cpp:100-135)."""
    r = jnp.linalg.norm(pc.xyz, axis=-1)
    keep = (r >= min_range) & (r <= max_range)
    return pc._replace(mask=pc.mask & keep)


def no_filter(pc: PointCloud) -> PointCloud:
    """Identity (cloud_filter/no_filter.cpp)."""
    return pc


def remove_nonfinite(pc: PointCloud) -> PointCloud:
    """Mask out non-finite points (RemoveNanPoint, point_cloud_utils.cpp)."""
    finite = jnp.isfinite(pc.xyz).all(axis=-1)
    return pc._replace(mask=pc.mask & finite)
