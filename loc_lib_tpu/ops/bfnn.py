"""Brute-force exact nearest neighbors — the library's oracle search.

Rebuild of the reference's BFNN (/root/reference/LocUtils/src/model/
search_point/bfnn/bfnn.cpp:24-66), which exists as the ground-truth baseline
the kd-tree is checked against (test_node.cpp:376-435). Here it plays the
same role for the hash-grid `ops.voxel.knn`: an O(Q*N) masked distance
matrix + top-k, exact over the WHOLE cloud with no stencil-radius bound.
Unlike the reference's per-query std::sort loop this is one batched
matmul-shaped program (the distance matrix is a matmul via the
|a-b|^2 = |a|^2 - 2ab + |b|^2 expansion), so it is also a perfectly usable
matcher backend for small targets, not just a test fixture.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from .pointcloud import PointCloud


@functools.partial(jax.jit, static_argnames=("k",))
def knn(target: PointCloud, queries: jax.Array, query_mask: jax.Array,
        k: int = 1):
    """Exact k-NN of each query against every valid target point.

    queries: (Q, 3). Returns (pts (Q, k, 3), idx (Q, k) int32,
    dist2 (Q, k), valid (Q, k)) — same contract as ops.voxel.knn, exact
    everywhere (bfnn.cpp:24-40 semantics, batched).
    """
    t = target.xyz                                         # (N, 3)
    # |q - t|^2 = |q|^2 - 2 q.t + |t|^2 : the cross term is one (Q,3)x(3,N)
    # matmul instead of a (Q,N,3) broadcast in HBM
    cross = queries @ t.T                                  # (Q, N)
    d2 = (jnp.sum(queries * queries, axis=1)[:, None]
          - 2.0 * cross + jnp.sum(t * t, axis=1)[None, :])
    d2 = jnp.maximum(d2, 0.0)                              # numeric floor
    d2 = jnp.where(target.mask[None, :], d2, jnp.inf)
    neg, idx = jax.lax.top_k(-d2, k)                       # (Q, k)
    top_d2 = -neg
    valid = jnp.isfinite(top_d2) & query_mask[:, None]
    pts = t[idx]
    return pts, idx.astype(jnp.int32), jnp.where(valid, top_d2, jnp.inf), valid


def nn1(target: PointCloud, queries: jax.Array, query_mask: jax.Array):
    """Single exact nearest neighbor (GetClosestPoint, bfnn.cpp:42-66)."""
    pts, idx, d2, valid = knn(target, queries, query_mask, 1)
    return pts[:, 0], idx[:, 0], d2[:, 0], valid[:, 0]
