"""ICP scan matching: point-to-point / point-to-line / point-to-plane.

Rebuild of the reference `IcpRegistration`
(/root/reference/LocUtils/src/model/matching/3d/icp/icp_registration.cpp).
The per-point inner loop (transform -> kNN -> local fit -> Jacobian ->
6x6 accumulate, icp_registration.cpp:161-213) becomes one batched program:
all N source points are transformed, matched against the voxel hash grid,
line/plane-fit, and their Jacobians assembled in parallel; the H/b reduction
is a single (6,3N)x(3N,6) matmul. The outer Gauss-Newton loop is a `lax.while_loop` with the reference's stopping rule
(|dx| < eps, icp_registration.cpp:371-375) and degeneracy guards
(effective_num >= min_effective_pts, icp_registration.cpp:94-101).

Deliberate deviation from the reference (documented, not a bug): the
reference's P2P mode scales the rotation Jacobian block and the solved step
by 1/16 (icp_registration.cpp:84,287) — an ad-hoc damping artifact. We use
the exact Jacobian; golden tests compare against an undamped oracle and both
converge to the same fixed point.

Jacobian conventions (right perturbation, residuals as in the reference):
  P2P    e = p - T q          J = [ R*hat(q)        , -I       ]  (3x6)
  P2Line e = hat(d)(Tq - p0)  J = [-hat(d)*R*hat(q) , hat(d)   ]  (3x6)
  P2Plane e = n.(Tq) + d      J = [-n^T*R*hat(q)    , n^T      ]  (1x6)
(icp_registration.cpp:83-85, 138-140, 193-195.)
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from ..ops.pointcloud import PointCloud
from ..ops import linearize, voxel
from ..utils import lie, mathx


@dataclasses.dataclass(frozen=True)
class IcpOptions:
    """Mirror of IcpOptions (icp_registration.hpp:22-39).

    method="p2plane_vox" is the production P2Plane path: target-side
    geometry (a plane per voxel, neighbor-merged Gaussians, VGICP-style) is
    precomputed ONCE at set_target, so each GN iteration is one O(1) dense
    voxel lookup + plane evaluation per point (ops/linearize) — instead of
    re-running 5-NN search + eigen plane fit per point per iteration (what the reference does per kd-tree probe,
    icp_registration.cpp:161-213, and what method="p2plane" replicates for
    oracle parity). The reference's own NDT amortizes target geometry exactly
    this way (ndt_registration.cpp:87-148 build vs :262-372 align).
    """

    method: str = "p2plane"          # p2p | p2line | p2plane | p2plane_vox
    # When False, the GN init's TRANSLATION is replaced by the
    # target-source centroid difference (icp_registration.hpp:36,
    # cpp:273-275 / 311-313). NOTE: the reference's own centroid
    # accumulation is commented out (cpp:22-26, 261-264), so its option is
    # inert — centers stay zero; here it is implemented functionally.
    use_initial_translation: bool = True
    max_iteration: int = 20
    max_nn_distance: float = 1.0     # SQUARED-distance gate for P2P (cpp:75)
    max_plane_distance: float = 0.1
    max_line_distance: float = 0.5
    min_effective_pts: int = 10
    eps: float = 1e-2
    # Search structure (replaces the kd-tree): cell size of the hash grid
    # and how many candidate points to keep per cell.
    grid_leaf: float = 1.0
    bucket_size: int = 8
    # p2plane_vox: plane-quality gate (max variance along the normal, m^2 —
    # the analog of FitPlane's per-point resid^2 <= 1e-2, math_utils.h:128-133)
    # and minimum merged point count (the reference requires 5 NN, cpp:171).
    plane_fit_eps: float = 1e-2
    plane_min_pts: int = 5
    # p2line_vox: anisotropy gate — the principal eigenvalue must dominate
    # the cross-sectional ones by this ratio for a voxel to carry a line.
    line_ratio: float = 3.0
    # static dims of the O(1) dense voxel index window (voxels per axis)
    dense_dims: tuple = (256, 256, 64)
    # p2plane_vox GN refinement: re-elect correspondences only for the first
    # k iterations, then FREEZE the (plane, weight) assignment and iterate
    # the linearization alone (the plane-distance gate stays live);
    # any iteration whose pose has moved more than elect_dx_threshold
    # (translation metres; rotation via angle * elect_rot_scale) since the
    # last election re-elects. Leave this at 0 in any MAPPING/LOCALIZATION
    # feedback loop: inside the LIO pipeline the slight per-frame bias of
    # frozen refinement bakes into the map and ATE degrades 6x (0.27 vs
    # 0.044 m on the bench log); Loc with 0.3 m transients diverges
    # outright under looser gating. Opt-in for one-shot registrations only.
    # 0 = re-elect every iteration (reference-faithful re-search,
    # icp_registration.cpp:170 per-iteration kNN).
    freeze_election_after: int = 0
    elect_dx_threshold: float = 0.15
    elect_rot_scale: float = 30.0   # m of drift per rad at scene scale
    # Accumulation-gate warm-up (p2plane_vox family, opt-in): run the
    # first k GN iterations with gate = max_plane_distance *
    # gate_warmup_scale, then the production gate; convergence cannot
    # fire during warm-up iterations. MEASURED (round-5 diagnosis
    # of the round-4 9.3 cm batched-converged tail): warm-up is NOT the
    # fix for that tail — the tail was a target-DENSITY misconfiguration
    # (grid_leaf=1.0/plane_min_pts=5 on a sparse 8192-pt/70 m keyframe
    # cloud leaves ~23% of source points with any valid plane; the
    # surviving near-zero-residual subset false-converges at the init,
    # worst lane err 0.0931 = its init error, and a wide warm-up gate on
    # that sparse table made it WORSE, 0.198). With density-matched
    # options (grid_leaf=2.0, plane_min_pts=4) the B=64 converged tail is
    # 0.9-1.9 cm and warm-up is neutral-to-slightly-better. Where warm-up
    # DOES win: poor inits beyond the tight gate on dense targets — a
    # 0.3 m-offset init on a 20 m corridor recovers to 1 mm with
    # warmup=3 where the plain default stops 0.16 m off (the end-wall
    # residuals that carry the x signal all exceed the 0.1 m gate).
    # Warm-up iterations take a Marquardt-damped step (lambda = 1e-2 *
    # max diag H) because the wide gate on a degenerate scene can leave H
    # near-singular and the raw GN step explodes. Keep 0 unless running a
    # registration from inits that may exceed the accumulation gate.
    # (Reference gate/stop semantics: icp_registration.cpp:187-190,
    # 371-375.)
    gate_warmup_iters: int = 0
    gate_warmup_scale: float = 5.0


class IcpTarget(NamedTuple):
    grid: voxel.HashGrid
    # masked centroid of the target cloud (for use_initial_translation=False)
    centroid: Optional[jax.Array] = None
    # p2plane_vox extras (None for other methods). `packed` rows are
    # [n(3), d, mu(3), valid] so each candidate voxel costs ONE 32-byte row
    # gather per query; plane/plane_mu/plane_valid are views kept for tests.
    packed: Optional[jax.Array] = None       # (V, 8)
    plane: Optional[jax.Array] = None        # (V, 4) [n, d] per grid slot
    plane_mu: Optional[jax.Array] = None     # (V, 3) merged centroid
    plane_valid: Optional[jax.Array] = None  # (V,) bool
    dense: Optional[voxel.DenseIndex] = None
    # p2line_vox extras: rows [mu(3), W(9 row-major), valid] where
    # W W^T = I - d d^T (the perpendicular projector of the voxel's line
    # direction d) — the generalized-Gaussian form linearize.ndt consumes.
    line_packed: Optional[jax.Array] = None  # (V, 13)
    line_dir: Optional[jax.Array] = None     # (V, 3) kept for tests
    # p2plane_vox_oct extras: correspondences PRE-ELECTED per (voxel, octant)
    # at target-build time, so an iteration gathers ONE 8-float row per point
    # instead of 7 (see _p2plane_vox_oct_terms).
    dense_oct: Optional[voxel.DenseIndex] = None  # over the DILATED key set
    oct_table: Optional[jax.Array] = None    # (V7, 8) int32 -> packed_ext row
    packed_ext: Optional[jax.Array] = None   # (V+1, 8); last row invalid


def _merge_neighbor_moments(keys, count, mean, cov, dense, dims):
    """Merge each voxel's count-weighted moments with its 6 face neighbors
    (rows stay slot-aligned with `keys`). Returns (n, mu, cov)."""
    coords = voxel.key_to_coords(keys)                          # (V, 3)
    nb_keys = voxel.coords_to_key(
        coords[:, None, :] + voxel.NEARBY6[None, :, :],
        keys[:, None] != voxel.INVALID_KEY)                     # (V, 7)
    slot, found = voxel.lookup_dense(dense, dims, nb_keys)
    n_k = jnp.where(found, count[slot], 0.0)                    # (V, 7)
    mu_k = mean[slot]                                           # (V, 7, 3)
    # second moments about the origin: S_k = n_k (cov_k + mu_k mu_k^T)
    s2_k = n_k[..., None, None] * (
        cov[slot] + mu_k[..., :, None] * mu_k[..., None, :])
    n = jnp.sum(n_k, axis=1)                                    # (V,)
    s1 = jnp.sum(n_k[..., None] * mu_k, axis=1)                 # (V, 3)
    s2 = jnp.sum(s2_k, axis=1)                                  # (V, 3, 3)
    mu = s1 / jnp.maximum(n, 1.0)[:, None]
    cov_m = (s2 / jnp.maximum(n, 1.0)[:, None, None]
             - mu[:, :, None] * mu[:, None, :])
    return n, mu, cov_m


def _merged_moments(pc: PointCloud, grid: voxel.HashGrid, opts: IcpOptions,
                    dense: voxel.DenseIndex, stats=None):
    """Neighbor-merged Gaussian moments per voxel (VGICP-style): voxel
    first/second moments by segment reduce, then each voxel merges the
    count-weighted moments of itself + its 6 face neighbors (so local
    geometry stays continuous across voxel borders and reaches the
    reference's >=5-point support even in sparse cells). Table rows align
    with grid.voxel_keys slots. Pass `stats` to reuse the key sort the
    grid build already paid (voxel.build_hash_grid_with_stats).
    Returns (n, mu, cov, keys)."""
    if stats is None:
        stats = voxel.voxel_stats(pc, opts.grid_leaf, origin=grid.origin,
                                  mode="floor")
    n, mu, cov = _merge_neighbor_moments(stats.keys, stats.count, stats.mean,
                                         stats.cov, dense, opts.dense_dims)
    return n, mu, cov, stats.keys


def _build_line_table(pc: PointCloud, grid: voxel.HashGrid, opts: IcpOptions,
                      dense: voxel.DenseIndex, stats=None):
    """Per-voxel LINE from the merged moments: direction = principal
    eigenvector; a voxel carries a line only when that direction dominates
    the cross-section (line_ratio) with >= plane_min_pts support (the
    reference's P2Line requires 5 NN + a cross-residual gate,
    icp_registration.cpp:115-128). The residual machinery is the NDT
    linearization (linearize.ndt) with per-voxel information I - d d^T
    (the perpendicular projector): e^T (I - dd^T) e is exactly the squared line distance
    |d x (qs - mu)|^2, so gate, residual, Jacobian and H/b all reduce to
    the generalized-Gaussian form."""
    n, mu, cov, keys = _merged_moments(pc, grid, opts, dense, stats)
    vals, vecs = mathx.eigh_sym3x3(cov)
    d = vecs[..., :, 2]                                         # principal
    valid = ((n >= opts.plane_min_pts)
             & (vals[..., 2] >= opts.line_ratio
                * (vals[..., 0] + vals[..., 1]))
             & (keys != voxel.INVALID_KEY)
             & jnp.isfinite(vecs).all(axis=(-2, -1)))
    # exact square-root factor of the projector I - dd^T: the orthonormal
    # perpendicular eigenvector pair W = [v0 v1 0] (W W^T = v0 v0^T +
    # v1 v1^T = I - dd^T) — no Cholesky of a rank-deficient matrix needed
    v0 = vecs[..., :, 0]
    v1 = vecs[..., :, 1]
    zero = jnp.zeros_like(v0[..., 0:1])
    W = jnp.concatenate(
        [v0[..., 0:1], v1[..., 0:1], zero,
         v0[..., 1:2], v1[..., 1:2], zero,
         v0[..., 2:3], v1[..., 2:3], zero], axis=-1)            # (V, 9)
    W = jnp.where(valid[:, None], W, 0.0)
    packed = jnp.concatenate(
        [mu, W, valid[:, None].astype(jnp.float32)], axis=1)    # (V, 13)
    return packed, jnp.where(valid[:, None], d, 0.0)


def _planes_from_moments(n, mu, cov, keys, opts: IcpOptions):
    """Planes + validity from merged moments: normal = smallest eigenvector.

    Validity: enough support, thin along the normal, AND genuinely planar —
    the eigenvalue-ratio term rejects line-degenerate voxels (e0 ~ e1) whose
    PCA "plane" has an arbitrary normal direction; verified to be the
    failure mode that diverged GN on corridor scenes (round-2 drive)."""
    vals, vecs = mathx.eigh_sym3x3(cov)
    nvec = vecs[..., :, 0]
    d = -jnp.sum(nvec * mu, axis=-1, keepdims=True)
    plane = jnp.concatenate([nvec, d], axis=-1)                 # (V, 4)
    valid = ((n >= opts.plane_min_pts)
             & (vals[..., 0] <= opts.plane_fit_eps)
             & (vals[..., 1] >= 3.0 * vals[..., 0])
             & (keys != voxel.INVALID_KEY)
             & jnp.isfinite(plane).all(axis=-1))
    return jnp.where(valid[:, None], plane, 0.0), mu, valid


def _build_plane_table(pc: PointCloud, grid: voxel.HashGrid, opts: IcpOptions,
                       dense: voxel.DenseIndex, stats=None):
    """Per-voxel plane from neighbor-merged Gaussian moments (VGICP-style):
    normal = smallest eigenvector of the merged covariance."""
    n, mu, cov, keys = _merged_moments(pc, grid, opts, dense, stats)
    return _planes_from_moments(n, mu, cov, keys, opts)


@functools.partial(jax.jit, static_argnames=("opts", "dims"))
def target_from_moment_table(keys, count, mean, cov, dense_table, dense_lo,
                             origin, opts: IcpOptions, dims) -> IcpTarget:
    """Derive a p2plane_vox target from an INCREMENTALLY MAINTAINED voxel
    moment table (an ndt.NdtMap built with bin_mode='floor') — the
    amortization lever for the keyframe rebuild: instead of re-sorting the
    whole ~80k-point local-map window per keyframe (set_target), the moment
    table absorbs only the new keyframe (ndt.update_incremental: sort of one
    scan) and this O(V) pass re-derives planes: neighbor merge + closed-form
    eigh + repack. The reference's own incremental NDT is the same
    amortization for its Gaussians (ndt_registration.cpp:150-236); this
    extends it to the VGICP plane table. Age eviction replaces the sliding
    keyframe window for map forgetting.

    `dims` must equal the table's dense-index dims; opts.grid_leaf must
    equal the table's voxel size; `keys` must use floor binning."""
    dense = voxel.DenseIndex(table=dense_table, lo=dense_lo)
    n, mu, cov_m = _merge_neighbor_moments(keys, count, mean, cov,
                                           dense, dims)
    plane, mu, valid = _planes_from_moments(n, mu, cov_m, keys, opts)
    packed = jnp.concatenate(
        [plane, mu, valid[:, None].astype(jnp.float32)], axis=1)
    v = keys.shape[0]
    # minimal grid carrier: the vox matcher only reads inv_leaf/origin from
    # it (correspondences go through the dense index + packed rows)
    grid = voxel.HashGrid(
        voxel_keys=keys,
        bucket_xyz=jnp.zeros((v, 3), jnp.float32),
        bucket_idx=jnp.full((v, 1), -1, jnp.int32),
        bucket_cnt=jnp.zeros((v,), jnp.int32),
        num_voxels=jnp.sum((keys != voxel.INVALID_KEY).astype(jnp.int32)),
        overflow=jnp.int32(0),
        inv_leaf=jnp.float32(1.0 / opts.grid_leaf),
        origin=jnp.asarray(origin, jnp.float32),
    )
    return IcpTarget(grid=grid, packed=packed, plane=plane, plane_mu=mu,
                     plane_valid=valid, dense=dense)


def _build_oct_tables(grid: voxel.HashGrid, dense: voxel.DenseIndex,
                      packed: jax.Array, opts: IcpOptions):
    """Pre-elect the correspondence for every (voxel, octant) cell.

    Each GN iteration of p2plane_vox runs the election: a 7-key dense
    lookup + (N, 7, 8) row gather + nearest-centroid argmin per point
    (freezing the election is unsafe in feedback loops, see
    IcpOptions.freeze_election_after). This is the safe middle ground: the same nearest-valid-centroid
    election over the NEARBY6+self stencil, evaluated ONCE at target-build
    time at the 8 octant centers of every voxel (half-voxel spatial
    granularity), for the DILATED voxel set (occupied voxels + their empty
    face neighbors, so queries that fall just off the surface still find
    the neighboring plane, like the stencil does). Per iteration a point
    then needs one dense lookup + one (N,) index gather + one (N, 8) row
    gather — ~7x less gather traffic — and the election still TRACKS THE
    POSE because the (voxel, octant) cell a point lands in changes as the
    pose moves (unlike freeze_election_after, whose assignment is pinned
    to points). Deviation from exact per-point election is bounded by the
    half-voxel cell size; trajectory parity is pinned by tests.

    Returns (dense_oct, oct_table (V7, 8) int32, packed_ext (V+1, 8))."""
    keys = grid.voxel_keys                                   # (V,)
    v = keys.shape[0]
    coords = voxel.key_to_coords(keys)
    nb = voxel.coords_to_key(
        coords[:, None, :] + voxel.NEARBY6[None, :, :],
        keys[:, None] != voxel.INVALID_KEY)                  # (V, 7)
    allk = jnp.sort(nb.reshape(-1))                          # (7V,)
    first = jnp.concatenate([jnp.ones((1,), bool), allk[1:] != allk[:-1]])
    dk = jnp.sort(jnp.where(first & (allk != voxel.INVALID_KEY), allk,
                            voxel.INVALID_KEY))              # deduped keys
    dense_oct = voxel.build_dense_index(dk, dims=opts.dense_dims)

    dc = voxel.key_to_coords(dk)                             # (7V, 3)
    stencil = voxel.coords_to_key(
        dc[:, None, :] + voxel.NEARBY6[None, :, :],
        dk[:, None] != voxel.INVALID_KEY)                    # (7V, 7)
    slot7, found7 = voxel.lookup_dense(dense, opts.dense_dims, stencil)
    # Election in TRANSPOSED (8, 7V)/(3, 7V) layout with a running min
    # over the 7 stencil entries, the large axis minor (the direct
    # (7V, 7, 8) form's padded temps exhausted memory in the B=64 batched
    # target build on the earlier hardware); semantics identical (first
    # stencil hit wins ties, like argmin).
    offs = (((jnp.arange(8)[:, None] >> jnp.arange(3)[None, :]) & 1)
            .astype(jnp.float32) * 0.5 + 0.25)               # (8, 3)
    leaf = 1.0 / grid.inv_leaf
    # pos[c, o, j] = octant-o center coord c of dilated voxel j (world)
    pos = (dc.T[:, None, :].astype(jnp.float32) + offs.T[:, :, None]) \
        * leaf + grid.origin[:, None, None]                  # (3, 8, 7V)
    packed_t = packed.T                                      # (8, V)
    n7 = dk.shape[0]
    best_d2 = jnp.full((8, n7), jnp.inf, jnp.float32)
    best_slot = jnp.zeros((8, n7), jnp.int32)
    for s in range(7):
        slot_s = slot7[:, s]                                 # (7V,)
        row_s = packed_t[:, slot_s]                          # (8, 7V)
        valid_s = found7[:, s] & (row_s[7] > 0.5)            # (7V,)
        mu_s = row_s[4:7]                                    # (3, 7V)
        d2 = jnp.sum((mu_s[:, None, :] - pos) ** 2, axis=0)  # (8, 7V)
        d2 = jnp.where(valid_s[None, :], d2, jnp.inf)
        take = d2 < best_d2
        best_d2 = jnp.where(take, d2, best_d2)
        best_slot = jnp.where(take, slot_s[None, :], best_slot)
    has = jnp.isfinite(best_d2)                              # (8, 7V)
    oct_table = jnp.where(has, best_slot, v).T.astype(jnp.int32)  # (7V, 8)
    packed_ext = jnp.concatenate([packed, jnp.zeros((1, 8), packed.dtype)])
    return dense_oct, oct_table, packed_ext


def _masked_centroid(pc: PointCloud) -> jax.Array:
    n = jnp.maximum(jnp.sum(pc.mask.astype(jnp.float32)), 1.0)
    return jnp.sum(jnp.where(pc.mask[:, None], pc.xyz, 0.0), axis=0) / n


@functools.partial(jax.jit, static_argnames=("opts",))
def set_target(pc: PointCloud, opts: IcpOptions, origin=None) -> IcpTarget:
    """Build the search structure over the target cloud
    (SetInputTarget, icp_registration.cpp:9-29)."""
    cen = _masked_centroid(pc)
    if opts.method not in ("p2plane_vox", "p2plane_vox_oct", "p2line_vox"):
        grid = voxel.build_hash_grid(pc, opts.grid_leaf, opts.bucket_size,
                                     origin)
        return IcpTarget(grid=grid, centroid=cen)
    # vox targets: the grid and the per-voxel Gaussians share floor binning
    # and the same origin, so ONE key sort feeds both explicitly (XLA CSE
    # already merged the duplicates inside this jit; see voxel.py)
    grid, stats = voxel.build_hash_grid_with_stats(
        pc, opts.grid_leaf, opts.bucket_size, origin)
    dense = voxel.build_dense_index(grid.voxel_keys, dims=opts.dense_dims)
    if opts.method == "p2line_vox":
        line_packed, line_dir = _build_line_table(pc, grid, opts, dense,
                                                  stats)
        return IcpTarget(grid=grid, centroid=cen, dense=dense,
                         line_packed=line_packed, line_dir=line_dir)
    plane, plane_mu, plane_valid = _build_plane_table(pc, grid, opts, dense,
                                                      stats)
    packed = jnp.concatenate(
        [plane, plane_mu, plane_valid[:, None].astype(jnp.float32)], axis=1)
    tgt = IcpTarget(grid=grid, centroid=cen, packed=packed, plane=plane,
                    plane_mu=plane_mu, plane_valid=plane_valid, dense=dense)
    if opts.method == "p2plane_vox_oct":
        dense_oct, oct_table, packed_ext = _build_oct_tables(grid, dense,
                                                             packed, opts)
        tgt = tgt._replace(dense_oct=dense_oct, oct_table=oct_table,
                           packed_ext=packed_ext)
    return tgt


class MatchResult(NamedTuple):
    R: jax.Array
    t: jax.Array
    converged: jax.Array      # bool: |dx| < eps reached
    num_effective: jax.Array  # effective points at the last iteration
    iterations: jax.Array
    chi2: jax.Array           # sum of squared residuals at last iteration


# ---------------------------------------------------------------------------
# Per-mode H/b assembly (each is one batched pass over all source points)
# ---------------------------------------------------------------------------

def _assemble(J: jax.Array, e: jax.Array, w: jax.Array):
    """Masked H = sum J^T J, b = -sum J^T e as matmuls.

    J: (N, r, 6), e: (N, r), w: (N,) validity weights.
    """
    n, r, _ = J.shape
    Jw = (J * w[:, None, None]).reshape(n * r, 6)
    ew = (e * w[:, None]).reshape(n * r)
    H = Jw.T @ Jw
    b = -(Jw.T @ ew)
    return H, b


def _p2p_terms(target: IcpTarget, opts: IcpOptions, src: PointCloud, R, t):
    q = src.xyz
    qs = q @ R.T + t
    p, idx, d2, valid = voxel.nn1(target.grid, qs, src.mask)
    # squared-distance gate, matching cpp:74-78
    eff = valid & (d2 <= opts.max_nn_distance)
    e = p - qs                                             # (N, 3)
    Rhatq = jnp.einsum("ij,njk->nik", R, lie.hat(q))       # (N, 3, 3)
    J = jnp.concatenate(
        [Rhatq, jnp.broadcast_to(-jnp.eye(3, dtype=q.dtype), Rhatq.shape)], axis=-1
    )                                                      # (N, 3, 6)
    w = eff.astype(q.dtype)
    H, b = _assemble(J, e, w)
    chi2 = jnp.sum(jnp.sum(e * e, axis=-1) * w)
    return H, b, jnp.sum(eff), chi2


def _p2line_terms(target: IcpTarget, opts: IcpOptions, src: PointCloud, R, t):
    q = src.xyz
    qs = q @ R.T + t
    nn_pts, idx, d2, valid = voxel.knn(target.grid, qs, src.mask, 5)
    got5 = jnp.sum(valid.astype(jnp.int32), axis=1) == 5   # cpp:115 requires 5
    p0, d, fit_ok = mathx.fit_line(nn_pts, valid, eps=opts.max_line_distance)
    hat_d = lie.hat(d)                                     # (N, 3, 3)
    e = jnp.einsum("nij,nj->ni", hat_d, qs - p0)
    # effective = got5 & fit ok (cpp:123-128); the norm gate only skips
    # accumulation (cpp:132-135)
    eff = got5 & fit_ok
    accum = eff & (jnp.linalg.norm(e, axis=-1) <= opts.max_line_distance)
    Rhatq = jnp.einsum("ij,njk->nik", R, lie.hat(q))
    Jrot = -jnp.einsum("nij,njk->nik", hat_d, Rhatq)
    J = jnp.concatenate([Jrot, hat_d], axis=-1)            # (N, 3, 6)
    w = accum.astype(q.dtype)
    H, b = _assemble(J, e, w)
    chi2 = jnp.sum(jnp.sum(e * e, axis=-1) * w)
    return H, b, jnp.sum(eff), chi2


def _p2plane_terms(target: IcpTarget, opts: IcpOptions, src: PointCloud, R, t):
    q = src.xyz
    qs = q @ R.T + t
    nn_pts, idx, d2, valid = voxel.knn(target.grid, qs, src.mask, 5)
    got = jnp.sum(valid.astype(jnp.int32), axis=1) > 3     # cpp:171 ("> 3")
    coeffs, fit_ok = mathx.fit_plane(nn_pts, valid)        # (N, 4)
    nvec = coeffs[:, :3]
    dis = jnp.sum(nvec * qs, axis=-1) + coeffs[:, 3]       # (N,)
    eff = got & fit_ok
    accum = eff & (jnp.abs(dis) <= opts.max_plane_distance)  # cpp:187-190
    Rhatq = jnp.einsum("ij,njk->nik", R, lie.hat(q))
    Jrot = -jnp.einsum("ni,nik->nk", nvec, Rhatq)          # (N, 6->3)
    J = jnp.concatenate([Jrot, nvec], axis=-1)[:, None, :]  # (N, 1, 6)
    w = accum.astype(q.dtype)
    H, b = _assemble(J, dis[:, None], w)
    chi2 = jnp.sum(dis * dis * w)
    return H, b, jnp.sum(eff), chi2


def _p2plane_vox_terms(target: IcpTarget, opts: IcpOptions, src: PointCloud, R, t,
                       gate=None):
    """Voxel-plane P2Plane linearization: dense O(1) lookups + one row
    gather, then `linearize.p2plane_pick`. Correspondence = nearest-centroid
    VALID plane voxel among the point's own voxel + its 6 face neighbors
    (the gather-friendly stand-in for the reference's kd-tree NN;
    center-only lookup demonstrably diverges near voxel borders — round-2
    drive)."""
    rows7 = _p2plane_vox_rows7(target, opts, src, R, t)
    g = opts.max_plane_distance if gate is None else gate
    return linearize.p2plane_pick(
        src.xyz, rows7, src.mask.astype(jnp.float32), R, t, g)


def _p2plane_vox_rows7(target: IcpTarget, opts: IcpOptions,
                       src: PointCloud, R, t):
    """The candidate gather of `_p2plane_vox_terms`: 7-key dense lookup +
    (N, 7, 8) packed-row gather at the current pose (validity folded into
    column 7)."""
    qs = src.xyz @ R.T + t
    qcoords = voxel.voxel_coords(qs, target.grid.inv_leaf, target.grid.origin)
    keys7 = voxel.coords_to_key(
        qcoords[:, None, :] + voxel.NEARBY6[None, :, :], src.mask[:, None])
    slot7, found7 = voxel.lookup_dense(target.dense, opts.dense_dims, keys7)
    rows7 = target.packed[slot7]                             # (N, 7, 8)
    valid7 = found7 & (rows7[..., 7] > 0.5)                  # (N, 7)
    return rows7.at[..., 7].set(valid7.astype(rows7.dtype))


def _p2plane_vox_elect(target: IcpTarget, opts: IcpOptions,
                       src: PointCloud, R, t):
    """Correspondence election only: nearest-valid-centroid plane over the
    NEARBY6+self stencil at the CURRENT pose. Returns (plane (N,4), w (N,))
    — the inputs `linearize.p2plane` consumes."""
    rows7 = _p2plane_vox_rows7(target, opts, src, R, t)
    plane, d2 = linearize.elect_nearest(rows7[..., 0:4], rows7[..., 4:7],
                                        rows7[..., 7] > 0.5, src.xyz @ R.T + t)
    return plane, (jnp.isfinite(d2) & src.mask).astype(jnp.float32)


def _p2line_vox_terms(target: IcpTarget, opts: IcpOptions, src: PointCloud, R, t,
                      gate=None):
    """Voxel-line P2Line linearization.

    Correspondence = nearest-centroid VALID line voxel among the NEARBY6
    stencil (same election as p2plane_vox); linearization = linearize.ndt
    in weighted mode with per-voxel information I - d d^T, whose
    chi2 |L^T e|^2 is exactly the squared perpendicular line distance —
    gated at max_line_distance^2, matching the reference's |e| <=
    max_line_distance accumulation gate (icp_registration.cpp:132-135)."""
    q = src.xyz
    qs = q @ R.T + t
    qcoords = voxel.voxel_coords(qs, target.grid.inv_leaf, target.grid.origin)
    keys7 = voxel.coords_to_key(
        qcoords[:, None, :] + voxel.NEARBY6[None, :, :], src.mask[:, None])
    slot7, found7 = voxel.lookup_dense(target.dense, opts.dense_dims, keys7)
    rows7 = target.line_packed[slot7]                        # (N, 7, 13)
    valid7 = found7 & (rows7[..., 12] > 0.5)
    rows, d2 = linearize.elect_nearest(rows7, rows7[..., 0:3], valid7, qs)
    w = (jnp.isfinite(d2) & src.mask).astype(jnp.float32)
    g = opts.max_line_distance if gate is None else gate
    return linearize.ndt(
        q, qs, rows[:, None, 0:3], rows[:, None, 3:12], w[:, None], R,
        g ** 2, weighted=True)


def _p2plane_vox_oct_terms(target: IcpTarget, opts: IcpOptions,
                           src: PointCloud, R, t, gate=None):
    """Octant-pre-elected P2Plane linearization (see _build_oct_tables):
    per point, ONE dense lookup of its (voxel, octant) cell + one row
    gather of the pre-elected plane, then linearize.p2plane. The
    election tracks the pose (the cell a point lands in moves with it) at
    half-voxel granularity instead of exactly per point."""
    q = src.xyz
    qs = q @ R.T + t
    u = (qs - target.grid.origin) * target.grid.inv_leaf
    vc = jnp.floor(u).astype(jnp.int32)
    frac = u - jnp.floor(u)
    octant = ((frac[:, 0] > 0.5).astype(jnp.int32)
              + 2 * (frac[:, 1] > 0.5).astype(jnp.int32)
              + 4 * (frac[:, 2] > 0.5).astype(jnp.int32))
    key = voxel.coords_to_key(vc, src.mask)
    slot, found = voxel.lookup_dense(target.dense_oct, opts.dense_dims, key)
    row_slot = jnp.take_along_axis(target.oct_table[slot], octant[:, None],
                                   axis=1)[:, 0]             # (N,)
    rows = target.packed_ext[row_slot]                       # (N, 8)
    w = (found & (rows[:, 7] > 0.5) & src.mask).astype(q.dtype)
    g = opts.max_plane_distance if gate is None else gate
    return linearize.p2plane(q, rows[:, 0:4], w, R, t, g)


_TERM_FNS = {"p2p": _p2p_terms, "p2line": _p2line_terms,
             "p2plane": _p2plane_terms, "p2plane_vox": _p2plane_vox_terms,
             "p2plane_vox_oct": _p2plane_vox_oct_terms,
             "p2line_vox": _p2line_vox_terms}


@functools.partial(jax.jit, static_argnames=("opts",))
def compute_h_and_b(target: IcpTarget, opts: IcpOptions, src: PointCloud, R, t):
    """One linearization: (H, b, num_effective, chi2) at the given pose.
    Mirror of CaculateMatrixHAndB (icp_registration.cpp:31-55); exposed so
    LOAM can fuse edge+surf systems (loam_registration.cpp:38-99)."""
    return _TERM_FNS[opts.method](target, opts, src, R, t)


@functools.partial(jax.jit, static_argnames=("opts",))
def get_fitness_score(target: IcpTarget, opts: IcpOptions, src: PointCloud,
                      R, t, max_range: float = 1.0):
    """MatchingInterface::GetFitnessScore analog (matching_interface.h:52).

    The reference DECLARES this accessor on every matcher but each
    implementation is an unimplemented 0-return stub
    (icp_registration.cpp:246-250, ndt_registration.cpp:466-471,
    loam_registration.cpp:101-104); this is the PCL-convention fitness the
    interface promises: mean squared NN distance of the transformed source
    against the target cloud, over correspondences within `max_range`.
    Lower is better; +inf when nothing matches. Works for every method —
    the hash grid is always built at set_target."""
    qs = src.xyz @ R.T + t
    _, _, d2, valid = voxel.nn1(target.grid, qs, src.mask)
    eff = valid & (d2 <= max_range * max_range)
    n = jnp.sum(eff.astype(jnp.float32))
    return jnp.where(n > 0, jnp.sum(jnp.where(eff, d2, 0.0)) / jnp.maximum(n, 1.0),
                     jnp.inf)


@functools.partial(jax.jit, static_argnames=("opts",))
def scan_match(target: IcpTarget, opts: IcpOptions, src: PointCloud, R0, t0) -> MatchResult:
    """Full GN alignment (ScanMatch -> AlignP2P/P2Line/P2Plane,
    icp_registration.cpp:216-381)."""
    terms = _TERM_FNS[opts.method]
    if not opts.use_initial_translation:
        # translation init = centroid difference (cpp:273-275; functional
        # here, inert in the reference whose centers are never computed)
        assert target.centroid is not None, (
            "use_initial_translation=False needs a set_target-built target")
        t0 = target.centroid - _masked_centroid(src)

    if opts.method == "p2plane_vox" and opts.freeze_election_after > 0:
        return _scan_match_vox_frozen(target, opts, src, R0, t0)

    warmup = (opts.gate_warmup_iters
              if opts.method in ("p2plane_vox", "p2plane_vox_oct",
                                 "p2line_vox") else 0)
    base_gate = (opts.max_line_distance if opts.method == "p2line_vox"
                 else opts.max_plane_distance)

    def cond(state):
        it, R, t, done, _, _ = state
        return (it < opts.max_iteration) & (~done)

    def body(state):
        it, R, t, _, _, _ = state
        if warmup > 0:
            # accumulation-gate warm-up schedule (IcpOptions docstring):
            # wide gate while the pose may still be far, production gate
            # after; convergence can only fire on tight-gate iterations
            gate = jnp.where(it < warmup,
                             jnp.float32(base_gate * opts.gate_warmup_scale),
                             jnp.float32(base_gate))
            H, b, n_eff, chi2 = terms(target, opts, src, R, t, gate=gate)
        else:
            H, b, n_eff, chi2 = terms(target, opts, src, R, t)
        ok = n_eff >= opts.min_effective_pts
        dx_gn = mathx.solve_gn_6x6(H, b)
        if warmup > 0:
            # Marquardt-damped step during warm-up: a wide gate on a
            # degenerate scene can leave H near-singular along the
            # unconstrained direction, and the raw GN step explodes
            # (measured: a 20 m corridor walked to |t| ~ 2800 m). Damping
            # only warm-up iterations keeps post-warm-up semantics exact.
            # damp relative to the LARGEST diagonal: per-element Marquardt
            # scaling leaves a near-zero H_xx (degenerate direction)
            # near-zero and the step still explodes — measured
            lam = 1e-2 * jnp.max(jnp.diagonal(H)) + 1e-6
            Hd = H + lam * jnp.eye(6, dtype=H.dtype)
            dx_gn = jnp.where(it < warmup, mathx.solve_gn_6x6(Hd, b), dx_gn)
        dx = jnp.where(ok, dx_gn, jnp.zeros(6, dtype=b.dtype))
        dx = jnp.where(jnp.isfinite(dx), dx, 0.0)
        R_new, t_new = lie.se3_retract(R, t, dx)
        converged = ok & (jnp.linalg.norm(dx) < opts.eps) & (it >= warmup)
        return (it + 1, R_new, t_new, converged, n_eff, chi2)

    init = (
        jnp.int32(0),
        jnp.asarray(R0, jnp.float32),
        jnp.asarray(t0, jnp.float32),
        jnp.bool_(False),
        jnp.int32(0),
        jnp.float32(0.0),
    )
    it, R, t, converged, n_eff, chi2 = jax.lax.while_loop(cond, body, init)
    # pin the output on SO(3): float32 retraction defects otherwise feed
    # back through odometry-only prediction and grow exponentially
    # (lie.so3_renormalize docstring)
    return MatchResult(R=lie.so3_renormalize(R), t=t, converged=converged,
                       num_effective=n_eff, iterations=it, chi2=chi2)


@functools.partial(jax.jit, static_argnames=("opts",))
def set_target_batch(pcs: PointCloud, opts: IcpOptions,
                     origins=None) -> IcpTarget:
    """Build B independent targets in ONE program: every leaf of `pcs`
    carries a leading batch axis ((B, N, 3) xyz, (B, N) mask) and the
    returned IcpTarget's leaves all carry the same leading axis — the
    stacked-target input `scan_match_batch` consumes."""
    if origins is None:
        return jax.vmap(lambda p: set_target(p, opts))(pcs)
    return jax.vmap(lambda p, o: set_target(p, opts, o))(pcs, origins)


@functools.partial(jax.jit, static_argnames=("opts",))
def scan_match_batch(targets: IcpTarget, opts: IcpOptions, srcs: PointCloud,
                     R0, t0) -> MatchResult:
    """B independent scan matches as ONE device program (vmap over the full
    GN loop).

    A single match is mostly fixed per-iteration overhead, so independent
    registrations (pending loop candidates, multi-robot streams, offline
    re-registration sweeps) should ride ONE dispatch: the per-iteration
    fixed cost is paid once for all B. This amortizes exactly what the
    reference pays PER PROBE in its sequential loop over candidates
    (icp_registration.cpp:161-213).

    targets: IcpTarget with a leading batch axis (from `set_target_batch`
    or a tree_map-stack of same-shape targets); srcs: (B, N, 3)/(B, N);
    R0: (B, 3, 3); t0: (B, 3). Returns a MatchResult whose every leaf has
    the leading B axis. Each lane runs its own while_loop trip count under
    vmap semantics (lanes that converge early stop changing state)."""
    return jax.vmap(
        lambda tg, s, R, t: scan_match(tg, opts, s, R, t)
    )(targets, srcs, R0, t0)


def scan_match_batch_chunked(targets: IcpTarget, opts: IcpOptions,
                             srcs: PointCloud, R0, t0,
                             chunk: int = 8) -> MatchResult:
    """`scan_match_batch` over sub-batches of `chunk` lanes, dispatched
    sequentially and re-stacked.

    The direct B-lane program at keyframe-MAP-sized targets (65k points)
    can exceed the compiler's memory at B>=16, and even where it compiles, one B-lane executable per distinct B is a
    compile-cache liability. Chunking pays B/chunk dispatch round trips
    but compiles exactly ONE sub-batch executable for any B (the last
    chunk pads with repeated lanes, results dropped), which is the right
    trade everywhere off the hot path: loop re-registration sweeps over
    full submaps, offline alignment jobs. B <= chunk falls through to the
    direct path."""
    B = R0.shape[0]
    if B <= chunk:
        return scan_match_batch(targets, opts, srcs, R0, t0)
    take = lambda tree, s: jax.tree_util.tree_map(lambda a: a[s], tree)
    outs = []
    for s0 in range(0, B, chunk):
        idx = [(s0 + i) % B for i in range(chunk)]   # pad by wrap, drop later
        sl = jnp.asarray(idx, jnp.int32)
        outs.append(scan_match_batch(
            take(targets, sl), opts, take(srcs, sl), R0[sl], t0[sl]))
    full = jax.tree_util.tree_map(
        lambda *a: jnp.concatenate(a, axis=0)[:B], *outs)
    return full


def _scan_match_vox_frozen(target: IcpTarget, opts: IcpOptions,
                           src: PointCloud, R0, t0) -> MatchResult:
    """p2plane_vox GN with election freezing (freeze_election_after > 0):
    the first k iterations re-elect correspondences at the current pose;
    later iterations reuse the frozen (plane, weight) assignment and run
    ONLY the linearization — dropping the dense lookup + (N,7,8) row
    gather once the election is stationary. ADAPTIVE GUARD: any iteration whose PREVIOUS step
    |dx| > elect_dx_threshold re-elects — large steps mean correspondences
    are still moving (poor init / transient), and there the frozen
    assignment demonstrably diverges. The |n.q+d| <=
    max_plane_distance gate stays live every iteration, so outlier
    rejection still tracks the pose."""
    n = src.capacity

    def cond(state):
        it, R, t, done = state[0], state[1], state[2], state[3]
        return (it < opts.max_iteration) & (~done)

    def body(state):
        (it, R, t, _, _, _, plane, w, R_e, t_e) = state
        moved = (jnp.linalg.norm(t - t_e)
                 + opts.elect_rot_scale
                 * jnp.linalg.norm(lie.so3_log(R_e.T @ R)))
        elect = (it < opts.freeze_election_after) | (
            moved > opts.elect_dx_threshold)

        def do_elect(a):
            R_c, t_c = a
            pl, ww = _p2plane_vox_elect(target, opts, src, R_c, t_c)
            return pl, ww, R_c, t_c

        plane, w, R_e, t_e = jax.lax.cond(
            elect, do_elect, lambda a: (plane, w, R_e, t_e), (R, t))
        H, b, n_eff, chi2 = linearize.p2plane(
            src.xyz, plane, w, R, t, opts.max_plane_distance)
        ok = n_eff >= opts.min_effective_pts
        dx = jnp.where(ok, mathx.solve_gn_6x6(H, b), jnp.zeros(6, dtype=b.dtype))
        dx = jnp.where(jnp.isfinite(dx), dx, 0.0)
        R_new, t_new = lie.se3_retract(R, t, dx)
        converged = ok & (jnp.linalg.norm(dx) < opts.eps)
        return (it + 1, R_new, t_new, converged, n_eff, chi2, plane, w,
                R_e, t_e)

    big = jnp.float32(1e9)
    init = (jnp.int32(0), jnp.asarray(R0, jnp.float32),
            jnp.asarray(t0, jnp.float32), jnp.bool_(False), jnp.int32(0),
            jnp.float32(0.0), jnp.zeros((n, 4), jnp.float32),
            jnp.zeros((n,), jnp.float32),
            jnp.eye(3, dtype=jnp.float32),
            jnp.full((3,), big))   # far-away anchor: iteration 0 elects
    it, R, t, converged, n_eff, chi2, _, _, _, _ = jax.lax.while_loop(
        cond, body, init)
    return MatchResult(R=lie.so3_renormalize(R), t=t, converged=converged,
                       num_effective=n_eff, iterations=it, chi2=chi2)
