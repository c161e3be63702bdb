"""Batched geometry/statistics kernels.

Batched rewrite of the reference math kernel namespace `LocUtils::math`
(/root/reference/LocUtils/include/LocUtils/common/math_utils.h): masked
mean/covariance reductions (math_utils.h:36-72), Gaussian merge
(math_utils.h:88-98), plane fit (math_utils.h:113-136) and line fit
(math_utils.h:138-163) — but vectorized over an arbitrary batch of neighbor
sets instead of one `std::vector` at a time, with validity masks standing in
for the reference's early-return bools.

The 3x3/4x4 eigen-decompositions are closed-form-ish via `jnp.linalg.eigh`
(batched; XLA lowers small-batch eigh efficiently) so a whole scan's worth of
5-NN plane fits runs as a single fused batched op.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

G_M_S2 = 9.81  # gravity magnitude used throughout the reference


def masked_mean(x: jax.Array, mask: jax.Array, axis=-2, eps: float = 1e-9):
    """Mean over `axis` counting only mask==True rows. mask: (...,N)."""
    m = mask[..., None].astype(x.dtype)
    n = jnp.sum(m, axis=axis)
    return jnp.sum(x * m, axis=axis) / jnp.maximum(n, eps), n[..., 0]


def masked_mean_and_cov(pts: jax.Array, mask: jax.Array):
    """Masked mean and (unbiased, /(n-1)) covariance of point sets.

    pts: (..., N, 3), mask: (..., N) -> mean (..., 3), cov (..., 3, 3), n (...).
    Matches math::ComputeMeanAndCov (math_utils.h:55-72) which divides by
    (len - 1).
    """
    mean, n = masked_mean(pts, mask)
    d = (pts - mean[..., None, :]) * mask[..., None].astype(pts.dtype)
    cov = jnp.einsum("...ni,...nj->...ij", d, d) / jnp.maximum(n - 1.0, 1.0)[..., None, None]
    return mean, cov, n


def masked_mean_and_cov_diag(x: jax.Array, mask: jax.Array):
    """Diagonal-covariance variant, math::ComputeMeanAndCovDiag
    (math_utils.h:36-47). x: (..., N, D)."""
    mean, n = masked_mean(x, mask)
    d = (x - mean[..., None, :]) * mask[..., None].astype(x.dtype)
    var = jnp.sum(d * d, axis=-2) / jnp.maximum(n - 1.0, 1.0)[..., None]
    return mean, var, n


def merge_gaussian(hist_n, hist_mean, hist_cov, cur_n, cur_mean, cur_cov):
    """Moment-matched merge of two Gaussians, math::UpdateMeanAndCov
    (math_utils.h:88-98). Used by incremental NDT voxel updates."""
    total = hist_n + cur_n
    new_mean = (hist_n[..., None] * hist_mean + cur_n[..., None] * cur_mean) / total[..., None]
    dh = hist_mean - new_mean
    dc = cur_mean - new_mean
    new_cov = (
        hist_n[..., None, None] * (hist_cov + dh[..., :, None] * dh[..., None, :])
        + cur_n[..., None, None] * (cur_cov + dc[..., :, None] * dc[..., None, :])
    ) / total[..., None, None]
    return new_mean, new_cov


def eigh_sym3x3(A: jax.Array):
    """Closed-form eigendecomposition of symmetric (..., 3, 3) matrices.

    Analytic eigenvalues (Cardano, ascending order) and eigenvectors by the
    matrix-product trick: for eigenvalue li, the columns of
    (A - lj I)(A - lk I) span its eigenspace. Fully branch-free elementwise
    arithmetic, in place of `jnp.linalg.eigh`'s iterative batched
    factorization. Accuracy is ample for covariance/plane work (~1e-6
    relative for well-separated eigenvalues; degenerate pairs fall back to
    stable column selection).
    """
    a00 = A[..., 0, 0]; a01 = A[..., 0, 1]; a02 = A[..., 0, 2]
    a11 = A[..., 1, 1]; a12 = A[..., 1, 2]; a22 = A[..., 2, 2]
    q = (a00 + a11 + a22) / 3.0
    p1 = a01 * a01 + a02 * a02 + a12 * a12
    b00, b11, b22 = a00 - q, a11 - q, a22 - q
    p2 = b00 * b00 + b11 * b11 + b22 * b22 + 2.0 * p1
    p = jnp.sqrt(jnp.maximum(p2 / 6.0, 1e-30))
    # det(B)/2p^3 with B = (A - qI)/p
    detB = (b00 * (b11 * b22 - a12 * a12)
            - a01 * (a01 * b22 - a12 * a02)
            + a02 * (a01 * a12 - b11 * a02))
    r = jnp.clip(detB / (2.0 * p * p * p), -1.0, 1.0)
    phi = jnp.arccos(r) / 3.0
    e2 = q + 2.0 * p * jnp.cos(phi)                          # largest
    e0 = q + 2.0 * p * jnp.cos(phi + 2.0 * jnp.pi / 3.0)     # smallest
    e1 = 3.0 * q - e0 - e2
    vals = jnp.stack([e0, e1, e2], axis=-1)

    eye = jnp.eye(3, dtype=A.dtype)

    def vec_for(li, lj, lk):
        M = (A - lj[..., None, None] * eye) @ (A - lk[..., None, None] * eye)
        # best column = largest norm (branch-free)
        n2 = jnp.sum(M * M, axis=-2)                          # (..., 3)
        onehot = jax.nn.one_hot(jnp.argmax(n2, axis=-1), 3, dtype=A.dtype)
        v = jnp.einsum("...ij,...j->...i", M, onehot)
        nrm = jnp.sqrt(jnp.sum(v * v, axis=-1, keepdims=True))
        # degenerate (near-spherical) fallback: e_x
        fallback = jnp.zeros_like(v).at[..., 0].set(1.0)
        return jnp.where(nrm > 1e-20, v / jnp.maximum(nrm, 1e-20), fallback)

    v0 = vec_for(e0, e1, e2)
    v2 = vec_for(e2, e0, e1)
    # middle vector: orthogonal completion (exact for symmetric A)
    v1 = jnp.cross(v2, v0)
    v1 = v1 / jnp.maximum(jnp.linalg.norm(v1, axis=-1, keepdims=True), 1e-20)
    vecs = jnp.stack([v0, v1, v2], axis=-1)                   # columns
    return vals, vecs


def fit_plane(pts: jax.Array, mask: jax.Array, eps: float = 1e-2):
    """Batched plane fit: smallest right-singular vector of [x y z 1].

    pts: (..., K, 3), mask: (..., K) -> coeffs (..., 4) with ||coeffs||=1,
    valid (...,). Mirrors math::FitPlane (math_utils.h:113-136): the plane is
    the null direction of A = [p, 1]; validity requires >=3 points and
    per-point residual^2 <= eps for every (real) neighbor.
    """
    # Centered PCA: unit normal = smallest eigenvector of the centered
    # scatter, offset d0 = -n.c; then rescale the 4-vector (n, d0) to unit
    # norm, matching the reference's ||(n,d)||_4 = 1 convention. For the
    # near-coplanar 5-NN sets this agrees with the exact [p,1] TLS solution
    # to O(residual^2) and runs closed-form instead of batched eigh
    # (documented deviation; golden ICP tests bound the effect).
    centroid, n = masked_mean(pts, mask)
    d = (pts - centroid[..., None, :]) * mask[..., None].astype(pts.dtype)
    S = jnp.einsum("...ki,...kj->...ij", d, d)
    _, vecs = eigh_sym3x3(S)
    nvec = vecs[..., :, 0]
    d0 = -jnp.sum(nvec * centroid, axis=-1, keepdims=True)
    coeffs = jnp.concatenate([nvec, d0], axis=-1)
    coeffs = coeffs / jnp.maximum(
        jnp.linalg.norm(coeffs, axis=-1, keepdims=True), 1e-12)
    resid = (jnp.einsum("...ki,...i->...k", pts, coeffs[..., :3])
             + coeffs[..., 3][..., None])
    ok = jnp.all(jnp.where(mask, resid * resid <= eps, True), axis=-1)
    valid = (n >= 3) & ok & jnp.isfinite(coeffs).all(axis=-1)
    return coeffs, valid


def fit_line(pts: jax.Array, mask: jax.Array, eps: float = 0.2):
    """Batched line fit: centroid + principal eigenvector of the scatter.

    pts: (..., K, 3), mask: (..., K) -> origin (..., 3), dir (..., 3) unit,
    valid (...,). Mirrors math::FitLine (math_utils.h:138-163); validity
    requires >=2 points and |dir x (p - origin)|^2 <= eps for every neighbor.
    """
    origin, n = masked_mean(pts, mask)
    d = (pts - origin[..., None, :]) * mask[..., None].astype(pts.dtype)
    S = jnp.einsum("...ki,...kj->...ij", d, d)
    _, vecs = eigh_sym3x3(S)
    direction = vecs[..., :, 2]  # largest eigenvalue
    cr = jnp.cross(jnp.broadcast_to(direction[..., None, :], d.shape), d)
    cr2 = jnp.sum(cr * cr, axis=-1)
    ok = jnp.all(jnp.where(mask, cr2 <= eps, True), axis=-1)
    valid = (n >= 2) & ok & jnp.isfinite(direction).all(axis=-1)
    return origin, direction, valid


def clamped_inverse_3x3(cov: jax.Array, rel_floor: float = 1e-3):
    """Information matrix from covariance with singular-value clamping.

    Mirrors the NDT voxel info computation (ndt_registration.cpp:116-131):
    SVD of sigma, clamp lambda[1], lambda[2] below lambda[0]*1e-3, invert.
    cov: (..., 3, 3) symmetric PSD -> info (..., 3, 3).
    """
    vals, vecs = eigh_sym3x3(cov)  # ascending
    lam0 = vals[..., 2:3]  # largest
    floor = lam0 * rel_floor
    clamped = jnp.maximum(vals, floor)
    inv = 1.0 / jnp.maximum(clamped, 1e-12)
    return jnp.einsum("...ij,...j,...kj->...ik", vecs, inv, vecs)


def regularized_inverse_3x3(cov: jax.Array, jitter: float = 1e-3):
    """info = (sigma + jitter*I)^-1, the incremental-NDT first-scan variant
    (ndt_registration.cpp:188-189)."""
    eye = jnp.eye(3, dtype=cov.dtype)
    return jnp.linalg.inv(cov + jitter * eye)


def solve_gn_6x6(H: jax.Array, b: jax.Array, damping: float = 0.0):
    """Solve H dx = b for the 6-DoF GN step.

    The reference inverts H directly (icp_registration.cpp:325). We solve the
    (slightly damped, for f32 robustness) system instead; with damping=0 this
    is numerically equivalent for well-conditioned H.
    """
    if damping:
        H = H + damping * jnp.eye(6, dtype=H.dtype)
    return jnp.linalg.solve(H, b)


def schur_marginalize(H: jax.Array, b: jax.Array, k: int):
    """Schur-complement marginalization of the first k states.

    Mirrors math::Marginalize (math_utils.h:613-686) semantics: returns the
    reduced (H', b') over the remaining block after eliminating block [0:k].
    H: (n, n), b: (n,).
    """
    Haa = H[:k, :k]
    Hab = H[:k, k:]
    Hba = H[k:, :k]
    Hbb = H[k:, k:]
    ba = b[:k]
    bb = b[k:]
    Haa_inv = jnp.linalg.inv(Haa + 1e-9 * jnp.eye(k, dtype=H.dtype))
    Hp = Hbb - Hba @ Haa_inv @ Hab
    bp = bb - Hba @ Haa_inv @ ba
    return Hp, bp


def cholesky_3x3(A: jax.Array):
    """Closed-form lower Cholesky of batched SPD 3x3 matrices (..., 3, 3) ->
    six packed factors (..., 6) ordered [L00, L10, L11, L20, L21, L22].

    Used to pre-factor NDT per-voxel information matrices at map-build time
    so the matching kernel folds info into rows B = L^T J / z = L^T e and
    accumulates plain outer products (H = B^T B) — no per-point
    3x3 quadratic forms in the hot loop. Degenerate inputs (zero info of a
    non-estimated voxel) produce zeros, not NaNs."""
    # Off-diagonal solves are CLIPPED to their exact-arithmetic PSD bounds
    # (|L_ij| <= sqrt(A_jj-ish)): a rank-deficient input whose tiny diagonal
    # cancels to 0 in f32 while its off-diagonal keeps rounding error (e.g.
    # the projector I - dd^T for d one float-ulp off unit) would otherwise
    # cascade the division by sqrt(eps) into astronomically large factors.
    eps = jnp.float32(1e-12)
    a00 = jnp.maximum(A[..., 0, 0], 0.0)
    a11 = jnp.maximum(A[..., 1, 1], 0.0)
    a22 = jnp.maximum(A[..., 2, 2], 0.0)
    l00 = jnp.sqrt(a00 + eps)
    clip = lambda x, b: jnp.clip(x, -b, b)
    l10 = clip(A[..., 1, 0] / l00, jnp.sqrt(a11 + eps))
    l20 = clip(A[..., 2, 0] / l00, jnp.sqrt(a22 + eps))
    d11 = jnp.maximum(a11 - l10 * l10, 0.0)
    l11 = jnp.sqrt(d11 + eps)
    d22_bound = jnp.sqrt(jnp.maximum(a22 - l20 * l20, 0.0) + eps)
    l21 = clip((A[..., 2, 1] - l20 * l10) / l11, d22_bound)
    d22 = jnp.maximum(a22 - l20 * l20 - l21 * l21, 0.0)
    l22 = jnp.sqrt(d22 + eps)
    packed = jnp.stack([l00, l10, l11, l20, l21, l22], axis=-1)
    # exact-zero input -> exact-zero factor (est=False voxels carry info=0)
    zero = jnp.all(A == 0.0, axis=(-2, -1))
    return jnp.where(zero[..., None], 0.0, packed)


def cholesky_3x3_unpack(packed: jax.Array) -> jax.Array:
    """(..., 6) packed factors -> (..., 3, 3) lower-triangular L."""
    z = jnp.zeros_like(packed[..., 0])
    rows = jnp.stack([
        jnp.stack([packed[..., 0], z, z], axis=-1),
        jnp.stack([packed[..., 1], packed[..., 2], z], axis=-1),
        jnp.stack([packed[..., 3], packed[..., 4], packed[..., 5]], axis=-1),
    ], axis=-2)
    return rows
