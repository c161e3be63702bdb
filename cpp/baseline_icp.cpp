// CPU baseline: kd-tree 5-NN + point-to-plane ICP Gauss-Newton.
//
// An independent, from-scratch C++17 implementation of the ALGORITHM the
// reference runs (kd-tree correspondence search + per-point plane fit +
// 6-DoF GN, icp_registration.cpp AlignP2Plane path), used by bench.py as the
// measured "C++ CPU baseline" that BASELINE.md requires (the reference
// itself cannot be built here: it needs ROS1/PCL/Sophus). Same workload,
// same iteration budget and stopping rule as the JAX engine, single thread
// (the reference's hot loop is single-threaded, SURVEY.md section 2).
//
// Usage: baseline_icp <data.bin> <repeats>
//   data.bin layout (little-endian float32 unless noted):
//     int32 n_target, int32 n_source
//     target xyz  [n_target*3]
//     source xyz  [n_source*3]
//     optional initial pose: R row-major [9], t [3] (identity if absent)
//   Prints: "<build_ms> <match_ms>" (kd-tree build, mean per-scan match);
//   the converged pose (R row-major + t) goes to stderr for parity checks.

#include <algorithm>
#include <chrono>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <fstream>
#include <queue>
#include <vector>

struct V3 {
  float x = 0, y = 0, z = 0;
  V3() = default;
  V3(float a, float b, float c) : x(a), y(b), z(c) {}
  V3 operator+(const V3& o) const { return {x + o.x, y + o.y, z + o.z}; }
  V3 operator-(const V3& o) const { return {x - o.x, y - o.y, z - o.z}; }
  V3 operator*(float s) const { return {x * s, y * s, z * s}; }
  float dot(const V3& o) const { return x * o.x + y * o.y + z * o.z; }
  V3 cross(const V3& o) const {
    return {y * o.z - z * o.y, z * o.x - x * o.z, x * o.y - y * o.x};
  }
  float norm() const { return std::sqrt(dot(*this)); }
  float operator[](int i) const { return i == 0 ? x : (i == 1 ? y : z); }
};

struct M3 {
  float m[3][3] = {{1, 0, 0}, {0, 1, 0}, {0, 0, 1}};
  V3 mul(const V3& v) const {
    return {m[0][0] * v.x + m[0][1] * v.y + m[0][2] * v.z,
            m[1][0] * v.x + m[1][1] * v.y + m[1][2] * v.z,
            m[2][0] * v.x + m[2][1] * v.y + m[2][2] * v.z};
  }
  M3 mul(const M3& o) const {
    M3 r;
    for (int i = 0; i < 3; i++)
      for (int j = 0; j < 3; j++) {
        r.m[i][j] = 0;
        for (int k = 0; k < 3; k++) r.m[i][j] += m[i][k] * o.m[k][j];
      }
    return r;
  }
};

static M3 so3_exp(const V3& w) {
  float t = w.norm();
  M3 R;
  float a = (t < 1e-8f) ? 1.0f : std::sin(t) / t;
  float b = (t < 1e-8f) ? 0.5f : (1.0f - std::cos(t)) / (t * t);
  float W[3][3] = {{0, -w.z, w.y}, {w.z, 0, -w.x}, {-w.y, w.x, 0}};
  float W2[3][3];
  for (int i = 0; i < 3; i++)
    for (int j = 0; j < 3; j++) {
      W2[i][j] = 0;
      for (int k = 0; k < 3; k++) W2[i][j] += W[i][k] * W[k][j];
    }
  for (int i = 0; i < 3; i++)
    for (int j = 0; j < 3; j++)
      R.m[i][j] = (i == j ? 1.0f : 0.0f) + a * W[i][j] + b * W2[i][j];
  return R;
}

// ---------------------------------------------------------------------------
// kd-tree: max-variance split axis, mean threshold (the reference's scheme,
// kdtree.cpp:96-123), single point per leaf, kNN with bounded max-heap.
// ---------------------------------------------------------------------------
struct KdTree {
  struct Node {
    int point = -1;     // leaf payload
    int axis = 0;
    float thresh = 0;
    int left = -1, right = -1;
  };
  std::vector<Node> nodes;
  const std::vector<V3>* pts = nullptr;

  int build(std::vector<int>& idx, int lo, int hi) {
    if (hi - lo == 1) {
      nodes.push_back({idx[lo], 0, 0, -1, -1});
      return (int)nodes.size() - 1;
    }
    // max-variance axis + mean split
    double mean[3] = {0, 0, 0}, var[3] = {0, 0, 0};
    for (int i = lo; i < hi; i++)
      for (int a = 0; a < 3; a++) mean[a] += (*pts)[idx[i]][a];
    for (int a = 0; a < 3; a++) mean[a] /= (hi - lo);
    for (int i = lo; i < hi; i++)
      for (int a = 0; a < 3; a++) {
        double d = (*pts)[idx[i]][a] - mean[a];
        var[a] += d * d;
      }
    int axis = 0;
    if (var[1] > var[axis]) axis = 1;
    if (var[2] > var[axis]) axis = 2;
    float th = (float)mean[axis];
    int mid = (int)(std::partition(idx.begin() + lo, idx.begin() + hi,
                                   [&](int p) { return (*pts)[p][axis] < th; }) -
                    idx.begin());
    if (mid == lo || mid == hi) mid = (lo + hi) / 2;  // degenerate split
    int self = (int)nodes.size();
    nodes.push_back({-1, axis, th, -1, -1});
    int l = build(idx, lo, mid);
    int r = build(idx, mid, hi);
    nodes[self].left = l;
    nodes[self].right = r;
    return self;
  }

  void init(const std::vector<V3>& p) {
    pts = &p;
    nodes.reserve(2 * p.size());
    std::vector<int> idx(p.size());
    for (size_t i = 0; i < p.size(); i++) idx[i] = (int)i;
    build(idx, 0, (int)p.size());
  }

  void knn(const V3& q, int k, std::vector<int>& out) const {
    // max-heap of (d2, idx)
    std::priority_queue<std::pair<float, int>> heap;
    knn_rec(0, q, k, heap);
    out.clear();
    while (!heap.empty()) {
      out.push_back(heap.top().second);
      heap.pop();
    }
  }

  void knn_rec(int ni, const V3& q, int k,
               std::priority_queue<std::pair<float, int>>& heap) const {
    const Node& n = nodes[ni];
    if (n.point >= 0) {
      V3 d = (*pts)[n.point] - q;
      float d2 = d.dot(d);
      if ((int)heap.size() < k)
        heap.push({d2, n.point});
      else if (d2 < heap.top().first) {
        heap.pop();
        heap.push({d2, n.point});
      }
      return;
    }
    float delta = q[n.axis] - n.thresh;
    int first = delta < 0 ? n.left : n.right;
    int second = delta < 0 ? n.right : n.left;
    knn_rec(first, q, k, heap);
    if ((int)heap.size() < k || delta * delta < heap.top().first)
      knn_rec(second, q, k, heap);
  }
};

// Smallest eigenvector of a symmetric 3x3 (plane normal): analytic
// eigenvalues (Cardano) + cross-product eigenvector recovery.
static V3 smallest_eigvec(const float A[3][3]) {
  float p1 = A[0][1] * A[0][1] + A[0][2] * A[0][2] + A[1][2] * A[1][2];
  float q = (A[0][0] + A[1][1] + A[2][2]) / 3.0f;
  float B[3][3];
  for (int i = 0; i < 3; i++)
    for (int j = 0; j < 3; j++) B[i][j] = A[i][j] - (i == j ? q : 0.0f);
  float p2 = B[0][0] * B[0][0] + B[1][1] * B[1][1] + B[2][2] * B[2][2] + 2 * p1;
  float p = std::sqrt(std::max(p2 / 6.0f, 1e-20f));
  float detB = B[0][0] * (B[1][1] * B[2][2] - B[1][2] * B[1][2]) -
               B[0][1] * (B[0][1] * B[2][2] - B[1][2] * B[0][2]) +
               B[0][2] * (B[0][1] * B[1][2] - B[1][1] * B[0][2]);
  float r = detB / (2 * p * p * p);
  r = std::max(-1.0f, std::min(1.0f, r));
  float phi = std::acos(r) / 3.0f;
  float eig_min = q + 2 * p * std::cos(phi + 2.0f * 3.14159265f / 3.0f);
  // rows of (A - eig_min I) span the orthogonal complement of the eigenvector
  V3 r0(A[0][0] - eig_min, A[0][1], A[0][2]);
  V3 r1(A[0][1], A[1][1] - eig_min, A[1][2]);
  V3 r2(A[0][2], A[1][2], A[2][2] - eig_min);
  V3 c0 = r0.cross(r1), c1 = r0.cross(r2), c2 = r1.cross(r2);
  V3 best = c0;
  if (c1.dot(c1) > best.dot(best)) best = c1;
  if (c2.dot(c2) > best.dot(best)) best = c2;
  float n = best.norm();
  return n > 1e-12f ? best * (1.0f / n) : V3(0, 0, 1);
}

static bool solve6(double H[6][6], double b[6], double x[6]) {
  int piv[6];
  for (int i = 0; i < 6; i++) piv[i] = i;
  for (int c = 0; c < 6; c++) {
    int best = c;
    for (int r = c + 1; r < 6; r++)
      if (std::fabs(H[r][c]) > std::fabs(H[best][c])) best = r;
    if (std::fabs(H[best][c]) < 1e-12) return false;
    std::swap(H[c], H[best]);
    std::swap(b[c], b[best]);
    for (int r = c + 1; r < 6; r++) {
      double f = H[r][c] / H[c][c];
      for (int k = c; k < 6; k++) H[r][k] -= f * H[c][k];
      b[r] -= f * b[c];
    }
  }
  for (int r = 5; r >= 0; r--) {
    double s = b[r];
    for (int k = r + 1; k < 6; k++) s -= H[r][k] * x[k];
    x[r] = s / H[r][r];
  }
  return true;
}

int main(int argc, char** argv) {
  if (argc < 3) {
    std::fprintf(stderr, "usage: %s data.bin repeats\n", argv[0]);
    return 1;
  }
  std::ifstream f(argv[1], std::ios::binary);
  int32_t nt = 0, ns = 0;
  f.read((char*)&nt, 4);
  f.read((char*)&ns, 4);
  std::vector<V3> target(nt), source(ns);
  f.read((char*)target.data(), (std::streamsize)nt * 12);
  f.read((char*)source.data(), (std::streamsize)ns * 12);
  M3 R_init;
  V3 t_init(0, 0, 0);
  {
    float pose[12];
    f.read((char*)pose, 48);
    if (f.gcount() == 48) {
      for (int i = 0; i < 3; i++)
        for (int j = 0; j < 3; j++) R_init.m[i][j] = pose[3 * i + j];
      t_init = V3(pose[9], pose[10], pose[11]);
    }
  }
  int repeats = std::atoi(argv[2]);

  auto t0 = std::chrono::steady_clock::now();
  KdTree tree;
  tree.init(target);
  auto t1 = std::chrono::steady_clock::now();
  double build_ms =
      std::chrono::duration<double, std::milli>(t1 - t0).count();

  const int kMaxIter = 20;
  const float kEps = 1e-2f;
  const float kMaxPlaneDist = 0.1f;

  double total_ms = 0;
  M3 R_out;
  V3 t_out;
  for (int rep = 0; rep < repeats; rep++) {
    M3 R = R_init;
    V3 t = t_init;
    auto m0 = std::chrono::steady_clock::now();
    std::vector<int> nn;
    for (int iter = 0; iter < kMaxIter; iter++) {
      double H[6][6] = {}, b[6] = {};
      int eff = 0;
      for (int i = 0; i < ns; i++) {
        V3 q = source[i];
        V3 qs = R.mul(q) + t;
        tree.knn(qs, 5, nn);
        if (nn.size() < 5) continue;
        // plane fit through the 5 neighbors (centroid + smallest eigvec)
        V3 mu(0, 0, 0);
        for (int j : nn) mu = mu + target[j];
        mu = mu * 0.2f;
        float C[3][3] = {};
        for (int j : nn) {
          V3 d = target[j] - mu;
          C[0][0] += d.x * d.x; C[0][1] += d.x * d.y; C[0][2] += d.x * d.z;
          C[1][1] += d.y * d.y; C[1][2] += d.y * d.z; C[2][2] += d.z * d.z;
        }
        C[1][0] = C[0][1]; C[2][0] = C[0][2]; C[2][1] = C[1][2];
        V3 n = smallest_eigvec(C);
        float d = -n.dot(mu);
        float dis = n.dot(qs) + d;
        if (std::fabs(dis) > kMaxPlaneDist) continue;
        eff++;
        // J = [-n^T R hat(q), n^T]
        V3 Rtn = {R.m[0][0] * n.x + R.m[1][0] * n.y + R.m[2][0] * n.z,
                  R.m[0][1] * n.x + R.m[1][1] * n.y + R.m[2][1] * n.z,
                  R.m[0][2] * n.x + R.m[1][2] * n.y + R.m[2][2] * n.z};
        float J[6] = {-(Rtn.y * q.z - Rtn.z * q.y),
                      -(Rtn.z * q.x - Rtn.x * q.z),
                      -(Rtn.x * q.y - Rtn.y * q.x),
                      n.x, n.y, n.z};
        for (int a = 0; a < 6; a++) {
          for (int c = 0; c < 6; c++) H[a][c] += (double)J[a] * J[c];
          b[a] -= (double)J[a] * dis;
        }
      }
      if (eff < 10) break;
      double dx[6];
      if (!solve6(H, b, dx)) break;
      R = R.mul(so3_exp(V3((float)dx[0], (float)dx[1], (float)dx[2])));
      t = t + V3((float)dx[3], (float)dx[4], (float)dx[5]);
      double step2 = dx[0] * dx[0] + dx[1] * dx[1] + dx[2] * dx[2] +
                     dx[3] * dx[3] + dx[4] * dx[4] + dx[5] * dx[5];
      if (std::sqrt(step2) < kEps) break;
    }
    auto m1 = std::chrono::steady_clock::now();
    total_ms += std::chrono::duration<double, std::milli>(m1 - m0).count();
    R_out = R;
    t_out = t;
  }
  std::fprintf(stderr,
               "pose R = %.6f %.6f %.6f %.6f %.6f %.6f %.6f %.6f %.6f "
               "t = %.6f %.6f %.6f\n",
               R_out.m[0][0], R_out.m[0][1], R_out.m[0][2], R_out.m[1][0],
               R_out.m[1][1], R_out.m[1][2], R_out.m[2][0], R_out.m[2][1],
               R_out.m[2][2], t_out.x, t_out.y, t_out.z);
  std::printf("%.3f %.3f\n", build_ms, total_ms / repeats);
  return 0;
}
