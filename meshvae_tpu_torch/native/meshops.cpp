// Native host-side mesh preprocessing for meshvae_tpu_torch: QSlim
// decimation, nearest-point barycentric transfer and the OBJ parse (the
// port's own copy of meshvae_tpu/native/meshops.cpp).
//
// The same algorithms as meshvae_tpu_torch/mesh/qslim.py and transfer.py
// (cross-product face quadrics, lazy-invalidation binary heap with version
// stamps, union-find vertex representatives; uniform-grid accelerated exact
// point-triangle projection) in C++: the numpy path takes minutes on the
// 80k-vertex scaled template, this one seconds. Exposed via a C ABI and
// loaded with ctypes (meshvae_tpu_torch/native/__init__.py); the Python
// implementations remain as the fallback and the behavioral reference.
//
// Built at first use by meshvae_tpu_torch/native/__init__.py
// (g++ -O3 -std=c++17 -shared -fPIC) into meshvae_tpu_torch/ops/_build/.

#include <algorithm>
#include <array>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <queue>
#include <set>
#include <unordered_map>
#include <unordered_set>
#include <vector>

namespace {

struct Vec3 {
  double x, y, z;
  Vec3 operator-(const Vec3 &o) const { return {x - o.x, y - o.y, z - o.z}; }
  Vec3 operator+(const Vec3 &o) const { return {x + o.x, y + o.y, z + o.z}; }
  Vec3 operator*(double s) const { return {x * s, y * s, z * s}; }
  double dot(const Vec3 &o) const { return x * o.x + y * o.y + z * o.z; }
  Vec3 cross(const Vec3 &o) const {
    return {y * o.z - z * o.y, z * o.x - x * o.z, x * o.y - y * o.x};
  }
  double norm() const { return std::sqrt(dot(*this)); }
};

struct Quadric {
  double q[10];  // symmetric 4x4: [a00 a01 a02 a03 a11 a12 a13 a22 a23 a33]
  Quadric() { std::memset(q, 0, sizeof(q)); }
  void add_plane(double a, double b, double c, double d) {
    q[0] += a * a; q[1] += a * b; q[2] += a * c; q[3] += a * d;
    q[4] += b * b; q[5] += b * c; q[6] += b * d;
    q[7] += c * c; q[8] += c * d; q[9] += d * d;
  }
  void add(const Quadric &o) {
    for (int i = 0; i < 10; ++i) q[i] += o.q[i];
  }
  double eval(const Vec3 &p) const {
    // [p 1]^T Q [p 1]
    return q[0] * p.x * p.x + 2 * q[1] * p.x * p.y + 2 * q[2] * p.x * p.z +
           2 * q[3] * p.x + q[4] * p.y * p.y + 2 * q[5] * p.y * p.z +
           2 * q[6] * p.y + q[7] * p.z * p.z + 2 * q[8] * p.z + q[9];
  }
};

struct HeapEntry {
  double cost;
  int32_t u, v;       // u < v
  int64_t ver_u, ver_v;
  bool operator>(const HeapEntry &o) const {
    if (cost != o.cost) return cost > o.cost;
    if (u != o.u) return u > o.u;
    return v > o.v;
  }
};

int32_t find_root(std::vector<int32_t> &parent, int32_t i) {
  int32_t root = i;
  while (parent[root] != root) root = parent[root];
  while (parent[i] != root) {
    int32_t next = parent[i];
    parent[i] = root;
    i = next;
  }
  return root;
}

}  // namespace

extern "C" {

// QSlim decimation. Returns number of kept vertices, or -1 on error.
// Outputs (caller-allocated to worst-case sizes):
//   out_faces      [num_faces * 3]  (first *out_num_faces rows valid)
//   out_kept       [num_vertices]   parent-space ids of kept vertices, sorted
//                                   (D matrix: D[i, out_kept[i]] = 1)
int64_t meshops_qslim(const double *vertices, int64_t num_vertices,
                      const int64_t *faces, int64_t num_faces,
                      int64_t target_vertices, int64_t *out_faces,
                      int64_t *out_num_faces, int64_t *out_kept) {
  std::vector<Vec3> v(num_vertices);
  for (int64_t i = 0; i < num_vertices; ++i)
    v[i] = {vertices[3 * i], vertices[3 * i + 1], vertices[3 * i + 2]};

  // face quadrics via cross products (matches qslim.py face_quadrics)
  std::vector<Quadric> quadrics(num_vertices);
  std::vector<std::array<int64_t, 3>> f(num_faces);
  for (int64_t i = 0; i < num_faces; ++i) {
    f[i] = {faces[3 * i], faces[3 * i + 1], faces[3 * i + 2]};
    Vec3 p0 = v[f[i][0]], p1 = v[f[i][1]], p2 = v[f[i][2]];
    Vec3 n = (p1 - p0).cross(p2 - p0);
    double norm = n.norm();
    if (norm <= 0) continue;
    Vec3 nu = n * (1.0 / norm);
    double d = -nu.dot(p0);
    for (int k = 0; k < 3; ++k)
      quadrics[f[i][k]].add_plane(nu.x, nu.y, nu.z, d);
  }

  // adjacency sets
  std::vector<std::set<int32_t>> nbr(num_vertices);
  for (auto &tri : f)
    for (int k = 0; k < 3; ++k) {
      int32_t a = (int32_t)tri[k], b = (int32_t)tri[(k + 1) % 3];
      if (a == b) continue;
      nbr[a].insert(b);
      nbr[b].insert(a);
    }

  std::vector<int64_t> version(num_vertices, 0);
  std::vector<int32_t> parent(num_vertices);
  for (int64_t i = 0; i < num_vertices; ++i) parent[i] = (int32_t)i;

  auto edge_cost = [&](int32_t a, int32_t b, int32_t *keep, int32_t *destroy,
                       Quadric *qsum) {
    Quadric s = quadrics[a];
    s.add(quadrics[b]);
    double cost_keep_a = s.eval(v[a]);  // destroy b
    double cost_keep_b = s.eval(v[b]);  // destroy a
    if (qsum) *qsum = s;
    if (cost_keep_a <= cost_keep_b) {
      if (keep) { *keep = a; *destroy = b; }
      return cost_keep_a;
    }
    if (keep) { *keep = b; *destroy = a; }
    return cost_keep_b;
  };

  std::priority_queue<HeapEntry, std::vector<HeapEntry>,
                      std::greater<HeapEntry>> heap;
  for (int32_t a = 0; a < num_vertices; ++a)
    for (int32_t b : nbr[a])
      if (a < b)
        heap.push({edge_cost(a, b, nullptr, nullptr, nullptr), a, b, 0, 0});

  // live faces + incidence + incremental live-vertex count (a vertex is
  // live while it has >= 1 live incident face — identical to counting
  // unique vertices over remaining faces, without the O(F) rescan)
  std::vector<char> face_alive(num_faces, 1);
  std::vector<std::unordered_set<int64_t>> incident(num_vertices);
  std::vector<int64_t> ref_count(num_vertices, 0);
  for (int64_t i = 0; i < num_faces; ++i)
    for (int k = 0; k < 3; ++k) {
      incident[f[i][k]].insert(i);
      ref_count[f[i][k]]++;
    }
  int64_t n_live = 0;
  for (int64_t i = 0; i < num_vertices; ++i)
    if (ref_count[i] > 0) n_live++;
  auto dec_ref = [&](int64_t vi) {
    if (--ref_count[vi] == 0) n_live--;
  };
  auto inc_ref = [&](int64_t vi) {
    if (ref_count[vi]++ == 0) n_live++;
  };

  while (n_live > target_vertices && !heap.empty()) {
    HeapEntry e = heap.top();
    heap.pop();
    int32_t ra = find_root(parent, e.u), rb = find_root(parent, e.v);
    if (ra == rb) continue;
    if (version[ra] != e.ver_u || version[rb] != e.ver_v || e.u != ra ||
        e.v != rb) {
      if (nbr[ra].count(rb)) {
        int32_t u = std::min(ra, rb), w = std::max(ra, rb);
        heap.push({edge_cost(ra, rb, nullptr, nullptr, nullptr), u, w,
                   version[u], version[w]});
      }
      continue;
    }

    int32_t keep, destroy;
    Quadric qsum;
    double c_now = edge_cost(ra, rb, &keep, &destroy, &qsum);
    if (c_now > e.cost) {
      heap.push({c_now, e.u, e.v, e.ver_u, e.ver_v});
      continue;
    }

    parent[destroy] = keep;
    quadrics[keep] = qsum;
    version[keep]++;
    version[destroy]++;

    nbr[destroy].erase(keep);
    nbr[keep].erase(destroy);
    for (int32_t nb : nbr[destroy]) {
      nbr[nb].erase(destroy);
      if (nb != keep) {
        nbr[nb].insert(keep);
        nbr[keep].insert(nb);
      }
    }
    nbr[destroy].clear();

    for (int64_t fi : std::vector<int64_t>(incident[destroy].begin(),
                                           incident[destroy].end())) {
      if (!face_alive[fi]) continue;
      auto &tri = f[fi];
      for (int k = 0; k < 3; ++k)
        if (tri[k] == destroy) {
          tri[k] = keep;
          dec_ref(destroy);
          inc_ref(keep);
        }
      if (tri[0] == tri[1] || tri[1] == tri[2] || tri[2] == tri[0]) {
        face_alive[fi] = 0;
        std::set<int64_t> distinct(tri.begin(), tri.end());
        for (int64_t vv : distinct) incident[vv].erase(fi);
        for (int k = 0; k < 3; ++k) dec_ref(tri[k]);
      } else {
        incident[keep].insert(fi);
      }
    }
    incident[destroy].clear();

    for (int32_t nb : nbr[keep]) {
      int32_t u = std::min(keep, nb), w = std::max(keep, nb);
      heap.push({edge_cost(keep, nb, nullptr, nullptr, nullptr), u, w,
                 version[u], version[w]});
    }
  }

  // compact kept vertices (sorted parent-space ids) + reindex faces
  std::set<int64_t> kept_set;
  for (int64_t i = 0; i < num_faces; ++i)
    if (face_alive[i])
      for (int k = 0; k < 3; ++k) kept_set.insert(f[i][k]);
  std::unordered_map<int64_t, int64_t> remap;
  int64_t idx = 0;
  for (int64_t k : kept_set) {
    out_kept[idx] = k;
    remap[k] = idx++;
  }
  int64_t nf = 0;
  for (int64_t i = 0; i < num_faces; ++i) {
    if (!face_alive[i]) continue;
    for (int k = 0; k < 3; ++k) out_faces[3 * nf + k] = remap[f[i][k]];
    nf++;
  }
  *out_num_faces = nf;
  return (int64_t)kept_set.size();
}

// Exact closest point on triangle (Ericson); returns barycentric weights.
static void closest_point_triangle(const Vec3 &p, const Vec3 &a, const Vec3 &b,
                                   const Vec3 &c, Vec3 *q, double w[3]) {
  Vec3 ab = b - a, ac = c - a, ap = p - a;
  double d1 = ab.dot(ap), d2 = ac.dot(ap);
  if (d1 <= 0 && d2 <= 0) { *q = a; w[0] = 1; w[1] = 0; w[2] = 0; return; }
  Vec3 bp = p - b;
  double d3 = ab.dot(bp), d4 = ac.dot(bp);
  if (d3 >= 0 && d4 <= d3) { *q = b; w[0] = 0; w[1] = 1; w[2] = 0; return; }
  double vc = d1 * d4 - d3 * d2;
  if (vc <= 0 && d1 >= 0 && d3 <= 0) {
    double t = d1 / (d1 - d3);
    *q = a + ab * t; w[0] = 1 - t; w[1] = t; w[2] = 0; return;
  }
  Vec3 cp = p - c;
  double d5 = ab.dot(cp), d6 = ac.dot(cp);
  if (d6 >= 0 && d5 <= d6) { *q = c; w[0] = 0; w[1] = 0; w[2] = 1; return; }
  double vb = d5 * d2 - d1 * d6;
  if (vb <= 0 && d2 >= 0 && d6 <= 0) {
    double t = d2 / (d2 - d6);
    *q = a + ac * t; w[0] = 1 - t; w[1] = 0; w[2] = t; return;
  }
  double va = d3 * d6 - d5 * d4;
  if (va <= 0 && (d4 - d3) >= 0 && (d5 - d6) >= 0) {
    double t = (d4 - d3) / ((d4 - d3) + (d5 - d6));
    *q = b + (c - b) * t; w[0] = 0; w[1] = 1 - t; w[2] = t; return;
  }
  double denom = 1.0 / (va + vb + vc);
  double vv = vb * denom, ww = vc * denom;
  *q = a + ab * vv + ac * ww;
  w[0] = 1 - vv - ww; w[1] = vv; w[2] = ww;
}

// Barycentric transfer: for each target vertex, find the closest point on
// the source mesh (uniform-grid candidate search over face centroids with
// ring expansion) and emit up to 3 (col, weight) pairs.
// out_cols/out_weights: [num_targets * 3]; absent entries get col = -1.
void meshops_transfer(const double *src_v, int64_t src_nv,
                      const int64_t *src_f, int64_t src_nf,
                      const double *tgt_v, int64_t tgt_nv,
                      int64_t *out_cols, double *out_weights) {
  std::vector<Vec3> sv(src_nv), centroids(src_nf);
  for (int64_t i = 0; i < src_nv; ++i)
    sv[i] = {src_v[3 * i], src_v[3 * i + 1], src_v[3 * i + 2]};
  Vec3 lo = sv.empty() ? Vec3{0, 0, 0} : sv[0], hi = lo;
  for (auto &p : sv) {
    lo = {std::min(lo.x, p.x), std::min(lo.y, p.y), std::min(lo.z, p.z)};
    hi = {std::max(hi.x, p.x), std::max(hi.y, p.y), std::max(hi.z, p.z)};
  }
  for (int64_t i = 0; i < src_nf; ++i) {
    Vec3 a = sv[src_f[3 * i]], b = sv[src_f[3 * i + 1]],
         c = sv[src_f[3 * i + 2]];
    centroids[i] = (a + b + c) * (1.0 / 3.0);
  }

  // uniform grid over centroids
  int64_t gdim = std::max<int64_t>(
      1, (int64_t)std::cbrt((double)std::max<int64_t>(src_nf, 1)));
  gdim = std::min<int64_t>(gdim, 64);
  Vec3 span = hi - lo;
  double eps = 1e-12;
  double cx = std::max(span.x, eps) / gdim, cy = std::max(span.y, eps) / gdim,
         cz = std::max(span.z, eps) / gdim;
  auto cell_of = [&](const Vec3 &p, int64_t *ix, int64_t *iy, int64_t *iz) {
    *ix = std::min<int64_t>(gdim - 1,
                            std::max<int64_t>(0, (int64_t)((p.x - lo.x) / cx)));
    *iy = std::min<int64_t>(gdim - 1,
                            std::max<int64_t>(0, (int64_t)((p.y - lo.y) / cy)));
    *iz = std::min<int64_t>(gdim - 1,
                            std::max<int64_t>(0, (int64_t)((p.z - lo.z) / cz)));
  };
  std::unordered_map<int64_t, std::vector<int64_t>> grid;
  for (int64_t i = 0; i < src_nf; ++i) {
    int64_t ix, iy, iz;
    cell_of(centroids[i], &ix, &iy, &iz);
    grid[(ix * gdim + iy) * gdim + iz].push_back(i);
  }

  for (int64_t t = 0; t < tgt_nv; ++t) {
    Vec3 p = {tgt_v[3 * t], tgt_v[3 * t + 1], tgt_v[3 * t + 2]};
    int64_t ix, iy, iz;
    cell_of(p, &ix, &iy, &iz);

    double best_d2 = 1e300, bw[3] = {1, 0, 0};
    int64_t best_face = -1;
    // expand rings until a hit is found, then one safety ring more
    for (int64_t ring = 0, found_ring = -1; ring <= gdim; ++ring) {
      if (found_ring >= 0 && ring > found_ring + 1) break;
      bool any = false;
      for (int64_t dx = -ring; dx <= ring; ++dx)
        for (int64_t dy = -ring; dy <= ring; ++dy)
          for (int64_t dz = -ring; dz <= ring; ++dz) {
            if (std::max({std::abs(dx), std::abs(dy), std::abs(dz)}) != ring)
              continue;  // shell only
            int64_t gx = ix + dx, gy = iy + dy, gz = iz + dz;
            if (gx < 0 || gy < 0 || gz < 0 || gx >= gdim || gy >= gdim ||
                gz >= gdim)
              continue;
            auto it = grid.find((gx * gdim + gy) * gdim + gz);
            if (it == grid.end()) continue;
            any = true;
            for (int64_t fi : it->second) {
              Vec3 q;
              double w[3];
              closest_point_triangle(p, sv[src_f[3 * fi]],
                                     sv[src_f[3 * fi + 1]],
                                     sv[src_f[3 * fi + 2]], &q, w);
              double d2 = (p - q).dot(p - q);
              if (d2 < best_d2 - 1e-18 ||
                  (d2 < best_d2 + 1e-18 && fi < best_face)) {
                best_d2 = d2;
                best_face = fi;
                bw[0] = w[0]; bw[1] = w[1]; bw[2] = w[2];
              }
            }
          }
      if (any && found_ring < 0) found_ring = ring;
    }

    for (int k = 0; k < 3; ++k) {
      if (best_face >= 0 && bw[k] != 0.0) {
        out_cols[3 * t + k] = src_f[3 * best_face + k];
        out_weights[3 * t + k] = bw[k];
      } else {
        out_cols[3 * t + k] = -1;
        out_weights[3 * t + k] = 0.0;
      }
    }
  }
}

// OBJ parse for the plain-triangle dialect this framework and the
// reference both emit ("v x y z" / "f a b c", positive 1-based indices) —
// the data-loader hot path. The reference's loaders are native too
// (psbody-mesh / open3d); the pure-Python
// parser costs ~15 ms per 5k-vertex mesh, which dominated the whole
// inference pipeline at 512 meshes. Single pass; numbers go through the
// exact fixed-point fast path below (strtod only on exponents/long
// mantissas — strtod itself was ~75% of the parse at ~45k tokens/mesh).
//
// Returns 0 on success (writing *nv / *nf counts), -1 if the file can't
// be read, -2 on any construct outside the dialect (texture/normal
// indices, polygons, negative indices, vertex w components) — the caller
// falls back to the general Python parser — and -3 if caller capacity is
// exceeded. Faces are written 0-based.

// Fast decimal fixed-point parse, BIT-IDENTICAL to strtod on its fast
// path: for <= 15 significant digits the mantissa is exact in uint64
// (10^15 < 2^53), 10^frac is exactly representable for frac <= 22, and
// IEEE division is correctly rounded — so mant / 10^frac IS the
// correctly-rounded double strtod would produce (the classic JSON-parser
// fast path; bit-exactness matters here because the hierarchy golden
// tests hash vertex bits). Exponents / long mantissas fall back to
// strtod. strtod itself is ~10x slower per token (locale machinery),
// and a 5k-vertex mesh is ~45k tokens.
static const double kPow10[23] = {
    1e0,  1e1,  1e2,  1e3,  1e4,  1e5,  1e6,  1e7,  1e8,  1e9,  1e10, 1e11,
    1e12, 1e13, 1e14, 1e15, 1e16, 1e17, 1e18, 1e19, 1e20, 1e21, 1e22};

static inline const char *parse_double_fast(const char *p, double *out,
                                            bool *ok) {
  while (*p == ' ' || *p == '\t') ++p;
  const char *start = p;
  bool neg = false;
  if (*p == '-' || *p == '+') {
    neg = (*p == '-');
    ++p;
  }
  uint64_t mant = 0;
  int digits = 0, frac = 0;
  while (*p >= '0' && *p <= '9') {
    mant = mant * 10 + (uint64_t)(*p - '0');
    ++digits;
    ++p;
  }
  if (*p == '.') {
    ++p;
    while (*p >= '0' && *p <= '9') {
      mant = mant * 10 + (uint64_t)(*p - '0');
      ++digits;
      ++frac;
      ++p;
    }
  }
  if (digits == 0 || digits > 15 || frac > 22 || *p == 'e' || *p == 'E') {
    char *q;
    *out = std::strtod(start, &q);
    *ok = (q != start);
    return q;
  }
  double v = (double)mant / kPow10[frac];
  *out = neg ? -v : v;
  *ok = true;
  return p;
}

int64_t meshops_obj_parse(const char *path, double *verts, int64_t v_cap,
                          int64_t *faces, int64_t f_cap, int64_t *nv,
                          int64_t *nf) {
  FILE *fp = std::fopen(path, "rb");
  if (!fp) return -1;
  std::fseek(fp, 0, SEEK_END);
  long size = std::ftell(fp);
  std::fseek(fp, 0, SEEK_SET);
  std::vector<char> buf(size + 1);
  if (size > 0 && std::fread(buf.data(), 1, size, fp) != (size_t)size) {
    std::fclose(fp);
    return -1;
  }
  std::fclose(fp);
  buf[size] = '\0';

  int64_t cv = 0, cf = 0;
  const char *p = buf.data();
  const char *end = buf.data() + size;
  while (p < end) {
    if (p[0] == 'v' && p[1] == ' ') {
      if (cv >= v_cap) return -3;
      p += 2;
      for (int k = 0; k < 3; ++k) {
        double x;
        bool ok;
        const char *q = parse_double_fast(p, &x, &ok);
        if (!ok) return -2;
        verts[3 * cv + k] = x;
        p = q;
      }
      while (p < end && (*p == ' ' || *p == '\r' || *p == '\t')) ++p;
      if (p < end && *p != '\n') return -2;  // w component etc.
      ++cv;
    } else if (p[0] == 'f' && p[1] == ' ') {
      if (cf >= f_cap) return -3;
      p += 2;
      for (int k = 0; k < 3; ++k) {
        while (*p == ' ' || *p == '\t') ++p;
        int64_t i = 0;
        int digits = 0;
        while (*p >= '0' && *p <= '9' && digits < 18) {
          i = i * 10 + (*p - '0');
          ++digits;
          ++p;
        }
        if (digits == 0 || i <= 0) return -2;  // negative/malformed index
        // >18-digit token: out of dialect, defer to the general parser
        // rather than silently splitting it into several indices.
        if (*p >= '0' && *p <= '9') return -2;
        faces[3 * cf + k] = i - 1;
        if (*p == '/') return -2;  // i/t, i//n forms
      }
      while (p < end && (*p == ' ' || *p == '\r' || *p == '\t')) ++p;
      if (p < end && *p != '\n') return -2;  // polygon (4+ indices)
      ++cf;
    }
    while (p < end && *p != '\n') ++p;  // skip comments / other directives
    ++p;
  }
  *nv = cv;
  *nf = cf;
  return 0;
}

}  // extern "C"
