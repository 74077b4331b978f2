// Iso-surface extraction over a dense scalar grid — host-side native
// component of the PyTorch port (C ABI for ctypes).  The port's own copy of
// factored_neus_tpu/native/marching_cubes.cpp: the same source, built into
// the port's own library (factored_neus_tpu_torch/native/__init__.py).
//
// Role parity: the reference uses PyMCubes' compiled extension
// (ref:models/renderer.py:6,35 `mcubes.marching_cubes(u, threshold)`).  We
// extract with *marching tetrahedra* (each cell split into 6 tets): the case
// logic is derivable from first principles (no 256-entry tables to get
// wrong), the mesh is watertight by construction, and at the 512^3
// resolutions used for DTU eval the chamfer difference vs classic MC is far
// below measurement noise.  Vertices are emitted in grid-index coordinates;
// the caller rescales to the bounding box exactly like the reference
// (ref:models/renderer.py:36-39).
//
// Conventions: grid indexed [x][y][z] C-order (z fastest); surface at
// grid == iso; triangles wound so normals point toward *larger* field values
// (the caller passes -sdf, so normals point outside).
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <cmath>
#include <unordered_map>
#include <vector>

namespace {

struct V3 { double x, y, z; };

// The 6-tetrahedra decomposition of the unit cube around the main diagonal
// (corners numbered by bit pattern x|y<<1|z<<2).  Every tet contains the
// diagonal 0 -> 7, which makes neighboring cells agree on shared faces.
static const int kTets[6][4] = {
    {0, 1, 3, 7}, {0, 3, 2, 7}, {0, 2, 6, 7},
    {0, 6, 4, 7}, {0, 4, 5, 7}, {0, 5, 1, 7},
};

static const int kCorner[8][3] = {
    {0, 0, 0}, {1, 0, 0}, {0, 1, 0}, {1, 1, 0},
    {0, 0, 1}, {1, 0, 1}, {0, 1, 1}, {1, 1, 1},
};

struct MeshBuilder {
  std::vector<float> verts;
  std::vector<int32_t> tris;
  std::unordered_map<uint64_t, int32_t> edge_cache;
  int64_t ny, nz;
  const float* grid;
  float iso;

  inline float value(int64_t x, int64_t y, int64_t z) const {
    return grid[(x * ny + y) * nz + z];
  }

  // deduplicated vertex on the global grid edge (ca, cb)
  int32_t edge_vertex(int64_t cx, int64_t cy, int64_t cz, int ca, int cb) {
    int64_t ax = cx + kCorner[ca][0], ay = cy + kCorner[ca][1],
            az = cz + kCorner[ca][2];
    int64_t bx = cx + kCorner[cb][0], by = cy + kCorner[cb][1],
            bz = cz + kCorner[cb][2];
    // order-independent exact key over the two packed corner ids (each
    // < (nx+1)(ny+1)(nz+1) <= 2^32 for grids up to ~1600^3)
    uint64_t ka = (uint64_t)((ax * (ny + 1) + ay) * (nz + 1) + az);
    uint64_t kb = (uint64_t)((bx * (ny + 1) + by) * (nz + 1) + bz);
    if (ka > kb) std::swap(ka, kb);
    uint64_t key = (ka << 32) | kb;
    auto it = edge_cache.find(key);
    if (it != edge_cache.end()) return it->second;

    float va = value(ax, ay, az), vb = value(bx, by, bz);
    double denom = (double)vb - (double)va;
    double t = std::fabs(denom) < 1e-12 ? 0.5 : ((double)iso - va) / denom;
    if (t < 0.0) t = 0.0;
    if (t > 1.0) t = 1.0;
    int32_t vid = (int32_t)(verts.size() / 3);
    verts.push_back((float)(ax + t * (bx - ax)));
    verts.push_back((float)(ay + t * (by - ay)));
    verts.push_back((float)(az + t * (bz - az)));
    edge_cache.emplace(key, vid);
    return vid;
  }

  // Emit with robust orientation: wind so the triangle normal points TOWARD
  // the below-iso side of this tet (centroid `cin` of its <iso corners).
  // The caller feeds -sdf, so below-iso == outside the object and this makes
  // normals outward.  Removes any dependence on per-case winding choices.
  inline void emit(int32_t a, int32_t b, int32_t c, const V3& cin) {
    if (a == b || b == c || a == c) return;  // degenerate (t clamped)
    const float* pa = &verts[3 * a];
    const float* pb = &verts[3 * b];
    const float* pc = &verts[3 * c];
    double ux = pb[0] - pa[0], uy = pb[1] - pa[1], uz = pb[2] - pa[2];
    double vx = pc[0] - pa[0], vy = pc[1] - pa[1], vz = pc[2] - pa[2];
    double nx = uy * vz - uz * vy, ny_ = uz * vx - ux * vz,
           nz_ = ux * vy - uy * vx;
    double gx = cin.x - (pa[0] + pb[0] + pc[0]) / 3.0;
    double gy = cin.y - (pa[1] + pb[1] + pc[1]) / 3.0;
    double gz = cin.z - (pa[2] + pb[2] + pc[2]) / 3.0;
    if (nx * gx + ny_ * gy + nz_ * gz < 0.0) std::swap(b, c);
    tris.push_back(a);
    tris.push_back(b);
    tris.push_back(c);
  }

  // one tetrahedron: corners t[0..3] (cube-corner ids), inside = value < iso
  void do_tet(int64_t cx, int64_t cy, int64_t cz, const int* t) {
    float v[4];
    int mask = 0;
    for (int i = 0; i < 4; ++i) {
      const int* c = kCorner[t[i]];
      v[i] = value(cx + c[0], cy + c[1], cz + c[2]);
      if (v[i] < iso) mask |= 1 << i;
    }
    if (mask == 0 || mask == 15) return;

    // centroid of the below-iso corners (orientation anchor for emit)
    V3 cin = {0, 0, 0};
    int n_in = 0;
    for (int i = 0; i < 4; ++i) {
      if (mask & (1 << i)) {
        const int* c = kCorner[t[i]];
        cin.x += (double)(cx + c[0]);
        cin.y += (double)(cy + c[1]);
        cin.z += (double)(cz + c[2]);
        ++n_in;
      }
    }
    cin.x /= n_in; cin.y /= n_in; cin.z /= n_in;

    // helper: vertex on edge between tet corners i and j
    auto ev = [&](int i, int j) {
      return edge_vertex(cx, cy, cz, t[i], t[j]);
    };

    // Enumerate the 14 non-trivial sign cases.  Winding: triangles face the
    // >= iso side.  For a single inside corner k the triangle spans its three
    // edges; parity of the permutation fixes orientation.
    switch (mask) {
      case 1:  emit(ev(0, 1), ev(0, 2), ev(0, 3), cin); break;
      case 2:  emit(ev(1, 0), ev(1, 3), ev(1, 2), cin); break;
      case 4:  emit(ev(2, 0), ev(2, 1), ev(2, 3), cin); break;
      case 8:  emit(ev(3, 0), ev(3, 2), ev(3, 1), cin); break;
      case 14: emit(ev(0, 1), ev(0, 3), ev(0, 2), cin); break;  // ~1
      case 13: emit(ev(1, 0), ev(1, 2), ev(1, 3), cin); break;  // ~2
      case 11: emit(ev(2, 0), ev(2, 3), ev(2, 1), cin); break;  // ~4
      case 7:  emit(ev(3, 0), ev(3, 1), ev(3, 2), cin); break;  // ~8
      case 3:   // corners 0,1 inside -> quad over edges (0-2,0-3,1-2,1-3)
        emit(ev(0, 2), ev(1, 3), ev(1, 2), cin);
        emit(ev(0, 2), ev(0, 3), ev(1, 3), cin);
        break;
      case 12:  // complement of 3
        emit(ev(0, 2), ev(1, 2), ev(1, 3), cin);
        emit(ev(0, 2), ev(1, 3), ev(0, 3), cin);
        break;
      case 5:   // corners 0,2 inside
        emit(ev(0, 1), ev(2, 3), ev(2, 1), cin);
        emit(ev(0, 1), ev(0, 3), ev(2, 3), cin);
        break;
      case 10:  // complement of 5
        emit(ev(0, 1), ev(2, 1), ev(2, 3), cin);
        emit(ev(0, 1), ev(2, 3), ev(0, 3), cin);
        break;
      case 6:   // corners 1,2 inside
        emit(ev(1, 0), ev(2, 3), ev(1, 3), cin);
        emit(ev(1, 0), ev(2, 0), ev(2, 3), cin);
        break;
      case 9:   // complement of 6
        emit(ev(1, 0), ev(1, 3), ev(2, 3), cin);
        emit(ev(1, 0), ev(2, 3), ev(2, 0), cin);
        break;
    }
  }
};

}  // namespace

extern "C" {

int marching_cubes(const float* grid, int64_t nx, int64_t ny, int64_t nz,
                   float iso,
                   float** out_verts, int64_t* out_n_verts,
                   int32_t** out_tris, int64_t* out_n_tris) {
  MeshBuilder mb;
  mb.ny = ny;
  mb.nz = nz;
  mb.grid = grid;
  mb.iso = iso;
  mb.verts.reserve(1 << 16);
  mb.tris.reserve(1 << 16);

  for (int64_t x = 0; x + 1 < nx; ++x)
    for (int64_t y = 0; y + 1 < ny; ++y)
      for (int64_t z = 0; z + 1 < nz; ++z)
        for (int ti = 0; ti < 6; ++ti) mb.do_tet(x, y, z, kTets[ti]);

  *out_n_verts = (int64_t)(mb.verts.size() / 3);
  *out_n_tris = (int64_t)(mb.tris.size() / 3);
  float* vb = (float*)std::malloc(
      (mb.verts.empty() ? 1 : mb.verts.size()) * sizeof(float));
  int32_t* tb = (int32_t*)std::malloc(
      (mb.tris.empty() ? 1 : mb.tris.size()) * sizeof(int32_t));
  if (!vb || !tb) return 1;
  std::memcpy(vb, mb.verts.data(), mb.verts.size() * sizeof(float));
  std::memcpy(tb, mb.tris.data(), mb.tris.size() * sizeof(int32_t));
  *out_verts = vb;
  *out_tris = tb;
  return 0;
}

void mc_free(void* p) { std::free(p); }

}  // extern "C"
