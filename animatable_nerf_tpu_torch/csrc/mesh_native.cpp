// Host-side marching tetrahedra of the port's mesh extraction, and the
// z-buffered rasterizer of its mesh previews (--type raster).
//
// A copy of `marching_tets`, `mesh_native_free` and `rasterize_mesh` of
// the JAX package's animatable_nerf_tpu/csrc/mesh_native.cpp:135-278
// (the port imports nothing of that package). marching_tets: the
// isosurface {vol == level} of a
// (D, H, W) float32 grid, each cube split into 6 tetrahedra around its
// 0-7 diagonal, edge crossings interpolated in double and deduplicated
// on keys rounded to 1e-6 grid units. It replaces the reference's
// PyMCubes (lib/networks/renderer/aninerf_mesh_renderer.py:42,
// sdf_mesh_renderer.py:76). rasterize_mesh: triangles projected by a
// pinhole camera, each pixel's nearest covering triangle by a z-buffer
// and its per-vertex attributes interpolated perspective-correctly.
// Neither is a TPU kernel: they run on the host in both packages, on
// what the device's sweeps produced.
//
// Plain C ABI, bound with ctypes by animatable_nerf_tpu_torch/native.py,
// which builds it with g++ at first use (the same flags as the JAX
// package's loader, so both give the same vertices bit for bit).

#include <cstdint>
#include <cstring>
#include <cmath>
#include <unordered_map>
#include <vector>

namespace {

struct Key {
  int64_t x, y, z;
  bool operator==(const Key& o) const {
    return x == o.x && y == o.y && z == o.z;
  }
};

struct KeyHash {
  size_t operator()(const Key& k) const {
    uint64_t h = 1469598103934665603ull;
    auto mix = [&h](uint64_t v) {
      h ^= v;
      h *= 1099511628211ull;
    };
    mix((uint64_t)k.x);
    mix((uint64_t)k.y);
    mix((uint64_t)k.z);
    return (size_t)h;
  }
};

// cube corner k sits at offset (k>>2 & 1, k>>1 & 1, k & 1)
const int kCornerOff[8][3] = {
    {0, 0, 0}, {0, 0, 1}, {0, 1, 0}, {0, 1, 1},
    {1, 0, 0}, {1, 0, 1}, {1, 1, 0}, {1, 1, 1},
};

// 6 tetrahedra around the 0-7 diagonal
const int kTets[6][4] = {
    {0, 1, 3, 7}, {0, 1, 7, 5}, {0, 5, 7, 4},
    {0, 4, 7, 6}, {0, 6, 7, 2}, {0, 2, 7, 3},
};

struct MeshBuilder {
  std::vector<float> verts;
  std::vector<int64_t> faces;
  std::unordered_map<Key, int64_t, KeyHash> lookup;

  int64_t vertex(double px, double py, double pz) {
    Key k{(int64_t)llround(px * 1e6), (int64_t)llround(py * 1e6),
          (int64_t)llround(pz * 1e6)};
    auto it = lookup.find(k);
    if (it != lookup.end()) return it->second;
    int64_t id = (int64_t)(verts.size() / 3);
    verts.push_back((float)px);
    verts.push_back((float)py);
    verts.push_back((float)pz);
    lookup.emplace(k, id);
    return id;
  }

  void tri(int64_t a, int64_t b, int64_t c) {
    if (a == b || b == c || a == c) return;
    faces.push_back(a);
    faces.push_back(b);
    faces.push_back(c);
  }
};

// edge crossing between tet vertices a (inside) and b (outside)
inline void cross_point(const double* pos, const double* val, int a, int b,
                        double level, double* out) {
  double t = (level - val[a]) / (val[b] - val[a]);
  for (int i = 0; i < 3; i++)
    out[i] = pos[a * 3 + i] + t * (pos[b * 3 + i] - pos[a * 3 + i]);
}

void emit_tet(MeshBuilder& mb, const double* pos, const double* val,
              double level) {
  int inside[4], outside[4], ni = 0, no = 0;
  for (int i = 0; i < 4; i++) {
    if (val[i] > level)
      inside[ni++] = i;
    else
      outside[no++] = i;
  }
  if (ni == 0 || ni == 4) return;
  double p[4][3];
  if (ni == 1) {
    // triangle: edges (a, o0), (a, o1), (a, o2)
    for (int j = 0; j < 3; j++)
      cross_point(pos, val, inside[0], outside[j], level, p[j]);
    mb.tri(mb.vertex(p[0][0], p[0][1], p[0][2]),
           mb.vertex(p[1][0], p[1][1], p[1][2]),
           mb.vertex(p[2][0], p[2][1], p[2][2]));
  } else if (ni == 3) {
    // triangle: edges (i0, a), (i2, a), (i1, a), wound as the JAX package's
    for (int j = 0; j < 3; j++)
      cross_point(pos, val, inside[j], outside[0], level, p[j]);
    mb.tri(mb.vertex(p[0][0], p[0][1], p[0][2]),
           mb.vertex(p[2][0], p[2][1], p[2][2]),
           mb.vertex(p[1][0], p[1][1], p[1][2]));
  } else {
    // quad from edges (i0,o0), (i0,o1), (i1,o0), (i1,o1) -> 2 tris
    double e00[3], e01[3], e10[3], e11[3];
    cross_point(pos, val, inside[0], outside[0], level, e00);
    cross_point(pos, val, inside[0], outside[1], level, e01);
    cross_point(pos, val, inside[1], outside[0], level, e10);
    cross_point(pos, val, inside[1], outside[1], level, e11);
    int64_t v00 = mb.vertex(e00[0], e00[1], e00[2]);
    int64_t v01 = mb.vertex(e01[0], e01[1], e01[2]);
    int64_t v10 = mb.vertex(e10[0], e10[1], e10[2]);
    int64_t v11 = mb.vertex(e11[0], e11[1], e11[2]);
    mb.tri(v00, v01, v11);
    mb.tri(v00, v11, v10);
  }
}

}  // namespace

extern "C" {

// Extract {vol == level}; vol is (D, H, W) row-major float32.
// Returns 0 on success. Caller frees out_verts/out_faces with
// mesh_native_free.
int marching_tets(const float* vol, int D, int H, int W, float level,
                  const float* spacing, const float* origin,
                  float** out_verts, int64_t** out_faces,
                  int64_t* n_verts, int64_t* n_faces) {
  if (D < 2 || H < 2 || W < 2) {
    *out_verts = nullptr;
    *out_faces = nullptr;
    *n_verts = 0;
    *n_faces = 0;
    return 0;
  }
  MeshBuilder mb;
  const int64_t sD = (int64_t)H * W, sH = W;
  for (int x = 0; x < D - 1; x++) {
    for (int y = 0; y < H - 1; y++) {
      for (int z = 0; z < W - 1; z++) {
        double cv[8];
        bool any_in = false, all_in = true;
        for (int k = 0; k < 8; k++) {
          cv[k] = vol[(x + kCornerOff[k][0]) * sD +
                      (y + kCornerOff[k][1]) * sH + (z + kCornerOff[k][2])];
          bool in = cv[k] > level;
          any_in |= in;
          all_in &= in;
        }
        if (!any_in || all_in) continue;
        for (int t = 0; t < 6; t++) {
          double pos[12], val[4];
          for (int v = 0; v < 4; v++) {
            int c = kTets[t][v];
            pos[v * 3 + 0] = x + kCornerOff[c][0];
            pos[v * 3 + 1] = y + kCornerOff[c][1];
            pos[v * 3 + 2] = z + kCornerOff[c][2];
            val[v] = cv[c];
          }
          emit_tet(mb, pos, val, level);
        }
      }
    }
  }
  int64_t nv = (int64_t)(mb.verts.size() / 3);
  int64_t nf = (int64_t)(mb.faces.size() / 3);
  float* vbuf = nullptr;
  int64_t* fbuf = nullptr;
  if (nv > 0) {
    vbuf = new float[nv * 3];
    for (int64_t i = 0; i < nv; i++)
      for (int j = 0; j < 3; j++)
        vbuf[i * 3 + j] =
            mb.verts[i * 3 + j] * spacing[j] + origin[j];
  }
  if (nf > 0) {
    fbuf = new int64_t[nf * 3];
    memcpy(fbuf, mb.faces.data(), sizeof(int64_t) * nf * 3);
  }
  *out_verts = vbuf;
  *out_faces = fbuf;
  *n_verts = nv;
  *n_faces = nf;
  return 0;
}

void mesh_native_free(void* p) { delete[] (char*)p; }

// Z-buffered triangle rasterization with per-vertex attribute
// interpolation. verts are world-space; K
// (3x3 row-major), R (3x3), T (3) map world->camera; attrs has C
// channels per vertex; out_attr is (H, W, C) zero-filled where no
// triangle covers the pixel; out_depth is written only where one does
// (the caller zero-fills it); out_mask 0/1.
void rasterize_mesh(const float* verts, int64_t n_verts,
                    const int64_t* faces, int64_t n_faces,
                    const float* attrs, int n_channels,
                    const float* K, const float* R, const float* T,
                    int H, int W,
                    float* out_attr, float* out_depth,
                    uint8_t* out_mask) {
  const int64_t npix = (int64_t)H * W;
  memset(out_attr, 0, sizeof(float) * npix * n_channels);
  memset(out_mask, 0, npix);
  std::vector<float> zbuf(npix, 3.0e38f);
  std::vector<float> sx(n_verts), sy(n_verts), sz(n_verts);
  for (int64_t v = 0; v < n_verts; v++) {
    const float* p = verts + v * 3;
    float cx = R[0] * p[0] + R[1] * p[1] + R[2] * p[2] + T[0];
    float cy = R[3] * p[0] + R[4] * p[1] + R[5] * p[2] + T[1];
    float cz = R[6] * p[0] + R[7] * p[1] + R[8] * p[2] + T[2];
    float u = K[0] * cx + K[1] * cy + K[2] * cz;
    float w = K[3] * cx + K[4] * cy + K[5] * cz;
    float d = K[6] * cx + K[7] * cy + K[8] * cz;
    sz[v] = d;
    sx[v] = (d > 1e-8f) ? u / d : -1e9f;
    sy[v] = (d > 1e-8f) ? w / d : -1e9f;
  }
  for (int64_t f = 0; f < n_faces; f++) {
    int64_t a = faces[f * 3], b = faces[f * 3 + 1], c = faces[f * 3 + 2];
    if (sz[a] <= 1e-8f || sz[b] <= 1e-8f || sz[c] <= 1e-8f) continue;
    float x0 = sx[a], y0 = sy[a], x1 = sx[b], y1 = sy[b],
          x2 = sx[c], y2 = sy[c];
    float area = (x1 - x0) * (y2 - y0) - (x2 - x0) * (y1 - y0);
    if (area == 0.0f) continue;
    int xmin = (int)floorf(fminf(fminf(x0, x1), x2));
    int xmax = (int)ceilf(fmaxf(fmaxf(x0, x1), x2));
    int ymin = (int)floorf(fminf(fminf(y0, y1), y2));
    int ymax = (int)ceilf(fmaxf(fmaxf(y0, y1), y2));
    xmin = xmin < 0 ? 0 : xmin;
    ymin = ymin < 0 ? 0 : ymin;
    xmax = xmax >= W ? W - 1 : xmax;
    ymax = ymax >= H ? H - 1 : ymax;
    float inv_area = 1.0f / area;
    for (int y = ymin; y <= ymax; y++) {
      for (int x = xmin; x <= xmax; x++) {
        float px = (float)x, py = (float)y;
        float w0 = ((x1 - px) * (y2 - py) - (x2 - px) * (y1 - py)) * inv_area;
        float w1 = ((x2 - px) * (y0 - py) - (x0 - px) * (y2 - py)) * inv_area;
        float w2 = 1.0f - w0 - w1;
        if (w0 < 0 || w1 < 0 || w2 < 0) continue;
        // perspective-correct interpolation
        float iz = w0 / sz[a] + w1 / sz[b] + w2 / sz[c];
        float z = 1.0f / iz;
        int64_t pix = (int64_t)y * W + x;
        if (z >= zbuf[pix]) continue;
        zbuf[pix] = z;
        out_depth[pix] = z;
        out_mask[pix] = 1;
        for (int ch = 0; ch < n_channels; ch++) {
          float va = attrs[a * n_channels + ch];
          float vb = attrs[b * n_channels + ch];
          float vc = attrs[c * n_channels + ch];
          out_attr[pix * n_channels + ch] =
              z * (w0 * va / sz[a] + w1 * vb / sz[b] + w2 * vc / sz[c]);
        }
      }
    }
  }
}

}  // extern "C"
