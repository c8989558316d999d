// Native host runtime for pupiloptixlab_tpu.
//
// The reference's host runtime is C++ (scene load via assimp,
// resource/shape.cpp:219-278; GAS builds in world/gas_manager.cpp).
// The TPU build keeps the COMPUTE path in JAX/Pallas and moves the two
// heaviest host-side steps here, behind ctypes (pupiloptixlab_tpu/
// native.py) with a numpy fallback:
//
//   * build_bvh8 — the 8-wide binned-SAH BVH builder (the GAS-build
//     analog). Semantics mirror accel/bvh.py exactly: 16-bin SAH over
//     the widest-extent candidates, three collapsed binary levels per
//     8-ary node, children sorted along the dominant axis, TCL-aligned
//     contiguous leaves, never-hit point boxes at 1e30 for empty slots
//     and all-padding leaves.
//   * parse_obj — a fan-triangulating OBJ reader with corner dedupe
//     (v/vt/vn indices), byte-compatible with scene/shapes.py:load_obj.
//
// Build: see native/build.sh (g++ -O2 -shared -fPIC).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <limits>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

constexpr float kNever = 1e30f;
constexpr int kBins = 16;

struct V3 {
  float x, y, z;
};

inline V3 vmin(const V3 &a, const V3 &b) {
  return {std::min(a.x, b.x), std::min(a.y, b.y), std::min(a.z, b.z)};
}
inline V3 vmax(const V3 &a, const V3 &b) {
  return {std::max(a.x, b.x), std::max(a.y, b.y), std::max(a.z, b.z)};
}
inline float area(const V3 &lo, const V3 &hi) {
  float dx = std::max(hi.x - lo.x, 0.f);
  float dy = std::max(hi.y - lo.y, 0.f);
  float dz = std::max(hi.z - lo.z, 0.f);
  return dx * dy + dy * dz + dx * dz;
}
inline float comp(const V3 &v, int ax) { return ax == 0 ? v.x : ax == 1 ? v.y : v.z; }

struct Builder {
  int t_pad, valid, tcl;
  const float *lo;   // (T,3) per-tri box min (padding at +1e30)
  const float *hi;   // (T,3) per-tri box max (padding at -1e30)
  std::vector<V3> centroid;
  int64_t *order;
  std::vector<int32_t> child;   // 8 per node
  std::vector<int32_t> axis;    // per node
  std::vector<float> boxes;     // 8*8 per node

  V3 tri_lo(int64_t r) const { return {lo[r * 3], lo[r * 3 + 1], lo[r * 3 + 2]}; }
  V3 tri_hi(int64_t r) const { return {hi[r * 3], hi[r * 3 + 1], hi[r * 3 + 2]}; }

  // binned-SAH partition of order[a:b) at a TCL-aligned cut
  // returns (mid, axis)
  std::pair<int, int> sah_split(int a, int b) {
    V3 cmin = {kNever, kNever, kNever}, cmax = {-kNever, -kNever, -kNever};
    for (int i = a; i < b; ++i) {
      cmin = vmin(cmin, centroid[order[i]]);
      cmax = vmax(cmax, centroid[order[i]]);
    }
    V3 ext = {cmax.x - cmin.x, cmax.y - cmin.y, cmax.z - cmin.z};
    int n_leaves = (b - a) / tcl;
    double best_cost = std::numeric_limits<double>::infinity();
    int best_axis = -1, best_nleft = 0;
    for (int ax = 0; ax < 3; ++ax) {
      float e = comp(ext, ax);
      if (e < 1e-12f) continue;
      int counts[kBins] = {0};
      V3 blo[kBins], bhi[kBins];
      for (int k = 0; k < kBins; ++k) {
        blo[k] = {kNever, kNever, kNever};
        bhi[k] = {-kNever, -kNever, -kNever};
      }
      for (int i = a; i < b; ++i) {
        int64_t r = order[i];
        int bin = (int)((comp(centroid[r], ax) - comp(cmin, ax)) / e * kBins);
        bin = std::min(std::max(bin, 0), kBins - 1);
        counts[bin]++;
        blo[bin] = vmin(blo[bin], tri_lo(r));
        bhi[bin] = vmax(bhi[bin], tri_hi(r));
      }
      // prefix/suffix
      V3 plo[kBins], phi[kBins], slo[kBins], shi[kBins];
      plo[0] = blo[0]; phi[0] = bhi[0];
      for (int k = 1; k < kBins; ++k) {
        plo[k] = vmin(plo[k - 1], blo[k]);
        phi[k] = vmax(phi[k - 1], bhi[k]);
      }
      slo[kBins - 1] = blo[kBins - 1]; shi[kBins - 1] = bhi[kBins - 1];
      for (int k = kBins - 2; k >= 0; --k) {
        slo[k] = vmin(slo[k + 1], blo[k]);
        shi[k] = vmax(shi[k + 1], bhi[k]);
      }
      int nl = 0;
      for (int k = 0; k < kBins - 1; ++k) {
        nl += counts[k];
        int nr = (b - a) - nl;
        if (nl == 0 || nr == 0) continue;
        double cost = (double)area(plo[k], phi[k]) * nl +
                      (double)area(slo[k + 1], shi[k + 1]) * nr;
        if (cost < best_cost) {
          // align the cut to whole leaves (round like python)
          int n_left = (int)std::lround((double)nl / tcl) * tcl;
          n_left = std::min(std::max(n_left, tcl), (n_leaves - 1) * tcl);
          best_cost = cost;
          best_axis = ax;
          best_nleft = n_left;
        }
      }
    }
    if (best_axis < 0) {  // degenerate: median on widest axis
      best_axis = ext.x >= ext.y && ext.x >= ext.z ? 0 : (ext.y >= ext.z ? 1 : 2);
      best_nleft = (n_leaves / 2) * tcl;
    }
    int ax = best_axis;
    std::nth_element(order + a, order + a + best_nleft - 1, order + b,
                     [&](int64_t i, int64_t j) {
                       return comp(centroid[i], ax) < comp(centroid[j], ax);
                     });
    return {a + best_nleft, best_axis};
  }

  struct Entry {
    int32_t id;
    V3 blo, bhi;
    float key;
  };

  // returns (node_id, box_lo, box_hi)
  int make_node(int lo_r, int hi_r, V3 *out_lo, V3 *out_hi) {
    int nid = (int)axis.size();
    for (int k = 0; k < 8; ++k) child.push_back(0);
    axis.push_back(0);
    boxes.resize(boxes.size() + 64, 0.f);

    // collapse 3 binary split levels into <= 8 subranges
    std::pair<int, int> ranges[8];
    int n_ranges = 1;
    ranges[0] = {lo_r, hi_r};
    int first_axis = -1;
    for (int level = 0; level < 3; ++level) {
      std::pair<int, int> next[8];
      int n_next = 0;
      for (int i = 0; i < n_ranges; ++i) {
        auto [a, b] = ranges[i];
        if (b - a <= tcl) {
          next[n_next++] = {a, b};
          continue;
        }
        auto [mid, ax] = sah_split(a, b);
        if (first_axis < 0) first_axis = ax;
        next[n_next++] = {a, mid};
        next[n_next++] = {mid, b};
      }
      n_ranges = n_next;
      std::copy(next, next + n_next, ranges);
    }

    int ax = first_axis < 0 ? 0 : first_axis;
    Entry entries[8];
    int n_entries = 0;
    for (int i = 0; i < n_ranges; ++i) {
      auto [a, b] = ranges[i];
      Entry e;
      if (b - a <= tcl) {
        V3 blo = {kNever, kNever, kNever}, bhi = {-kNever, -kNever, -kNever};
        for (int r = a; r < b; ++r) {
          blo = vmin(blo, tri_lo(order[r]));
          bhi = vmax(bhi, tri_hi(order[r]));
        }
        if (blo.x > bhi.x) {  // all-padding leaf -> never visit
          blo = {kNever, kNever, kNever};
          bhi = {kNever, kNever, kNever};
        }
        e = {(int32_t)(-(a + 1)), blo, bhi, 0.f};
      } else {
        V3 blo, bhi;
        int cid = make_node(a, b, &blo, &bhi);
        e = {(int32_t)cid, blo, bhi, 0.f};
      }
      e.key = 0.5f * (comp(e.blo, ax) + comp(e.bhi, ax));
      entries[n_entries++] = e;
    }
    std::stable_sort(entries, entries + n_entries,
                     [](const Entry &a, const Entry &b) { return a.key < b.key; });

    V3 total_lo = {kNever, kNever, kNever}, total_hi = {-kNever, -kNever, -kNever};
    float *box = &boxes[(size_t)nid * 64];
    for (int k = 0; k < 8; ++k) {
      if (k < n_entries) {
        const Entry &e = entries[k];
        child[(size_t)nid * 8 + k] = e.id;
        box[k * 8 + 0] = e.blo.x; box[k * 8 + 1] = e.blo.y; box[k * 8 + 2] = e.blo.z;
        box[k * 8 + 3] = e.bhi.x; box[k * 8 + 4] = e.bhi.y; box[k * 8 + 5] = e.bhi.z;
        if (e.bhi.x < kNever) {
          total_lo = vmin(total_lo, e.blo);
          total_hi = vmax(total_hi, e.bhi);
        }
      } else {
        box[k * 8 + 0] = box[k * 8 + 1] = box[k * 8 + 2] = kNever;
        box[k * 8 + 3] = box[k * 8 + 4] = box[k * 8 + 5] = kNever;
      }
    }
    if (total_lo.x > total_hi.x) {
      total_lo = {kNever, kNever, kNever};
      total_hi = {kNever, kNever, kNever};
    }
    axis[nid] = ax;
    *out_lo = total_lo;
    *out_hi = total_hi;
    return nid;
  }
};

}  // namespace

extern "C" {

// Returns the node count, or -1 on error. Caller allocates:
//   order:   int64[t_pad]        (output permutation)
//   child:   int32[max_nodes*8]
//   axis:    int32[max_nodes]
//   boxes:   float[max_nodes*64]
// with max_nodes >= t_pad/tcl + 8.
int pupil_build_bvh8(const float *p0, const float *p1, const float *p2,
                     int t_pad, int valid_count, int tcl, int max_nodes,
                     int64_t *order, int32_t *child, int32_t *axis,
                     float *boxes) {
  if (t_pad <= tcl || t_pad % tcl != 0) return -1;
  Builder b;
  b.t_pad = t_pad;
  b.valid = valid_count;
  b.tcl = tcl;
  std::vector<float> lo((size_t)t_pad * 3), hi((size_t)t_pad * 3);
  b.centroid.resize(t_pad);
  V3 anchor = {0, 0, 0};
  for (int r = 0; r < t_pad; ++r) {
    for (int c = 0; c < 3; ++c) {
      float a = p0[r * 3 + c], bb = p1[r * 3 + c], cc = p2[r * 3 + c];
      lo[r * 3 + c] = std::min(std::min(a, bb), cc);
      hi[r * 3 + c] = std::max(std::max(a, bb), cc);
    }
    if (r < valid_count) {
      b.centroid[r] = {0.5f * (lo[r * 3] + hi[r * 3]),
                       0.5f * (lo[r * 3 + 1] + hi[r * 3 + 1]),
                       0.5f * (lo[r * 3 + 2] + hi[r * 3 + 2])};
      if (r == valid_count - 1) anchor = b.centroid[r];
    }
  }
  for (int r = valid_count; r < t_pad; ++r) {
    // padding: inverted per-tri boxes + clustered centroids (bvh.py)
    lo[r * 3] = lo[r * 3 + 1] = lo[r * 3 + 2] = kNever;
    hi[r * 3] = hi[r * 3 + 1] = hi[r * 3 + 2] = -kNever;
    b.centroid[r] = anchor;
  }
  b.lo = lo.data();
  b.hi = hi.data();
  b.order = order;
  for (int r = 0; r < t_pad; ++r) order[r] = r;
  b.child.reserve((size_t)max_nodes * 8);
  b.axis.reserve(max_nodes);
  b.boxes.reserve((size_t)max_nodes * 64);

  V3 tl, th;
  b.make_node(0, t_pad, &tl, &th);
  int m = (int)b.axis.size();
  if (m > max_nodes) return -1;
  std::memcpy(child, b.child.data(), (size_t)m * 8 * sizeof(int32_t));
  std::memcpy(axis, b.axis.data(), (size_t)m * sizeof(int32_t));
  std::memcpy(boxes, b.boxes.data(), (size_t)m * 64 * sizeof(float));
  return m;
}

// --- OBJ parser ------------------------------------------------------------
// Two-phase API: pupil_parse_obj fills internal buffers and returns
// counts; pupil_obj_fetch copies them out and frees the state.

struct ObjState {
  std::vector<float> pos, uv, nrm;
  std::vector<uint32_t> idx;
  bool has_uv = false, has_n = false;
};

static thread_local ObjState *g_obj = nullptr;

int pupil_parse_obj(const char *path, int64_t *out_counts) {
  FILE *f = std::fopen(path, "rb");
  if (!f) return -1;
  std::vector<float> vs, vts, vns;
  delete g_obj;
  g_obj = new ObjState();
  ObjState &o = *g_obj;
  std::unordered_map<uint64_t, uint32_t> corner_map;
  corner_map.reserve(1 << 16);

  char line[4096];
  auto resolve = [](long v, size_t n) -> long {
    return v > 0 ? v - 1 : (v == 0 ? -1 : (long)n + v);
  };
  while (std::fgets(line, sizeof line, f)) {
    if (line[0] == 'v' && line[1] == ' ') {
      float x, y, z;
      if (std::sscanf(line + 2, "%f %f %f", &x, &y, &z) == 3) {
        vs.push_back(x); vs.push_back(y); vs.push_back(z);
      }
    } else if (line[0] == 'v' && line[1] == 't') {
      float u = 0, v = 0;
      std::sscanf(line + 3, "%f %f", &u, &v);
      vts.push_back(u); vts.push_back(v);
    } else if (line[0] == 'v' && line[1] == 'n') {
      float x, y, z;
      if (std::sscanf(line + 3, "%f %f %f", &x, &y, &z) == 3) {
        vns.push_back(x); vns.push_back(y); vns.push_back(z);
      }
    } else if (line[0] == 'f' && line[1] == ' ') {
      uint32_t face[64];
      int nf = 0;
      char *p = line + 2;
      while (*p && nf < 64) {
        while (*p == ' ' || *p == '\t') ++p;
        if (*p == '\n' || *p == '\r' || *p == 0) break;
        long vi = std::strtol(p, &p, 10), ti = 0, ni = 0;
        if (*p == '/') {
          ++p;
          if (*p != '/') ti = std::strtol(p, &p, 10);
          if (*p == '/') { ++p; ni = std::strtol(p, &p, 10); }
        }
        long rv = resolve(vi, vs.size() / 3);
        long rt = resolve(ti, vts.size() / 2);
        long rn = resolve(ni, vns.size() / 3);
        uint64_t key = ((uint64_t)(rv + 1) << 42) ^ ((uint64_t)(rt + 1) << 21) ^
                       (uint64_t)(rn + 1);
        auto it = corner_map.find(key);
        uint32_t id;
        if (it != corner_map.end()) {
          id = it->second;
        } else {
          id = (uint32_t)(o.pos.size() / 3);
          corner_map.emplace(key, id);
          o.pos.push_back(vs[rv * 3]); o.pos.push_back(vs[rv * 3 + 1]);
          o.pos.push_back(vs[rv * 3 + 2]);
          if (rt >= 0) { o.has_uv = true; o.uv.push_back(vts[rt * 2]); o.uv.push_back(vts[rt * 2 + 1]); }
          else { o.uv.push_back(0); o.uv.push_back(0); }
          if (rn >= 0) { o.has_n = true; o.nrm.push_back(vns[rn * 3]); o.nrm.push_back(vns[rn * 3 + 1]); o.nrm.push_back(vns[rn * 3 + 2]); }
          else { o.nrm.push_back(0); o.nrm.push_back(0); o.nrm.push_back(0); }
        }
        face[nf++] = id;
      }
      for (int k = 1; k + 1 < nf; ++k) {
        o.idx.push_back(face[0]); o.idx.push_back(face[k]); o.idx.push_back(face[k + 1]);
      }
    }
  }
  std::fclose(f);
  out_counts[0] = (int64_t)(o.pos.size() / 3);
  out_counts[1] = (int64_t)(o.idx.size() / 3);
  out_counts[2] = o.has_uv ? 1 : 0;
  out_counts[3] = o.has_n ? 1 : 0;
  return 0;
}

int pupil_obj_fetch(float *pos, float *uv, float *nrm, uint32_t *idx) {
  if (!g_obj) return -1;
  ObjState &o = *g_obj;
  std::memcpy(pos, o.pos.data(), o.pos.size() * sizeof(float));
  std::memcpy(uv, o.uv.data(), o.uv.size() * sizeof(float));
  std::memcpy(nrm, o.nrm.data(), o.nrm.size() * sizeof(float));
  std::memcpy(idx, o.idx.data(), o.idx.size() * sizeof(uint32_t));
  delete g_obj;
  g_obj = nullptr;
  return 0;
}

}  // extern "C"
