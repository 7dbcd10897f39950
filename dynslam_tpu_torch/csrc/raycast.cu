// Full-frame TSDF raycast (CUDA, sm_90a): a candidate pre-pass and the
// ray march.
//
// Replaces the Pallas kernel dynslam_tpu/ops/pallas_raycast.py::
// raycast_tiled (kernel body _kernel_factory, candidate lists from the
// XLA-side build_candidates). Its plain PyTorch twins are
// dynslam_tpu_torch/ops/raycast.py::candidate_bits_ref (the pre-pass) and
// raycast_ref (the march), which implement the same rule step for step.
//
// Rule, per pixel ray (z-normalised direction, so t is z-depth):
//   * only "candidate" block cells count: visible, holding a stored
//     negative voxel, and in depth range; every other voxel reads sdf = +1;
//   * the march starts at the first candidate block at or after
//     t_min = 0.6 min_depth and is capped at t_cap = 1.05 max_depth + 2 dt;
//   * inside a candidate block it sphere-steps by max(0.9 mu sdf, dt),
//     dt = 2.5 voxel; where the next position is not covered it leaps to
//     the next candidate block's entry minus dt/4 (at least t + dt/2),
//     found by a 3-D DDA over the local grid's block cells;
//   * the first +->- crossing wins, linearly interpolated against the
//     previous sample (clamped to 1.5 dt back), then polished by one
//     Newton step clipped to +-2.5 voxels;
//   * colour and weight are read at the hit, falling back to the
//     crossing sample and then to one dt in front of it.
//
// What bounds it on this card: its bound is the bytes it must move
// (~11 MB of outputs at 1242x375, the bitmap, and ~1 MB of distinct pool
// words on the bench's static map: ~3.7 us at 3.35 TB/s), but the march is a latency- and issue-bound walk: most of
// its lane time is the empty-space DDA (sky rays, misses and object
// renders walk their whole length, dozens of cells a ray), the rest
// dependent loads (grid, then voxel) a sample. Per-tile timers on the card
// showed why a plain per-ray loop stays slow: a warp pays, at every
// sample, the longest gap walk of any of its lanes, so lanes that walk at
// different samples walk one after another.
//
// Design:
//   * candidates_kernel (pre-pass) writes a packed bitmap of the local
//     window, one bit per block cell (150 KB for 160x48x160, 15 KB for
//     64x24x80), then one bit per super-cell of kSuper^3 cells: one warp
//     per visible slot, 16 pool words a lane (four 16-byte loads), a ballot
//     for "any stored negative voxel", lanes 0-7 one block corner's camera
//     depth each; the bits are set with atomicOr where grid[cell] == slot.
//     The wrapper clears the bitmap with one cudaMemsetAsync. It derives
//     world-to-camera row 2 from the pose itself, so no inverse runs
//     before it;
//   * march_kernel copies the bitmap into shared memory once per CTA
//     (16-byte loads) and reads pose, intrinsics and origin into shared
//     memory once per CTA. The candidate test is a shared-memory bit test;
//     the grid is loaded only for a candidate cell, and the DDA and
//     `covered` cost no global load at all;
//   * the DDA takes an empty super-cell in one exact step (walk_chunk) and
//     stops once the ray has left the window for good;
//   * the march runs as a state machine, one loop a lane: a lane walks at
//     most kWalkChunk DDA iterations a turn, so lanes that need gap walks
//     at different samples walk side by side;
//   * CTAs are persistent (as many as fit at once; 1024 threads for the
//     static window's bitmap, which allows one CTA per SM); each warp takes
//     8x4-pixel tiles from an atomic tile counter, so short and long rays
//     do not hold each other (a static round-robin of tiles measured
//     slower);
//   * the epilogue is in the kernel: depth, world points (the operation
//     order of _ray_dirs), unpacked colour, hit and weight, and the
//     march_samples total from per-CTA partial sums and one 64-bit atomic.
//
// The DDA keeps its exact cell walk, tie rule and max_dda count. Compiled
// with -fmad=false, so every operation rounds as the plain version's does.

#include <cstdint>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr float kBig = 1e9f;
constexpr int kTileW = 8, kTileH = 4;  // one warp's pixel tile
constexpr int kSuper = 4;  // block cells per super-cell edge (coarse level)
constexpr int kWalkChunk = 4;  // DDA iterations a lane takes in one turn
constexpr int kPrepassThreads = 256;

struct Params {
  int dx, dy, dz;
  int img_h, img_w, n_steps, max_dda;
  int n_vec;  // bitmap size in 16-byte vectors (fine, then coarse bits)
  int cdy, cdz;  // super-cells along y and z
  int coarse_word;  // first word of the coarse bits
  int tiles_x, n_tiles;
  float inv_voxel, block, inv_sdf_scale;
  float dt, dt15, qdt, hdt, mu, mu09, polish_clip;
  float t_min, t_max, t_cap, t_cap_eps;
};

// per-render values read from the device once per CTA
struct View {
  float r[9], cam[3], fx, fy, cx, cy;
  int ox, oy, oz;
};

struct Ray {
  float ox, oy, oz, dx, dy, dz;
};

struct Maps {
  const int32_t* tsdf_w;
  const int32_t* color;
  const int32_t* grid;
};

struct Outputs {
  float* depth;      // (H, W)
  float* points;     // (H, W, 3)
  uint8_t* color;    // (H, W, 3)
  float* weight;     // (H, W)
  uint8_t* hit;      // (H, W) bool
  unsigned long long* header;  // [samples total, tile counter]
};

__device__ __forceinline__ void load_view(View& v, const float* c2w,
                                          const float* intr,
                                          const int32_t* origin) {
  for (int k = 0; k < 3; ++k) {
    v.r[3 * k + 0] = c2w[4 * k + 0];
    v.r[3 * k + 1] = c2w[4 * k + 1];
    v.r[3 * k + 2] = c2w[4 * k + 2];
    v.cam[k] = c2w[4 * k + 3];
  }
  v.fx = intr[0];
  v.fy = intr[1];
  v.cx = intr[2];
  v.cy = intr[3];
  v.ox = origin[0];
  v.oy = origin[1];
  v.oz = origin[2];
}

// linear cell of block (bx, by, bz) in the local window, or -1
__device__ __forceinline__ int cell_of(const Params& p, const View& w, int bx,
                                       int by, int bz) {
  const int lx = bx - w.ox, ly = by - w.oy, lz = bz - w.oz;
  if (lx < 0 || lx >= p.dx || ly < 0 || ly >= p.dy || lz < 0 || lz >= p.dz)
    return -1;
  return (lx * p.dy + ly) * p.dz + lz;
}

__device__ __forceinline__ bool bit_at(const uint32_t* bits, int cell) {
  return (bits[cell >> 5] >> (cell & 31)) & 1u;
}

__device__ __forceinline__ bool is_cand(const Params& p, const View& w,
                                        const uint32_t* bits, int bx, int by,
                                        int bz) {
  const int cell = cell_of(p, w, bx, by, bz);
  return cell >= 0 && bit_at(bits, cell);
}

__device__ __forceinline__ void voxel_at(const Params& p, const Ray& r,
                                         float t, int& vx, int& vy, int& vz) {
  vx = (int)floorf((r.ox + r.dx * t) * p.inv_voxel);
  vy = (int)floorf((r.oy + r.dy * t) * p.inv_voxel);
  vz = (int)floorf((r.oz + r.dz * t) * p.inv_voxel);
}

// flat pool index of the voxel at t inside a candidate block, or -1; a
// set bit means grid[cell] holds the block's slot (the pre-pass checked)
__device__ __forceinline__ int64_t cand_voxel(const Params& p, const View& w,
                                              const uint32_t* bits,
                                              const Maps& m, const Ray& r,
                                              float t) {
  if (!(t < p.t_max)) return -1;
  int vx, vy, vz;
  voxel_at(p, r, t, vx, vy, vz);
  const int cell = cell_of(p, w, vx >> 3, vy >> 3, vz >> 3);
  if (cell < 0 || !bit_at(bits, cell)) return -1;
  const int slot = m.grid[cell];
  return (int64_t)slot * 512 + (((vx & 7) * 8 + (vy & 7)) * 8 + (vz & 7));
}

__device__ __forceinline__ float sample_sdf(const Params& p, const View& w,
                                            const uint32_t* bits,
                                            const Maps& m, const Ray& r,
                                            float t) {
  const int64_t idx = cand_voxel(p, w, bits, m, r, t);
  if (idx < 0) return 1.0f;
  const int32_t v = m.tsdf_w[idx];
  return (v & 0xFFFF) > 0 ? (float)(v >> 16) * p.inv_sdf_scale : 1.0f;
}

__device__ __forceinline__ bool covered(const Params& p, const View& w,
                                        const uint32_t* bits, const Ray& r,
                                        float t) {
  if (!(t >= p.t_min && t <= p.t_max)) return false;
  int vx, vy, vz;
  voxel_at(p, r, t, vx, vy, vz);
  return is_cand(p, w, bits, vx >> 3, vy >> 3, vz >> 3);
}

// one axis of the DDA: the t at which the ray leaves cell c along it
__device__ __forceinline__ float cell_exit(const Params& p, int c, int step,
                                          float o, float inv) {
  return step != 0 ? ((float)(c + (step > 0 ? 1 : 0)) * p.block - o) * inv
                   : CUDART_INF_F;
}

__device__ __forceinline__ int dir_step(float d) {
  return fabsf(d) < 1e-9f ? 0 : (d > 0.0f ? 1 : -1);
}

// the DDA's per-ray constants: step direction and reciprocal per axis
struct Dda {
  int sx, sy, sz;
  float ix, iy, iz;
};

__device__ __forceinline__ Dda make_dda(const Ray& r) {
  Dda d;
  d.sx = dir_step(r.dx);
  d.sy = dir_step(r.dy);
  d.sz = dir_step(r.dz);
  d.ix = d.sx != 0 ? 1.0f / r.dx : 0.0f;
  d.iy = d.sy != 0 ? 1.0f / r.dy : 0.0f;
  d.iz = d.sz != 0 ? 1.0f / r.dz : 0.0f;
  return d;
}

// outside the window on an axis and not moving back into it: a line that
// has left the (convex) window never re-enters it
__device__ __forceinline__ bool leaving(int l, int s, int d) {
  return (l < 0 && s <= 0) || (l >= d && s >= 0);
}

__device__ __forceinline__ int super_of(const Params& p, int lx, int ly,
                                        int lz) {
  return ((lx / kSuper) * p.cdy + ly / kSuper) * p.cdz + lz / kSuper;
}

// the last local cell index inside the super-cell of l along a step
__device__ __forceinline__ int super_last(int l, int step, int d) {
  const int lo = (l / kSuper) * kSuper;
  return step > 0 ? min(lo + kSuper - 1, d - 1) : lo;
}

// steps the fine walk takes along one axis, from global cell c, before
// the step (t_x, axis a): the prefix of that axis's exits that come first
// in (t, axis) order; `lower` says the axis is below a. At most `limit`.
__device__ __forceinline__ int run_before(const Params& p, int c, int step,
                                          float o, float inv, int limit,
                                          float t_x, bool lower) {
  int n = 0;
  for (; n < limit; ++n) {
    const float v = cell_exit(p, c + n * step, step, o, inv);
    if (!(v < t_x || (v == t_x && lower))) break;
  }
  return n;
}

// The DDA: the entry t of the first candidate block after the cell
// holding t_a, or kBig; it walks at most max_dda cells and gives up past
// t_cap. Ties pick the lowest axis, as raycast_ref's next_entry does.
//
// The walk is the fine cell walk, computed faster where that is exact:
//   * a fine step recomputes only the exit of the axis it crossed and
//     keeps the cell's local index by adding the axis stride;
//   * in a super-cell (kSuper^3 cells) with no candidate, the walk's run
//     to the step that leaves it is taken at once. The walk merges the
//     three axes' exit sequences, each non-decreasing, in (t, axis) order;
//     the leaving step is the least (t, axis) of the three boundary exits
//     ((float)c * block - o) * inv at the fine boundary cells, and along
//     each other axis the walk steps over exactly the prefix of exits that
//     precede it. The run's cells count toward max_dda, and a run that
//     crosses t_cap or the budget ends the walk with kBig, as the cell
//     walk would (none of its cells is a candidate);
//   * the walk stops once the ray has left the window for good (a line
//     that leaves the convex window never re-enters it).
// It advances in chunks (walk_chunk), so that the march can interleave
// one lane's walk with the other lanes' samples.
struct Walk {
  int cx, cy, cz, lx, ly, lz, lin, it;
  float tx, ty, tz;
};

__device__ __forceinline__ void walk_begin(const Params& p, const View& w,
                                           const Ray& r, const Dda& d,
                                           float t_a, Walk& k) {
  int vx, vy, vz;
  voxel_at(p, r, t_a, vx, vy, vz);
  k.cx = vx >> 3;
  k.cy = vy >> 3;
  k.cz = vz >> 3;
  k.lx = k.cx - w.ox;
  k.ly = k.cy - w.oy;
  k.lz = k.cz - w.oz;
  k.lin = (k.lx * p.dy + k.ly) * p.dz + k.lz;
  k.it = 0;
  k.tx = cell_exit(p, k.cx, d.sx, r.ox, d.ix);
  k.ty = cell_exit(p, k.cy, d.sy, r.oy, d.iy);
  k.tz = cell_exit(p, k.cz, d.sz, r.oz, d.iz);
}

// up to `steps` iterations of the walk (a fine step or a super-cell run
// each); returns false while it goes on, true when it has ended with its
// entry t (or kBig) in t_out
__device__ __forceinline__ bool walk_chunk(const Params& p, const View& w,
                                           const uint32_t* bits,
                                           const Ray& r, const Dda& d,
                                           Walk& k, int steps,
                                           float& t_out) {
  const uint32_t* coarse = bits + p.coarse_word;
  for (int n = 0; n < steps; ++n) {
    if (k.it >= p.max_dda) break;
    float t_e;
    const bool inside = (unsigned)k.lx < (unsigned)p.dx
                        && (unsigned)k.ly < (unsigned)p.dy
                        && (unsigned)k.lz < (unsigned)p.dz;
    if (inside && !bit_at(coarse, super_of(p, k.lx, k.ly, k.lz))) {
      const int bx = super_last(k.lx, d.sx, p.dx);
      const int by = super_last(k.ly, d.sy, p.dy);
      const int bz = super_last(k.lz, d.sz, p.dz);
      const float ex = cell_exit(p, bx + w.ox, d.sx, r.ox, d.ix);
      const float ey = cell_exit(p, by + w.oy, d.sy, r.oy, d.iy);
      const float ez = cell_exit(p, bz + w.oz, d.sz, r.oz, d.iz);
      const int axis = (ex <= ey && ex <= ez) ? 0 : (ey <= ez ? 1 : 2);
      t_e = axis == 0 ? ex : (axis == 1 ? ey : ez);
      const int nx = axis == 0 ? abs(bx - k.lx) + 1
                               : run_before(p, k.cx, d.sx, r.ox, d.ix,
                                            abs(bx - k.lx), t_e, true);
      const int ny = axis == 1 ? abs(by - k.ly) + 1
                               : run_before(p, k.cy, d.sy, r.oy, d.iy,
                                            abs(by - k.ly), t_e, axis == 2);
      const int nz = axis == 2 ? abs(bz - k.lz) + 1
                               : run_before(p, k.cz, d.sz, r.oz, d.iz,
                                            abs(bz - k.lz), t_e, false);
      k.it += nx + ny + nz;
      if (!(t_e <= p.t_cap) || k.it > p.max_dda) {
        t_out = kBig;
        return true;
      }
      k.cx += nx * d.sx;
      k.cy += ny * d.sy;
      k.cz += nz * d.sz;
      k.lx += nx * d.sx;
      k.ly += ny * d.sy;
      k.lz += nz * d.sz;
      k.lin = (k.lx * p.dy + k.ly) * p.dz + k.lz;
      k.tx = cell_exit(p, k.cx, d.sx, r.ox, d.ix);
      k.ty = cell_exit(p, k.cy, d.sy, r.oy, d.iy);
      k.tz = cell_exit(p, k.cz, d.sz, r.oz, d.iz);
    } else {
      ++k.it;
      if (k.tx <= k.ty && k.tx <= k.tz) {
        t_e = k.tx;
        k.cx += d.sx;
        k.lx += d.sx;
        k.lin += d.sx * p.dy * p.dz;
        k.tx = cell_exit(p, k.cx, d.sx, r.ox, d.ix);
      } else if (k.ty <= k.tz) {
        t_e = k.ty;
        k.cy += d.sy;
        k.ly += d.sy;
        k.lin += d.sy * p.dz;
        k.ty = cell_exit(p, k.cy, d.sy, r.oy, d.iy);
      } else {
        t_e = k.tz;
        k.cz += d.sz;
        k.lz += d.sz;
        k.lin += d.sz;
        k.tz = cell_exit(p, k.cz, d.sz, r.oz, d.iz);
      }
      if (!(t_e <= p.t_cap)) {
        t_out = kBig;
        return true;
      }
    }
    if ((unsigned)k.lx < (unsigned)p.dx && (unsigned)k.ly < (unsigned)p.dy
        && (unsigned)k.lz < (unsigned)p.dz) {
      if (bit_at(bits, k.lin)) {
        t_out = t_e;
        return true;
      }
    } else if (leaving(k.lx, d.sx, p.dx) || leaving(k.ly, d.sy, p.dy)
               || leaving(k.lz, d.sz, p.dz)) {
      t_out = kBig;
      return true;
    }
  }
  if (k.it >= p.max_dda) {
    t_out = kBig;
    return true;
  }
  return false;
}

// colour / weight read: true when t lies in a candidate block
__device__ __forceinline__ bool sample_cw(const Params& p, const View& w,
                                          const uint32_t* bits,
                                          const Maps& m, const Ray& r,
                                          float t, int& wbits, int32_t& col) {
  const int64_t idx = cand_voxel(p, w, bits, m, r, t);
  if (idx < 0) {
    wbits = 0;
    col = 0;
    return false;
  }
  wbits = m.tsdf_w[idx] & 0xFFFF;
  col = m.color[idx];
  return true;
}

// march one pixel's ray and write its outputs; returns its sample count
__device__ __forceinline__ int march_pixel(const Params& p, const View& w,
                           const uint32_t* bits, const Maps& m,
                           const Outputs& o, int u, int v) {
  const float rcx = ((float)u - w.cx) / w.fx;
  const float rcy = ((float)v - w.cy) / w.fy;
  Ray r;
  r.ox = w.cam[0];
  r.oy = w.cam[1];
  r.oz = w.cam[2];
  r.dx = w.r[0] * rcx + w.r[1] * rcy + w.r[2];
  r.dy = w.r[3] * rcx + w.r[4] * rcy + w.r[5];
  r.dz = w.r[6] * rcx + w.r[7] * rcy + w.r[8];
  const Dda dda = make_dda(r);

  // The march as a state machine in one loop: a lane walks the DDA for at
  // most kWalkChunk iterations a turn, then samples once it has found its
  // entry. Lanes whose rays need several gap walks at different samples
  // then walk side by side instead of one after another. The states and
  // their transitions are the loop of raycast_ref, step for step.
  enum Mode { kFirstWalk, kGapWalk, kSample, kDone };
  float t = 0.0f, psdf = 1.0f, pt = 0.0f, bh = kBig, bc = kBig, t_gap = 0.0f;
  int ns = 0, s = 0;
  Walk k;
  int mode;
  if (covered(p, w, bits, r, p.t_min)) {
    t = fminf(p.t_min, p.t_cap);
    pt = t - p.dt;
    mode = kSample;
  } else {
    walk_begin(p, w, r, dda, p.t_min, k);
    mode = kFirstWalk;
  }
  while (mode != kDone) {
    if (mode != kSample) {
      float e;
      if (walk_chunk(p, w, bits, r, dda, k, kWalkChunk, e)) {
        if (mode == kFirstWalk) {
          t = fminf(e, p.t_cap);
          pt = t - p.dt;
        } else {
          t = fminf(fmaxf(e - p.qdt, t_gap + p.hdt), p.t_cap);
        }
        mode = kSample;
      }
    }
    if (mode == kSample) {
      if (s >= p.n_steps || bh < kBig || !(t < p.t_cap_eps)) {
        mode = kDone;
        continue;
      }
      ++s;
      ++ns;
      const float sdf = sample_sdf(p, w, bits, m, r, t);
      const float prev_t = fmaxf(pt, t - p.dt15);
      if (psdf > 0.0f && sdf <= 0.0f && t < p.t_max && t > 0.0f) {
        const float frac = psdf / fmaxf(psdf - sdf, 1e-6f);
        bh = prev_t + (t - prev_t) * frac;
        bc = t;
        mode = kDone;
        continue;
      }
      psdf = sdf;
      pt = t;
      const float tn = t + fmaxf(sdf * p.mu09, p.dt);
      if (covered(p, w, bits, r, tn)) {
        t = fminf(tn, p.t_cap);
      } else {
        t_gap = t;
        walk_begin(p, w, r, dda, t + p.qdt, k);
        mode = kGapWalk;
      }
    }
  }

  float depth = 0.0f, weight = 0.0f;
  int32_t col = 0;
  if (bh < p.t_max) {
    const float sh = sample_sdf(p, w, bits, m, r, bh);
    if (fabsf(sh) < 0.5f) {
      bh = bh + fminf(fmaxf(sh * p.mu, -p.polish_clip), p.polish_clip);
    }
    int wb;
    const bool in_hit = sample_cw(p, w, bits, m, r, bh, wb, col);
    if (!(in_hit && wb > 0)) {
      sample_cw(p, w, bits, m, r, bc, wb, col);
      if (!(wb > 0)) sample_cw(p, w, bits, m, r, bc - p.dt, wb, col);
    }
    depth = bh;
    weight = (float)wb * (1.0f / 64.0f);
  }
  const bool hit = depth > 0.0f;
  if (!hit) col = 0;
  const int pix = v * p.img_w + u;
  o.depth[pix] = depth;
  o.weight[pix] = weight;
  o.hit[pix] = hit;
  o.points[3 * pix + 0] = r.ox + r.dx * depth;
  o.points[3 * pix + 1] = r.oy + r.dy * depth;
  o.points[3 * pix + 2] = r.oz + r.dz * depth;
  o.color[3 * pix + 0] = (uint8_t)((col >> 16) & 0xFF);
  o.color[3 * pix + 1] = (uint8_t)((col >> 8) & 0xFF);
  o.color[3 * pix + 2] = (uint8_t)(col & 0xFF);
  return ns;
}

template <int kThreads>
__global__ void __launch_bounds__(kThreads)
    march_kernel(Params p, Maps m, const float* __restrict__ c2w,
                 const float* __restrict__ intr,
                 const int32_t* __restrict__ origin,
                 const uint4* __restrict__ bits_g, Outputs o) {
  extern __shared__ uint4 s_bits[];
  __shared__ View s_view;
  __shared__ unsigned long long s_samples;
  for (int i = threadIdx.x; i < p.n_vec; i += blockDim.x) {
    s_bits[i] = bits_g[i];
  }
  if (threadIdx.x == 0) {
    load_view(s_view, c2w, intr, origin);
    s_samples = 0;
  }
  __syncthreads();
  const uint32_t* bits = reinterpret_cast<const uint32_t*>(s_bits);
  const int lane = threadIdx.x & 31;
  unsigned long long samples = 0;
  int* counter = reinterpret_cast<int*>(o.header + 1);
  for (;;) {
    int tile = 0;
    if (lane == 0) tile = atomicAdd(counter, 1);
    tile = __shfl_sync(0xffffffffu, tile, 0);
    if (tile >= p.n_tiles) break;
    const int u = (tile % p.tiles_x) * kTileW + (lane % kTileW);
    const int v = (tile / p.tiles_x) * kTileH + (lane / kTileW);
    if (u < p.img_w && v < p.img_h) {
      samples += march_pixel(p, s_view, bits, m, o, u, v);
    }
  }
  for (int off = 16; off > 0; off >>= 1) {
    samples += __shfl_down_sync(0xffffffffu, samples, off);
  }
  if (lane == 0) atomicAdd(&s_samples, samples);
  __syncthreads();
  if (threadIdx.x == 0) atomicAdd(o.header, s_samples);
}

// the pre-pass: one warp per visible entry
__global__ void __launch_bounds__(kPrepassThreads)
    candidates_kernel(const int32_t* __restrict__ tsdf_w,
                      const int32_t* __restrict__ block_coords,
                      const int32_t* __restrict__ grid,
                      const int32_t* __restrict__ slots,
                      const uint8_t* __restrict__ mask, int n_visible,
                      const float* __restrict__ c2w,
                      const int32_t* __restrict__ origin, int dx, int dy,
                      int dz, float block, float z_lo, float z_hi,
                      uint32_t* __restrict__ bits, int coarse_word) {
  const int lane = threadIdx.x & 31;
  const int warps = gridDim.x * (blockDim.x >> 5);
  // world-to-camera row 2 of the rigid inverse (R^T, -R^T t)
  const float r0 = c2w[2], r1 = c2w[6], r2 = c2w[10];
  const float t2 = -(c2w[2] * c2w[3] + c2w[6] * c2w[7] + c2w[10] * c2w[11]);
  for (int e = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
       e < n_visible; e += warps) {
    if (!mask[e]) continue;
    const int slot = slots[e];
    const int4* row = reinterpret_cast<const int4*>(tsdf_w + (int64_t)slot * 512);
    bool neg = false;
    for (int k = 0; k < 4; ++k) {
      const int4 q = row[k * 32 + lane];
      const int32_t w4[4] = {q.x, q.y, q.z, q.w};
      for (int j = 0; j < 4; ++j) {
        neg |= (w4[j] & 0xFFFF) > 0 && (w4[j] >> 16) < 0;
      }
    }
    const bool has_neg = __any_sync(0xffffffffu, neg);
    // lanes 0-7: one corner (i, j, k) = bits (2, 1, 0) of the lane each
    const int bx = block_coords[3 * slot + 0];
    const int by = block_coords[3 * slot + 1];
    const int bz = block_coords[3 * slot + 2];
    float zmax = -CUDART_INF_F, zmin = CUDART_INF_F;
    if (lane < 8) {
      const float px = ((float)bx + (float)((lane >> 2) & 1)) * block;
      const float py = ((float)by + (float)((lane >> 1) & 1)) * block;
      const float pz = ((float)bz + (float)(lane & 1)) * block;
      const float z = px * r0 + py * r1 + pz * r2 + t2;
      zmax = z;
      zmin = z;
    }
    for (int off = 4; off > 0; off >>= 1) {
      zmax = fmaxf(zmax, __shfl_down_sync(0xffffffffu, zmax, off));
      zmin = fminf(zmin, __shfl_down_sync(0xffffffffu, zmin, off));
    }
    if (lane == 0 && has_neg && zmax > z_lo && zmin < z_hi) {
      const int lx = bx - origin[0], ly = by - origin[1], lz = bz - origin[2];
      if (lx >= 0 && lx < dx && ly >= 0 && ly < dy && lz >= 0 && lz < dz) {
        const int cell = (lx * dy + ly) * dz + lz;
        if (grid[cell] == slot) {
          const int cdy = (dy + kSuper - 1) / kSuper;
          const int cdz = (dz + kSuper - 1) / kSuper;
          const int sc = ((lx / kSuper) * cdy + ly / kSuper) * cdz
                         + lz / kSuper;
          atomicOr(bits + (cell >> 5), 1u << (cell & 31));
          atomicOr(bits + coarse_word + (sc >> 5), 1u << (sc & 31));
        }
      }
    }
  }
}

int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  }
  return n;
}

struct MarchConfig {
  size_t smem;
  int threads, per_sm;
};

// The march's CTA size and CTAs an SM for a bitmap of `smem` bytes,
// worked out once per size: the size that keeps the most threads
// resident, 1024 when the bitmap allows one CTA per SM (the 150 KB static
// window), 512 when several small-window CTAs fit. Both instantiations'
// dynamic shared memory limit is raised to the largest size met.
cudaError_t march_config(size_t smem, MarchConfig& out) {
  static MarchConfig seen[8];
  static int n_seen = 0;
  static size_t limit = 0;
  for (int i = 0; i < n_seen; ++i) {
    if (seen[i].smem == smem) {
      out = seen[i];
      return cudaSuccess;
    }
  }
  cudaError_t err;
  if (smem > limit) {
    err = cudaFuncSetAttribute(march_kernel<512>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(march_kernel<1024>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return err;
    limit = smem;
  }
  int per_sm_512 = 0, per_sm_1024 = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm_512, march_kernel<512>, 512, smem);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm_1024, march_kernel<1024>, 1024, smem);
  if (err != cudaSuccess) return err;
  const bool wide = per_sm_1024 * 1024 > per_sm_512 * 512;
  out = {smem, wide ? 1024 : 512, wide ? per_sm_1024 : per_sm_512};
  if (out.per_sm < 1) return cudaErrorInvalidConfiguration;
  if (n_seen < 8) seen[n_seen++] = out;
  return cudaSuccess;
}

}  // namespace

// The version of the C entries' argument lists (ops/cuda_build.py
// ABI_VERSION).
extern "C" int dynslam_abi_version() { return 2; }

// Clears the bitmap (n_words uint32: the fine bits, then from
// coarse_word the super-cells' bits) and sets the bits of the candidate
// cells and of the super-cells holding them. Returns a cudaError_t.
extern "C" int dynslam_candidates(
    const void* tsdf_w, const void* block_coords, const void* grid,
    const void* slots, const void* mask, int n_visible, const void* c2w,
    const void* origin, int dx, int dy, int dz, float block, float z_lo,
    float z_hi, void* bits, int n_words, int coarse_word, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = cudaMemsetAsync(bits, 0, (size_t)n_words * 4, s);
  if (err != cudaSuccess) return (int)err;
  if (n_visible <= 0) return 0;
  const int warps_per_cta = kPrepassThreads / 32;
  int ctas = (n_visible + warps_per_cta - 1) / warps_per_cta;
  ctas = ctas < sm_count() * 8 ? ctas : sm_count() * 8;
  candidates_kernel<<<ctas, kPrepassThreads, 0, s>>>(
      (const int32_t*)tsdf_w, (const int32_t*)block_coords,
      (const int32_t*)grid, (const int32_t*)slots, (const uint8_t*)mask,
      n_visible, (const float*)c2w, (const int32_t*)origin, dx, dy, dz, block,
      z_lo, z_hi, (uint32_t*)bits, coarse_word);
  return (int)cudaGetLastError();
}

// Zeroes the header (samples total, tile counter) and marches every
// pixel. bits: n_vec 16-byte vectors, the super-cells' bits from word
// coarse_word. Returns a cudaError_t.
extern "C" int dynslam_march(
    const void* tsdf_w, const void* color, const void* grid, const void* bits,
    int n_vec, int coarse_word, const void* c2w, const void* intr, const void* origin, int dx,
    int dy, int dz, int img_h, int img_w, int n_steps, int max_dda,
    float inv_voxel, float block, float inv_sdf_scale, float dt, float dt15,
    float qdt, float hdt, float mu, float mu09, float polish_clip,
    float t_min, float t_max, float t_cap, float t_cap_eps, void* depth_out,
    void* points_out, void* color_out, void* weight_out, void* hit_out,
    void* header, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = cudaMemsetAsync(header, 0, 16, s);
  if (err != cudaSuccess) return (int)err;
  if (img_h <= 0 || img_w <= 0) return 0;
  Params p = {};
  p.dx = dx;
  p.dy = dy;
  p.dz = dz;
  p.img_h = img_h;
  p.img_w = img_w;
  p.n_steps = n_steps;
  p.max_dda = max_dda;
  p.n_vec = n_vec;
  p.cdy = (dy + kSuper - 1) / kSuper;
  p.cdz = (dz + kSuper - 1) / kSuper;
  p.coarse_word = coarse_word;
  p.tiles_x = (img_w + kTileW - 1) / kTileW;
  p.n_tiles = p.tiles_x * ((img_h + kTileH - 1) / kTileH);
  p.inv_voxel = inv_voxel;
  p.block = block;
  p.inv_sdf_scale = inv_sdf_scale;
  p.dt = dt;
  p.dt15 = dt15;
  p.qdt = qdt;
  p.hdt = hdt;
  p.mu = mu;
  p.mu09 = mu09;
  p.polish_clip = polish_clip;
  p.t_min = t_min;
  p.t_max = t_max;
  p.t_cap = t_cap;
  p.t_cap_eps = t_cap_eps;
  Maps m;
  m.tsdf_w = (const int32_t*)tsdf_w;
  m.color = (const int32_t*)color;
  m.grid = (const int32_t*)grid;
  Outputs o;
  o.depth = (float*)depth_out;
  o.points = (float*)points_out;
  o.color = (uint8_t*)color_out;
  o.weight = (float*)weight_out;
  o.hit = (uint8_t*)hit_out;
  o.header = (unsigned long long*)header;
  const size_t smem = (size_t)n_vec * 16;
  MarchConfig mc;
  err = march_config(smem, mc);
  if (err != cudaSuccess) return (int)err;
  int ctas = mc.per_sm * sm_count();
  if ((ctas * mc.threads) / 32 > p.n_tiles) {
    ctas = (p.n_tiles * 32 + mc.threads - 1) / mc.threads;
  }
  if (mc.threads == 1024) {
    march_kernel<1024><<<ctas, 1024, smem, s>>>(
        p, m, (const float*)c2w, (const float*)intr, (const int32_t*)origin,
        (const uint4*)bits, o);
  } else {
    march_kernel<512><<<ctas, 512, smem, s>>>(
        p, m, (const float*)c2w, (const float*)intr, (const int32_t*)origin,
        (const uint4*)bits, o);
  }
  return (int)cudaGetLastError();
}
