// Dense census stereo of ops/stereo.py::compute_disparity (CUDA, sm_90a):
// the census of both images, the aggregated cost volume, both
// winner-take-alls with the checks, and the 3x3 median, in four launches.
//
// Replaces no TPU kernel: the JAX package's compute_disparity_jit
// (dynslam_tpu/ops/stereo.py) is plain XLA. It was added because its
// plain PyTorch twin, compute_disparity_plain, makes ~850 launches and
// allocations a call at 1242x375 with 128 disparities (int64 census bits,
// XOR and SWAR popcounts and prefix sums over chunks of 16 disparities, a
// loop of 128 copies for the right view) and takes ~15 ms of device time.
//
// What bounds it on this card. The data is small: two 1242x375 images
// (3.7 MB) in, one disparity map out. The work is 59.6 M Hamming costs
// (128 disparities x 375 x 1242), each a 64-bit XOR and two 32-bit
// popcounts, then a 5x5 box sum and two minimum searches over them. At
// the popcount rate (16 a clock an SM, 132 SMs) the Hamming costs alone
// take ~28 us; the int16 cost volume (119 MB) written once and read once
// takes ~71 us at 3.35 TB/s. So the floor of this design is the volume's
// traffic, ~0.1 ms. On an H100 (700 W) the chain takes 0.48 ms there, 0.34
// of it the cost kernel. Not its census loads: a version that copies the
// block's census into shared memory first took 0.31 ms. What holds it
// there is not measured yet.
//
// Design. census: one thread a pixel, both images in one launch, a 48-bit
// signature a uint64. cost: a block is 32 disparities (one a lane) by 32
// columns (one a warp, the 2r halo columns included) and walks a band of
// 32 rows; each thread computes each Hamming cost of its (column,
// disparity) once, keeps the vertical window's running sum with a ring of
// the last 2r + 1 costs in shared memory, and the block sums each row's
// vertical sums across the 2r + 1 neighbouring columns from shared
// memory, so a cost is computed 1.29 times (the halo) and not 25. The
// int16 costs go out in (H, W, D) order: a pixel's costs are contiguous.
// select: one block a row, one thread a pixel, the costs read 16 bytes at
// a time; the left winner is the first minimum (strict <, as argmin
// keeps the first), the right view's first minimum of cost(x_r + d, d) is
// an atomicMin in shared memory over (cost << 16 | d), which orders by
// cost and then by the lower disparity; then the parabola, uniqueness,
// the left-right check in the same row, the range test and best_d > 0.
// median: one thread a pixel, the 3x3 replicate-padded window through a
// 19-exchange median network.
//
// Rounding. The costs and the winners are integers and exact. The float
// arithmetic is the plain version's, one operation at a time in its order
// and precision (the library is compiled with -fmad=false and without
// fast math, so the division is IEEE's): c0, cm, cp and the runner-up
// as float32, 0.5 (cm - cp) / max(denom, 1e-6), the offset clamped to
// +-0.5, c0 <= float32(uniqueness) * second. The median picks one of its
// nine values, so the result is equal to the plain version's bit for bit.
// No host sync, no allocation: the wrapper allocates the scratch.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kNoMatch = 96;  // cost of a column with no right counterpart
constexpr int kBig = 32767;   // the runner-up where no disparity is eligible
constexpr int kCensusThreads = 256;
constexpr int kLanes = 32;  // disparities a cost block (one a lane)
constexpr int kCols = 32;   // columns a cost block walks, halo included
constexpr int kRows = 32;   // output rows a cost block
constexpr int kSelectThreads = 256;
constexpr int kMedianThreads = 256;

// ops/depth.py's depth_m_from_mm(depth_mm_from_disparity(disp, ...)) in
// its operations' order and float32 rounding: 1 / den then a product with
// bf (PyTorch's scalar / tensor), the int32 cast of the clamped mm, the
// range test, the int16 mm times the float32 reciprocal of 1000
struct Depth {
  float* out;  // null: no depth
  float bf, mm_scale, m_per_mm;
  int min_mm, max_mm;
};

__device__ __forceinline__ float depth_of(float disp, const Depth& dp) {
  const float den = fabsf(disp) < 1e-5f ? __int_as_float(0x7f800000) : disp;
  const float mm = dp.mm_scale * ((1.0f / den) * dp.bf);
  int i = 0;
  if (fabsf(mm) <= 3.402823466e38f)  // torch.isfinite
    i = (int)fminf(fmaxf(mm, -2147483648.0f), 2147483520.0f);
  const int16_t v = (i > dp.max_mm || i < dp.min_mm) ? 0 : (int16_t)i;
  return (float)v * dp.m_per_mm;
}

// bit k of a pixel's signature: the k-th window pixel (row-major, the
// centre skipped) is darker than the centre; outside the image compare 0
__global__ void __launch_bounds__(kCensusThreads) census_kernel(
    const float* __restrict__ left, const float* __restrict__ right, int h,
    int w, int r, unsigned long long* __restrict__ out) {
  const int i = blockIdx.x * kCensusThreads + threadIdx.x;
  if (i >= h * w) return;
  const float* img = blockIdx.y ? right : left;
  const int y = i / w, x = i - y * w;
  const float c = img[i];
  unsigned long long sig = 0;
  int k = 0;
  for (int dy = -r; dy <= r; ++dy) {
    const int yy = y + dy;
    for (int dx = -r; dx <= r; ++dx) {
      if (dy == 0 && dx == 0) continue;
      const int xx = x + dx;
      const float n = (yy >= 0 && yy < h && xx >= 0 && xx < w)
                          ? img[yy * w + xx] : 0.f;
      sig |= (unsigned long long)(n < c) << k;
      ++k;
    }
  }
  out[(size_t)blockIdx.y * h * w + i] = sig;
}

// the (2 ra + 1)^2 zero-padded box sum of the Hamming costs, as int16
// (H, W, D); grid (column tiles, row bands, disparity chunks)
__global__ void __launch_bounds__(kLanes * kCols) cost_kernel(
    const unsigned long long* __restrict__ cl,
    const unsigned long long* __restrict__ cr, int h, int w, int D, int ra,
    int16_t* __restrict__ cost) {
  extern __shared__ int smem[];
  constexpr int kThreads = kLanes * kCols;
  const int k = 2 * ra + 1;
  int* ring = smem;                  // k x kThreads: a thread's last k costs
  int* vrow = smem + k * kThreads;   // 2 x kThreads: a row's vertical sums
  const int lane = threadIdx.x, col = threadIdx.y;
  const int tid = col * kLanes + lane;
  const int d = blockIdx.z * kLanes + lane;
  const int x = blockIdx.x * (kCols - 2 * ra) - ra + col;
  const int y0 = blockIdx.y * kRows;
  const int rows = min(kRows, h - y0) + 2 * ra;
  const bool live = d < D && x >= 0 && x < w;
  const bool writes = live && col >= ra && col < kCols - ra;
  int vsum = 0, slot = 0;
  for (int i = 0; i < rows; ++i) {
    const int yy = y0 - ra + i;
    int ham = 0;
    if (live && yy >= 0 && yy < h) {
      const size_t row = (size_t)yy * w;
      ham = x < d ? kNoMatch : __popcll(cl[row + x] ^ cr[row + x - d]);
    }
    int* ri = ring + slot * kThreads + tid;
    if (i >= k) vsum -= *ri;  // the row that leaves the window
    vsum += ham;
    *ri = ham;
    slot = slot + 1 == k ? 0 : slot + 1;
    if (i < 2 * ra) continue;  // uniform across the block
    // vsum holds rows yy - 2 ra .. yy: output row yy - ra
    int* v = vrow + (i & 1) * kThreads;
    v[tid] = vsum;
    __syncthreads();
    if (writes) {
      int s = 0;
      for (int dx = -ra; dx <= ra; ++dx) s += v[(col + dx) * kLanes + lane];
      cost[((size_t)(yy - ra) * w + x) * D + d] = (int16_t)s;
    }
  }
}

// f(d, cost) for d = 0 .. D - 1 in order, V costs a load (V = 8: 16 bytes,
// the pixel's costs 16-byte aligned)
template <int V, typename F>
__device__ __forceinline__ void for_each_cost(const int16_t* c, int D,
                                              F&& f) {
  if constexpr (V == 8) {
#pragma unroll 4
    for (int d0 = 0; d0 < D; d0 += 8) {
      const uint4 q = *reinterpret_cast<const uint4*>(c + d0);
      const unsigned u[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        f(d0 + 2 * j, (int)(int16_t)(u[j] & 0xffffu));
        f(d0 + 2 * j + 1, (int)(int16_t)(u[j] >> 16));
      }
    }
  } else {
    for (int d = 0; d < D; ++d) f(d, (int)c[d]);
  }
}

// one block a row: both winner-take-alls, the subpixel parabola, the
// checks; writes the masked disparity of each pixel
template <int V>
__global__ void __launch_bounds__(kSelectThreads) select_kernel(
    const int16_t* __restrict__ cost, int w, int D, float uniqueness,
    float lr_max, float* __restrict__ out, Depth dp) {
  extern __shared__ int smem[];
  int* key = smem;  // the right view's minimum of cost << 16 | d
  float* sub = reinterpret_cast<float*>(smem + w);  // subpixel disparity
  int* meta = smem + 2 * w;  // best_d | the other checks passed << 16
  const int y = blockIdx.x;
  for (int x = threadIdx.x; x < w; x += kSelectThreads) key[x] = INT_MAX;
  __syncthreads();
  for (int x = threadIdx.x; x < w; x += kSelectThreads) {
    const int16_t* c = cost + ((size_t)y * w + x) * D;
    int best = 0, cb = INT_MAX;
    for_each_cost<V>(c, D, [&](int d, int v) {
      if (v < cb) {
        cb = v;
        best = d;
      }
      // cost_R(x - d, d) = cost_L(x, d)
      if (d <= x) atomicMin(&key[x - d], v * 65536 + d);
    });
    int second = kBig;
    for_each_cost<V>(c, D, [&](int d, int v) {
      if ((d < best - 1 || d > best + 1) && v < second) second = v;
    });
    const float c0 = (float)cb;
    const float cm = best == 0 ? c0 : (float)c[best - 1];
    const float cp = best == D - 1 ? c0 : (float)c[best + 1];
    const float denom = cm - 2.0f * c0 + cp;
    float offset = 0.f;
    if (denom > 1e-6f) offset = 0.5f * (cm - cp) / fmaxf(denom, 1e-6f);
    offset = fminf(fmaxf(offset, -0.5f), 0.5f);
    const bool unique_ok = c0 <= uniqueness * (float)second;
    const bool in_range = x >= D || best < x;
    sub[x] = (float)best + offset;
    meta[x] = best | (unique_ok && in_range && best > 0 ? 0x10000 : 0);
  }
  __syncthreads();
  for (int x = threadIdx.x; x < w; x += kSelectThreads) {
    const int best = meta[x] & 0xffff;
    int xr = (x - best) % w;  // the plain version's floor modulo
    if (xr < 0) xr += w;
    const float disp = sub[x];
    const bool lr_ok = fabsf(disp - (float)(key[xr] & 0xffff)) <= lr_max;
    const float o = (meta[x] >> 16) && lr_ok ? disp : 0.f;
    out[(size_t)y * w + x] = o;
    if (dp.out) dp.out[(size_t)y * w + x] = depth_of(o, dp);
  }
}

__device__ __forceinline__ void order(float& a, float& b) {
  const float lo = fminf(a, b), hi = fmaxf(a, b);
  a = lo;
  b = hi;
}

// the 3x3 median with replicate padding (the 5th of 9, as a sort gives)
__global__ void __launch_bounds__(kMedianThreads) median_kernel(
    const float* __restrict__ in, int h, int w, float* __restrict__ out,
    Depth dp) {
  const int i = blockIdx.x * kMedianThreads + threadIdx.x;
  if (i >= h * w) return;
  const int y = i / w, x = i - y * w;
  float p[9];
#pragma unroll
  for (int dy = 0; dy < 3; ++dy) {
    const int yy = min(max(y + dy - 1, 0), h - 1);
#pragma unroll
    for (int dx = 0; dx < 3; ++dx)
      p[3 * dy + dx] = in[(size_t)yy * w + min(max(x + dx - 1, 0), w - 1)];
  }
  order(p[1], p[2]); order(p[4], p[5]); order(p[7], p[8]);
  order(p[0], p[1]); order(p[3], p[4]); order(p[6], p[7]);
  order(p[1], p[2]); order(p[4], p[5]); order(p[7], p[8]);
  order(p[0], p[3]); order(p[5], p[8]); order(p[4], p[7]);
  order(p[3], p[6]); order(p[1], p[4]); order(p[2], p[5]);
  order(p[4], p[7]); order(p[4], p[2]); order(p[6], p[4]);
  order(p[4], p[2]);
  out[i] = p[4];
  if (dp.out) dp.out[i] = depth_of(p[4], dp);
}

// opt a kernel in to `bytes` of dynamic shared memory once it needs more
// than the default 48 KB
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes, size_t& opted) {
  if (bytes <= opted) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == cudaSuccess) opted = bytes;
  return err;
}

}  // namespace

// The version of the C entries' argument lists (ops/cuda_build.py
// ABI_VERSION).
extern "C" int dynslam_abi_version() { return 2; }

// compute_disparity on (h, w) float32 images: the census, cost, select
// and (where `median`) median kernels in order on `stream`. census:
// scratch of 2 h w uint64; cost: h w D int16; masked: h w float32 (the
// select kernel's output where the median follows, else unused); out: h w
// float32; depth: null, or h w float32 that the last kernel fills with the
// depth (m) of its disparity (the arguments after `depth`). Needs 1 <= D,
// census radius <= 3, 0 <= agg_r < kCols / 2. Returns a cudaError_t.
extern "C" int dynslam_stereo_disparity(
    const void* left, const void* right, int h, int w, int D, int census_r,
    int agg_r, float uniqueness, float lr_max, int median, void* census,
    void* cost, void* masked, void* out, void* depth, float bf,
    float mm_scale, int min_mm, int max_mm, float m_per_mm, void* stream) {
  if (h <= 0 || w <= 0 || D <= 0 || census_r < 0 || census_r > 3 ||
      agg_r < 0 || 2 * agg_r >= kCols)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const int n = h * w;
  auto* sig = (unsigned long long*)census;
  auto* vol = (int16_t*)cost;
  float* sel_out = median ? (float*)masked : (float*)out;
  const Depth none = {nullptr, 0.f, 0.f, 0.f, 0, 0};
  const Depth dp = {(float*)depth, bf, mm_scale, m_per_mm, min_mm, max_mm};
  cudaError_t err;
  census_kernel<<<dim3((n + kCensusThreads - 1) / kCensusThreads, 2),
                  kCensusThreads, 0, s>>>((const float*)left,
                                          (const float*)right, h, w,
                                          census_r, sig);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  static size_t cost_opted = 48 * 1024;
  const size_t cost_smem = sizeof(int) * (2 * agg_r + 3) * kLanes * kCols;
  if ((err = allow_smem(cost_kernel, cost_smem, cost_opted)) != cudaSuccess)
    return (int)err;
  const int tile = kCols - 2 * agg_r;
  const dim3 grid((w + tile - 1) / tile, (h + kRows - 1) / kRows,
                  (D + kLanes - 1) / kLanes);
  cost_kernel<<<grid, dim3(kLanes, kCols), cost_smem, s>>>(sig, sig + n, h,
                                                           w, D, agg_r, vol);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const size_t smem = sizeof(int) * 3 * (size_t)w;
  const Depth& sel_dp = median ? none : dp;
  if (D % 8 == 0) {
    static size_t opted = 48 * 1024;
    if ((err = allow_smem(select_kernel<8>, smem, opted)) != cudaSuccess)
      return (int)err;
    select_kernel<8><<<h, kSelectThreads, smem, s>>>(vol, w, D, uniqueness,
                                                     lr_max, sel_out, sel_dp);
  } else {
    static size_t opted = 48 * 1024;
    if ((err = allow_smem(select_kernel<1>, smem, opted)) != cudaSuccess)
      return (int)err;
    select_kernel<1><<<h, kSelectThreads, smem, s>>>(vol, w, D, uniqueness,
                                                     lr_max, sel_out, sel_dp);
  }
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  if (median) {
    median_kernel<<<(n + kMedianThreads - 1) / kMedianThreads,
                    kMedianThreads, 0, s>>>((const float*)masked, h, w,
                                            (float*)out, dp);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  return 0;
}
