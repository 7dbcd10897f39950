// TSDF fusion of one view per volume into its visible voxel blocks (CUDA,
// sm_90a).
//
// Replaces the Pallas kernel dynslam_tpu/ops/pallas_integrate.py::
// integrate_pallas (kernel body _kernel_factory, launched per tier by
// _run_tier). The update rule is dynslam_tpu/ops/tsdf.py::integrate, and
// its plain PyTorch twin is dynslam_tpu_torch/ops/integrate.py::
// integrate_ref: project each voxel centre, take the nearest pixel, gate
// on d in [min_depth, max_depth] and eta = d - z > -mu, take the weighted
// SDF mean with the weight capped at max_weight, blend colour where
// |eta| < mu/4, and set last_seen.
//
// The volume axis fuses several maps of one stacked pool (S, P, 512) in
// one launch, each from its own view: the dynamic step's routed object
// volumes, each with its own bbox crop (depth, RGB), pose, principal
// point and frame index. It replaces the JAX package's vmap of the Pallas
// kernel over the S pooled volumes (fused_dynamic.py:572). The static map
// and a single object volume are the case of one volume. Visible slots
// are unique within a volume and two volumes are distinct pool slots, so
// no two CTAs touch one pool row and no atomics are needed. The TPU
// kernel's tiers, compaction, one-hot MXU sampling and tile gates are not
// needed.
//
// What bounds it on this card: the work is 2 x 4 bytes per voxel of pool
// read and written (~8 KB a visible block, ~20 MB at 2,475 blocks) plus
// the pixels the voxels project to (7 bytes each, ~1.7 MB there; at most
// the 3.3 MB planes of 1242x375, which stay in L2): ~6.6 us at 3.35 TB/s;
// the arithmetic is a few dozen flops a voxel.
// A grid of one CTA per visible-list entry would spend its time launching
// and retiring CTAs: the list holds 16,384 entries of which ~15% are live.
// What is left is latency: a pair costs two dependent round trips (its
// rows and coordinates, then its pixels) after the probe, and a kernel
// launch (~13 us measured whatever the register budget).
//
// Design: a persistent grid of as many 128-thread CTAs as fit on the card
// at once. Each CTA strides over the (volume, entry) pairs: every thread
// probes one pair's mask byte and pool slot in one round trip, the live
// pairs are compacted in shared memory with warp ballots, and the CTA
// fuses them one after another, so a masked entry costs one byte load and
// no block launch. A thread owns four consecutive voxels (same x, y) and
// moves them as one 16-byte load and store for tsdf_w and for color, so
// one block row is one contiguous 2 KB access per array, loaded in the
// same round trip as the block's coordinates (registers). Pose,
// intrinsics and frame index go to shared memory once per volume.

// Arithmetic parity: the operations are integrate_ref's, which are the
// JAX rule as XLA's CPU backend evaluates it: divisions by a constant are
// multiplications by its float32 reciprocal (passed in), a * b + c is one
// fmaf (the transform's row sums are an fmaf chain, then the
// translation), rounding is half to even (rintf), float->int casts
// truncate, and the library is compiled with -fmad=false so nvcc
// contracts no other multiply-add.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;  // four voxels a thread, one block row a CTA
constexpr int kWarps = kThreads / 32;

struct Consts {
  int img_h, img_w;
  float voxel, mu, inv_mu, mu_quarter, inv_1000, inv_sdf_scale, max_weight;
  float min_depth, max_depth;
  int depth_weighting;
};

// one voxel of the update rule; (bx, by, bz) is the block's world
// coordinate and (x, y, z) the voxel within it
__device__ __forceinline__ void fuse_voxel(
    const Consts& c, const float* w2c, const float* intr, int bx, int by,
    int bz, int x, int y, int z, const float* __restrict__ depth,
    const uint8_t* __restrict__ rgb, int32_t& packed, int32_t& colour) {
  const float pwx = ((float)bx * 8.0f + (float)x + 0.5f) * c.voxel;
  const float pwy = ((float)by * 8.0f + (float)y + 0.5f) * c.voxel;
  const float pwz = ((float)bz * 8.0f + (float)z + 0.5f) * c.voxel;
  const float pcx =
      fmaf(w2c[2], pwz, fmaf(w2c[1], pwy, w2c[0] * pwx)) + w2c[3];
  const float pcy =
      fmaf(w2c[6], pwz, fmaf(w2c[5], pwy, w2c[4] * pwx)) + w2c[7];
  const float zc =
      fmaf(w2c[10], pwz, fmaf(w2c[9], pwy, w2c[8] * pwx)) + w2c[11];

  const float safe_z = fmaxf(zc, 1e-3f);
  const float u = fmaf(pcx / safe_z, intr[0], intr[2]);
  const float v = fmaf(pcy / safe_z, intr[1], intr[3]);
  const bool in_img = u >= 0.0f && u <= (float)(c.img_w - 1) && v >= 0.0f
                      && v <= (float)(c.img_h - 1) && zc > 1e-3f;
  const int ui = min(max(__float2int_rn(u), 0), c.img_w - 1);
  const int vi = min(max(__float2int_rn(v), 0), c.img_h - 1);
  const int px = vi * c.img_w + ui;
  // the pixel's depth and colour in one round trip (the colour is used
  // only where the blend applies)
  const float d_px = depth[px];
  const float rgb_px[3] = {(float)rgb[3 * px + 0], (float)rgb[3 * px + 1],
                           (float)rgb[3 * px + 2]};

  const int d_mm = (int)fminf(fmaxf(d_px * 1000.0f, 0.0f), 65535.0f);
  const float d = (float)d_mm * c.inv_1000;
  const bool d_ok = d >= c.min_depth && d <= c.max_depth;
  const float eta = d - zc;
  const bool update = in_img && d_ok && eta > -c.mu;
  const float sdf_obs = fminf(fmaxf(eta * c.inv_mu, -1.0f), 1.0f);

  float w_obs = 1.0f;
  if (c.depth_weighting) {
    const float q = c.max_depth / fmaxf(d, 0.5f);
    w_obs = fminf(fmaxf(q * q, 0.25f), 5.0f);
  }
  if (!update) w_obs = 0.0f;

  const float w_old = (float)(packed & 0xFFFF) / 64.0f;
  const float t_old = (float)(packed >> 16) * c.inv_sdf_scale;
  const float w_new = fminf(w_old + w_obs, c.max_weight);
  const float den = fmaxf(w_old + w_obs, 1e-6f);
  const float t_new =
      w_obs > 0.0f ? fmaf(t_old, w_old, sdf_obs * w_obs) / den : t_old;
  const int s =
      (int)fminf(fmaxf(rintf(t_new * 32767.0f), -32767.0f), 32767.0f);
  const int w = (int)fminf(fmaxf(rintf(w_new * 64.0f), 0.0f), 65535.0f);
  // build (s << 16) | w through uint32_t: shifting a negative int is UB
  packed = (int32_t)(((uint32_t)s << 16) | (uint32_t)w);

  float ch[3] = {(float)((colour >> 16) & 0xFF),
                 (float)((colour >> 8) & 0xFF), (float)(colour & 0xFF)};
  if (update && fabsf(eta) < c.mu_quarter) {
    for (int k = 0; k < 3; ++k) {
      ch[k] = fmaf(ch[k], w_old, rgb_px[k] * w_obs) / den;
    }
  }
  int q[3];
  for (int k = 0; k < 3; ++k) {
    q[k] = (int)fminf(fmaxf(ch[k] + 0.5f, 0.0f), 255.0f);
  }
  colour = (q[0] << 16) | (q[1] << 8) | q[2];
}

__global__ void __launch_bounds__(kThreads) integrate_kernel(
    int32_t* __restrict__ tsdf_w,              // (S, P, 512)
    int32_t* __restrict__ color,               // (S, P, 512)
    const int32_t* __restrict__ block_coords,  // (S, P, 3)
    int32_t* __restrict__ last_seen,           // (S, P)
    int pool_capacity,                         // P
    const int32_t* __restrict__ vols,          // (n,) pool slot of volume
    int n_vols,
    const int32_t* __restrict__ slots,         // (n, V)
    const uint8_t* __restrict__ mask,          // (n, V) bool
    int n_visible,                             // V
    const float* __restrict__ depth_all,       // (n, H, W) metres
    const uint8_t* __restrict__ rgb_all,       // (n, H, W, 3)
    const float* __restrict__ w2c_all,         // (n, 4, 4) row-major
    const float* __restrict__ intr_all,        // (n, 4) fx, fy, cx, cy
    const int32_t* __restrict__ frame_all,     // (n,), or null: frame
    int frame, Consts c) {
  __shared__ int s_items[kThreads];
  __shared__ int64_t s_slots[kThreads];
  __shared__ int s_warp[kWarps];
  __shared__ float s_w2c[12], s_intr[4];
  __shared__ int s_frame;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n_items = n_vols * n_visible;
  const int64_t plane = (int64_t)c.img_h * c.img_w;
  const int x = tid >> 4, y = (tid >> 1) & 7, z0 = (tid & 1) * 4;
  int cur_vol = -1;
  for (int64_t base = blockIdx.x; base < n_items;
       base += (int64_t)gridDim.x * kThreads) {
    // probe one (volume, entry) pair a thread, with its pool slot in the
    // same round trip; compact the live ones
    const int64_t item = base + (int64_t)tid * gridDim.x;
    const bool in_range = item < n_items;
    const bool live = in_range && mask[item];
    const int64_t slot_of = in_range
        ? (int64_t)vols[item / n_visible] * pool_capacity + slots[item]
        : 0;
    const unsigned bal = __ballot_sync(0xffffffffu, live);
    if (lane == 0) s_warp[warp] = __popc(bal);
    __syncthreads();
    int off = 0, n_live = 0;
    for (int k = 0; k < kWarps; ++k) {
      off += k < warp ? s_warp[k] : 0;
      n_live += s_warp[k];
    }
    if (live) {
      const int at = off + __popc(bal & ((1u << lane) - 1u));
      s_items[at] = (int)item;
      s_slots[at] = slot_of;
    }
    __syncthreads();
    for (int k = 0; k < n_live; ++k) {
      const int it = s_items[k];
      const int vol = it / n_visible;
      if (vol != cur_vol) {  // the same for every thread of the CTA
        __syncthreads();  // all threads are done with the last volume's
        if (tid < 12) s_w2c[tid] = w2c_all[vol * 16 + tid];
        if (tid >= 32 && tid < 36) s_intr[tid - 32] = intr_all[vol * 4 + tid - 32];
        if (tid == 64) s_frame = frame_all ? frame_all[vol] : frame;
        __syncthreads();
        cur_vol = vol;
      }
      const int64_t slot = s_slots[k];
      // one round trip: the block's coordinates and its two pool rows
      const int bx = block_coords[3 * slot + 0];
      const int by = block_coords[3 * slot + 1];
      const int bz = block_coords[3 * slot + 2];
      const int64_t at = slot * 512 + tid * 4;
      int4 tw = *reinterpret_cast<const int4*>(tsdf_w + at);
      int4 cw = *reinterpret_cast<const int4*>(color + at);
      const float* depth = depth_all + vol * plane;
      const uint8_t* rgb = rgb_all + vol * plane * 3;
      fuse_voxel(c, s_w2c, s_intr, bx, by, bz, x, y, z0 + 0, depth, rgb,
                 tw.x, cw.x);
      fuse_voxel(c, s_w2c, s_intr, bx, by, bz, x, y, z0 + 1, depth, rgb,
                 tw.y, cw.y);
      fuse_voxel(c, s_w2c, s_intr, bx, by, bz, x, y, z0 + 2, depth, rgb,
                 tw.z, cw.z);
      fuse_voxel(c, s_w2c, s_intr, bx, by, bz, x, y, z0 + 3, depth, rgb,
                 tw.w, cw.w);
      *reinterpret_cast<int4*>(tsdf_w + at) = tw;
      *reinterpret_cast<int4*>(color + at) = cw;
      if (tid == 0) last_seen[slot] = s_frame;
    }
  }
}

int persistent_ctas() {
  static int n = 0;
  if (n == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, integrate_kernel,
                                                  kThreads, 0);
    n = sms * (per_sm > 0 ? per_sm : 1);
  }
  return n;
}

}  // namespace

// The version of the C entries' argument lists (ops/cuda_build.py
// ABI_VERSION).
extern "C" int dynslam_abi_version() { return 2; }

// frame_idx may be null: then every volume's frame index is `frame`.
// Returns a cudaError_t.
extern "C" int dynslam_integrate(
    void* tsdf_w, void* color, const void* block_coords, void* last_seen,
    int pool_capacity, const void* vols, int n_vols, const void* slots,
    const void* mask, int n_visible, const void* depth, const void* rgb,
    const void* w2c, const void* intr, const void* frame_idx, int frame,
    int img_h, int img_w, float voxel, float mu, float inv_mu,
    float mu_quarter, float inv_1000, float inv_sdf_scale, float max_weight,
    float min_depth, float max_depth, int depth_weighting, void* stream) {
  if (n_visible <= 0 || n_vols <= 0) return 0;
  const Consts c = {img_h,      img_w,         voxel,      mu,
                    inv_mu,     mu_quarter,    inv_1000,   inv_sdf_scale,
                    max_weight, min_depth,     max_depth,  depth_weighting};
  const int n_items = n_vols * n_visible;
  int ctas = persistent_ctas();
  if (ctas > n_items) ctas = n_items;
  integrate_kernel<<<ctas, kThreads, 0, (cudaStream_t)stream>>>(
      (int32_t*)tsdf_w, (int32_t*)color, (const int32_t*)block_coords,
      (int32_t*)last_seen, pool_capacity, (const int32_t*)vols, n_vols,
      (const int32_t*)slots, (const uint8_t*)mask, n_visible,
      (const float*)depth, (const uint8_t*)rgb, (const float*)w2c,
      (const float*)intr, (const int32_t*)frame_idx, frame, c);
  return (int)cudaGetLastError();
}
