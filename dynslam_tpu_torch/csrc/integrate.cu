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
// Form: a grid of (visible entry, volume), one CTA per entry of a
// volume's visible list, one thread per voxel (512 threads). The volume
// axis fuses several maps of one stacked pool (S, P, 512) in one launch,
// each from its own view: the dynamic step's routed object volumes, each
// with its own bbox crop (depth, RGB), pose, principal point and frame
// index. It replaces the JAX package's vmap of the Pallas kernel over the
// S pooled volumes (fused_dynamic.py:572). The static map and a single
// object volume are the case of one volume. Each thread projects its
// voxel, reads depth and RGB straight from global memory (at 1242x375 both
// planes, ~3.3 MB, stay in L2), and rewrites its packed voxel word and
// colour word in place. Visible slots are unique within a volume and two
// volumes are distinct pool slots, so no two CTAs touch one pool row and
// no atomics are needed. The TPU kernel's tiers, compaction, one-hot MXU
// sampling and tile gates are not needed.
//
// Bound: the 2 x 4 bytes per voxel of pool read + write (plus the
// gathered pixel, mostly from L2); the arithmetic is a few dozen flops.
//
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

constexpr int kBlock3 = 512;

__global__ void integrate_kernel(
    int32_t* __restrict__ tsdf_w,              // (S, P, 512)
    int32_t* __restrict__ color,               // (S, P, 512)
    const int32_t* __restrict__ block_coords,  // (S, P, 3)
    int32_t* __restrict__ last_seen,           // (S, P)
    int pool_capacity,                         // P
    const int32_t* __restrict__ vols,          // (n,) pool slot of volume
    const int32_t* __restrict__ slots,         // (n, V)
    const uint8_t* __restrict__ mask,          // (n, V)
    int n_visible,                             // V
    const float* __restrict__ depth_all,       // (n, H, W) metres
    const uint8_t* __restrict__ rgb_all,       // (n, H, W, 3)
    const float* __restrict__ w2c_all,         // (n, 4, 4) row-major
    const float* __restrict__ intr_all,        // (n, 4) fx, fy, cx, cy
    const int32_t* __restrict__ frame_all,     // (n,)
    int img_h, int img_w, float voxel, float mu, float inv_mu,
    float mu_quarter, float inv_1000, float inv_sdf_scale, float max_weight,
    float min_depth, float max_depth, int depth_weighting) {
  const int vol = blockIdx.y;
  const int64_t entry = static_cast<int64_t>(vol) * n_visible + blockIdx.x;
  if (!mask[entry]) return;
  const int64_t slot =
      static_cast<int64_t>(vols[vol]) * pool_capacity + slots[entry];
  const int i = threadIdx.x;  // voxel index (x * 64 + y * 8 + z)
  const int64_t row = slot * kBlock3;
  const int64_t plane = static_cast<int64_t>(img_h) * img_w;
  const float* depth = depth_all + vol * plane;
  const uint8_t* rgb = rgb_all + vol * plane * 3;
  const float* w2c = w2c_all + vol * 16;
  const float* intr = intr_all + vol * 4;

  const float pwx = ((float)block_coords[3 * slot + 0] * 8.0f
                     + (float)(i >> 6) + 0.5f) * voxel;
  const float pwy = ((float)block_coords[3 * slot + 1] * 8.0f
                     + (float)((i >> 3) & 7) + 0.5f) * voxel;
  const float pwz = ((float)block_coords[3 * slot + 2] * 8.0f
                     + (float)(i & 7) + 0.5f) * voxel;
  const float pcx =
      fmaf(w2c[2], pwz, fmaf(w2c[1], pwy, w2c[0] * pwx)) + w2c[3];
  const float pcy =
      fmaf(w2c[6], pwz, fmaf(w2c[5], pwy, w2c[4] * pwx)) + w2c[7];
  const float z =
      fmaf(w2c[10], pwz, fmaf(w2c[9], pwy, w2c[8] * pwx)) + w2c[11];

  const float safe_z = fmaxf(z, 1e-3f);
  const float u = fmaf(pcx / safe_z, intr[0], intr[2]);
  const float v = fmaf(pcy / safe_z, intr[1], intr[3]);
  const bool in_img = u >= 0.0f && u <= (float)(img_w - 1) && v >= 0.0f
                      && v <= (float)(img_h - 1) && z > 1e-3f;
  const int ui = min(max(__float2int_rn(u), 0), img_w - 1);
  const int vi = min(max(__float2int_rn(v), 0), img_h - 1);
  const int px = vi * img_w + ui;

  const int d_mm = (int)fminf(fmaxf(depth[px] * 1000.0f, 0.0f), 65535.0f);
  const float d = (float)d_mm * inv_1000;
  const bool d_ok = d >= min_depth && d <= max_depth;
  const float eta = d - z;
  const bool update = in_img && d_ok && eta > -mu;
  const float sdf_obs = fminf(fmaxf(eta * inv_mu, -1.0f), 1.0f);

  float w_obs = 1.0f;
  if (depth_weighting) {
    const float q = max_depth / fmaxf(d, 0.5f);
    w_obs = fminf(fmaxf(q * q, 0.25f), 5.0f);
  }
  if (!update) w_obs = 0.0f;

  const int32_t packed_old = tsdf_w[row + i];
  const float w_old = (float)(packed_old & 0xFFFF) / 64.0f;
  const float t_old = (float)(packed_old >> 16) * inv_sdf_scale;
  const float w_new = fminf(w_old + w_obs, max_weight);
  const float den = fmaxf(w_old + w_obs, 1e-6f);
  const float t_new =
      w_obs > 0.0f ? fmaf(t_old, w_old, sdf_obs * w_obs) / den : t_old;
  const int s = (int)fminf(fmaxf(rintf(t_new * 32767.0f), -32767.0f), 32767.0f);
  const int w = (int)fminf(fmaxf(rintf(w_new * 64.0f), 0.0f), 65535.0f);
  // build (s << 16) | w through uint32_t: shifting a negative int is UB
  tsdf_w[row + i] = (int32_t)(((uint32_t)s << 16) | (uint32_t)w);

  const int32_t c_old = color[row + i];
  float c[3] = {(float)((c_old >> 16) & 0xFF), (float)((c_old >> 8) & 0xFF),
                (float)(c_old & 0xFF)};
  if (update && fabsf(eta) < mu_quarter) {
    for (int k = 0; k < 3; ++k) {
      c[k] = fmaf(c[k], w_old, (float)rgb[3 * px + k] * w_obs) / den;
    }
  }
  int q[3];
  for (int k = 0; k < 3; ++k) {
    q[k] = (int)fminf(fmaxf(c[k] + 0.5f, 0.0f), 255.0f);
  }
  color[row + i] = (q[0] << 16) | (q[1] << 8) | q[2];

  if (i == 0) last_seen[slot] = frame_all[vol];
}

}  // namespace

extern "C" int dynslam_integrate(
    void* tsdf_w, void* color, const void* block_coords, void* last_seen,
    int pool_capacity, const void* vols, int n_vols, const void* slots,
    const void* mask, int n_visible, const void* depth, const void* rgb,
    const void* w2c, const void* intr, const void* frame_idx, int img_h,
    int img_w, float voxel, float mu, float inv_mu, float mu_quarter,
    float inv_1000, float inv_sdf_scale, float max_weight, float min_depth,
    float max_depth, int depth_weighting, void* stream) {
  if (n_visible <= 0 || n_vols <= 0) return 0;
  const dim3 grid(n_visible, n_vols);
  integrate_kernel<<<grid, kBlock3, 0, (cudaStream_t)stream>>>(
      (int32_t*)tsdf_w, (int32_t*)color, (const int32_t*)block_coords,
      (int32_t*)last_seen, pool_capacity, (const int32_t*)vols,
      (const int32_t*)slots, (const uint8_t*)mask, n_visible,
      (const float*)depth, (const uint8_t*)rgb, (const float*)w2c,
      (const float*)intr, (const int32_t*)frame_idx, img_h, img_w, voxel, mu,
      inv_mu, mu_quarter, inv_1000, inv_sdf_scale, max_weight, min_depth,
      max_depth, depth_weighting);
  return (int)cudaGetLastError();
}
