// KH: prologue and epilogue of the inverse-skinning search (kernel KC).
//
// deform_prologue replaces the init pruning of
// intrinsicavatar_tpu/anim/deformer.py:264-286 (FastSNARF.search): per
// point, the squared distance of each bone's canonicalized start point
// R_b^T (p - t_b) to that bone's canonical segment, then the I nearest
// bones, lower slot first on ties (jax.lax.top_k(-d) and a stable
// ascending argsort order ties so).
//
// deform_epilogue replaces intrinsicavatar_tpu/anim/broyden.py:518
// (filter_duplicates_soa) and anim/deformer.py:380-394 (the ovf_candidates
// count and the first K survivors in lane order, via stable_partition_rows):
// a root is dropped when a later valid root lies within `thresh` of it; the
// first K survivors are kept, then (when fewer survive) the first lanes that
// did not, in lane order.
//
// deform_skinning replaces anim/deformer.py:235 (query_weights: 24-channel
// trilinear sample, border padding, align_corners, corners summed in
// (dx, dy, dz) order with dz fastest) and anim/broyden.py:550
// (forward_skinning_soa): the rotation rows of sum_b w_b tfs[b, :3, :3] at
// each kept lane.  The eval path launches it only where the query reads the
// rotation (a gradient query without use_j_inv).
//
// deform_skinning_bwd (kernel KN) replaces the backward with respect to tfs
// of anim/deformer.py:396-412 (the train-mode implicit-function correction
// x_c - v J^-1 (x_d(x_c, tfs) - sg(x_d))) through anim/broyden.py:550
// (forward_skinning_soa), and of the blended rotation beside it.  Per lane
// m, with the detached root x_m, x^_m = (x, y, z, 1), its validity v_m, its
// 24 LBS weights w_m (sampled as deform_skinning samples them), J^-1_m and
// the cotangents g_m of the corrected root and R_m of the rotation rows:
//   rho_m     = -v_m J^-1_m^T g_m
//   U_m[a, c] = rho_m[a] x^_m[c] + (c < 3 ? R_m[a, c] : 0)     (3 x 4)
//   d tfs[b, a, c] = sum_m w_m[b] U_m[a, c]  (a < 3; row 3 of tfs gets 0)
//
// What bounds them on an H100: bytes.  The prologue reads 12 B and writes
// 4 I B per point with ~40 flops per bone; the epilogue reads I x 13 B
// (x and valid of every lane) and K x 36 B (j_inv of the kept lanes only)
// and writes K x 49 B per point; the skinning reads 8 corners x 96 B of the
// 50 MB weight voxel per lane (counted once per lane, as the sample's
// input), the 24 bones' 3 x 3 rotations once, and writes 36 B.  KN reads
// 97 B a lane (root, validity, J^-1 and both cotangents) and the weight
// rows its lanes' corners touch, ~1,000 flops a lane, and writes 288
// floats: at the train step's 1,474,560 lanes (a quarter of the voxel's
// rows touched) its bound on an H100 is ~0.047 ms, by bytes (chip_smoke.py).
// Its order of sums is fixed, so a check can bound its rounding
// (anim/broyden.py:deform_skinning_bwd_exact).
//
// Design: one thread per point for the prologue and for the filter and
// first-K, with the I candidates in per-thread arrays (indexed at run time,
// so they live in local memory); one thread per kept lane for
// the weight sample and blend, each corner read as 6 x float4 of the
// channel-last voxel.  The arithmetic follows the plain versions' order,
// so with -fmad=false the prologue's distances and the epilogue's filter
// equal theirs.  The blend sums the 24 bones in order, where the plain
// version's matrix product sums in the library's order.  KN is a reduction
// of every lane into 288 floats, done without float atomics, so that it is
// the same from run to run: pass 1 gives each of G blocks 288 threads; a
// thread computes one lane's w and U into shared memory (a tile of 288
// lanes), then sums one of the 288 (b, a * 4 + c) entries over the tile,
// and carries it across a grid-stride loop over tiles into a [G, 288]
// scratch row; pass 2 sums the G rows in block order.  The reduction is a
// [24 x M] . [M x 12] product that tensor cores could take: later work.
#include "common.cuh"

namespace {

constexpr int kMaxInit = 16;
constexpr int kBones = 24;

__global__ void prologue_kernel(const float* __restrict__ pts,
                                const float* __restrict__ tfs,
                                const float* __restrict__ segs, int64_t N,
                                int n_all, int I, int* __restrict__ slot) {
  const int64_t n = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  const float px = pts[n * 3], py = pts[n * 3 + 1], pz = pts[n * 3 + 2];
  float best[kMaxInit];
  int idx[kMaxInit];
  int filled = 0;
  for (int s = 0; s < n_all; ++s) {
    const float* T = tfs + s * 16;  // [4, 4] row-major
    const float* g = segs + s * 7;  // a (3), b - a (3), |b - a|^2 + 1e-9
    const float dx = px - T[3], dy = py - T[7], dz = pz - T[11];
    const float xi = T[0] * dx + T[4] * dy + T[8] * dz;
    const float yi = T[1] * dx + T[5] * dy + T[9] * dz;
    const float zi = T[2] * dx + T[6] * dy + T[10] * dz;
    float t = ((xi - g[0]) * g[3] + (yi - g[1]) * g[4] + (zi - g[2]) * g[5])
              / g[6];
    t = fminf(fmaxf(t, 0.f), 1.f);
    const float ex = xi - (g[0] + t * g[3]);
    const float ey = yi - (g[1] + t * g[4]);
    const float ez = zi - (g[2] + t * g[5]);
    const float d = ex * ex + ey * ey + ez * ez;
    if (filled == I && !(d < best[I - 1])) continue;
    int p = filled < I ? filled++ : I - 1;
    // insert after every kept entry <= d: equal distances keep slot order
    for (; p > 0 && d < best[p - 1]; --p) {
      best[p] = best[p - 1];
      idx[p] = idx[p - 1];
    }
    best[p] = d;
    idx[p] = s;
  }
  for (int k = 0; k < I; ++k) slot[n * I + k] = idx[k];
}

__global__ void epilogue_kernel(const float* __restrict__ x,
                                const float* __restrict__ jinv,
                                const uint8_t* __restrict__ valid, int64_t N,
                                int I, int K, float thresh2,
                                float* __restrict__ xc,
                                float* __restrict__ jinv_out,
                                uint8_t* __restrict__ valid_out,
                                unsigned long long* __restrict__ overflow) {
  const int64_t n = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  unsigned long long ovf = 0;
  if (n < N) {
    float cx[kMaxInit], cy[kMaxInit], cz[kMaxInit];
    bool v[kMaxInit], keep[kMaxInit];
    for (int i = 0; i < I; ++i) {
      const int64_t m = n * I + i;
      cx[i] = x[m * 3];
      cy[i] = x[m * 3 + 1];
      cz[i] = x[m * 3 + 2];
      v[i] = valid[m] != 0;
    }
    int survivors = 0;
    for (int i = 0; i < I; ++i) {
      bool dup = false;
      for (int j = i + 1; j < I; ++j) {
        const float ax = cx[i] - cx[j], ay = cy[i] - cy[j],
                    az = cz[i] - cz[j];
        dup |= v[j] && (ax * ax + ay * ay + az * az < thresh2);
      }
      keep[i] = v[i] && !dup;
      survivors += keep[i] ? 1 : 0;
    }
    ovf = survivors > K ? (unsigned long long)(survivors - K) : 0ull;
    int k = 0;
    for (int pass = 0; pass < 2; ++pass) {
      for (int i = 0; i < I && k < K; ++i) {
        if (keep[i] != (pass == 0)) continue;
        const int64_t m = n * I + i, q = n * K + k;
        xc[q * 3] = cx[i];
        xc[q * 3 + 1] = cy[i];
        xc[q * 3 + 2] = cz[i];
        for (int c = 0; c < 9; ++c) jinv_out[q * 9 + c] = jinv[m * 9 + c];
        valid_out[q] = keep[i];
        ++k;
      }
    }
  }
  for (int off = 16; off > 0; off >>= 1)
    ovf += __shfl_down_sync(0xffffffffu, ovf, off);
  if ((threadIdx.x & 31) == 0 && ovf) atomicAdd(overflow, ovf);
}

// The 24 LBS weights at a canonical point: trilinear, border padding,
// align_corners, corners summed in (dx, dy, dz) order with dz fastest.
__device__ __forceinline__ void sample_weights(
    const float* __restrict__ xc, int64_t q, const float* __restrict__ vox,
    int D, int H, int W, float ox, float oy, float oz, float scale,
    float ratio, float* w) {
  const float cx = (xc[q * 3] - ox) / scale;
  const float cy = (xc[q * 3 + 1] - oy) / scale;
  const float cz = (xc[q * 3 + 2] - oz) / scale * ratio;
  const float ix = fminf(fmaxf((cx + 1.f) * 0.5f * (float)(W - 1), 0.f),
                         (float)(W - 1));
  const float iy = fminf(fmaxf((cy + 1.f) * 0.5f * (float)(H - 1), 0.f),
                         (float)(H - 1));
  const float iz = fminf(fmaxf((cz + 1.f) * 0.5f * (float)(D - 1), 0.f),
                         (float)(D - 1));
  const float x0f = floorf(ix), y0f = floorf(iy), z0f = floorf(iz);
  const float fx = ix - x0f, fy = iy - y0f, fz = iz - z0f;
  const int x0 = (int)x0f, y0 = (int)y0f, z0 = (int)z0f;
  for (int b = 0; b < kBones; ++b) w[b] = 0.f;
  for (int k = 0; k < 8; ++k) {
    const int dx = k >> 2, dy = (k >> 1) & 1, dz = k & 1;
    const float wx = dx ? fx : 1.f - fx;
    const float wy = dy ? fy : 1.f - fy;
    const float wz = dz ? fz : 1.f - fz;
    const float wc = wx * wy * wz;
    const int px = min(x0 + dx, W - 1), py = min(y0 + dy, H - 1),
              pz = min(z0 + dz, D - 1);
    const float4* row = reinterpret_cast<const float4*>(
        vox + (((int64_t)pz * H + py) * W + px) * kBones);
    for (int c = 0; c < kBones / 4; ++c) {
      const float4 a = __ldg(row + c);
      w[4 * c] = w[4 * c] + wc * a.x;
      w[4 * c + 1] = w[4 * c + 1] + wc * a.y;
      w[4 * c + 2] = w[4 * c + 2] + wc * a.z;
      w[4 * c + 3] = w[4 * c + 3] + wc * a.w;
    }
  }
}

__global__ void skinning_kernel(const float* __restrict__ xc,
                                const float* __restrict__ vox,
                                const float* __restrict__ tfs, int64_t M,
                                int D, int H, int W, float ox, float oy,
                                float oz, float scale, float ratio,
                                float* __restrict__ rot) {
  const int64_t q = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= M) return;
  float w[kBones];
  sample_weights(xc, q, vox, D, H, W, ox, oy, oz, scale, ratio, w);
  for (int r = 0; r < 3; ++r)
    for (int c = 0; c < 3; ++c) {
      float acc = 0.f;
      for (int b = 0; b < kBones; ++b) acc += w[b] * tfs[b * 16 + r * 4 + c];
      rot[q * 9 + r * 3 + c] = acc;
    }
}

constexpr int kEntries = kBones * 12;  // (b, a * 4 + c) of d tfs, a < 3
constexpr int kTile = kEntries;        // lanes a tile = threads a block
constexpr int kWStride = kBones + 1;   // odd row strides: no bank conflicts
constexpr int kUStride = 13;

__global__ void __launch_bounds__(kTile) skinning_bwd_partial_kernel(
    const float* __restrict__ xc, const uint8_t* __restrict__ valid,
    const float* __restrict__ jinv, const float* __restrict__ g_xc,
    const float* __restrict__ g_rot, const float* __restrict__ vox,
    int64_t M, int D, int H, int W, float ox, float oy, float oz,
    float scale, float ratio, float* __restrict__ partial) {
  __shared__ float sw[kTile * kWStride];
  __shared__ float su[kTile * kUStride];
  const int t = threadIdx.x;
  const int b = t / 12, k = t % 12;  // the entry this thread sums
  float acc = 0.f;
  const int64_t n_tiles = (M + kTile - 1) / kTile;
  for (int64_t tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int64_t q = tile * kTile + t;
    float* w = sw + t * kWStride;
    float* u = su + t * kUStride;
    if (q < M) {
      float wl[kBones];
      sample_weights(xc, q, vox, D, H, W, ox, oy, oz, scale, ratio, wl);
      for (int bb = 0; bb < kBones; ++bb) w[bb] = wl[bb];
      const float v = valid[q] ? 1.f : 0.f;
      const float* J = jinv + q * 9;
      const float g0 = g_xc[q * 3], g1 = g_xc[q * 3 + 1],
                  g2 = g_xc[q * 3 + 2];
      const float xh[4] = {xc[q * 3], xc[q * 3 + 1], xc[q * 3 + 2], 1.f};
      for (int a = 0; a < 3; ++a) {
        const float rho = -(v * (J[a] * g0 + J[3 + a] * g1 + J[6 + a] * g2));
        for (int c = 0; c < 4; ++c) {
          float e = rho * xh[c];
          if (c < 3 && g_rot != nullptr) e = e + g_rot[q * 9 + a * 3 + c];
          u[a * 4 + c] = e;
        }
      }
    } else {
      for (int bb = 0; bb < kBones; ++bb) w[bb] = 0.f;
      for (int e = 0; e < 12; ++e) u[e] = 0.f;
    }
    __syncthreads();
    for (int l = 0; l < kTile; ++l)
      acc = acc + sw[l * kWStride + b] * su[l * kUStride + k];
    __syncthreads();
  }
  partial[(int64_t)blockIdx.x * kEntries + t] = acc;
}

__global__ void __launch_bounds__(kEntries) skinning_bwd_sum_kernel(
    const float* __restrict__ partial, int G, float* __restrict__ d_tfs) {
  const int t = threadIdx.x;
  float acc = 0.f;
  for (int g = 0; g < G; ++g) acc = acc + partial[(int64_t)g * kEntries + t];
  const int b = t / 12, k = t % 12;
  d_tfs[b * 16 + k] = acc;  // row a = k / 4, column c = k % 4
  if (k < 4) d_tfs[b * 16 + 12 + k] = 0.f;
}

}  // namespace

extern "C" int deform_prologue_fwd(const float* pts, const float* tfs,
                                   const float* segs, long long N, int n_all,
                                   int I, int* slot, void* stream) {
  if (N <= 0) return 0;
  if (I < 1 || I > n_all || I > kMaxInit) return (int)cudaErrorInvalidValue;
  const int threads = 128;
  unsigned blocks = (unsigned)((N + threads - 1) / threads);
  prologue_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      pts, tfs, segs, N, n_all, I, slot);
  return launch_status();
}

extern "C" int deform_epilogue_fwd(const float* x, const float* jinv,
                                   const uint8_t* valid, long long N, int I,
                                   int K, float thresh2, float* xc,
                                   float* jinv_out, uint8_t* valid_out,
                                   unsigned long long* overflow,
                                   void* stream) {
  if (N <= 0) return 0;
  if (I < 1 || I > kMaxInit || K < 1 || K > I)
    return (int)cudaErrorInvalidValue;
  const int threads = 128;
  unsigned blocks = (unsigned)((N + threads - 1) / threads);
  epilogue_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      x, jinv, valid, N, I, K, thresh2, xc, jinv_out, valid_out, overflow);
  return launch_status();
}

extern "C" int deform_skinning_fwd(const float* xc, const float* vox,
                                   const float* tfs, long long M, int D,
                                   int H, int W, float ox, float oy, float oz,
                                   float scale, float ratio, float* rot,
                                   void* stream) {
  if (M <= 0) return 0;
  const int threads = 128;
  unsigned blocks = (unsigned)((M + threads - 1) / threads);
  skinning_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      xc, vox, tfs, M, D, H, W, ox, oy, oz, scale, ratio, rot);
  return launch_status();
}

extern "C" int deform_skinning_bwd(const float* xc, const uint8_t* valid,
                                   const float* jinv, const float* g_xc,
                                   const float* g_rot, const float* vox,
                                   long long M, int D, int H, int W,
                                   float ox, float oy, float oz, float scale,
                                   float ratio, float* partial, int G,
                                   float* d_tfs, void* stream) {
  if (G < 1) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (M > 0)
    skinning_bwd_partial_kernel<<<G, kTile, 0, s>>>(
        xc, valid, jinv, g_xc, g_rot, vox, M, D, H, W, ox, oy, oz, scale,
        ratio, partial);
  skinning_bwd_sum_kernel<<<1, kEntries, 0, s>>>(partial, M > 0 ? G : 0,
                                                 d_tfs);
  return launch_status();
}
