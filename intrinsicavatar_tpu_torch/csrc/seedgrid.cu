// KM: the eval seed grid's gather (seed_gather_fwd).
//
// Replaces intrinsicavatar_tpu/anim/seedgrid.py:173 gather_from_grid (and
// :252 seed_from_grid, its two-output view).  Per point: map it into the
// lattice's [-1, 1]^3 frame, n = (p - center) / half; mark it inside when
// every |n| <= 1 + 1/(res - 1); find its cell by the align-corners "border"
// sampler (ix = ((n + 1) * 0.5) * (res - 1), clipped to [0, res - 1], then
// floored; a +1 corner past the last node clamps onto it); read the cell's
// 8 corner nodes, ordered (dx, dy, dz) with dz fastest, weights
// (wx * wy) * wz.  Then:
//   seed_ok  = some corner is valid (channel 3) and the point is inside;
//   coherent = max over valid corners of |xc_k - mean|^2 <= coh^2 * diag^2,
//              mean over all 8 pre-masked corners / max(#valid, 1);
//   seed_xc  = coherent ? sum w ok xc / max(sum w ok, 1e-9)
//                       : xc of argmax(w ok + ok 1e-6), first on ties;
//   sdf      = the same choice under the SDF channel's own validity
//              (channel 5), 1e5 where no corner is SDF-valid or outside.
//
// What bounds it on an H100: bytes.  A point reads 12 B and writes 17 B
// (seed 12, ok 1, sdf 4); its 8 corners of C floats come from the grid,
// 21.2 MB at 96^3 x 6, which the card's 50 MB L2 holds, so the grid is
// counted once at its size.  The arithmetic is ~300 flops a point.
//
// Design: one thread per point, the 8 corners' channels kept in registers
// (the loops over corners unroll, so the arrays are indexed at compile
// time); no shared-memory staging.  The grid is channel-last [res, res, res,
// C] (the JAX package's 8x corner packing is a TPU layout).  Every sum over
// the corners runs in corner order, as the plain twin sums, so with
// -fmad=false the floor, the weights and the coherence test round as the
// twin's do.
#include "common.cuh"

namespace {

template <int C>
__global__ void seed_gather_kernel(const float* __restrict__ pts,
                                   const float* __restrict__ grid,
                                   const float* __restrict__ center,
                                   const float* __restrict__ half,
                                   int64_t N, int res, float slack,
                                   float coh2, float* __restrict__ seed_xc,
                                   bool* __restrict__ seed_ok,
                                   float* __restrict__ sdf_out) {
  const int64_t n = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  const float rm1 = (float)(res - 1);
  float nc[3], f[3];
  int i0[3];
  bool inside = true;
  for (int a = 0; a < 3; ++a) {
    nc[a] = (pts[n * 3 + a] - center[a]) / half[a];
    inside = inside && fabsf(nc[a]) <= slack;
    float i = (nc[a] + 1.f) * 0.5f * rm1;
    i = fminf(fmaxf(i, 0.f), rm1);
    const float fl = floorf(i);
    i0[a] = (int)fl;
    f[a] = i - fl;
  }
  float w[8], xc[8][3], ok[8];
  float sd[8], sok[8];
  bool any_ok = false, any_sok = false;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int dx = k >> 2, dy = (k >> 1) & 1, dz = k & 1;
    const int x = min(i0[0] + dx, res - 1), y = min(i0[1] + dy, res - 1),
              z = min(i0[2] + dz, res - 1);
    const float wx = dx ? f[0] : 1.f - f[0];
    const float wy = dy ? f[1] : 1.f - f[1];
    const float wz = dz ? f[2] : 1.f - f[2];
    w[k] = wx * wy * wz;
    const float* row = grid + (((int64_t)z * res + y) * res + x) * C;
    xc[k][0] = __ldg(row);
    xc[k][1] = __ldg(row + 1);
    xc[k][2] = __ldg(row + 2);
    const bool v = __ldg(row + 3) > 0.5f;
    ok[k] = v ? 1.f : 0.f;
    any_ok = any_ok || v;
    if (C == 6) {
      sd[k] = __ldg(row + 4);
      const bool s = __ldg(row + 5) > 0.5f;
      sok[k] = s ? 1.f : 0.f;
      any_sok = any_sok || s;
    }
  }
  // blend, mean and coherence, each sum in corner order
  float den = 0.f, tri[3] = {0.f, 0.f, 0.f}, sum[3] = {0.f, 0.f, 0.f};
  float n_ok = 0.f;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const float wok = w[k] * ok[k];
    den = den + wok;
    for (int c = 0; c < 3; ++c) {
      tri[c] = tri[c] + wok * xc[k][c];
      sum[c] = sum[c] + xc[k][c];
    }
    n_ok = n_ok + ok[k];
  }
  const float inv_den = fmaxf(den, 1e-9f);
  const float cnt = fmaxf(n_ok, 1.f);
  float mean[3];
  for (int c = 0; c < 3; ++c) mean[c] = sum[c] / cnt;
  float dev2 = 0.f;
  int near = 0;
  float best = -1.f;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const float ex = xc[k][0] - mean[0], ey = xc[k][1] - mean[1],
                ez = xc[k][2] - mean[2];
    const float d = (ex * ex + ey * ey + ez * ez) * ok[k];
    dev2 = k == 0 ? d : fmaxf(dev2, d);
    const float score = w[k] * ok[k] + ok[k] * 1e-6f;
    if (k == 0 || score > best) {
      best = score;
      near = k;
    }
  }
  float diag2 = 0.f;
  for (int a = 0; a < 3; ++a) {
    const float e = 2.f * half[a] / rm1;
    diag2 = diag2 + e * e;
  }
  const bool coherent = dev2 <= coh2 * diag2;
  for (int c = 0; c < 3; ++c) {
    float v = xc[0][c];
#pragma unroll
    for (int k = 1; k < 8; ++k) v = k == near ? xc[k][c] : v;
    seed_xc[n * 3 + c] = coherent ? tri[c] / inv_den : v;
  }
  seed_ok[n] = any_ok && inside;
  if (C == 6) {
    float sden = 0.f, snum = 0.f;
    int snear = 0;
    float sbest = -1.f;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const float wsok = w[k] * sok[k];
      snum = snum + wsok * sd[k];
      sden = sden + wsok;
      const float score = wsok + sok[k] * 1e-6f;
      if (k == 0 || score > sbest) {
        sbest = score;
        snear = k;
      }
    }
    float v = sd[0];
#pragma unroll
    for (int k = 1; k < 8; ++k) v = k == snear ? sd[k] : v;
    const float s = coherent ? snum / fmaxf(sden, 1e-9f) : v;
    sdf_out[n] = (any_sok && inside) ? s : 1e5f;
  }
}

}  // namespace

extern "C" int seed_gather_fwd(const float* pts, const float* grid,
                               const float* center, const float* half,
                               long long N, int res, int C, float slack,
                               float coh2, float* seed_xc, bool* seed_ok,
                               float* sdf, void* stream) {
  if (N <= 0) return 0;
  const int threads = 128;
  unsigned blocks = (unsigned)((N + threads - 1) / threads);
  cudaStream_t s = (cudaStream_t)stream;
  if (C == 6)
    seed_gather_kernel<6><<<blocks, threads, 0, s>>>(
        pts, grid, center, half, N, res, slack, coh2, seed_xc, seed_ok, sdf);
  else if (C == 4)
    seed_gather_kernel<4><<<blocks, threads, 0, s>>>(
        pts, grid, center, half, N, res, slack, coh2, seed_xc, seed_ok, sdf);
  else
    return (int)cudaErrorInvalidValue;
  return launch_status();
}
