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
// (seed 12, ok 1, sdf 4); its 8 corners come from the grid, 28.3 MB of
// 32 B node records at 96^3, which the card's 50 MB L2 holds, so the grid is
// counted at most once (the rows the points touch).  The arithmetic is ~300
// flops a point.
//
// Design: one thread per point, 256 a block, at most 64 registers.  Each
// node is a 32 B record, its C channels zero-padded to 8 floats
// (anim/seedgrid.py:node_records), so a corner is one 16 B load (x_c, y_c,
// z_c, ok) and, with the SDF channel, one 8 B load (sdf, sdf_ok), each
// record inside one 32 B sector; the x-neighbour pair of a cell is 64
// contiguous bytes.  The JAX package's 8x corner packing is a TPU layout
// and is not copied.  One pass over the corners sums the blend, the mean's
// numerator, the counts and the SDF blend and keeps the nearest valid
// corner's values as it goes (first on ties), so only the corners' roots
// and validity stay in registers for the coherence test.  The points come
// in and the seeds go out through shared memory, coalesced; the lattice's
// coherence threshold is computed once a block.  Every sum over the corners
// runs in corner order, as the plain twin sums, and every division the twin
// makes is a division here, so with -fmad=false the floor, the weights and
// the coherence test round as the twin's do.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int RECORD = 8;  // floats a node

template <int C>
__global__ void __launch_bounds__(THREADS, 4) seed_gather_kernel(
    const float* __restrict__ pts, const float* __restrict__ grid,
    const float* __restrict__ center, const float* __restrict__ half,
    int64_t N, int res, float slack, float coh2, float* __restrict__ seed_xc,
    bool* __restrict__ seed_ok, float* __restrict__ sdf_out) {
  __shared__ float s_xyz[THREADS * 3];  // the points in, the seeds out
  __shared__ float s_par[7];            // center, half, coherence threshold
  const int tid = threadIdx.x;
  const int64_t n0 = (int64_t)blockIdx.x * THREADS;
  const int rows = N - n0 < THREADS ? (int)(N - n0) : THREADS;
  const float rm1 = (float)(res - 1);
  if (tid < 3) {
    s_par[tid] = center[tid];
    s_par[3 + tid] = half[tid];
  }
  if (tid == 0) {
    float diag2 = 0.f;
    for (int a = 0; a < 3; ++a) {
      const float e = 2.f * half[a] / rm1;
      diag2 = diag2 + e * e;
    }
    s_par[6] = coh2 * diag2;
  }
  for (int e = tid; e < rows * 3; e += THREADS) s_xyz[e] = pts[n0 * 3 + e];
  __syncthreads();
  if (tid < rows) {
    const int64_t n = n0 + tid;
    float f[3];
    int i0[3];
    bool inside = true;
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const float nc = (s_xyz[tid * 3 + a] - s_par[a]) / s_par[3 + a];
      inside = inside && fabsf(nc) <= slack;
      float i = (nc + 1.f) * 0.5f * rm1;
      i = fminf(fmaxf(i, 0.f), rm1);
      const float fl = floorf(i);
      i0[a] = (int)fl;
      f[a] = i - fl;
    }
    const float4* rec = reinterpret_cast<const float4*>(grid);
    float xc[8][3], ok[8];
    float den = 0.f, tri[3] = {0.f, 0.f, 0.f}, sum[3] = {0.f, 0.f, 0.f};
    float n_ok = 0.f, best = -1.f, near[3] = {0.f, 0.f, 0.f};
    float sden = 0.f, snum = 0.f, sbest = -1.f, snear = 0.f;
    bool any_ok = false, any_sok = false;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int dx = k >> 2, dy = (k >> 1) & 1, dz = k & 1;
      const int x = min(i0[0] + dx, res - 1), y = min(i0[1] + dy, res - 1),
                z = min(i0[2] + dz, res - 1);
      const float wx = dx ? f[0] : 1.f - f[0];
      const float wy = dy ? f[1] : 1.f - f[1];
      const float wz = dz ? f[2] : 1.f - f[2];
      const float w = wx * wy * wz;
      const int64_t node = ((int64_t)z * res + y) * res + x;
      const float4 r = __ldg(rec + node * (RECORD / 4));
      xc[k][0] = r.x;
      xc[k][1] = r.y;
      xc[k][2] = r.z;
      const bool v = r.w > 0.5f;
      ok[k] = v ? 1.f : 0.f;
      any_ok = any_ok || v;
      const float wok = w * ok[k];
      den = den + wok;
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        tri[c] = tri[c] + wok * xc[k][c];
        sum[c] = sum[c] + xc[k][c];
      }
      n_ok = n_ok + ok[k];
      const float score = wok + ok[k] * 1e-6f;
      if (k == 0 || score > best) {
        best = score;
        near[0] = xc[k][0];
        near[1] = xc[k][1];
        near[2] = xc[k][2];
      }
      if (C == 6) {
        const float2 sv = __ldg(reinterpret_cast<const float2*>(
            rec + node * (RECORD / 4) + 1));
        const bool s = sv.y > 0.5f;
        const float sok = s ? 1.f : 0.f;
        any_sok = any_sok || s;
        const float wsok = w * sok;
        snum = snum + wsok * sv.x;
        sden = sden + wsok;
        const float sscore = wsok + sok * 1e-6f;
        if (k == 0 || sscore > sbest) {
          sbest = sscore;
          snear = sv.x;
        }
      }
    }
    const float cnt = fmaxf(n_ok, 1.f);
    float mean[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) mean[c] = sum[c] / cnt;
    float dev2 = 0.f;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const float ex = xc[k][0] - mean[0], ey = xc[k][1] - mean[1],
                  ez = xc[k][2] - mean[2];
      const float d = (ex * ex + ey * ey + ez * ez) * ok[k];
      dev2 = k == 0 ? d : fmaxf(dev2, d);
    }
    const bool coherent = dev2 <= s_par[6];
    const float inv_den = fmaxf(den, 1e-9f);
#pragma unroll
    for (int c = 0; c < 3; ++c)
      s_xyz[tid * 3 + c] = coherent ? tri[c] / inv_den : near[c];
    seed_ok[n] = any_ok && inside;
    if (C == 6) {
      const float s = coherent ? snum / fmaxf(sden, 1e-9f) : snear;
      sdf_out[n] = (any_sok && inside) ? s : 1e5f;
    }
  }
  __syncthreads();
  for (int e = tid; e < rows * 3; e += THREADS) seed_xc[n0 * 3 + e] = s_xyz[e];
}

}  // namespace

extern "C" int seed_gather_fwd(const float* pts, const float* grid,
                               const float* center, const float* half,
                               long long N, int res, int C, float slack,
                               float coh2, float* seed_xc, bool* seed_ok,
                               float* sdf, void* stream) {
  if (N <= 0) return 0;
  unsigned blocks = (unsigned)((N + THREADS - 1) / THREADS);
  cudaStream_t s = (cudaStream_t)stream;
  if (C == 6)
    seed_gather_kernel<6><<<blocks, THREADS, 0, s>>>(
        pts, grid, center, half, N, res, slack, coh2, seed_xc, seed_ok, sdf);
  else if (C == 4)
    seed_gather_kernel<4><<<blocks, THREADS, 0, s>>>(
        pts, grid, center, half, N, res, slack, coh2, seed_xc, seed_ok, sdf);
  else
    return (int)cudaErrorInvalidValue;
  return launch_status();
}
