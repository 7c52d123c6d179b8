// KC: Broyden inverse-LBS root search (broyden_search_fwd); KL: its seeded
// single-lane polish (broyden_polish_fwd), described above its kernel
// below.  Both run the same per-lane body, broyden_lane.
//
// KC:
// Replaces intrinsicavatar_tpu/anim/broyden.py:351-460 broyden_search (body
// :242-314), itself the TPU form of Fast-SNARF's broyden_kernel.  Per lane
// (point x initialization bone): start from the bone's inverse rigid
// transform, then up to max_iters Broyden steps on
// g(x) = J_vox(x) [x; 1] - x_d, where J_vox is a trilinear sample (zero
// padding, align_corners) of the 3x4 skinning-transform voxel, with rank-1
// "good Broyden" updates of J^-1; converged at |g| < cvg, diverged at
// |g| > dvg, valid only if the root lies inside the voxel's [-1, 1]^3.
//
// This is the single-phase loop (two_phase=False in the JAX op): the TPU's
// lane compaction after 4 iterations is a workaround for gathers priced per
// row, and no lane is dropped here.
//
// What bounds it on an H100: each sample of each live lane reads 8
// corners x 12 channels = 384 B of the 25 MB voxel, mostly from L1 and L2;
// the math is ~250 flops per sample.  Against the roofline the lane's
// inputs and outputs (target 12 B, bone index 4 B, root 12 B, J^-1 36 B,
// valid 1 B) are the bytes that must move, so the bound is set by bytes.
// The kernel's time is set by the L1's work on its 24 scattered 16-byte
// voxel loads a sample (a serve chunk's 6.3 M lanes take 15 M samples):
// the sectors each load instruction touches and the 384 B it returns to
// each lane.  A lane that has stopped issues none, so the idle lanes of a
// warp whose slowest lane runs on cost no loads, and lanes whose loads
// fall on one sector in the same instruction share it.
//
// Design: one thread per lane, 128-thread blocks, so a warp is 4 points x 8
// inits in the caller's point-major order: a point's inits converge on the
// same roots and then load the same rows in the same instruction.  (Lane
// refill within a tile, a tile staged through shared memory, lanes strided
// so a warp holds one init of 32 points, and persistent blocks were each
// slower on the card, as were a sample's 24 loads held in registers at
// once and its rows staged in shared memory by cp.async.)  The whole state
// (x, g, J^-1) lives in registers; the voxel is read channel-last
// ([D, H, W, 12]) so a corner is 48 contiguous bytes.  A cell that reaches
// into the voxel issues its 24 float4 corner loads without a branch: a
// corner outside reads the clamped row with weight 0, which adds +-0 to a
// sum that starts at +0 and so changes no bit of it.  A cell wholly
// outside (most lanes of a chunk's empty space start there) loads nothing.
#include "common.cuh"

namespace {

constexpr int KC_THREADS = 128;  // one lane a thread

struct Sampler {
  const float* vox;  // [D, H, W, 12]
  int D, H, W;
  float ox, oy, oz, sx, sy, sz;

  // 12 channels of the blended transform at canonical (x, y, z); the
  // corners are summed in the order k = dx * 4 + dy * 2 + dz
  __device__ void sample(float x, float y, float z, float* J) const {
    float cx = sx * (x - ox), cy = sy * (y - oy), cz = sz * (z - oz);
    float ix = (cx + 1.f) * 0.5f * (float)(W - 1);
    float iy = (cy + 1.f) * 0.5f * (float)(H - 1);
    float iz = (cz + 1.f) * 0.5f * (float)(D - 1);
    float fx0 = floorf(ix), fy0 = floorf(iy), fz0 = floorf(iz);
    // cells clamped to [-2, n]: both corners of a cell beyond the voxel
    // stay outside it, and x0 + 1 cannot overflow where the cast saturated
    int x0 = min(max((int)fx0, -2), W), y0 = min(max((int)fy0, -2), H),
        z0 = min(max((int)fz0, -2), D);
    float fx = ix - fx0, fy = iy - fy0, fz = iz - fz0;
#pragma unroll
    for (int c = 0; c < 12; ++c) J[c] = 0.f;
    // a cell wholly outside the voxel adds nothing: no loads
    if (x0 < -1 || x0 >= W || y0 < -1 || y0 >= H || z0 < -1 || z0 >= D)
      return;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      int dx = k >> 2, dy = (k >> 1) & 1, dz = k & 1;
      int px = x0 + dx, py = y0 + dy, pz = z0 + dz;
      bool inside = px >= 0 && px < W && py >= 0 && py < H && pz >= 0 &&
                    pz < D;
      const int64_t cell = ((int64_t)min(max(pz, 0), D - 1) * H
                            + min(max(py, 0), H - 1)) * W
                           + min(max(px, 0), W - 1);
      const float4* row = reinterpret_cast<const float4*>(vox + cell * 12);
      const float4 a = __ldg(row), b = __ldg(row + 1), c = __ldg(row + 2);
      float wx = dx ? fx : 1.f - fx;
      float wy = dy ? fy : 1.f - fy;
      float wz = dz ? fz : 1.f - fz;
      float w = inside ? wx * wy * wz : 0.f;
      J[0] += w * a.x; J[1] += w * a.y; J[2] += w * a.z; J[3] += w * a.w;
      J[4] += w * b.x; J[5] += w * b.y; J[6] += w * b.z; J[7] += w * b.w;
      J[8] += w * c.x; J[9] += w * c.y; J[10] += w * c.z; J[11] += w * c.w;
    }
  }

  __device__ bool in_bounds(float x, float y, float z) const {
    float cx = sx * (x - ox), cy = sy * (y - oy), cz = sz * (z - oz);
    return cx >= -1.f && cx <= 1.f && cy >= -1.f && cy <= 1.f &&
           cz >= -1.f && cz <= 1.f;
  }
};

// From canonical start (x, y, z): J^-1 starts as the transpose of the
// sampled rotation block, then up to max_iters Broyden steps toward target
// (tx, ty, tz).  Stores the lane's outputs: the root to xo, J^-1 to O and
// valid to vo where it converged inside the voxel, zeros otherwise.
__device__ __forceinline__ void broyden_lane(
    const Sampler& S, float x, float y, float z, float tx, float ty,
    float tz, int max_iters, float cvg2, float dvg2, float* __restrict__ xo,
    float* __restrict__ O, uint8_t* __restrict__ vo) {
  float J[12];
  S.sample(x, y, z, J);
  float J00 = J[0], J01 = J[4], J02 = J[8];
  float J10 = J[1], J11 = J[5], J12 = J[9];
  float J20 = J[2], J21 = J[6], J22 = J[10];
  float g0 = J[0] * x + J[1] * y + J[2] * z + J[3] - tx;
  float g1 = J[4] * x + J[5] * y + J[6] * z + J[7] - ty;
  float g2 = J[8] * x + J[9] * y + J[10] * z + J[11] - tz;
  bool converged = false;
  for (int it = 0; it < max_iters; ++it) {
    float u0 = -(J00 * g0 + J01 * g1 + J02 * g2);
    float u1 = -(J10 * g0 + J11 * g1 + J12 * g2);
    float u2 = -(J20 * g0 + J21 * g1 + J22 * g2);
    x = x + u0;
    y = y + u1;
    z = z + u2;
    S.sample(x, y, z, J);
    float n0 = J[0] * x + J[1] * y + J[2] * z + J[3] - tx;
    float n1 = J[4] * x + J[5] * y + J[6] * z + J[7] - ty;
    float n2 = J[8] * x + J[9] * y + J[10] * z + J[11] - tz;
    float nsq = n0 * n0 + n1 * n1 + n2 * n2;
    if (nsq < cvg2) {
      converged = true;
      break;
    }
    if (nsq > dvg2) break;
    // rank-1 update: c = u^T J^-1; s = c . dg; J^-1 += (u - J^-1 dg) c / s
    float d0 = n0 - g0, d1 = n1 - g1, d2 = n2 - g2;
    float c0 = J00 * u0 + J10 * u1 + J20 * u2;
    float c1 = J01 * u0 + J11 * u1 + J21 * u2;
    float c2 = J02 * u0 + J12 * u1 + J22 * u2;
    float sden = c0 * d0 + c1 * d1 + c2 * d2;
    float r0 = -(J00 * d0 + J01 * d1 + J02 * d2);
    float r1 = -(J10 * d0 + J11 * d1 + J12 * d2);
    float r2 = -(J20 * d0 + J21 * d1 + J22 * d2);
    float inv_s = fabsf(sden) > 1e-30f ? 1.f / sden : 0.f;
    float a0 = (r0 + u0) * inv_s, a1 = (r1 + u1) * inv_s,
          a2 = (r2 + u2) * inv_s;
    J00 = J00 + c0 * a0; J01 = J01 + c1 * a0; J02 = J02 + c2 * a0;
    J10 = J10 + c0 * a1; J11 = J11 + c1 * a1; J12 = J12 + c2 * a1;
    J20 = J20 + c0 * a2; J21 = J21 + c1 * a2; J22 = J22 + c2 * a2;
    g0 = n0; g1 = n1; g2 = n2;
  }
  const bool valid = converged && S.in_bounds(x, y, z);
  const float vf = valid ? 1.f : 0.f;
  if (!converged) {
    x = y = z = 0.f;
    J00 = J01 = J02 = J10 = J11 = J12 = J20 = J21 = J22 = 0.f;
  }
  xo[0] = x * vf; xo[1] = y * vf; xo[2] = z * vf;
  O[0] = J00 * vf; O[1] = J01 * vf; O[2] = J02 * vf;
  O[3] = J10 * vf; O[4] = J11 * vf; O[5] = J12 * vf;
  O[6] = J20 * vf; O[7] = J21 * vf; O[8] = J22 * vf;
  *vo = valid ? 1 : 0;
}

__global__ void __launch_bounds__(KC_THREADS) broyden_search_kernel(
    const float* __restrict__ xd, const int* __restrict__ bone_idx,
    const float* __restrict__ tfs, Sampler S, float* __restrict__ x_out,
    float* __restrict__ jinv_out, uint8_t* __restrict__ valid_out, int64_t M,
    int max_iters, float cvg2, float dvg2) {
  const int64_t m = (int64_t)blockIdx.x * KC_THREADS + threadIdx.x;
  if (m >= M) return;
  float tx = xd[m * 3], ty = xd[m * 3 + 1], tz = xd[m * 3 + 2];
  const float* T = tfs + (int64_t)bone_idx[m] * 16;  // [4, 4] row-major
  // x = R^T (x_d - t)
  float ddx = tx - __ldg(T + 3), ddy = ty - __ldg(T + 7),
        ddz = tz - __ldg(T + 11);
  float x = __ldg(T) * ddx + __ldg(T + 4) * ddy + __ldg(T + 8) * ddz;
  float y = __ldg(T + 1) * ddx + __ldg(T + 5) * ddy + __ldg(T + 9) * ddz;
  float z = __ldg(T + 2) * ddx + __ldg(T + 6) * ddy + __ldg(T + 10) * ddz;
  broyden_lane(S, x, y, z, tx, ty, tz, max_iters, cvg2, dvg2, x_out + m * 3,
               jinv_out + m * 9, valid_out + m);
}

// ---------------------------------------------------------------------------
// KL: seeded Broyden polish.
//
// Replaces intrinsicavatar_tpu/anim/broyden.py:464 broyden_polish, the
// warm start of the secondary fine pass (FastSNARF.deform_seeded,
// anim/deformer.py:476-537): one lane per point, started at a known-nearby
// canonical root (the seed) instead of the bone initializations, at most
// max_iters Broyden steps with KC's residual, thresholds and bounds test.
// A lane without a usable seed (seed_ok false) is done at entry and
// invalid; invalid lanes' outputs are zero.
//
// What bounds it on an H100: bytes.  Per lane it reads 12 B of target,
// 13 B of seed and writes 49 B, with up to max_iters + 1 trilinear samples
// of 384 B from the 25 MB voxel (mostly L2) and ~250 flops each.  At the
// path's calls few lanes are seeded, at the front of the budget where the
// compaction puts the valid slots (a phys step's fine pass ~1,200 of its
// 65,536, a relight chunk's ~1): the time is the unseeded lanes' zero rows
// and the seeded lanes' serial chain of samples, ~1 us an iteration.
//
// Design: KC's one thread per lane with its state in registers; the body is
// KC's own (broyden_lane), so a seed that KC's search would reach gives the
// same iterates. Two forms, by the call's size. Calls of up to
// KL_SPREAD_MAX lanes (a fine pass's budget) take the spread form: each
// warp writes its 32 consecutive lanes' zero rows with 16-byte stores where
// a word holds no seeded lane's bytes (13 scalar stores a lane took 7 us of
// a 65,536-lane call on an H100), and thread t of block b polishes lane
// 4 (b + gridDim.x (t / 4)) + t % 4, so the seeded front's 4-lane chunks
// spread over every block and multiprocessor, where in lane order they
// filled the first few. Larger calls (a grid-seeded shading pass, a
// third of its lanes seeded) take the lane-order form, whose 102 registers
// keep more warps in flight. (A group of 2, 4 or 8 lanes a point sharing
// each sample through shared memory, packing a block's seeded lanes into
// its first warps, and register caps were each slower at the recorded
// calls: PERF.md.)
// ---------------------------------------------------------------------------

constexpr int KL_THREADS = 128;
// calls of up to this many lanes (a fine pass's budget, at most 131,072)
// take the spread form; larger ones the lane-order form
constexpr long long KL_SPREAD_MAX = 1 << 17;

// Zeros to the unseeded rows of a warp's n <= 32 consecutive points at
// dst (per elements of T each, 16-byte aligned; `seeded` their bits), 16
// bytes a store where a word holds no seeded point's bytes.
template <int per, typename T>
__device__ __forceinline__ void zero_warp_rows(T* __restrict__ dst, int n,
                                               unsigned seeded, int lane) {
  constexpr int W = 16 / sizeof(T);
  const int len = n * per;
  for (int wd = lane; wd * W < len; wd += 32) {
    bool whole = (wd + 1) * W <= len;
#pragma unroll
    for (int q = 0; q < W; ++q)
      whole = whole && !((seeded >> ((wd * W + q) / per)) & 1u);
    if (whole) {
      reinterpret_cast<uint4*>(dst)[wd] = make_uint4(0u, 0u, 0u, 0u);
      continue;
    }
    for (int q = 0; q < W && wd * W + q < len; ++q)
      if (!((seeded >> ((wd * W + q) / per)) & 1u)) dst[wd * W + q] = T(0);
  }
}

// The spread form: each warp writes its 32 consecutive lanes' zero rows,
// then each thread polishes the lane of its slot, in 4-lane chunks spread
// over the blocks, if that lane is seeded (the slots are a permutation of
// the lanes, so the outputs do not depend on it).  One block an SM is
// all it asks of occupancy, so the compiler keeps a sample's loads in
// flight together (161 registers; 96 without the bound, 13% slower at a
// fine pass on an H100).
__global__ void __launch_bounds__(KL_THREADS, 1)
broyden_polish_kernel_spread(
    const float* __restrict__ xd, const float* __restrict__ seed,
    const uint8_t* __restrict__ seed_ok, Sampler S,
    float* __restrict__ x_out, float* __restrict__ jinv_out,
    uint8_t* __restrict__ valid_out, int64_t M, int max_iters, float cvg2,
    float dvg2) {
  const int t = threadIdx.x, lane = t & 31;
  const int64_t mt = (int64_t)blockIdx.x * KL_THREADS + t;
  const unsigned seeded =
      __ballot_sync(0xffffffffu, mt < M && seed_ok[mt] != 0);
  const int64_t w0 = mt - lane;
  if (w0 < M) {
    const int n = (int)min((int64_t)32, M - w0);
    zero_warp_rows<3>(x_out + w0 * 3, n, seeded, lane);
    zero_warp_rows<9>(jinv_out + w0 * 9, n, seeded, lane);
    zero_warp_rows<1>(valid_out + w0, n, seeded, lane);
  }
  const int64_t m =
      4 * ((int64_t)blockIdx.x + (int64_t)gridDim.x * (t >> 2)) + (t & 3);
  if (m < M && seed_ok[m] != 0)
    broyden_lane(S, seed[m * 3], seed[m * 3 + 1], seed[m * 3 + 2],
                 xd[m * 3], xd[m * 3 + 1], xd[m * 3 + 2], max_iters, cvg2,
                 dvg2, x_out + m * 3, jinv_out + m * 9, valid_out + m);
}

// The lane-order form: thread t of block b takes lane 128 b + t; an
// unseeded lane stores its zeros.
__global__ void broyden_polish_kernel(
    const float* __restrict__ xd, const float* __restrict__ seed,
    const uint8_t* __restrict__ seed_ok, Sampler S,
    float* __restrict__ x_out, float* __restrict__ jinv_out,
    uint8_t* __restrict__ valid_out, int64_t M, int max_iters, float cvg2,
    float dvg2) {
  int64_t m = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (m >= M) return;
  if (!seed_ok[m]) {  // no seed: invalid, zeros
    for (int a = 0; a < 3; ++a) x_out[m * 3 + a] = 0.f;
    for (int i = 0; i < 9; ++i) jinv_out[m * 9 + i] = 0.f;
    valid_out[m] = 0;
    return;
  }
  broyden_lane(S, seed[m * 3], seed[m * 3 + 1], seed[m * 3 + 2], xd[m * 3],
               xd[m * 3 + 1], xd[m * 3 + 2], max_iters, cvg2, dvg2,
               x_out + m * 3, jinv_out + m * 9, valid_out + m);
}

}  // namespace

extern "C" int broyden_search_fwd(const float* xd, const int* bone_idx,
                                  const float* tfs, const float* vox,
                                  float* x_out, float* jinv_out,
                                  uint8_t* valid_out, long long M,
                                  int D, int H, int W,
                                  int max_iters, float ox, float oy,
                                  float oz, float sx, float sy, float sz,
                                  float cvg2, float dvg2, void* stream) {
  if (M <= 0) return 0;
  Sampler S{vox, D, H, W, ox, oy, oz, sx, sy, sz};
  const unsigned blocks = (unsigned)((M + KC_THREADS - 1) / KC_THREADS);
  broyden_search_kernel<<<blocks, KC_THREADS, 0, (cudaStream_t)stream>>>(
      xd, bone_idx, tfs, S, x_out, jinv_out, valid_out, M, max_iters, cvg2,
      dvg2);
  return launch_status();
}

// Outputs that are not 16-byte aligned are refused (the wrapper allocates
// them).
extern "C" int broyden_polish_fwd(const float* xd, const float* seed,
                                  const uint8_t* seed_ok, const float* vox,
                                  float* x_out, float* jinv_out,
                                  uint8_t* valid_out, long long M,
                                  int D, int H, int W,
                                  int max_iters, float ox, float oy,
                                  float oz, float sx, float sy, float sz,
                                  float cvg2, float dvg2, void* stream) {
  if (((reinterpret_cast<uintptr_t>(x_out) |
        reinterpret_cast<uintptr_t>(jinv_out) |
        reinterpret_cast<uintptr_t>(valid_out)) & 15u) != 0)
    return (int)cudaErrorMisalignedAddress;
  if (M <= 0) return 0;
  Sampler S{vox, D, H, W, ox, oy, oz, sx, sy, sz};
  const unsigned blocks = (unsigned)((M + KL_THREADS - 1) / KL_THREADS);
  if (M <= KL_SPREAD_MAX)
    broyden_polish_kernel_spread<<<blocks, KL_THREADS, 0,
                                   (cudaStream_t)stream>>>(
        xd, seed, seed_ok, S, x_out, jinv_out, valid_out, M, max_iters,
        cvg2, dvg2);
  else
    broyden_polish_kernel<<<blocks, KL_THREADS, 0, (cudaStream_t)stream>>>(
        xd, seed, seed_ok, S, x_out, jinv_out, valid_out, M, max_iters,
        cvg2, dvg2);
  return launch_status();
}
