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
// trilinear sample, border padding, align_corners) and anim/broyden.py:550
// (forward_skinning_soa): the rotation rows of sum_b w_b tfs[b, :3, :3] at
// each kept lane.  The sample is linear in the voxel, so it reads the
// frame's transform voxel voxel_J (sum_b W_b tfs[b, :3, :4] at each voxel,
// baked once a frame for the search) and samples its 9 rotation channels:
// the same function with the sums in another order.  The eval path
// launches it only where the query reads the rotation (a gradient query
// without use_j_inv).
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
// What bounds them on an H100: bytes, and for the prologue its
// instruction issue.  The prologue reads 12 B and writes 4 I B per point
// (at 262,144 points and I = 8, ~3.4 us at 3.35 TB/s) but issues ~47 FP32
// operations per bone, none of which may fuse into a multiply-add (the
// twin's rounding), an IEEE division among them, and one compare a pair of
// bones: at 13 bones ~900 instructions a point; the epilogue reads I x 13 B
// (x and valid of every lane) and K x 36 B (j_inv of the kept lanes only)
// and writes K x 49 B per point, a copy of ~444 B a point at I = 8, K = 4,
// so its time is set by how many sectors its loads and stores touch; the
// skinning reads 12 B a lane and the 48 B rows of the 25 MB transform
// voxel that its corners touch (the weight voxel's rows are 96 B, and the
// blend adds 24 x 9 products a lane), and writes 36 B a lane.  KN reads
// 97 B a lane (root, validity, J^-1 and both cotangents) and the weight
// rows its lanes' corners touch, ~1,000 flops a lane, and writes 288
// floats: at the train step's 1,474,560 lanes (a quarter of the voxel's
// rows touched) its bound on an H100 is ~0.047 ms, by bytes (chip_smoke.py).
// Its order of sums is fixed, so a check can bound its rounding
// (anim/broyden.py:deform_skinning_bwd_exact).
//
// Design: the prologue is a thread a point over 128-point tiles with
// nothing in local memory and no branch on the data.  The bone count is a
// template parameter (13, or the limit of 24), the table padded with rows
// whose distance is +inf.  A block stages the bone rows (the 12 transform
// floats used and the segment's 7) in shared memory, read as five 16-byte
// broadcast loads a bone, and its points with coalesced loads.  The
// distances stay in registers, and the selection is a rank by counting:
// one compare a pair of bones gives both ranks, so rank_s = #{t < s : d_t
// <= d_s} + #{t > s : d_t < d_s} is bone s's stable ascending position
// (lower slot first on ties, as top_k(-d) and a stable argsort order
// them), the ranks packed 4 bits a bone in two words so that a pair costs
// one predicated add, and bone s goes to output rank_s when it is below I
// (else to a spare word).  The ranks index a shared-memory row of the
// tile's I slots a point, written out with 16-byte stores.  Its time is
// the same for any order of the distances.  The epilogue is lane-parallel,
// with no arrays: a
// group of G lanes of one warp (G the power of two >= I) serves a point,
// lane i its candidate i, so the loads of x and valid are coalesced and
// j_inv is read only by the K lanes that fill a slot.  Lane i learns
// whether a valid later lane lies within thresh by shuffles over its
// group; `keep` is a ballot, and the slots come from population counts:
// a kept lane's slot is the kept lanes below it, a dropped lane's is the
// survivors plus the dropped lanes below it.  Persistent blocks walk over
// tiles of 256 / G points, stage the tile's K slots of xc, j_inv and valid
// in shared memory (they are contiguous in the outputs) and write them out
// with 16-byte stores; the overflow is summed in the block and added with
// one atomic a block.  The skinning gives a kept lane two threads, one for
// each x side of its cell (skinning_kernel, below).  The arithmetic
// follows the plain versions' order, so with -fmad=false the prologue's
// distances and the epilogue's filter equal theirs.  KN is a reduction
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

// Copy n words of shared memory to dst with 16-byte stores, then the tail
// (dst and src 16-byte aligned).
template <typename W>
__device__ __forceinline__ void copy_out(W* dst, const W* src, int n) {
  constexpr int per = 16 / sizeof(W);
  const int n4 = n / per;
  for (int q = threadIdx.x; q < n4; q += blockDim.x)
    reinterpret_cast<uint4*>(dst)[q] = reinterpret_cast<const uint4*>(src)[q];
  for (int e = n4 * per + threadIdx.x; e < n; e += blockDim.x) dst[e] = src[e];
}

// The prologue: a thread a point over tiles of PRO_THREADS points, NB bones
// a point known at compile time (13, the search's init bones, or the
// kernel's limit of 24).  A block stages NB bone rows in shared memory,
// kBoneStride floats a row (T rows 0-2, then the segment's 7 floats, then a
// pad), so that a thread reads a bone with five 16-byte broadcast loads;
// rows from n_all on are T = 0, a = (3e38, 0, 0), b - a = 0 and a
// denominator of 1, whose distance is +inf for every finite point, so they
// rank after every bone of the table and the kernel has no branch on n_all.
constexpr int PRO_THREADS = 128;
constexpr int kBoneStride = 20;
constexpr int kInitBones = 13;

// The squared distance of the canonicalized point R^T (p - t) to the
// segment of bone row b (the plain version's expressions in its order)
__device__ __forceinline__ float bone_distance(const float4* b, float px,
                                               float py, float pz) {
  // T[0..3], T[4..7], T[8..11] of the row-major [4, 4] transform; a (3),
  // b - a (3), |b - a|^2 + 1e-9
  const float4 T0 = b[0], T1 = b[1], T2 = b[2], g0 = b[3], g1 = b[4];
  const float dx = px - T0.w, dy = py - T1.w, dz = pz - T2.w;
  const float xi = T0.x * dx + T1.x * dy + T2.x * dz;
  const float yi = T0.y * dx + T1.y * dy + T2.y * dz;
  const float zi = T0.z * dx + T1.z * dy + T2.z * dz;
  float t = ((xi - g0.x) * g0.w + (yi - g0.y) * g1.x + (zi - g0.z) * g1.y)
            / g1.z;
  t = fminf(fmaxf(t, 0.f), 1.f);
  const float ex = xi - (g0.x + t * g0.w);
  const float ey = yi - (g0.y + t * g1.x);
  const float ez = zi - (g0.z + t * g1.y);
  return ex * ex + ey * ey + ez * ez;
}

// rank_s = #{t < s : d_t <= d_s} + #{t > s : d_t < d_s}, the stable
// ascending position of bone s, packed FB bits a bone into NW words, then
// bone s written to out[rank_s] when it is below I, else to *spare.
// rank_t starts at t; a pair s < t with d_t < d_s adds one to rank_s and
// takes one from rank_t (every field stays in [0, NB) throughout, so the
// packed adds are exact): one compare a pair and one predicated add (two
// where the two bones' fields lie in different words).
template <int NB>
__device__ __forceinline__ void rank_out(const float (&d)[NB], int I,
                                         int* out, int* spare) {
  constexpr int FB = NB <= 16 ? 4 : 5, PW = 32 / FB, NW = (NB + PW - 1) / PW;
  unsigned w[NW];
#pragma unroll
  for (int i = 0; i < NW; ++i) w[i] = 0u;
#pragma unroll
  for (int s = 0; s < NB; ++s) w[s / PW] += (unsigned)s << (FB * (s % PW));
#pragma unroll
  for (int t = 1; t < NB; ++t)
#pragma unroll
    for (int s = 0; s < t; ++s) {
      const unsigned bs = 1u << (FB * (s % PW)), bt = 1u << (FB * (t % PW));
      if (d[t] < d[s]) {
        if (s / PW == t / PW) {
          w[s / PW] += bs - bt;
        } else {
          w[s / PW] += bs;
          w[t / PW] -= bt;
        }
      }
    }
#pragma unroll
  for (int s = 0; s < NB; ++s) {
    const int r = (int)(w[s / PW] >> (FB * (s % PW))) & ((1 << FB) - 1);
    *(r < I ? out + r : spare) = s;
  }
}

template <int NB>
__global__ void __launch_bounds__(PRO_THREADS) prologue_kernel(
    const float* __restrict__ pts, const float* __restrict__ tfs,
    const float* __restrict__ segs, int64_t N, int n_all, int I,
    int* __restrict__ slot) {
  __shared__ __align__(16) float s_bone[NB * kBoneStride];
  __shared__ float s_pts[PRO_THREADS * 3];
  // the tile's I slots a point, then a spare word a thread
  __shared__ __align__(16) int s_slot[PRO_THREADS * (kMaxInit + 1)];
  const int tid = threadIdx.x;
  const int64_t n0 = (int64_t)blockIdx.x * PRO_THREADS;
  const int P = (int)(N - n0 < PRO_THREADS ? N - n0 : PRO_THREADS);
  for (int e = tid; e < NB * kBoneStride; e += PRO_THREADS) {
    const int s = e / kBoneStride, c = e % kBoneStride;
    float v = c == 12 ? 3e38f : c == 18 ? 1.f : 0.f;
    if (s < n_all)
      v = c < 12 ? tfs[s * 16 + c] : c < 19 ? segs[s * 7 + c - 12] : 0.f;
    s_bone[e] = v;
  }
  // the tile's points, coalesced
  for (int e = tid; e < P * 3; e += PRO_THREADS) s_pts[e] = pts[n0 * 3 + e];
  __syncthreads();
  // past the tile's last point, its first (that row is not copied out)
  const int q = tid < P ? tid : 0;
  const float px = s_pts[q * 3], py = s_pts[q * 3 + 1], pz = s_pts[q * 3 + 2];
  float d[NB];
#pragma unroll
  for (int s = 0; s < NB; ++s)
    d[s] = bone_distance(reinterpret_cast<const float4*>(s_bone)
                         + s * (kBoneStride / 4), px, py, pz);
  rank_out<NB>(d, I, s_slot + tid * I, s_slot + PRO_THREADS * kMaxInit + tid);
  __syncthreads();
  // the tile's slots are contiguous in `slot` (n0 * I * 4 B is a multiple
  // of 16)
  copy_out(slot + n0 * I, s_slot, P * I);
}

// The epilogue, lane-parallel: a group of G lanes (G, a power of two >= I)
// of one warp serves one point, lane i of the group its candidate i.
constexpr int EPI_THREADS = 256;

__global__ void __launch_bounds__(EPI_THREADS) epilogue_kernel(
    const float* __restrict__ x, const float* __restrict__ jinv,
    const uint8_t* __restrict__ valid, int64_t N, int I, int K, int G,
    float thresh2, float* __restrict__ xc, float* __restrict__ jinv_out,
    uint8_t* __restrict__ valid_out,
    unsigned long long* __restrict__ overflow) {
  // a tile is EPI_THREADS / G points; its K slots a point, staged (the
  // slots of a tile never exceed EPI_THREADS)
  __shared__ __align__(16) float s_xc[EPI_THREADS * 3];
  __shared__ __align__(16) float s_j[EPI_THREADS * 9];
  __shared__ __align__(16) uint8_t s_v[EPI_THREADS];
  __shared__ unsigned long long s_ovf[EPI_THREADS / 32];
  const int tid = threadIdx.x, lane = tid & 31;
  const int i = lane & (G - 1), pt = tid / G, PB = EPI_THREADS / G;
  const unsigned group = ((1u << G) - 1) << (lane & ~(G - 1));
  const unsigned below = (1u << lane) - 1;
  unsigned long long ovf = 0;
  const int64_t n_tiles = (N + PB - 1) / PB;
  for (int64_t tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int64_t n0 = tile * PB, n = n0 + pt, m = n * I + i;
    const bool live = n < N && i < I;
    float cx = 0.f, cy = 0.f, cz = 0.f;
    bool v = false;
    if (live) {
      cx = x[m * 3];
      cy = x[m * 3 + 1];
      cz = x[m * 3 + 2];
      v = valid[m] != 0;
    }
    // a duplicate: a valid later lane j of the group within thresh
    bool dup = false;
    for (int s = 1; s < I; ++s) {
      const float ox = __shfl_down_sync(0xffffffffu, cx, s, G);
      const float oy = __shfl_down_sync(0xffffffffu, cy, s, G);
      const float oz = __shfl_down_sync(0xffffffffu, cz, s, G);
      const int ov = __shfl_down_sync(0xffffffffu, (int)v, s, G);
      if (i + s < I) {
        const float ax = cx - ox, ay = cy - oy, az = cz - oz;
        dup |= ov && (ax * ax + ay * ay + az * az < thresh2);
      }
    }
    const bool keep = v && !dup;
    // slots: the survivors in lane order, then the lanes that did not
    // survive, in lane order
    const unsigned kept = __ballot_sync(0xffffffffu, keep) & group;
    const unsigned dropped = __ballot_sync(0xffffffffu, live && !keep) & group;
    const int survivors = __popc(kept);
    const int slot = keep ? __popc(kept & below)
                          : survivors + __popc(dropped & below);
    if (live && i == 0 && survivors > K)
      ovf += (unsigned long long)(survivors - K);
    if (live && slot < K) {
      const int q = pt * K + slot;
      s_xc[q * 3] = cx;
      s_xc[q * 3 + 1] = cy;
      s_xc[q * 3 + 2] = cz;
#pragma unroll
      for (int c = 0; c < 9; ++c) s_j[q * 9 + c] = jinv[m * 9 + c];
      s_v[q] = keep;
    }
    __syncthreads();
    // the tile's slots are contiguous in each output (n0 is a multiple of
    // 16 points, so each region starts 16-byte aligned)
    const int slots = (int)(N - n0 < PB ? N - n0 : PB) * K;
    copy_out(xc + n0 * K * 3, s_xc, slots * 3);
    copy_out(jinv_out + n0 * K * 9, s_j, slots * 9);
    copy_out(valid_out + n0 * K, s_v, slots);
    __syncthreads();
  }
  // the overflow: one atomic a block
  for (int o = 16; o > 0; o >>= 1) ovf += __shfl_down_sync(0xffffffffu, ovf, o);
  if (lane == 0) s_ovf[tid >> 5] = ovf;
  __syncthreads();
  if (tid == 0) {
    unsigned long long sum = 0;
    for (int w = 0; w < EPI_THREADS / 32; ++w) sum += s_ovf[w];
    if (sum) atomicAdd(overflow, sum);
  }
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

// KH skinning: two threads a lane (a point) over blocks of SKIN_POINTS
// lanes.  Both threads of a lane compute its coordinates in the transform
// voxel voxJ [D*H*W, 12] (channel-last, the blended [3, 4] transform of
// each voxel, sum_b W_b tfs[b, :3, :4]) as sample_weights does (border
// padding, align_corners); thread dx then takes the 4 corners of its x side
// in (dy, dz) order, each row three 16-byte loads, and sums the 9 rotation
// channels; one shuffle adds the two sides.  The x pair's rows are
// neighbours in memory, so the two threads' loads share lines, and a
// thread's chain of dependent loads is half a lane's.  The block stages its
// [SKIN_POINTS, 9] output in shared memory for 16-byte stores.
constexpr int SKIN_POINTS = 64;
constexpr int SKIN_THREADS = 2 * SKIN_POINTS;

__global__ void __launch_bounds__(SKIN_THREADS) skinning_kernel(
    const float* __restrict__ xc, const float* __restrict__ voxJ, int64_t M,
    int D, int H, int W, float ox, float oy, float oz, float scale,
    float ratio, float* __restrict__ rot) {
  __shared__ __align__(16) float s_rot[SKIN_POINTS * 9];
  const int t = threadIdx.x, p = t >> 1, dx = t & 1;
  const int64_t q0 = (int64_t)blockIdx.x * SKIN_POINTS;
  const int rows = M - q0 < SKIN_POINTS ? (int)(M - q0) : SKIN_POINTS;
  const bool live = p < rows;
  const float* px = xc + (q0 + (live ? p : 0)) * 3;
  const float cx = (__ldg(px) - ox) / scale;
  const float cy = (__ldg(px + 1) - oy) / scale;
  const float cz = (__ldg(px + 2) - oz) / scale * ratio;
  const float ix = fminf(fmaxf((cx + 1.f) * 0.5f * (float)(W - 1), 0.f),
                         (float)(W - 1));
  const float iy = fminf(fmaxf((cy + 1.f) * 0.5f * (float)(H - 1), 0.f),
                         (float)(H - 1));
  const float iz = fminf(fmaxf((cz + 1.f) * 0.5f * (float)(D - 1), 0.f),
                         (float)(D - 1));
  const float x0f = floorf(ix), y0f = floorf(iy), z0f = floorf(iz);
  const float fx = ix - x0f, fy = iy - y0f, fz = iz - z0f;
  const int x0 = (int)x0f, y0 = (int)y0f, z0 = (int)z0f;
  const int X = dx ? min(x0 + 1, W - 1) : x0;
  const int Y[2] = {y0, min(y0 + 1, H - 1)};
  const int Z[2] = {z0, min(z0 + 1, D - 1)};
  float4 v[4][3];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float4* row = reinterpret_cast<const float4*>(
        voxJ + (((int64_t)Z[k & 1] * H + Y[k >> 1]) * W + X) * 12);
#pragma unroll
    for (int a = 0; a < 3; ++a) v[k][a] = __ldg(row + a);
  }
  const float wx = dx ? fx : 1.f - fx;
  float r[9];
#pragma unroll
  for (int c = 0; c < 9; ++c) r[c] = 0.f;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int dy = k >> 1, dz = k & 1;
    const float wy = dy ? fy : 1.f - fy;
    const float wz = dz ? fz : 1.f - fz;
    const float wc = wx * wy * wz;
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      r[a * 3] = r[a * 3] + wc * v[k][a].x;
      r[a * 3 + 1] = r[a * 3 + 1] + wc * v[k][a].y;
      r[a * 3 + 2] = r[a * 3 + 2] + wc * v[k][a].z;
    }
  }
#pragma unroll
  for (int c = 0; c < 9; ++c) {
    const float o = __shfl_xor_sync(0xffffffffu, r[c], 1);
    r[c] = dx ? o + r[c] : r[c] + o;
  }
  if (live && dx == 0) {
#pragma unroll
    for (int c = 0; c < 9; ++c) s_rot[p * 9 + c] = r[c];
  }
  __syncthreads();
  copy_out(rot + q0 * 9, s_rot, rows * 9);
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
  if (I < 1 || I > n_all || I > kMaxInit || n_all > kBones)
    return (int)cudaErrorInvalidValue;
  // the 16-byte stores of the staged slots
  if (reinterpret_cast<uintptr_t>(slot) & 15)
    return (int)cudaErrorMisalignedAddress;
  unsigned blocks = (unsigned)((N + PRO_THREADS - 1) / PRO_THREADS);
  const cudaStream_t st = (cudaStream_t)stream;
  if (n_all <= kInitBones)
    prologue_kernel<kInitBones><<<blocks, PRO_THREADS, 0, st>>>(
        pts, tfs, segs, N, n_all, I, slot);
  else
    prologue_kernel<kBones><<<blocks, PRO_THREADS, 0, st>>>(
        pts, tfs, segs, N, n_all, I, slot);
  return launch_status();
}

extern "C" int deform_epilogue_fwd(const float* x, const float* jinv,
                                   const uint8_t* valid, long long N, int I,
                                   int K, float thresh2, float* xc,
                                   float* jinv_out, uint8_t* valid_out,
                                   unsigned long long* overflow,
                                   void* stream) {
  if (I < 1 || I > kMaxInit || K < 1 || K > I)
    return (int)cudaErrorInvalidValue;
  // the 16-byte stores of the staged slots
  if ((reinterpret_cast<uintptr_t>(xc) | reinterpret_cast<uintptr_t>(jinv_out)
       | reinterpret_cast<uintptr_t>(valid_out)) & 15)
    return (int)cudaErrorMisalignedAddress;
  if (N <= 0) return 0;
  int G = 1;
  while (G < I) G <<= 1;
  static int resident[kMaxDevices] = {};
  unsigned blocks = 0;
  const cudaError_t err = persistent_grid(
      epilogue_kernel, EPI_THREADS, 0,
      (N + EPI_THREADS / G - 1) / (EPI_THREADS / G), resident, blocks);
  if (err != cudaSuccess) return (int)err;
  epilogue_kernel<<<blocks, EPI_THREADS, 0, (cudaStream_t)stream>>>(
      x, jinv, valid, N, I, K, G, thresh2, xc, jinv_out, valid_out, overflow);
  return launch_status();
}

extern "C" int deform_skinning_fwd(const float* xc, const float* voxJ,
                                   long long M, int D, int H, int W,
                                   float ox, float oy, float oz, float scale,
                                   float ratio, float* rot, void* stream) {
  if (M <= 0) return 0;
  // the 16-byte loads of the voxel's rows and stores of the staged rows
  if ((reinterpret_cast<uintptr_t>(voxJ) | reinterpret_cast<uintptr_t>(rot))
      & 15)
    return (int)cudaErrorMisalignedAddress;
  const unsigned blocks = (unsigned)((M + SKIN_POINTS - 1) / SKIN_POINTS);
  skinning_kernel<<<blocks, SKIN_THREADS, 0, (cudaStream_t)stream>>>(
      xc, voxJ, M, D, H, W, ox, oy, oz, scale, ratio, rot);
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
