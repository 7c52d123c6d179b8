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
// 37 B a lane (validity and the rotation cotangent), and at the lanes it
// adds (a lane with U = 0 adds nothing) 60 B more (root, J^-1, position
// cotangent) and the weight rows their corners touch, ~1,000 flops an
// adding lane, and writes 288 floats: at a train step's 1,474,560 lanes
// (~10% of them adding) its bound on an H100 is ~0.02 ms, by bytes
// (chip_smoke.py).  Its order of sums is fixed, so a check can bound its
// rounding (anim/broyden.py:deform_skinning_bwd_exact).
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
// of every lane into 288 floats, done without float atomics in one launch,
// so that it is the same from run to run: persistent blocks stage a tile
// of lanes' flags, number the lanes that add anything, sample their
// weights with the block's threads spread over whole weight rows, and add
// them into a 4 x 4 block of the sum held in each thread's registers; the
// last block to finish adds the blocks' sums in block order
// (skinning_bwd_kernel, below).
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

// KH skinning: two threads a lane (a point) over blocks of SKIN_POINTS
// lanes.  Both threads of a lane compute its coordinates in the transform
// voxel voxJ [D*H*W, 12] (channel-last, the blended [3, 4] transform of
// each voxel, sum_b W_b tfs[b, :3, :4]) as the twin's trilinear sample
// does (border padding, align_corners); thread dx then takes the 4 corners
// of its x side in (dy, dz) order, each row three 16-byte loads, and sums
// the 9 rotation channels; one shuffle adds the two sides.  The x pair's
// rows are neighbours in memory, so the two threads' loads share lines, and
// a thread's chain of dependent loads is half a lane's.  The block stages its
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

// KN: persistent blocks of KN_THREADS threads walk over tiles of KN_TILE
// lanes (tile t goes to block t mod G).  For each tile a block
//  1. stages the lanes' validity and rotation cotangents in shared memory
//     with asynchronous 16-byte copies (cp.async), double-buffered: the
//     next tile's copies are in flight while this one is worked on;
//  2. finds the lanes that add anything: a lane that is not valid and has
//     no rotation cotangent has U = 0 (at a train step's call ~90% of the
//     lanes: the search's invalid roots and the shading budget's padding),
//     and only the others load their root, J^-1 and position cotangent
//     (in flight while the lanes are numbered in lane order, by a ballot
//     and a count a warp); a thread a lane, each adding lane's thread
//     writes its U and its cell at its number;
//  3. samples the adding lanes' weights: their (lane, 16-byte word) pairs,
//     6 a weight row, spread over all the block's threads, the word
//     fastest, so that a warp's load of one corner reads whole rows; a
//     pair adds its word of the lane's 8 corner rows (all 8 loads in
//     flight) in the twin's corner order;
//  4. adds the adding lanes into registers: thread (slice s, sub-block k)
//     owns the 4 bones x 4 entries (one row a of U) of sub-block k of the
//     24 x 12 sum, and for the numbers s, s + 16, ... reads the 4 weights
//     and the 4 U entries as two 16-byte words and does 16 multiply-adds
//     (8 a shared-memory load, against 0.5 when a thread summed one entry;
//     a warp's threads read few distinct words, which broadcast).
// After its last tile a block adds its 16 slices' sums of each entry in
// slice order into its row of `partial`, and the last block to finish (a
// fence and a ticket) adds the G rows in block order into d_tfs and resets
// the ticket.  Every sum runs in one fixed order, so two calls give the same
// bits and anim/broyden.py:deform_skinning_bwd_exact models the order
// exactly: per (block, slice) one running sum over the adding lanes of the
// block's tiles by number, then the slices, then the blocks.  The sums and
// the weights' sample use fused multiply-adds (__fmaf_rn), which round
// once where a product and a sum round twice.  The ticket is a device
// variable: calls on one device must not overlap (the port makes one call
// a step, on one stream).
constexpr int kEntries = kBones * 12;  // (b, a * 4 + c) of d tfs, a < 3
constexpr int KN_THREADS = 288;
constexpr int KN_TILE = KN_THREADS;       // lanes a tile, a thread a lane
constexpr int KN_SLICES = 16;             // lane slices of the reduction
constexpr int KN_SUBS = kEntries / 16;    // 18 sub-blocks of 4 x 4 entries
constexpr int KN_STEPS = KN_TILE / KN_SLICES;  // lanes a thread adds a tile
static_assert(KN_SLICES * KN_SUBS == KN_THREADS, "a thread a (slice, sub)");
static_assert(KN_STEPS * KN_SLICES == KN_TILE, "whole slices a tile");
// blocks resident on an SM (the launch bound); the wrapper's block count,
// anim/broyden.py:SKIN_BWD_BLOCKS, is this times the H100's 132 SMs
constexpr int KN_BLOCKS_PER_SM = 3;

__device__ unsigned int kn_ticket = 0;

// Copies `bytes` bytes from global src to shared dst (both 16-byte aligned)
// in 16-byte asynchronous copies spread over the block's threads; the tail
// of the last copy is zero-filled (cp.async's source size).
__device__ __forceinline__ void copy_async(void* dst, const void* src,
                                           int bytes) {
  for (int c = threadIdx.x; c < (bytes + 15) / 16; c += blockDim.x) {
    const unsigned d =
        (unsigned)__cvta_generic_to_shared(static_cast<char*>(dst) + 16 * c);
    const int n = bytes - 16 * c < 16 ? bytes - 16 * c : 16;
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(d),
                 "l"(static_cast<const char*>(src) + 16 * c), "r"(n)
                 : "memory");
  }
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
// waits for every group of this thread's copies but the latest
__device__ __forceinline__ void cp_async_wait_prior() {
  asm volatile("cp.async.wait_group 1;" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}

__global__ void __launch_bounds__(KN_THREADS, KN_BLOCKS_PER_SM)
skinning_bwd_kernel(
    const float* __restrict__ xc, const uint8_t* __restrict__ valid,
    const float* __restrict__ jinv, const float* __restrict__ g_xc,
    const float* __restrict__ g_rot, const float* __restrict__ vox,
    int64_t M, int D, int H, int W, float ox, float oy, float oz,
    float scale, float ratio, float* __restrict__ partial,
    float* __restrict__ d_tfs) {
  // in dynamic shared memory: the adding lanes' weights [KN_TILE, 24], U
  // [KN_TILE, 12] and cells by number; after the last tile the block's
  // [KN_SLICES, kEntries] sums in their place
  extern __shared__ __align__(16) float kn_dyn[];
  float* s_wu = kn_dyn;
  // each adding lane's cell at its number: 8 words (the corner row (x0,
  // y0, z0), the steps to its x, y and z neighbours, 0 at the voxel's
  // border, and fx, fy, fz)
  int* s_cell = reinterpret_cast<int*>(kn_dyn + KN_TILE * (kBones + 12));
  // the staged validity and rotation cotangents, double-buffered: tile
  // i + 1's copies run while tile i is worked on
  __shared__ __align__(16) float s_r[2][KN_TILE * 9];
  __shared__ __align__(16) uint8_t s_v[2][KN_TILE];
  __shared__ int s_cnt[KN_THREADS / 32];
  __shared__ bool s_last;
  static_assert(KN_SLICES * kEntries <= KN_TILE * (kBones + 12),
                "the block's sums fit over the tile");
  float* s_w = s_wu;
  float* s_u = s_wu + KN_TILE * kBones;
  const int tid = threadIdx.x;
  const int p = tid;  // the tile's lane this thread stages
  const int slice = tid / KN_SUBS, sub = tid % KN_SUBS;
  const int kb = sub / 3, ra = sub % 3;    // bones 4 kb .., row ra of U
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[i][c] = 0.f;

  const int64_t n_tiles = (M + KN_TILE - 1) / KN_TILE;
  // 1. a tile's flags, copied into buffer b with asynchronous 16-byte
  // copies (the tile's spans start 16-byte aligned; the last chunk of a
  // short tile is zero-filled)
  auto stage = [&](int b, int64_t tile) {
    const int64_t q0 = tile * KN_TILE;
    const int rows = M - q0 < KN_TILE ? (int)(M - q0) : KN_TILE;
    if (g_rot != nullptr) copy_async(s_r[b], g_rot + q0 * 9, rows * 36);
    copy_async(s_v[b], valid + q0, rows);
  };
  if (blockIdx.x < n_tiles) stage(0, blockIdx.x);
  cp_async_commit();
  int buf = 0;
  for (int64_t tile = blockIdx.x; tile < n_tiles;
       tile += gridDim.x, buf ^= 1) {
    const int64_t q0 = tile * KN_TILE;
    const int rows = M - q0 < KN_TILE ? (int)(M - q0) : KN_TILE;
    if (tile + gridDim.x < n_tiles) stage(buf ^ 1, tile + gridDim.x);
    cp_async_commit();
    cp_async_wait_prior();  // this tile's copies; the next tile's may run
    __syncthreads();

    // 2. the lanes that add anything: a lane that is not valid and has no
    // rotation cotangent has U = 0 and is skipped (the compaction's padding,
    // the search's invalid roots); the others load their root, J^-1 and
    // position cotangent (in flight while the lanes are numbered), are
    // numbered in lane order through a count a warp, and take their U and
    // cell to that number
    const bool live = p < rows;
    const int q = live ? p : 0;
    bool adds = live && s_v[buf][q] != 0;
    if (g_rot != nullptr) {
#pragma unroll
      for (int k = 0; k < 9; ++k) adds |= live && s_r[buf][q * 9 + k] != 0.f;
    }
    float x3[3], J[9], g3[3];
    if (adds) {
      const int64_t m = q0 + q;
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        x3[k] = __ldg(xc + m * 3 + k);
        g3[k] = __ldg(g_xc + m * 3 + k);
      }
#pragma unroll
      for (int k = 0; k < 9; ++k) J[k] = __ldg(jinv + m * 9 + k);
    }
    const int wid = tid >> 5, wl = tid & 31;
    const unsigned bits = __ballot_sync(0xffffffffu, adds);
    if (wl == 0) s_cnt[wid] = __popc(bits);
    __syncthreads();
    int pc = __popc(bits & ((1u << wl) - 1u)), n_live = 0;
#pragma unroll
    for (int w = 0; w < KN_THREADS / 32; ++w) {
      const int c = s_cnt[w];
      pc += w < wid ? c : 0;
      n_live += c;
    }
    if (adds) {
      // the lane's U: U[a, c] = rho[a] x^[c] + (c < 3 ? R[a, c] : 0)
      const float v = s_v[buf][q] ? 1.f : 0.f;
      float rho[3];
#pragma unroll
      for (int a = 0; a < 3; ++a)
        rho[a] = -(v * (J[a] * g3[0] + J[3 + a] * g3[1] + J[6 + a] * g3[2]));
      float u[12];
#pragma unroll
      for (int e = 0; e < 12; ++e) {
        const int a = e >> 2, c = e & 3;
        float t = rho[a] * (c < 3 ? x3[c < 3 ? c : 0] : 1.f);
        if (c < 3 && g_rot != nullptr) t = t + s_r[buf][q * 9 + a * 3 + c];
        u[e] = t;
      }
      float4* du = reinterpret_cast<float4*>(s_u + pc * 12);
#pragma unroll
      for (int e = 0; e < 3; ++e)
        du[e] = make_float4(u[4 * e], u[4 * e + 1], u[4 * e + 2], u[4 * e + 3]);
      {
        const float cx = (x3[0] - ox) / scale;
        const float cy = (x3[1] - oy) / scale;
        const float cz = (x3[2] - oz) / scale * ratio;
        const float ix = fminf(fmaxf((cx + 1.f) * 0.5f * (float)(W - 1), 0.f),
                               (float)(W - 1));
        const float iy = fminf(fmaxf((cy + 1.f) * 0.5f * (float)(H - 1), 0.f),
                               (float)(H - 1));
        const float iz = fminf(fmaxf((cz + 1.f) * 0.5f * (float)(D - 1), 0.f),
                               (float)(D - 1));
        const float x0f = floorf(ix), y0f = floorf(iy), z0f = floorf(iz);
        const int x0 = (int)x0f, y0 = (int)y0f, z0 = (int)z0f;
        int* ci = s_cell + pc * 8;
        ci[0] = (z0 * H + y0) * W + x0;
        ci[1] = min(x0 + 1, W - 1) - x0;
        ci[2] = (min(y0 + 1, H - 1) - y0) * W;
        ci[3] = (min(z0 + 1, D - 1) - z0) * H * W;
        float* cf = reinterpret_cast<float*>(ci);
        cf[4] = ix - x0f;
        cf[5] = iy - y0f;
        cf[6] = iz - z0f;
      }
    }
    __syncthreads();

    // 3. the adding lanes' weights: the (lane, word) pairs of their 6
    // 16-byte words of a weight row spread over the block's threads, the
    // word fastest, so that a warp's load of one corner reads whole rows;
    // each pair adds its word of the lane's 8 corner rows in the twin's
    // corner order, the 8 loads in flight at once
    for (int e = tid; e < n_live * 6; e += KN_THREADS) {
      const int l = e / 6, c = e - 6 * l;
      const int* ci = s_cell + l * 8;
      const int r0 = ci[0], sx_ = ci[1], sy_ = ci[2], sz_ = ci[3];
      const float* cf = reinterpret_cast<const float*>(ci);
      const float fx = cf[4], fy = cf[5], fz = cf[6];
      const float4* col = reinterpret_cast<const float4*>(vox) + c;
      float4 a[8];
#pragma unroll
      for (int k = 0; k < 8; ++k)
        a[k] = __ldg(col + (int64_t)(r0 + ((k >> 2) ? sx_ : 0)
                                     + (((k >> 1) & 1) ? sy_ : 0)
                                     + ((k & 1) ? sz_ : 0)) * (kBones / 4));
      float4 w = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const int dx = k >> 2, dy = (k >> 1) & 1, dz = k & 1;
        const float wc = (dx ? fx : 1.f - fx) * (dy ? fy : 1.f - fy)
                         * (dz ? fz : 1.f - fz);
        w.x = __fmaf_rn(wc, a[k].x, w.x);
        w.y = __fmaf_rn(wc, a[k].y, w.y);
        w.z = __fmaf_rn(wc, a[k].z, w.z);
        w.w = __fmaf_rn(wc, a[k].w, w.w);
      }
      reinterpret_cast<float4*>(s_w)[e] = w;
    }
    __syncthreads();

    // 4. the adding lanes into this thread's 4 x 4 entries
#pragma unroll
    for (int j = 0; j < KN_STEPS; ++j) {
      const int l = j * KN_SLICES + slice;
      if (j * KN_SLICES >= n_live) break;  // the same for the whole block
      if (l >= n_live) continue;
      const float4 wv = reinterpret_cast<const float4*>(s_w)[l * 6 + kb];
      const float4 uv = reinterpret_cast<const float4*>(s_u)[l * 3 + ra];
      const float wb[4] = {wv.x, wv.y, wv.z, wv.w};
      const float ub[4] = {uv.x, uv.y, uv.z, uv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c)
          acc[i][c] = __fmaf_rn(wb[i], ub[c], acc[i][c]);
    }
    // the next tile's barrier, after its copies land, keeps its weights
    // from overwriting these before every thread has added them
  }

  cp_async_wait_all();
  __syncthreads();  // every thread has added the last tile
  // the block's sum of each entry, its slices in order
  float* s_red = s_wu;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c)
      s_red[slice * kEntries + (4 * kb + i) * 12 + 4 * ra + c] = acc[i][c];
  __syncthreads();
  {
    float s = 0.f;
#pragma unroll
    for (int k = 0; k < KN_SLICES; ++k) s = s + s_red[k * kEntries + tid];
    partial[(int64_t)blockIdx.x * kEntries + tid] = s;
  }
  // the last block to finish adds the blocks' sums in block order
  __threadfence();
  __syncthreads();
  if (tid == 0) s_last = atomicAdd(&kn_ticket, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!s_last) return;
  float s = 0.f;
  const int G = (int)gridDim.x;
  for (int g0 = 0; g0 < G; g0 += 8) {
    float v[8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
      v[i] = g0 + i < G ? __ldcg(partial + (int64_t)(g0 + i) * kEntries + tid)
                        : 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i)
      if (g0 + i < G) s = s + v[i];
  }
  const int b = tid / 12, k = tid % 12;
  d_tfs[b * 16 + k] = s;  // row a = k / 4, column c = k % 4
  if (k < 4) d_tfs[b * 16 + 12 + k] = 0.f;
  if (tid == 0) kn_ticket = 0u;  // for the next call
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
  if (G < 1 || M < 0) return (int)cudaErrorInvalidValue;
  // the 16-byte loads of the weight rows and copies of the lanes' flags
  if ((reinterpret_cast<uintptr_t>(vox) | reinterpret_cast<uintptr_t>(valid)
       | reinterpret_cast<uintptr_t>(g_rot)) & 15)
    return (int)cudaErrorMisalignedAddress;
  // the adding lanes' weights, U and cells, above the 48 KB a block has
  // without asking
  constexpr int smem = KN_TILE * (kBones + 12 + 8) * 4;
  static bool asked[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess && dev >= kMaxDevices) err = cudaErrorInvalidDevice;
  if (err == cudaSuccess && !asked[dev]) {
    err = cudaFuncSetAttribute(skinning_bwd_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    asked[dev] = err == cudaSuccess;
  }
  if (err != cudaSuccess) return (int)err;
  skinning_bwd_kernel<<<G, KN_THREADS, smem, (cudaStream_t)stream>>>(
      xc, valid, jinv, g_xc, g_rot, vox, M, D, H, W, ox, oy, oz, scale, ratio,
      partial, d_tfs);
  return launch_status();
}
