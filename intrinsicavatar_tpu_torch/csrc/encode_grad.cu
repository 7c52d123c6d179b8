// KB: fused hash encode + SDF MLP + analytic SDF gradient, forward (KB',
// its backward, below).
//
// Replaces intrinsicavatar_tpu/ops/encode_grad.py:166-216 (_forward of
// encode_mlp_sdfgrad): per point, the multi-level hash encode, the one-hidden
// -layer SDF MLP with softplus(100) (weight-normed weights), the manual
// reverse pass for output channel 0 (nets/mlp.py:126-161) and the trilinear
// derivative of the encode from the same gathered corner rows, in normalized
// coordinates.
//
// What bounds it on an H100: the table gathers (N * L * 8 * F * 4 B at random
// addresses, as for KA) against 3.35 TB/s, and the MLP's three products,
// 2 * (35*64 + 64*13 + 64*35) ~ 10.6 kflop per point, which in FP32 at 67
// TFLOP/s are the larger of the two at the published widths; on the tensor
// cores (TF32, 495 TFLOP/s, three passes) they cost less than the gather.
//
// Design: a tile of 128 points per block, 8 warps, persistent blocks that
// keep the MLP's weights in shared memory for their whole life.
//  1. Gather: one thread per (point, level), levels fastest as in KA, with
//     the index rules of common.cuh:corner_row.  Each level's 8 corner rows
//     are read once; the same loop sums the encode value and its 3-vector
//     derivative (d enc / d pos), written to shared memory as the tile's
//     enc [128 x 40] (inputs zero-padded to 40) and jac [128 x L*F x 3].
//  2. MLP: each warp takes 16 points through three products on the tensor
//     cores with mma.sync m16n8k8 TF32, every operand split into a TF32 high
//     and low part (3xTF32: hi*lo + lo*hi + hi*hi, FP32 accumulators), which
//     keeps about FP32's precision where one TF32 pass keeps three digits:
//       H = enc [16 x 40] . W1 [40 x 64],
//       out = softplus100(H + b1) [16 x 64] . W2 [64 x 16],
//       g_enc = (sigmoid(100 (H + b1)) * W2[:, 0]) [16 x 64] . W1^T [64 x 40].
//     The accumulator fragment of H is the A fragment of the next two
//     products once their K index is permuted within each 8-wide step
//     (position t <-> unit 2t, t + 4 <-> 2t + 1); the weights are stored in
//     shared memory in that fragment order, so H never leaves registers.
//     Widths up to 40 inputs, 64 hidden units and 16 outputs run through
//     the same tiles, zero-padded (a padded hidden unit has W2 row 0).
//  3. Epilogue: out + b2, and the gradient g_enc . (xyz_scale | mask * jac)
//     summed over the quad of lanes that share a point, staged in shared
//     memory and written out coalesced.
//
// The bf16 form (encode_mlp_sdfgrad_fwd_bf16) replaces the same op inside
// the JAX package's bf16 scope (intrinsicavatar_tpu/ops/encode_grad.py:103,
// the rows gathered bf16, and nets/mlp.py:29-37, the products on bf16
// operands with float32 accumulation): the same kernel with the element
// type a template parameter.  The gather reads bf16 rows (half the bytes)
// and widens them (exact); enc, jac and the gradient stay float32.  The
// three products run on mma.sync m16n8k16 bf16 with float32 accumulators,
// one pass a k16 step where 3xTF32 takes six m16n8k8 passes, their
// operands rounded to nearest even where JAX's casts round: the encoding,
// softplus100(H + b1), sigmoid(100 (H + b1)) * W2[:, 0] and the weights
// (the wrapper's effective, weight-normed ones).  The bias adds and W2[:, 0]
// stay float32.  In m16n8k16 the accumulator fragment of H is the A
// fragment of the next products with no permutation (n-tiles 2m and 2m + 1
// are the k16 step m), so the weights are staged in plain k order.
#include "common.cuh"

namespace {

constexpr int MAX_IN = 40;      // MLP inputs (L*F <= 32, plus xyz), 5 k-steps
constexpr int MAX_HIDDEN = 64;  // 8 n-tiles of the first product
constexpr int MAX_OUT = 16;     // 2 n-tiles of the second
constexpr int MAX_LF = 32;
constexpr int MAX_L = 32;
constexpr int TILE = 128;       // points a block tile
constexpr int WARPS = TILE / 16;
constexpr int THREADS = WARPS * 32;
constexpr int KS_IN = MAX_IN / 8, NT_HID = MAX_HIDDEN / 8,
              NT_OUT = MAX_OUT / 8;
constexpr int ESTRIDE = MAX_IN + 4;  // enc rows: conflict-free A fragments

// shared memory, in floats
constexpr int SM_W1A = 0;                                   // [5][8][32] x2
constexpr int SM_W2 = SM_W1A + KS_IN * NT_HID * 64;         // [8][2][32] x2
constexpr int SM_W1C = SM_W2 + NT_HID * NT_OUT * 64;        // [8][5][32] x2
constexpr int SM_B1 = SM_W1C + NT_HID * KS_IN * 64;
constexpr int SM_W20 = SM_B1 + MAX_HIDDEN;
constexpr int SM_B2 = SM_W20 + MAX_HIDDEN;
constexpr int SM_MASK = SM_B2 + MAX_OUT;
constexpr int SM_SCALE = SM_MASK + MAX_LF;
constexpr int SM_RES = SM_SCALE + MAX_L;
constexpr int SM_X = SM_RES + MAX_L;
constexpr int SM_ENC = SM_X + TILE * 3;
constexpr int SM_JAC = SM_ENC + TILE * ESTRIDE;
constexpr int SM_FLOATS = SM_JAC + TILE * MAX_LF * 3;
constexpr int SM_BYTES = SM_FLOATS * 4;

__device__ __forceinline__ float softplus100(float h) {
  float y = 100.f * h;
  return (fmaxf(y, 0.f) + log1pf(expf(-fabsf(y)))) / 100.f;
}

__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo, both TF32
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32(x);
  lo = tf32(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a . b in 3xTF32 (a split by the caller): the two small cross terms
// first, then hi * hi
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4], float2 b) {
  uint32_t bh0, bl0, bh1, bl1;
  split(b.x, bh0, bl0);
  split(b.y, bh1, bl1);
  mma_tf32(d, al, bh0, bh1);
  mma_tf32(d, ah, bl0, bl1);
  mma_tf32(d, ah, bh0, bh1);
}

__device__ __forceinline__ void split4(const float (&a)[4], uint32_t (&hi)[4],
                                       uint32_t (&lo)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) split(a[i], hi[i], lo[i]);
}

// two floats rounded to nearest even into a bf16 pair, lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint2 b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b.x), "r"(b.y));
}

constexpr int KS16_IN = (MAX_IN + 15) / 16, KS16_HID = MAX_HIDDEN / 16;

template <typename E>
__global__ void __launch_bounds__(THREADS, 2) encode_mlp_sdfgrad_kernel(
    const E* __restrict__ table, const float* __restrict__ x,
    const float* __restrict__ scales, const int* __restrict__ res,
    const float* __restrict__ level_mask, const float* __restrict__ W1,
    const float* __restrict__ b1, const float* __restrict__ W2,
    const float* __restrict__ b2, float* __restrict__ feat,
    float* __restrict__ grad, int64_t N, int L, int T, int F,
    int include_xyz, int d_in, int hidden, int d_out, float xyz_scale,
    float xyz_offset) {
  extern __shared__ float sm[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int off = include_xyz ? 3 : 0;
  const int LF = L * F;

  constexpr bool BF16 = sizeof(E) == 2;
  auto w1 = [&](int i, int u) {
    return (i < d_in && u < hidden) ? W1[i * hidden + u] : 0.f;
  };
  auto w2 = [&](int u, int o) {
    return (u < hidden && o < d_out) ? W2[u * d_out + o] : 0.f;
  };
  // bf16: the weights rounded in B-fragment order of m16n8k16, zero-padded:
  // the pair (k 2t, 2t + 1) in .x and (2t + 8, 2t + 9) in .y, n = gid, k
  // in plain order for all three products
  uint2* v1a = reinterpret_cast<uint2*>(sm + SM_W1A);  // [KS16_IN][8][32]
  uint2* v2f = reinterpret_cast<uint2*>(sm + SM_W2);   // [KS16_HID][2][32]
  uint2* v1c = reinterpret_cast<uint2*>(sm + SM_W1C);  // [KS16_HID][5][32]
  if constexpr (BF16) {
    for (int e = tid; e < KS16_IN * NT_HID * 32; e += THREADS) {
      const int l = e & 31, t = l & 3, g = l >> 2, nt = (e >> 5) % NT_HID,
                k = ((e >> 5) / NT_HID) * 16 + 2 * t, u = nt * 8 + g;
      v1a[e] = make_uint2(pack_bf16(w1(k, u), w1(k + 1, u)),
                          pack_bf16(w1(k + 8, u), w1(k + 9, u)));
    }
    for (int e = tid; e < KS16_HID * NT_OUT * 32; e += THREADS) {
      const int l = e & 31, t = l & 3, g = l >> 2, nt = (e >> 5) % NT_OUT,
                k = ((e >> 5) / NT_OUT) * 16 + 2 * t, o = nt * 8 + g;
      v2f[e] = make_uint2(pack_bf16(w2(k, o), w2(k + 1, o)),
                          pack_bf16(w2(k + 8, o), w2(k + 9, o)));
    }
    for (int e = tid; e < KS16_HID * KS_IN * 32; e += THREADS) {
      const int l = e & 31, t = l & 3, g = l >> 2, nt = (e >> 5) % KS_IN,
                k = ((e >> 5) / KS_IN) * 16 + 2 * t, i = nt * 8 + g;
      v1c[e] = make_uint2(pack_bf16(w1(i, k), w1(i, k + 1)),
                          pack_bf16(w1(i, k + 8), w1(i, k + 9)));
    }
  }
  // float32: weights in B-fragment order, zero-padded: b0 at k position
  // tig, b1 at tig + 4, n = gid.  The first product's K is the input index;
  // the other two take the hidden unit 8j + 2t at position t and 8j + 2t + 1
  // at t + 4.
  float2* w1a = reinterpret_cast<float2*>(sm + SM_W1A);
  float2* w2f = reinterpret_cast<float2*>(sm + SM_W2);
  float2* w1c = reinterpret_cast<float2*>(sm + SM_W1C);
  if constexpr (!BF16) {
    for (int e = tid; e < KS_IN * NT_HID * 32; e += THREADS) {
      const int l = e & 31, t = l & 3, g = l >> 2, nt = (e >> 5) % NT_HID,
                ks = (e >> 5) / NT_HID;
      w1a[e] = make_float2(w1(ks * 8 + t, nt * 8 + g), w1(ks * 8 + t + 4,
                                                          nt * 8 + g));
    }
    for (int e = tid; e < NT_HID * NT_OUT * 32; e += THREADS) {
      const int l = e & 31, t = l & 3, g = l >> 2, nt = (e >> 5) % NT_OUT,
                j = (e >> 5) / NT_OUT;
      w2f[e] = make_float2(w2(j * 8 + 2 * t, nt * 8 + g),
                           w2(j * 8 + 2 * t + 1, nt * 8 + g));
    }
    for (int e = tid; e < NT_HID * KS_IN * 32; e += THREADS) {
      const int l = e & 31, t = l & 3, g = l >> 2, nt = (e >> 5) % KS_IN,
                j = (e >> 5) / KS_IN;
      w1c[e] = make_float2(w1(nt * 8 + g, j * 8 + 2 * t),
                           w1(nt * 8 + g, j * 8 + 2 * t + 1));
    }
  }
  for (int u = tid; u < MAX_HIDDEN; u += THREADS) {
    sm[SM_B1 + u] = u < hidden ? b1[u] : 0.f;
    sm[SM_W20 + u] = w2(u, 0);
  }
  for (int o = tid; o < MAX_OUT; o += THREADS)
    sm[SM_B2 + o] = o < d_out ? b2[o] : 0.f;
  for (int q = tid; q < MAX_LF; q += THREADS)
    sm[SM_MASK + q] = q < LF ? level_mask[q] : 0.f;
  for (int l = tid; l < L; l += THREADS) {
    sm[SM_SCALE + l] = scales[l];
    reinterpret_cast<int*>(sm + SM_RES)[l] = res[l];
  }

  float* sx = sm + SM_X;
  float* enc = sm + SM_ENC;
  float* jac = sm + SM_JAC;
  const uint32_t tmask = (uint32_t)(T - 1);
  const int64_t n_tiles = (N + TILE - 1) / TILE;
  for (int64_t tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int64_t n0 = tile * TILE;
    const int rows = N - n0 < TILE ? (int)(N - n0) : TILE;
    __syncthreads();  // the previous tile's epilogue is done with enc
    for (int e = tid; e < TILE * 3; e += THREADS)
      sx[e] = e < rows * 3 ? x[n0 * 3 + e] : 0.f;
    __syncthreads();
    // ---- 1. gather: xyz columns and padding, then (point, level) items
    for (int p = tid; p < TILE; p += THREADS) {
      float* ep = enc + p * ESTRIDE;
      for (int a = 0; a < off; ++a)
        ep[a] = __fadd_rn(__fmul_rn(sx[p * 3 + a], xyz_scale), xyz_offset);
      for (int i = d_in; i < MAX_IN; ++i) ep[i] = 0.f;
    }
    for (int it = tid; it < TILE * L; it += THREADS) {
      const int p = it / L, l = it - p * L;
      const float s = sm[SM_SCALE + l];
      const int r = reinterpret_cast<const int*>(sm + SM_RES)[l];
      const bool dense = level_is_dense(r, T);
      int c0[3];
      float f[3];
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        const float pos = __fadd_rn(__fmul_rn(sx[p * 3 + a], s), 0.5f);
        const float fl = floorf(pos);
        c0[a] = (int)fl;
        f[a] = pos - fl;
      }
      float e4[4] = {0.f, 0.f, 0.f, 0.f};
      float j4[4][3] = {};
      const E* tab = table + (int64_t)l * T * F;
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const int dx = k >> 2, dy = (k >> 1) & 1, dz = k & 1;
        const float wx = dx ? f[0] : 1.f - f[0];
        const float wy = dy ? f[1] : 1.f - f[1];
        const float wz = dz ? f[2] : 1.f - f[2];
        const float sx_ = dx ? 1.f : -1.f, sy = dy ? 1.f : -1.f,
                    sz = dz ? 1.f : -1.f;
        const float w = wx * wy * wz;
        const float dwx = sx_ * wy * wz, dwy = wx * sy * wz,
                    dwz = wx * wy * sz;
        const int64_t row = corner_row(c0[0], c0[1], c0[2], dx, dy, dz, r,
                                       dense, tmask);
        const E* tr = tab + row * F;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          if (c < F) {
            const float v = entry(__ldg(tr + c));
            e4[c] += w * v;
            j4[c][0] += dwx * v;
            j4[c][1] += dwy * v;
            j4[c][2] += dwz * v;
          }
        }
      }
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        if (c < F) {
          const int q = l * F + c;
          enc[p * ESTRIDE + off + q] = e4[c] * sm[SM_MASK + q];
          float* jq = jac + (p * MAX_LF + q) * 3;
          jq[0] = j4[c][0] * s;
          jq[1] = j4[c][1] * s;
          jq[2] = j4[c][2] * s;
        }
      }
    }
    __syncthreads();

    // ---- 2. the MLP: this warp's 16 points on the tensor cores
    const int r0 = warp * 16;
    const float* e0 = enc + (r0 + gid) * ESTRIDE;
    const float* e8 = e0 + 8 * ESTRIDE;
    float h[NT_HID][4];
#pragma unroll
    for (int j = 0; j < NT_HID; ++j)
      h[j][0] = h[j][1] = h[j][2] = h[j][3] = 0.f;
    float o[NT_OUT][4], gi[KS_IN][4];
#pragma unroll
    for (int t = 0; t < NT_OUT; ++t) o[t][0] = o[t][1] = o[t][2] = o[t][3] = 0.f;
#pragma unroll
    for (int t = 0; t < KS_IN; ++t)
      gi[t][0] = gi[t][1] = gi[t][2] = gi[t][3] = 0.f;
    if constexpr (BF16) {
      // H = enc . W1: enc rounded, a k16 step's columns 16 ks + 2 tig (+1)
      // and + 8 (+9); inputs from MAX_IN = 40 on are zero
#pragma unroll
      for (int ks = 0; ks < KS16_IN; ++ks) {
        const int k = ks * 16 + 2 * tig;
        const float2 p0 = *reinterpret_cast<const float2*>(e0 + k);
        const float2 p8 = *reinterpret_cast<const float2*>(e8 + k);
        uint32_t a[4] = {pack_bf16(p0.x, p0.y), pack_bf16(p8.x, p8.y), 0u,
                         0u};
        if (k + 8 < MAX_IN) {
          const float2 q0 = *reinterpret_cast<const float2*>(e0 + k + 8);
          const float2 q8 = *reinterpret_cast<const float2*>(e8 + k + 8);
          a[2] = pack_bf16(q0.x, q0.y);
          a[3] = pack_bf16(q8.x, q8.y);
        }
#pragma unroll
        for (int j = 0; j < NT_HID; ++j)
          mma_bf16(h[j], a, v1a[(ks * NT_HID + j) * 32 + lane]);
      }
      // k16 step m of the hidden units: n-tiles 2m (k 0-7) and 2m + 1
      // (k 8-15) of H; register 2 * half + (row gid + 8)
#pragma unroll
      for (int m = 0; m < KS16_HID; ++m) {
        uint32_t aa[4], ar[4];
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int j = 2 * m + half, u = j * 8 + 2 * tig;
          const float bb0 = sm[SM_B1 + u], bb1 = sm[SM_B1 + u + 1];
          const float v0 = sm[SM_W20 + u], v1 = sm[SM_W20 + u + 1];
#pragma unroll
          for (int rh = 0; rh < 2; ++rh) {
            const float h0 = h[j][2 * rh] + bb0, h1 = h[j][2 * rh + 1] + bb1;
            aa[2 * half + rh] = pack_bf16(softplus100(h0), softplus100(h1));
            ar[2 * half + rh] =
                pack_bf16(v0 * (1.f / (1.f + expf(-100.f * h0))),
                          v1 * (1.f / (1.f + expf(-100.f * h1))));
          }
        }
#pragma unroll
        for (int t = 0; t < NT_OUT; ++t)
          mma_bf16(o[t], aa, v2f[(m * NT_OUT + t) * 32 + lane]);
#pragma unroll
        for (int t = 0; t < KS_IN; ++t)
          mma_bf16(gi[t], ar, v1c[(m * KS_IN + t) * 32 + lane]);
      }
    } else {
#pragma unroll
      for (int ks = 0; ks < KS_IN; ++ks) {
        const float a[4] = {e0[ks * 8 + tig], e8[ks * 8 + tig],
                            e0[ks * 8 + tig + 4], e8[ks * 8 + tig + 4]};
        uint32_t ah[4], al[4];
        split4(a, ah, al);
#pragma unroll
        for (int j = 0; j < NT_HID; ++j)
          mma3(h[j], ah, al, w1a[(ks * NT_HID + j) * 32 + lane]);
      }
#pragma unroll
      for (int j = 0; j < NT_HID; ++j) {
        // accumulator (row, unit): c0 (g, 2t), c1 (g, 2t+1), c2 (g+8, 2t),
        // c3 (g+8, 2t+1) -> A fragment {c0, c2, c1, c3}
        const int u = j * 8 + 2 * tig;
        const float bb0 = sm[SM_B1 + u], bb1 = sm[SM_B1 + u + 1];
        const float v0 = sm[SM_W20 + u], v1 = sm[SM_W20 + u + 1];
        const float hh[4] = {h[j][0] + bb0, h[j][2] + bb0, h[j][1] + bb1,
                             h[j][3] + bb1};
        const float wv[4] = {v0, v0, v1, v1};
        float act[4], rev[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          act[i] = softplus100(hh[i]);
          rev[i] = wv[i] * (1.f / (1.f + expf(-100.f * hh[i])));
        }
        uint32_t ah[4], al[4];
        split4(act, ah, al);
#pragma unroll
        for (int t = 0; t < NT_OUT; ++t)
          mma3(o[t], ah, al, w2f[(j * NT_OUT + t) * 32 + lane]);
        split4(rev, ah, al);
#pragma unroll
        for (int t = 0; t < KS_IN; ++t)
          mma3(gi[t], ah, al, w1c[(j * KS_IN + t) * 32 + lane]);
      }
    }

    // ---- 3. epilogue: out + b2 and the point gradient, staged in this
    // warp's enc rows (the MLP is done with them)
    __syncwarp();
    float* st = enc + r0 * ESTRIDE;  // [16 x d_out] then [16 x 3]
#pragma unroll
    for (int t = 0; t < NT_OUT; ++t) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = gid + (i >> 1) * 8, oc = t * 8 + 2 * tig + (i & 1);
        if (oc < d_out) st[row * d_out + oc] = o[t][i] + sm[SM_B2 + oc];
      }
    }
    float g[2][3] = {{0.f, 0.f, 0.f}, {0.f, 0.f, 0.f}};
#pragma unroll
    for (int t = 0; t < KS_IN; ++t) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int hf = i >> 1, row = r0 + gid + hf * 8;
        const int col = t * 8 + 2 * tig + (i & 1);
        if (t == 0 && col < off) {
          const float v = gi[t][i] * xyz_scale;
          g[hf][0] += col == 0 ? v : 0.f;
          g[hf][1] += col == 1 ? v : 0.f;
          g[hf][2] += col == 2 ? v : 0.f;
        } else if (col - off < LF) {
          const int q = col - off;
          const float gq = gi[t][i] * sm[SM_MASK + q];
          const float* jq = jac + (row * MAX_LF + q) * 3;
          g[hf][0] += gq * jq[0];
          g[hf][1] += gq * jq[1];
          g[hf][2] += gq * jq[2];
        }
      }
    }
#pragma unroll
    for (int hf = 0; hf < 2; ++hf)
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        float v = g[hf][a];
        v += __shfl_xor_sync(0xffffffffu, v, 1);
        v += __shfl_xor_sync(0xffffffffu, v, 2);
        g[hf][a] = v;
      }
    float* sg = st + 16 * d_out;
    if (tig == 0) {
#pragma unroll
      for (int hf = 0; hf < 2; ++hf)
#pragma unroll
        for (int a = 0; a < 3; ++a) sg[(gid + hf * 8) * 3 + a] = g[hf][a];
    }
    __syncwarp();
    const int wrows = max(0, min(16, rows - r0));
    float* fo = feat + (n0 + r0) * d_out;
    for (int e = lane; e < wrows * d_out; e += 32) fo[e] = st[e];
    float* go = grad + (n0 + r0) * 3;
    for (int e = lane; e < wrows * 3; e += 32) go[e] = sg[e];
  }
}

// KB': the backward of KB, two launches around the MLP's vector-Jacobian
// product (which stays in PyTorch, as JAX leaves it to XLA).
//
// Replaces intrinsicavatar_tpu/ops/encode_grad.py:225-344 (_bwd of
// encode_mlp_sdfgrad): pass 1 (:238-269) regathers each level's corner rows
// and writes enc and g_genc_cot, the cotangent that the point gradient's
// cotangent g_grad puts on the MLP's input gradient (u_k = s * g_grad .
// dw_k / dpos); pass 2 (:288-341) adds the merged row cotangent
// w_k * d_enc + u_k * g_enc into the table (the TPU sorts and aggregates,
// ops/scatter.py; here an atomicAdd into the row each corner read) and pulls
// xn back: the encode path s * sum_k (row_k . d_enc) dw_k and the s^2
// second-order terms of the gradient path.
//
// What bounds them on an H100: bytes.  Pass 1 gathers N * L * 8 * F * 4 B
// of table rows (counted at most at the table's size) and writes 2 * N *
// d_in floats; pass 2 gathers the same rows when d_xn is asked for and adds
// N * L * 8 corner rows of F floats into a 64 MB cotangent (each row its
// corners touch counted read and written once).  A few dozen flops per
// (point, level, corner) stay far below the gather time; pass 2's time is
// set by its reductions, which the L2 serializes where many land on one
// row.
//
// Design of pass 1 (KA's, csrc/hashgrid.cu): persistent blocks walk 64-point
// tiles.  A block stages the tile's points and g_grad rows (coalesced
// loads) and, once, the per-level scales, resolutions, dense flags and mask
// in shared memory, so no thread reloads a point or divides in int64.  A
// warp takes 32 points of one level, so the ray-ordered points of a warp
// share a coarse level's corner sectors within one load.  For F = 2 a
// corner row is one float2 and the x pair of corners one float4 where both
// rows lie in one aligned pair of rows.  Each
// (point, level) runs the one-thread-a-(point, level) kernel's arithmetic
// in its order, so enc and g_genc_cot keep its bits.  A level the mask
// zeroes is gathered all the same: its outputs are e * 0, which is -0 for
// a negative e.  The tile's enc and g_genc_cot rows are staged in shared
// memory at an odd stride and written out with 16-byte stores.  Nothing
// is kept between the passes but enc and g_genc_cot (the corner weights
// are recomputed from xn).
//
// Design of pass 2: persistent blocks walk 64-point tiles, as KA does.  A
// block stages the tile's points, g_grad and its d_enc and g_enc rows
// (coalesced loads) and the per-level scales, resolutions, flags and mask
// in shared memory.  A warp takes 32 points of one level, so the
// ray-ordered points of a warp add into few rows (on a train step's
// shading call half or more of a warp's adds at every level share a row
// with another lane's): at each corner the lanes that add into one row
// find each other with __match_any_sync, and the lowest sums their terms
// in lane order and issues the row's one reduction
// (common.cuh:warp_row_add).  A row's F = 2 features go as one 8-byte
// vector reduction (sm_90's red.global.add.v2.f32; F = 4 as .v4).  A level
// the mask zeroes reads and adds nothing.
// d_xn takes no atomics: each (point, level) leaves its 3 partials in
// shared memory, and the block sums them in level order and stores the
// point's 3 floats once.
constexpr int KB1_TILE = 64;  // points a tile, a multiple of 32
constexpr int KB1_THREADS = 256;
constexpr int KB1_WARPS = KB1_THREADS / 32;
constexpr int KB1_SD = (MAX_LF + 3) | 1;  // odd stride of a staged row

// One (point p, level l) item of pass 1: the 8 corner rows of the level at
// p (px, its g_grad gn), blended with the corner weights into eo and with
// u_k = s * g_grad . dw_k / dpos into go, masked.
template <int F>
__device__ __forceinline__ void gather_item(const float* __restrict__ tab,
                                            const float* px, const float* gn,
                                            float s, int r, bool dense,
                                            uint32_t tmask, const float* mask,
                                            float* eo, float* go) {
  int c0[3];
  float f[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float pos = __fadd_rn(__fmul_rn(px[a], s), 0.5f);
    const float fl = floorf(pos);
    c0[a] = (int)fl;
    f[a] = pos - fl;
  }
  int X[2], Y[2], Z[2];
#pragma unroll
  for (int d = 0; d < 2; ++d) {
    X[d] = axis_corner(c0[0], d, r, dense);
    Y[d] = axis_corner(c0[1], d, r, dense);
    Z[d] = axis_corner(c0[2], d, r, dense);
  }
  auto row = [&](int dx, int dy, int dz) {
    return corner_index(X[dx], Y[dy], Z[dz], r, dense, tmask);
  };
  // v[k][c], corner k = dx * 4 + dy * 2 + dz
  float v[8][F];
  if constexpr (F == 2) {
    const float4* t4 = reinterpret_cast<const float4*>(tab);
    const float2* t2 = reinterpret_cast<const float2*>(tab);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const uint32_t r0 = row(0, q >> 1, q & 1), r1 = row(1, q >> 1, q & 1);
      const float4 pair = __ldg(t4 + (r0 >> 1));
      v[q][0] = (r0 & 1) ? pair.z : pair.x;
      v[q][1] = (r0 & 1) ? pair.w : pair.y;
      if ((r0 >> 1) == (r1 >> 1)) {
        v[q + 4][0] = (r1 & 1) ? pair.z : pair.x;
        v[q + 4][1] = (r1 & 1) ? pair.w : pair.y;
      } else {
        const float2 b = __ldg(t2 + r1);
        v[q + 4][0] = b.x;
        v[q + 4][1] = b.y;
      }
    }
  } else {
#pragma unroll
    for (int k = 0; k < 8; ++k)
#pragma unroll
      for (int c = 0; c < F; ++c)
        v[k][c] = __ldg(tab + (int64_t)row(k >> 2, (k >> 1) & 1, k & 1) * F
                        + c);
  }
  float e[F], u[F];
#pragma unroll
  for (int c = 0; c < F; ++c) {
    e[c] = 0.f;
    u[c] = 0.f;
  }
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int dx = k >> 2, dy = (k >> 1) & 1, dz = k & 1;
    const float wx = dx ? f[0] : 1.f - f[0];
    const float wy = dy ? f[1] : 1.f - f[1];
    const float wz = dz ? f[2] : 1.f - f[2];
    const float sx = dx ? 1.f : -1.f, sy = dy ? 1.f : -1.f,
                sz = dz ? 1.f : -1.f;
    const float w = wx * wy * wz;
    const float uk = s * (gn[0] * (sx * wy * wz) + gn[1] * (wx * sy * wz)
                          + gn[2] * (wx * wy * sz));
#pragma unroll
    for (int c = 0; c < F; ++c) {
      e[c] += w * v[k][c];
      u[c] += uk * v[k][c];
    }
  }
#pragma unroll
  for (int c = 0; c < F; ++c) {
    eo[c] = e[c] * mask[c];
    go[c] = u[c] * mask[c];
  }
}

// Copy n floats of shared memory at stride sd a row of d floats to the
// contiguous rows at dst (16-byte aligned): 16-byte stores, then the tail.
__device__ __forceinline__ void store_rows(float* __restrict__ dst,
                                           const float* src, int n, int d,
                                           int sd) {
  const int n4 = n >> 2;
  for (int q = threadIdx.x; q < n4; q += blockDim.x) {
    int p = (q * 4) / d, c = q * 4 - p * d;
    float v[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      v[j] = src[p * sd + c];
      if (++c == d) {
        c = 0;
        ++p;
      }
    }
    reinterpret_cast<float4*>(dst)[q] = make_float4(v[0], v[1], v[2], v[3]);
  }
  for (int e = n4 * 4 + threadIdx.x; e < n; e += blockDim.x) {
    const int p = e / d;
    dst[e] = src[p * sd + e - p * d];
  }
}

template <int F>
__global__ void __launch_bounds__(KB1_THREADS)
encode_mlp_sdfgrad_bwd_gather_kernel(
    const float* __restrict__ table, const float* __restrict__ x,
    const float* __restrict__ scales, const int* __restrict__ res,
    const float* __restrict__ level_mask, const float* __restrict__ g_grad,
    float* __restrict__ enc, float* __restrict__ gg, int64_t N, int L, int T,
    int include_xyz, float xyz_scale, float xyz_offset) {
  __shared__ float s_x[KB1_TILE * 3], s_g[KB1_TILE * 3];
  __shared__ float s_enc[KB1_TILE * KB1_SD], s_gg[KB1_TILE * KB1_SD];
  __shared__ float s_scale[MAX_L], s_mask[MAX_LF];
  __shared__ int s_res[MAX_L], s_dense[MAX_L];
  const int tid = threadIdx.x, lane = tid & 31;
  const int off = include_xyz ? 3 : 0;
  const int D = L * F + off, SD = D | 1;
  for (int l = tid; l < L; l += KB1_THREADS) {
    s_scale[l] = scales[l];
    s_res[l] = res[l];
    s_dense[l] = level_is_dense(res[l], T);
  }
  for (int q = tid; q < L * F; q += KB1_THREADS) s_mask[q] = level_mask[q];
  const uint32_t tmask = (uint32_t)(T - 1);
  const int64_t n_tiles = (N + KB1_TILE - 1) / KB1_TILE;
  for (int64_t tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int64_t n0 = tile * KB1_TILE;
    const int rows = N - n0 < KB1_TILE ? (int)(N - n0) : KB1_TILE;
    __syncthreads();  // the previous tile is written out
    for (int e = tid; e < rows * 3; e += KB1_THREADS) {
      s_x[e] = x[n0 * 3 + e];
      s_g[e] = g_grad[n0 * 3 + e];
    }
    __syncthreads();
    if (include_xyz) {
      for (int e = tid; e < rows * 3; e += KB1_THREADS) {
        const int p = e / 3, a = e - p * 3;
        s_enc[p * SD + a] =
            __fadd_rn(__fmul_rn(s_x[e], xyz_scale), xyz_offset);
        s_gg[p * SD + a] = s_g[e] * xyz_scale;
      }
    }
    // warp item w: level w % L of the tile's points 32 (w / L) + lane
    for (int w = tid >> 5; w < (KB1_TILE / 32) * L; w += KB1_WARPS) {
      const int l = w % L, p = (w / L) * 32 + lane;
      if (p >= rows) continue;
      const int q = p * SD + off + l * F;
      gather_item<F>(table + (int64_t)l * T * F, s_x + p * 3, s_g + p * 3,
                     s_scale[l], s_res[l], s_dense[l] != 0, tmask,
                     s_mask + l * F, s_enc + q, s_gg + q);
    }
    __syncthreads();
    // the tile's rows are contiguous in each output (n0 * D is a multiple
    // of 4 floats)
    store_rows(enc + n0 * D, s_enc, rows * D, D, SD);
    store_rows(gg + n0 * D, s_gg, rows * D, D, SD);
  }
}

template <int F>
int launch_gather(const float* table, const float* x, const float* scales,
                  const int* res, const float* level_mask,
                  const float* g_grad, float* enc, float* gg, long long N,
                  int L, int T, int include_xyz, float xyz_scale,
                  float xyz_offset, cudaStream_t stream) {
  static int resident[kMaxDevices] = {};
  unsigned blocks = 0;
  const cudaError_t err = persistent_grid(
      encode_mlp_sdfgrad_bwd_gather_kernel<F>, KB1_THREADS, 0,
      (N + KB1_TILE - 1) / KB1_TILE, resident, blocks);
  if (err != cudaSuccess) return (int)err;
  encode_mlp_sdfgrad_bwd_gather_kernel<F><<<blocks, KB1_THREADS, 0, stream>>>(
      table, x, scales, res, level_mask, g_grad, enc, gg, N, L, T,
      include_xyz, xyz_scale, xyz_offset);
  return launch_status();
}

constexpr int KB2_TILE = 64;  // points a tile, a multiple of 32
constexpr int KB2_THREADS = 256;
constexpr int KB2_WARPS = KB2_THREADS / 32;
constexpr int KB2_SD = (MAX_LF + 3) | 1;  // odd stride of a staged d_enc row

// dynamic shared memory in floats: points, g_grad, d_enc, g_enc, the warps'
// merge scratch, the level constants, and with d_xn its partials
constexpr int kb2_smem_floats(bool xn) {
  return KB2_TILE * 6 + 2 * KB2_TILE * KB2_SD + KB2_WARPS * 32 * 4
         + 2 * MAX_L + MAX_LF + (xn ? MAX_L * KB2_TILE * 3 : 0);
}

// One (point p, level l) item of pass 2: the 8 corners' row cotangents into
// the level's table cotangent, and with XN the point's partials of d_xn
// for this level into s_dxn.
template <int F, bool XN>
__device__ __forceinline__ void scatter_item(
    const float* __restrict__ tab, float* __restrict__ dtab, const float* px,
    const float* gn, const float* de_row, const float* ge_row,
    const float* mask, float s, int r, bool dense, uint32_t tmask,
    unsigned active, float* scratch, int lane, float* dxn) {
  float de[F], gl[F];
#pragma unroll
  for (int c = 0; c < F; ++c) {
    de[c] = de_row[c] * mask[c];
    gl[c] = ge_row[c] * mask[c];
  }
  int c0[3];
  float f[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float pos = __fadd_rn(__fmul_rn(px[a], s), 0.5f);
    const float fl = floorf(pos);
    c0[a] = (int)fl;
    f[a] = pos - fl;
  }
  int X[2], Y[2], Z[2];
#pragma unroll
  for (int d = 0; d < 2; ++d) {
    X[d] = axis_corner(c0[0], d, r, dense);
    Y[d] = axis_corner(c0[1], d, r, dense);
    Z[d] = axis_corner(c0[2], d, r, dense);
  }
  uint32_t rows[8];
#pragma unroll
  for (int k = 0; k < 8; ++k)
    rows[k] = corner_index(X[k >> 2], Y[(k >> 1) & 1], Z[k & 1], r, dense,
                           tmask);
  // with d_xn the 8 corner rows of the table are loaded before the corner
  // loop, whose reductions the compiler does not move loads across
  float t[XN ? 8 : 1][F];
  if constexpr (XN) {
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      if constexpr (F == 2) {
        const float2 t2 =
            __ldg(reinterpret_cast<const float2*>(tab) + rows[k]);
        t[k][0] = t2.x;
        t[k][1] = t2.y;
      } else {
#pragma unroll
        for (int c = 0; c < F; ++c)
          t[k][c] = __ldg(tab + (int64_t)rows[k] * F + c);
      }
    }
  }
  float ge[3] = {0.f, 0.f, 0.f}, g2[3] = {0.f, 0.f, 0.f};
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int dx = k >> 2, dy = (k >> 1) & 1, dz = k & 1;
    const float wx = dx ? f[0] : 1.f - f[0];
    const float wy = dy ? f[1] : 1.f - f[1];
    const float wz = dz ? f[2] : 1.f - f[2];
    const float sx = dx ? 1.f : -1.f, sy = dy ? 1.f : -1.f,
                sz = dz ? 1.f : -1.f;
    const float w = wx * wy * wz;
    const float dwx = sx * wy * wz, dwy = wx * sy * wz, dwz = wx * wy * sz;
    const float uk = s * (gn[0] * dwx + gn[1] * dwy + gn[2] * dwz);
    float v[F];
#pragma unroll
    for (int c = 0; c < F; ++c) v[c] = w * de[c] + uk * gl[c];
    warp_row_add<F>(dtab, rows[k], v, active, scratch, lane);
    if constexpr (XN) {
      float re = 0.f, fg = 0.f;
#pragma unroll
      for (int c = 0; c < F; ++c) {
        re += t[k][c] * de[c];
        fg += t[k][c] * gl[c];
      }
      ge[0] += re * dwx;
      ge[1] += re * dwy;
      ge[2] += re * dwz;
      g2[0] += fg * sx * (gn[1] * sy * wz + gn[2] * sz * wy);
      g2[1] += fg * sy * (gn[0] * sx * wz + gn[2] * sz * wx);
      g2[2] += fg * sz * (gn[0] * sx * wy + gn[1] * sy * wx);
    }
  }
  if constexpr (XN) {
#pragma unroll
    for (int a = 0; a < 3; ++a) dxn[a] = s * ge[a] + (s * s) * g2[a];
  }
}

template <int F, bool XN>
__global__ void __launch_bounds__(KB2_THREADS)
encode_mlp_sdfgrad_bwd_scatter_kernel(
    const float* __restrict__ table, const float* __restrict__ x,
    const float* __restrict__ scales, const int* __restrict__ res,
    const float* __restrict__ level_mask, const float* __restrict__ g_grad,
    const float* __restrict__ d_enc, const float* __restrict__ g_enc,
    float* __restrict__ d_table, float* __restrict__ d_xn, int64_t N, int L,
    int T, int include_xyz, float xyz_scale) {
  extern __shared__ __align__(16) float kb2_smem[];
  float* s_x = kb2_smem;                        // [TILE][3]
  float* s_g = s_x + KB2_TILE * 3;              // [TILE][3]
  float* s_de = s_g + KB2_TILE * 3;             // [TILE][SD]
  float* s_ge = s_de + KB2_TILE * KB2_SD;       // [TILE][SD]
  float* s_scr = s_ge + KB2_TILE * KB2_SD;      // [WARPS][4][32]
  float* s_scale = s_scr + KB2_WARPS * 32 * 4;  // [MAX_L]
  float* s_mask = s_scale + MAX_L;              // [MAX_LF]
  int* s_res = reinterpret_cast<int*>(s_mask + MAX_LF);  // [MAX_L]
  float* s_dxn = reinterpret_cast<float*>(s_res + MAX_L);  // [L][TILE][3]
  __shared__ int s_flags[MAX_L];  // bit 0: dense, bit 1: not masked off
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int off = include_xyz ? 3 : 0;
  const int D = L * F + off;
  for (int l = tid; l < L; l += KB2_THREADS) {
    bool on = false;
    for (int c = 0; c < F; ++c) on |= level_mask[l * F + c] != 0.f;
    s_scale[l] = scales[l];
    s_res[l] = res[l];
    s_flags[l] = (level_is_dense(res[l], T) ? 1 : 0) | (on ? 2 : 0);
  }
  for (int q = tid; q < L * F; q += KB2_THREADS) s_mask[q] = level_mask[q];
  const uint32_t tmask = (uint32_t)(T - 1);
  float* scratch = s_scr + warp * 32 * 4;
  const int64_t n_tiles = (N + KB2_TILE - 1) / KB2_TILE;
  for (int64_t tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int64_t n0 = tile * KB2_TILE;
    const int rows = N - n0 < KB2_TILE ? (int)(N - n0) : KB2_TILE;
    __syncthreads();  // the previous tile is done with shared memory
    for (int e = tid; e < rows * 3; e += KB2_THREADS) {
      s_x[e] = x[n0 * 3 + e];
      s_g[e] = g_grad[n0 * 3 + e];
    }
    for (int e = tid; e < rows * D; e += KB2_THREADS) {
      const int p = e / D;
      s_de[p * KB2_SD + e - p * D] = d_enc[n0 * D + e];
      s_ge[p * KB2_SD + e - p * D] = g_enc[n0 * D + e];
    }
    __syncthreads();
    // warp item w: level w % L of the tile's points 32 (w / L) + lane
    for (int w = warp; w < (KB2_TILE / 32) * L; w += KB2_WARPS) {
      const int l = w % L, p = (w / L) * 32 + lane;
      const int flags = s_flags[l];
      if (!(flags & 2)) continue;  // masked off: nothing to add
      const unsigned active = __ballot_sync(0xffffffffu, p < rows);
      if (p >= rows) continue;
      const int q = off + l * F;
      scatter_item<F, XN>(table + (int64_t)l * T * F,
                          d_table + (int64_t)l * T * F, s_x + p * 3,
                          s_g + p * 3, s_de + p * KB2_SD + q,
                          s_ge + p * KB2_SD + q, s_mask + l * F, s_scale[l],
                          s_res[l], (flags & 1) != 0, tmask, active, scratch,
                          lane, s_dxn + (l * KB2_TILE + p) * 3);
    }
    if constexpr (XN) {
      __syncthreads();
      for (int p = tid; p < rows; p += KB2_THREADS) {
        float v[3] = {0.f, 0.f, 0.f};
        for (int l = 0; l < L; ++l) {
          if (!(s_flags[l] & 2)) continue;
#pragma unroll
          for (int a = 0; a < 3; ++a)
            v[a] += s_dxn[(l * KB2_TILE + p) * 3 + a];
        }
#pragma unroll
        for (int a = 0; a < 3; ++a) {
          if (include_xyz) v[a] += s_de[p * KB2_SD + a] * xyz_scale;
          d_xn[(n0 + p) * 3 + a] = v[a];
        }
      }
    }
  }
}

template <int F, bool XN>
int launch_scatter(const float* table, const float* x, const float* scales,
                   const int* res, const float* level_mask,
                   const float* g_grad, const float* d_enc,
                   const float* g_enc, float* d_table, float* d_xn,
                   long long N, int L, int T, int include_xyz,
                   float xyz_scale, cudaStream_t stream) {
  static int resident[kMaxDevices] = {};
  constexpr int smem = kb2_smem_floats(XN) * 4;
  unsigned blocks = 0;
  const cudaError_t err = persistent_grid(
      encode_mlp_sdfgrad_bwd_scatter_kernel<F, XN>, KB2_THREADS, smem,
      (N + KB2_TILE - 1) / KB2_TILE, resident, blocks);
  if (err != cudaSuccess) return (int)err;
  encode_mlp_sdfgrad_bwd_scatter_kernel<F, XN>
      <<<blocks, KB2_THREADS, smem, stream>>>(
          table, x, scales, res, level_mask, g_grad, d_enc, g_enc, d_table,
          d_xn, N, L, T, include_xyz, xyz_scale);
  return launch_status();
}

}  // namespace

extern "C" int encode_mlp_sdfgrad_bwd_gather(
    const float* table, const float* x, const float* scales, const int* res,
    const float* level_mask, const float* g_grad, float* enc, float* gg,
    long long N, int L, int T, int F, int include_xyz, float xyz_scale,
    float xyz_offset, void* stream) {
  if (F < 1 || F > 4 || L > MAX_L || L * F > MAX_LF)
    return (int)cudaErrorInvalidValue;
  // the 16-byte stores of the staged rows, and the table's row pairs as
  // float4 (F = 2)
  if (((reinterpret_cast<uintptr_t>(enc) | reinterpret_cast<uintptr_t>(gg))
       & 15) ||
      (F == 2 && (reinterpret_cast<uintptr_t>(table) & 15)))
    return (int)cudaErrorMisalignedAddress;
  if (N <= 0) return 0;
  const cudaStream_t st = (cudaStream_t)stream;
#define KB1_LAUNCH(FF)                                                     \
  return launch_gather<FF>(table, x, scales, res, level_mask, g_grad, enc, \
                           gg, N, L, T, include_xyz, xyz_scale, xyz_offset, \
                           st)
  switch (F) {
    case 1: KB1_LAUNCH(1);
    case 2: KB1_LAUNCH(2);
    case 3: KB1_LAUNCH(3);
    default: KB1_LAUNCH(4);
  }
#undef KB1_LAUNCH
}

extern "C" int encode_mlp_sdfgrad_bwd_scatter(
    const float* table, const float* x, const float* scales, const int* res,
    const float* level_mask, const float* g_grad, const float* d_enc,
    const float* g_enc, float* d_table, float* d_xn, long long N, int L,
    int T, int F, int include_xyz, float xyz_scale, void* stream) {
  if (F < 1 || F > 4 || L > MAX_L || L * F > MAX_LF)
    return (int)cudaErrorInvalidValue;
  if (N <= 0) return 0;
  const cudaStream_t st = (cudaStream_t)stream;
#define KB2_LAUNCH(FF)                                                       \
  return d_xn ? launch_scatter<FF, true>(table, x, scales, res, level_mask, \
                                         g_grad, d_enc, g_enc, d_table,     \
                                         d_xn, N, L, T, include_xyz,        \
                                         xyz_scale, st)                     \
              : launch_scatter<FF, false>(table, x, scales, res,            \
                                          level_mask, g_grad, d_enc, g_enc, \
                                          d_table, d_xn, N, L, T,           \
                                          include_xyz, xyz_scale, st)
  switch (F) {
    case 1: KB2_LAUNCH(1);
    case 2: KB2_LAUNCH(2);
    case 3: KB2_LAUNCH(3);
    default: KB2_LAUNCH(4);
  }
#undef KB2_LAUNCH
}

// KB (float32 table) or its bf16 form (bf16 table).
template <typename E>
int launch_fwd(const E* table, const float* x, const float* scales,
               const int* res, const float* level_mask, const float* W1,
               const float* b1, const float* W2, const float* b2, float* feat,
               float* grad, long long N, int L, int T, int F, int include_xyz,
               int d_in, int hidden, int d_out, float xyz_scale,
               float xyz_offset, void* stream) {
  if (d_in > MAX_IN || hidden > MAX_HIDDEN || d_out > MAX_OUT || d_out < 1 ||
      L * F > MAX_LF || F > 4 || d_in != L * F + (include_xyz ? 3 : 0))
    return (int)cudaErrorInvalidValue;
  if (N <= 0) return 0;
  static int resident[kMaxDevices] = {};
  unsigned blocks = 0;
  const cudaError_t err =
      persistent_grid(encode_mlp_sdfgrad_kernel<E>, THREADS, SM_BYTES,
                      (N + TILE - 1) / TILE, resident, blocks);
  if (err != cudaSuccess) return (int)err;
  encode_mlp_sdfgrad_kernel<E><<<blocks, THREADS, SM_BYTES,
                                 (cudaStream_t)stream>>>(
      table, x, scales, res, level_mask, W1, b1, W2, b2, feat, grad, N, L, T,
      F, include_xyz, d_in, hidden, d_out, xyz_scale, xyz_offset);
  return launch_status();
}

extern "C" int encode_mlp_sdfgrad_fwd(
    const float* table, const float* x, const float* scales, const int* res,
    const float* level_mask, const float* W1, const float* b1,
    const float* W2, const float* b2, float* feat, float* grad, long long N,
    int L, int T, int F, int include_xyz, int d_in, int hidden, int d_out,
    float xyz_scale, float xyz_offset, void* stream) {
  return launch_fwd(table, x, scales, res, level_mask, W1, b1, W2, b2, feat,
                    grad, N, L, T, F, include_xyz, d_in, hidden, d_out,
                    xyz_scale, xyz_offset, stream);
}

// The bf16 form: `table` holds bf16 entries; the weights are float32 and
// rounded in the kernel.
extern "C" int encode_mlp_sdfgrad_fwd_bf16(
    const void* table, const float* x, const float* scales, const int* res,
    const float* level_mask, const float* W1, const float* b1,
    const float* W2, const float* b2, float* feat, float* grad, long long N,
    int L, int T, int F, int include_xyz, int d_in, int hidden, int d_out,
    float xyz_scale, float xyz_offset, void* stream) {
  return launch_fwd(static_cast<const __nv_bfloat16*>(table), x, scales, res,
                    level_mask, W1, b1, W2, b2, feat, grad, N, L, T, F,
                    include_xyz, d_in, hidden, d_out, xyz_scale, xyz_offset,
                    stream);
}
