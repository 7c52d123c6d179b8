// KA: multi-level hash-grid encode, forward (KA', its backward, below).
//
// Replaces intrinsicavatar_tpu/ops/hashgrid.py:191 hashgrid_encode_raw (the
// TPU version gathers one corner-packed row per dense level and eight rows
// per hashed level, because TPU gathers are priced per row).
//
// What bounds it on an H100: the gathered table rows, N * L * 8 corners of
// F * 4 B at scattered addresses.  The rows the 16 published levels use are
// ~48 MiB (5 dense levels, 16^3 to 71^3 rows, and 11 hashed levels of 2^19
// rows x 8 B), about the 50 MB L2, through which the [N, D] output also
// streams; so the kernel lives on L2 and L1 hits and on how many load
// instructions and sectors each (point, level) costs.  The arithmetic is a
// few dozen flops per (point, level).
//
// Design: persistent blocks (as many as fit on the card) walk over tiles of
// 64 points.  A block stages the tile's points and, once, the per-level
// scales, resolutions, dense flags and mask in shared memory, so no thread
// reads a point or a level constant from device memory or divides in int64.
// Within a tile each warp takes 32 points of one level (lanes = points), so
// the ray-ordered points of a request share the coarse levels' corner
// sectors within one load instruction, and a level's branch (dense or
// hashed) is the same for the whole warp.  For F = 2 each corner row is one
// 8-byte float2, and the pair of corners that differ only in x is one
// 16-byte float4 whenever both rows lie in one aligned pair of rows: dense
// levels put x fastest and the x prime of the hash is 1, so this holds for
// most dense cells and for every hashed cell with an even x; otherwise the
// second row is a float2 of its own.  The corners are summed in the order
// k = dx * 4 + dy * 2 + dz of the plain version, with the index rules of
// common.cuh (axis_corner, corner_index), which KA', KB and KB' share.
// The tile's [64, D] output is staged in shared memory (rows at an odd
// stride, so the 32 points of one level write 32 banks) and written out
// with coalesced 16-byte stores; D = L * F, plus 3 with include_xyz, and a
// ragged last tile.
//
// The bf16-row form (hashgrid_encode_fwd_bf16) replaces the same op inside
// the JAX package's bf16 scope (intrinsicavatar_tpu/ops/hashgrid.py:220,
// the table cast before the gathers): the same kernel on a bf16 table
// (the element type a template parameter), so an F = 2 row is 4 bytes and
// an aligned pair of rows one 8-byte load; the rows are widened to float32
// (exact) and blended, masked and written in float32 as above.  Its bytes
// are half the float32 form's; its arithmetic is the same.
#include "common.cuh"

namespace {

constexpr int KA_TILE = 64;       // points a tile, a multiple of 32
constexpr int KA_THREADS = 256;
constexpr int KA_MAX_L = 32;
constexpr int KA_MAX_LF = 64;
constexpr int KA_MAX_SD = (KA_MAX_LF + 3) | 1;  // odd output row stride

// One (point, level) item: the trilinear blend of the level's 8 corner rows
// at point p (x in shared memory), masked, into the output row o.
template <int F, typename E>
__device__ __forceinline__ void encode_item(const E* __restrict__ tab,
                                            const float* px, float s, int r,
                                            bool dense, uint32_t tmask,
                                            const float* mask, float* o) {
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
  float acc[F];
#pragma unroll
  for (int c = 0; c < F; ++c) acc[c] = 0.f;
  if constexpr (F == 2) {
    // v[k], k = dx * 4 + q, q = dy * 2 + dz: the x pair of each (dy, dz)
    using R = Rows2<E>;
    using Pair = typename R::Pair;
    using Row = typename R::Row;
    const Pair* t4 = reinterpret_cast<const Pair*>(tab);
    const Row* t2 = reinterpret_cast<const Row*>(tab);
    float2 v[8];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const uint32_t r0 = row(0, q >> 1, q & 1), r1 = row(1, q >> 1, q & 1);
      const Pair pair = __ldg(t4 + (r0 >> 1));
      v[q] = (r0 & 1) ? R::hi(pair) : R::lo(pair);
      if ((r0 >> 1) == (r1 >> 1))
        v[q + 4] = (r1 & 1) ? R::hi(pair) : R::lo(pair);
      else
        v[q + 4] = R::row(__ldg(t2 + r1));
    }
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int dx = k >> 2, dy = (k >> 1) & 1, dz = k & 1;
      const float w = (dx ? f[0] : 1.f - f[0]) * (dy ? f[1] : 1.f - f[1])
                      * (dz ? f[2] : 1.f - f[2]);
      acc[0] += w * v[k].x;
      acc[1] += w * v[k].y;
    }
  } else {
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int dx = k >> 2, dy = (k >> 1) & 1, dz = k & 1;
      const float w = (dx ? f[0] : 1.f - f[0]) * (dy ? f[1] : 1.f - f[1])
                      * (dz ? f[2] : 1.f - f[2]);
      const E* tr = tab + (int64_t)row(dx, dy, dz) * F;
#pragma unroll
      for (int c = 0; c < F; ++c) acc[c] += w * entry(__ldg(tr + c));
    }
  }
#pragma unroll
  for (int c = 0; c < F; ++c) o[c] = acc[c] * mask[c];
}

template <int F, typename E>
__global__ void __launch_bounds__(KA_THREADS, 4) hashgrid_encode_kernel(
    const E* __restrict__ table, const float* __restrict__ x,
    const float* __restrict__ scales, const int* __restrict__ res,
    const float* __restrict__ level_mask, float* __restrict__ out, int64_t N,
    int L, int T, int include_xyz, float xyz_scale, float xyz_offset) {
  __shared__ float s_x[KA_TILE * 3];
  __shared__ __align__(16) float s_out[KA_TILE * KA_MAX_SD];
  __shared__ float s_scale[KA_MAX_L], s_mask[KA_MAX_LF];
  __shared__ int s_res[KA_MAX_L], s_dense[KA_MAX_L];
  const int tid = threadIdx.x, lane = tid & 31;
  const int off = include_xyz ? 3 : 0;
  const int D = L * F + off, SD = D | 1;
  for (int l = tid; l < L; l += KA_THREADS) {
    s_scale[l] = scales[l];
    s_res[l] = res[l];
    s_dense[l] = level_is_dense(res[l], T);
  }
  for (int q = tid; q < L * F; q += KA_THREADS)
    s_mask[q] = level_mask ? level_mask[q] : 1.f;
  const uint32_t tmask = (uint32_t)(T - 1);
  const int64_t n_tiles = (N + KA_TILE - 1) / KA_TILE;
  for (int64_t tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int64_t n0 = tile * KA_TILE;
    const int rows = N - n0 < KA_TILE ? (int)(N - n0) : KA_TILE;
    __syncthreads();  // the previous tile is written out
    for (int e = tid; e < rows * 3; e += KA_THREADS) s_x[e] = x[n0 * 3 + e];
    __syncthreads();
    if (include_xyz) {
      for (int e = tid; e < rows * 3; e += KA_THREADS) {
        const int p = e / 3;
        s_out[p * SD + e - p * 3] =
            __fadd_rn(__fmul_rn(s_x[e], xyz_scale), xyz_offset);
      }
    }
    // warp item w: level w % L of the tile's points 32 (w / L) + lane
    for (int w = tid >> 5; w < (KA_TILE / 32) * L; w += KA_THREADS / 32) {
      const int l = w % L, p = (w / L) * 32 + lane;
      if (p >= rows) continue;
      encode_item<F, E>(table + (int64_t)l * T * F, s_x + p * 3,
                        s_scale[l], s_res[l], s_dense[l] != 0, tmask,
                        s_mask + l * F, s_out + p * SD + off + l * F);
    }
    __syncthreads();
    // the tile's rows are contiguous in `out`: 16-byte stores, then the
    // ragged tail (n0 * D is a multiple of 4 floats)
    float* dst = out + n0 * D;
    const int total = rows * D, n4 = total >> 2;
    for (int q = tid; q < n4; q += KA_THREADS) {
      int p = (q * 4) / D, c = q * 4 - p * D;
      float v[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        v[j] = s_out[p * SD + c];
        if (++c == D) {
          c = 0;
          ++p;
        }
      }
      reinterpret_cast<float4*>(dst)[q] = make_float4(v[0], v[1], v[2], v[3]);
    }
    for (int e = n4 * 4 + tid; e < total; e += KA_THREADS) {
      const int p = e / D;
      dst[e] = s_out[p * SD + e - p * D];
    }
  }
}

template <int F, typename E>
int launch_encode(const E* table, const float* x, const float* scales,
                  const int* res, const float* level_mask, float* out,
                  long long N, int L, int T, int include_xyz, float xyz_scale,
                  float xyz_offset, cudaStream_t stream) {
  static int resident[kMaxDevices] = {};
  unsigned blocks = 0;
  const cudaError_t err =
      persistent_grid(hashgrid_encode_kernel<F, E>, KA_THREADS, 0,
                      (N + KA_TILE - 1) / KA_TILE, resident, blocks);
  if (err != cudaSuccess) return (int)err;
  hashgrid_encode_kernel<F, E><<<blocks, KA_THREADS, 0, stream>>>(
      table, x, scales, res, level_mask, out, N, L, T, include_xyz, xyz_scale,
      xyz_offset);
  return launch_status();
}

// KA': the backward of KA.
//
// Replaces the JAX custom VJP of the encode (intrinsicavatar_tpu/ops/
// hashgrid.py:182 _encode_cvjp_bwd): the table pullback encode_table_grad
// (ops/encode_grad.py:350, a sort-aggregation on the TPU, ops/scatter.py) and
// the point pullback hashgrid_encode_vjp_x (ops/hashgrid.py:263).
//
// What bounds it on an H100: bytes.  It reads the points and the cotangent g
// once and adds N * L * 8 corner rows of F floats into the 64 MB [L, T, F]
// table cotangent (each row its corners touch counted read and written
// once); with d_x it also reads those rows of the table.  A few dozen flops
// per (point, level, corner) stay far below that.  Its time is set by the
// reductions, which the L2 serializes where many land on one row.
//
// Design (that of KB' pass 2, csrc/encode_grad.cu): persistent blocks walk
// 64-point tiles, as KA does.  A block stages the tile's points and g rows
// (coalesced loads) and the per-level scales, resolutions, flags and mask in
// shared memory.  A warp takes 32 points of one level, so points near each
// other (a ray's samples) add into few rows at the coarse levels: at each
// corner the lanes that add into one row find each other with
// __match_any_sync, and the lowest sums their terms in lane order and issues
// the row's one reduction (common.cuh:warp_row_add; F = 2 as one
// red.global.add.v2.f32, F = 4 as .v4).  For F = 2 the two corners that differ
// only in x go as one .v4 where their rows lie in one aligned pair of rows, as
// KA loads them (even x: half the cells; 11% faster on an H100 at 700 W).  The
// corner rows are KA's (common.cuh:axis_corner, corner_index), so the atomic
// into the clamped row of a dense level is the adjoint of the TPU's corner
// packing.  A level the mask zeroes reads and adds nothing, and nor does a
// point whose g is zero at a level: ~62% of a train step's radiance call are
// the shading compaction's padded slots, all at one point with a zero
// cotangent, whose adds into the same 8 rows a level would queue behind each
// other in the L2.  d_x takes no atomics: each (point, level) leaves its 3
// partials s * sum_k (row_k . g) dw_k/dpos in shared memory, and the block
// sums them in level order, adds xyz_scale * g once where the output has the
// xyz columns, and stores each point's 3 floats once, so d_x is the same on
// every call.
constexpr int KA2_THREADS = 256;
constexpr int KA2_WARPS = KA2_THREADS / 32;

// dynamic shared memory in floats: points, g rows, the warps' merge
// scratch, the level constants, and with d_x its partials
constexpr int ka2_smem_floats(bool xn) {
  return KA_TILE * 3 + KA_TILE * KA_MAX_SD + KA2_WARPS * 32 * 4
         + 2 * KA_MAX_L + KA_MAX_LF + (xn ? KA_MAX_L * KA_TILE * 3 : 0);
}

// One (point, level) item: the 8 corners' w_k * g into the level's table
// cotangent and, with XN, the point's partials of d_x for this level (gl:
// the level's masked g, not all zero).
template <int F, bool XN>
__device__ __forceinline__ void encode_bwd_item(
    const float* __restrict__ tab, float* __restrict__ dtab, const float* px,
    const float (&gl)[F], float s, int r, bool dense, uint32_t tmask,
    unsigned active, float* scratch, int lane, float* dxp) {
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
  // with d_x the 8 corner rows of the table are loaded before the corner
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
  // corner k's weight, in the twin's order of products
  auto weight = [&](int k) {
    return ((k >> 2) ? f[0] : 1.f - f[0])
           * (((k >> 1) & 1) ? f[1] : 1.f - f[1])
           * ((k & 1) ? f[2] : 1.f - f[2]);
  };
  if constexpr (F == 2) {
    // corners q and q + 4 differ only in x: where their rows lie in one
    // aligned pair of rows (an even x, or the dense border's clamp), one
    // 16-byte reduction adds both
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float w0 = weight(q), w1 = weight(q + 4);
      const float v0[2] = {w0 * gl[0], w0 * gl[1]};
      const float v1[2] = {w1 * gl[0], w1 * gl[1]};
      const uint32_t r0 = rows[q], r1 = rows[q + 4];
      const bool paired = (r0 >> 1) == (r1 >> 1);
      const unsigned pm = __ballot_sync(active, paired);
      if (paired) {
        const bool o0 = r0 & 1, o1 = r1 & 1;
        const float v4[4] = {(o0 ? 0.f : v0[0]) + (o1 ? 0.f : v1[0]),
                             (o0 ? 0.f : v0[1]) + (o1 ? 0.f : v1[1]),
                             (o0 ? v0[0] : 0.f) + (o1 ? v1[0] : 0.f),
                             (o0 ? v0[1] : 0.f) + (o1 ? v1[1] : 0.f)};
        warp_row_add<4>(dtab, r0 >> 1, v4, pm, scratch, lane);
      } else {
        warp_row_add<2>(dtab, r0, v0, active & ~pm, scratch, lane);
        warp_row_add<2>(dtab, r1, v1, active & ~pm, scratch, lane);
      }
    }
  } else {
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const float w = weight(k);
      float v[F];
#pragma unroll
      for (int c = 0; c < F; ++c) v[c] = w * gl[c];
      warp_row_add<F>(dtab, rows[k], v, active, scratch, lane);
    }
  }
  if constexpr (XN) {
    float lg[3] = {0.f, 0.f, 0.f};
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int dx = k >> 2, dy = (k >> 1) & 1, dz = k & 1;
      const float wx = dx ? f[0] : 1.f - f[0];
      const float wy = dy ? f[1] : 1.f - f[1];
      const float wz = dz ? f[2] : 1.f - f[2];
      float fg = 0.f;
#pragma unroll
      for (int c = 0; c < F; ++c) fg += t[k][c] * gl[c];
      const float sx = dx ? 1.f : -1.f, sy = dy ? 1.f : -1.f,
                  sz = dz ? 1.f : -1.f;
      lg[0] += fg * (sx * wy * wz);
      lg[1] += fg * (wx * sy * wz);
      lg[2] += fg * (wx * wy * sz);
    }
#pragma unroll
    for (int a = 0; a < 3; ++a) dxp[a] = lg[a] * s;
  }
}

template <int F, bool XN>
__global__ void __launch_bounds__(KA2_THREADS) hashgrid_encode_bwd_kernel(
    const float* __restrict__ table, const float* __restrict__ x,
    const float* __restrict__ scales, const int* __restrict__ res,
    const float* __restrict__ level_mask, const float* __restrict__ g,
    float* __restrict__ d_table, float* __restrict__ d_x, int64_t N, int L,
    int T, int include_xyz, float xyz_scale) {
  extern __shared__ __align__(16) float ka2_smem[];
  float* s_x = ka2_smem;                        // [TILE][3]
  float* s_g = s_x + KA_TILE * 3;               // [TILE][SD]
  float* s_scr = s_g + KA_TILE * KA_MAX_SD;     // [WARPS][4][32]
  float* s_scale = s_scr + KA2_WARPS * 32 * 4;  // [MAX_L]
  float* s_mask = s_scale + KA_MAX_L;           // [MAX_LF]
  int* s_res = reinterpret_cast<int*>(s_mask + KA_MAX_LF);  // [MAX_L]
  float* s_dx = reinterpret_cast<float*>(s_res + KA_MAX_L);  // [L][TILE][3]
  __shared__ int s_flags[KA_MAX_L];  // bit 0: dense, bit 1: not masked off
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int off = include_xyz ? 3 : 0;
  const int D = L * F + off;
  for (int l = tid; l < L; l += KA2_THREADS) {
    bool on = level_mask == nullptr;
    for (int c = 0; c < F && !on; ++c) on = level_mask[l * F + c] != 0.f;
    s_scale[l] = scales[l];
    s_res[l] = res[l];
    s_flags[l] = (level_is_dense(res[l], T) ? 1 : 0) | (on ? 2 : 0);
  }
  for (int q = tid; q < L * F; q += KA2_THREADS)
    s_mask[q] = level_mask ? level_mask[q] : 1.f;
  const uint32_t tmask = (uint32_t)(T - 1);
  float* scratch = s_scr + warp * 32 * 4;
  const int64_t n_tiles = (N + KA_TILE - 1) / KA_TILE;
  for (int64_t tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int64_t n0 = tile * KA_TILE;
    const int rows = N - n0 < KA_TILE ? (int)(N - n0) : KA_TILE;
    __syncthreads();  // the previous tile is done with shared memory
    for (int e = tid; e < rows * 3; e += KA2_THREADS) s_x[e] = x[n0 * 3 + e];
    for (int e = tid; e < rows * D; e += KA2_THREADS) {
      const int p = e / D;
      s_g[p * KA_MAX_SD + e - p * D] = g[n0 * D + e];
    }
    __syncthreads();
    // warp item w: level w % L of the tile's points 32 (w / L) + lane
    for (int w = warp; w < (KA_TILE / 32) * L; w += KA2_WARPS) {
      const int l = w % L, p = (w / L) * 32 + lane;
      const int flags = s_flags[l];
      if (!(flags & 2)) continue;  // masked off: nothing to add
      // a point whose g is zero at this level adds only zeros
      float gl[F];
      bool live = false;
#pragma unroll
      for (int c = 0; c < F; ++c) {
        gl[c] = p < rows ? s_g[p * KA_MAX_SD + off + l * F + c]
                               * s_mask[l * F + c]
                         : 0.f;
        live |= gl[c] != 0.f;
      }
      const unsigned active = __ballot_sync(0xffffffffu, live);
      float* dxp = s_dx + (l * KA_TILE + p) * 3;
      if (!live) {
        if (XN && p < rows) dxp[0] = dxp[1] = dxp[2] = 0.f;
        continue;
      }
      encode_bwd_item<F, XN>(table + (int64_t)l * T * F,
                             d_table + (int64_t)l * T * F, s_x + p * 3, gl,
                             s_scale[l], s_res[l], (flags & 1) != 0, tmask,
                             active, scratch, lane, dxp);
    }
    if constexpr (XN) {
      __syncthreads();
      for (int p = tid; p < rows; p += KA2_THREADS) {
        float v[3] = {0.f, 0.f, 0.f};
        for (int l = 0; l < L; ++l) {
          if (!(s_flags[l] & 2)) continue;
#pragma unroll
          for (int a = 0; a < 3; ++a)
            v[a] += s_dx[(l * KA_TILE + p) * 3 + a];
        }
#pragma unroll
        for (int a = 0; a < 3; ++a) {
          if (include_xyz) v[a] += s_g[p * KA_MAX_SD + a] * xyz_scale;
          d_x[(n0 + p) * 3 + a] = v[a];
        }
      }
    }
  }
}

template <int F, bool XN>
int launch_encode_bwd(const float* table, const float* x,
                      const float* scales, const int* res,
                      const float* level_mask, const float* g,
                      float* d_table, float* d_x, long long N, int L, int T,
                      int include_xyz, float xyz_scale, cudaStream_t stream) {
  static int resident[kMaxDevices] = {};
  constexpr int smem = ka2_smem_floats(XN) * 4;
  unsigned blocks = 0;
  const cudaError_t err =
      persistent_grid(hashgrid_encode_bwd_kernel<F, XN>, KA2_THREADS, smem,
                      (N + KA_TILE - 1) / KA_TILE, resident, blocks);
  if (err != cudaSuccess) return (int)err;
  hashgrid_encode_bwd_kernel<F, XN><<<blocks, KA2_THREADS, smem, stream>>>(
      table, x, scales, res, level_mask, g, d_table, d_x, N, L, T,
      include_xyz, xyz_scale);
  return launch_status();
}

}  // namespace

extern "C" int hashgrid_encode_bwd(const float* table, const float* x,
                                   const float* scales, const int* res,
                                   const float* level_mask, const float* g,
                                   float* d_table, float* d_x, long long N,
                                   int L, int T, int F, int include_xyz,
                                   float xyz_scale, void* stream) {
  // the tile's shared memory holds L <= 32 levels and g rows of L * F <= 64
  // features
  if (F < 1 || F > 4 || L < 1 || L > KA_MAX_L || L * F > KA_MAX_LF)
    return (int)cudaErrorInvalidValue;
  // the float2 row loads of d_x and the 16-byte reductions into d_table
  const uintptr_t vec = F == 2 || F == 4 ? 15 : 3;
  if ((d_x && F == 2 && (reinterpret_cast<uintptr_t>(table) & 7)) ||
      (reinterpret_cast<uintptr_t>(d_table) & vec))
    return (int)cudaErrorMisalignedAddress;
  if (N <= 0) return 0;
  const cudaStream_t st = (cudaStream_t)stream;
#define KA2_LAUNCH(FF)                                                       \
  return d_x ? launch_encode_bwd<FF, true>(table, x, scales, res,           \
                                           level_mask, g, d_table, d_x, N,  \
                                           L, T, include_xyz, xyz_scale,    \
                                           st)                              \
             : launch_encode_bwd<FF, false>(table, x, scales, res,          \
                                            level_mask, g, d_table, d_x, N, \
                                            L, T, include_xyz, xyz_scale,   \
                                            st)
  switch (F) {
    case 1: KA2_LAUNCH(1);
    case 2: KA2_LAUNCH(2);
    case 3: KA2_LAUNCH(3);
    default: KA2_LAUNCH(4);
  }
#undef KA2_LAUNCH
}

// The forward for a float32 or a bf16 table.
template <typename E>
int encode_fwd(const E* table, const float* x, const float* scales,
               const int* res, const float* level_mask, float* out,
               long long N, int L, int T, int F, int include_xyz,
               float xyz_scale, float xyz_offset, void* stream) {
  // the tile's shared memory holds L <= 32 levels and rows of L * F <= 64
  // features; a level's table has a power-of-two number of rows (the hash
  // mask), at least one aligned pair
  if (F < 1 || F > 4 || L < 1 || L > KA_MAX_L || L * F > KA_MAX_LF || T < 2 ||
      (T & (T - 1)) != 0)
    return (int)cudaErrorInvalidValue;
  // the pair loads (16 bytes in float32, 8 in bf16) and the float4 stores
  if ((reinterpret_cast<uintptr_t>(table) & (4 * sizeof(E) - 1)) ||
      (reinterpret_cast<uintptr_t>(out) & 15))
    return (int)cudaErrorMisalignedAddress;
  if (N <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  switch (F) {
    case 1: return launch_encode<1, E>(table, x, scales, res, level_mask, out,
                                       N, L, T, include_xyz, xyz_scale,
                                       xyz_offset, s);
    case 2: return launch_encode<2, E>(table, x, scales, res, level_mask, out,
                                       N, L, T, include_xyz, xyz_scale,
                                       xyz_offset, s);
    case 3: return launch_encode<3, E>(table, x, scales, res, level_mask, out,
                                       N, L, T, include_xyz, xyz_scale,
                                       xyz_offset, s);
    default: return launch_encode<4, E>(table, x, scales, res, level_mask,
                                        out, N, L, T, include_xyz, xyz_scale,
                                        xyz_offset, s);
  }
}

extern "C" int hashgrid_encode_fwd(const float* table, const float* x,
                                   const float* scales, const int* res,
                                   const float* level_mask, float* out,
                                   long long N, int L, int T, int F,
                                   int include_xyz, float xyz_scale,
                                   float xyz_offset, void* stream) {
  return encode_fwd(table, x, scales, res, level_mask, out, N, L, T, F,
                    include_xyz, xyz_scale, xyz_offset, stream);
}

// The bf16-row form: `table` holds bf16 entries.
extern "C" int hashgrid_encode_fwd_bf16(const void* table, const float* x,
                                        const float* scales, const int* res,
                                        const float* level_mask, float* out,
                                        long long N, int L, int T, int F,
                                        int include_xyz, float xyz_scale,
                                        float xyz_offset, void* stream) {
  return encode_fwd(static_cast<const __nv_bfloat16*>(table), x, scales, res,
                    level_mask, out, N, L, T, F, include_xyz, xyz_scale,
                    xyz_offset, stream);
}
