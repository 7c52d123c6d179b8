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
#include "common.cuh"

namespace {

constexpr int KA_TILE = 64;       // points a tile, a multiple of 32
constexpr int KA_THREADS = 256;
constexpr int KA_MAX_L = 32;
constexpr int KA_MAX_LF = 64;
constexpr int KA_MAX_SD = (KA_MAX_LF + 3) | 1;  // odd output row stride

// One (point, level) item: the trilinear blend of the level's 8 corner rows
// at point p (x in shared memory), masked, into the output row o.
template <int F>
__device__ __forceinline__ void encode_item(const float* __restrict__ tab,
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
    const float4* t4 = reinterpret_cast<const float4*>(tab);
    const float2* t2 = reinterpret_cast<const float2*>(tab);
    float2 v[8];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const uint32_t r0 = row(0, q >> 1, q & 1), r1 = row(1, q >> 1, q & 1);
      const float4 pair = __ldg(t4 + (r0 >> 1));
      v[q] = (r0 & 1) ? make_float2(pair.z, pair.w)
                      : make_float2(pair.x, pair.y);
      if ((r0 >> 1) == (r1 >> 1))
        v[q + 4] = (r1 & 1) ? make_float2(pair.z, pair.w)
                            : make_float2(pair.x, pair.y);
      else
        v[q + 4] = __ldg(t2 + r1);
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
      const float* tr = tab + (int64_t)row(dx, dy, dz) * F;
#pragma unroll
      for (int c = 0; c < F; ++c) acc[c] += w * __ldg(tr + c);
    }
  }
#pragma unroll
  for (int c = 0; c < F; ++c) o[c] = acc[c] * mask[c];
}

template <int F>
__global__ void __launch_bounds__(KA_THREADS, 4) hashgrid_encode_kernel(
    const float* __restrict__ table, const float* __restrict__ x,
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
      encode_item<F>(table + (int64_t)l * T * F, s_x + p * 3, s_scale[l],
                     s_res[l], s_dense[l] != 0, tmask, s_mask + l * F,
                     s_out + p * SD + off + l * F);
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

template <int F>
int launch_encode(const float* table, const float* x, const float* scales,
                  const int* res, const float* level_mask, float* out,
                  long long N, int L, int T, int include_xyz, float xyz_scale,
                  float xyz_offset, cudaStream_t stream) {
  static int resident[kMaxDevices] = {};
  unsigned blocks = 0;
  const cudaError_t err =
      persistent_grid(hashgrid_encode_kernel<F>, KA_THREADS, 0,
                      (N + KA_TILE - 1) / KA_TILE, resident, blocks);
  if (err != cudaSuccess) return (int)err;
  hashgrid_encode_kernel<F><<<blocks, KA_THREADS, 0, stream>>>(
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
// What bounds it on an H100: the scattered bytes, N * L * 8 corners * F
// atomic adds of 4 B into the [L, T, F] table cotangent at random rows; the
// table is 64 MB, so the bound counts at most twice its size (read and
// written once) plus the cotangent g read once.
//
// Design: one thread per (point, level) as in KA.  Each corner atomicAdds
// w_k * g into the row the forward read, so the dense levels need no adjoint
// of the TPU's corner packing: the atomic to the clamped row is that adjoint.
// The point pullback, when asked for, sums (row_k . g) dw_k / dpos over the
// corners and adds its 3 components into d_x with atomics (one per level).
__global__ void hashgrid_encode_bwd_kernel(
    const float* __restrict__ table, const float* __restrict__ x,
    const float* __restrict__ scales, const int* __restrict__ res,
    const float* __restrict__ level_mask, const float* __restrict__ g,
    float* __restrict__ d_table, float* __restrict__ d_x, int64_t N, int L,
    int T, int F, int include_xyz, float xyz_scale) {
  int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (tid >= N * L) return;
  int64_t n = tid / L;
  int l = (int)(tid - n * L);
  int D = L * F + (include_xyz ? 3 : 0);
  int off = include_xyz ? 3 : 0;
  const float* gn = g + n * D;
  const float* p = x + n * 3;

  float gl[4] = {0.f, 0.f, 0.f, 0.f};
  for (int c = 0; c < F; ++c) {
    float m = level_mask ? level_mask[l * F + c] : 1.f;
    gl[c] = gn[off + l * F + c] * m;
  }
  float s = scales[l];
  int r = res[l];
  bool dense = level_is_dense(r, T);
  int c0[3];
  float f[3];
  for (int a = 0; a < 3; ++a) {
    float pos = __fadd_rn(__fmul_rn(p[a], s), 0.5f);
    float fl = floorf(pos);
    c0[a] = (int)fl;
    f[a] = pos - fl;
  }
  const float* tab = table + (int64_t)l * T * F;
  float* dtab = d_table + (int64_t)l * T * F;
  uint32_t tmask = (uint32_t)(T - 1);
  float lg[3] = {0.f, 0.f, 0.f};
  for (int k = 0; k < 8; ++k) {
    int dx = k >> 2, dy = (k >> 1) & 1, dz = k & 1;
    float wx = dx ? f[0] : 1.f - f[0];
    float wy = dy ? f[1] : 1.f - f[1];
    float wz = dz ? f[2] : 1.f - f[2];
    float w = wx * wy * wz;
    int64_t row = corner_row(c0[0], c0[1], c0[2], dx, dy, dz, r, dense, tmask);
    for (int c = 0; c < F; ++c) atomicAdd(dtab + row * F + c, w * gl[c]);
    if (d_x) {
      float fg = 0.f;
      for (int c = 0; c < F; ++c) fg += __ldg(tab + row * F + c) * gl[c];
      float sx = dx ? 1.f : -1.f, sy = dy ? 1.f : -1.f, sz = dz ? 1.f : -1.f;
      lg[0] += fg * (sx * wy * wz);
      lg[1] += fg * (wx * sy * wz);
      lg[2] += fg * (wx * wy * sz);
    }
  }
  if (d_x) {
    float* dxn = d_x + n * 3;
    for (int a = 0; a < 3; ++a) {
      float v = lg[a] * s;
      if (include_xyz && l == 0) v += gn[a] * xyz_scale;
      atomicAdd(dxn + a, v);
    }
  }
}

}  // namespace

extern "C" int hashgrid_encode_bwd(const float* table, const float* x,
                                   const float* scales, const int* res,
                                   const float* level_mask, const float* g,
                                   float* d_table, float* d_x, long long N,
                                   int L, int T, int F, int include_xyz,
                                   float xyz_scale, void* stream) {
  if (F > 4) return (int)cudaErrorInvalidValue;
  if (N <= 0) return 0;
  const int threads = 256;
  int64_t total = (int64_t)N * L;
  unsigned blocks = (unsigned)((total + threads - 1) / threads);
  hashgrid_encode_bwd_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      table, x, scales, res, level_mask, g, d_table, d_x, N, L, T, F,
      include_xyz, xyz_scale);
  return launch_status();
}

extern "C" int hashgrid_encode_fwd(const float* table, const float* x,
                                   const float* scales, const int* res,
                                   const float* level_mask, float* out,
                                   long long N, int L, int T, int F,
                                   int include_xyz, float xyz_scale,
                                   float xyz_offset, void* stream) {
  // the tile's shared memory holds L <= 32 levels and rows of L * F <= 64
  // features; a level's table has a power-of-two number of rows (the hash
  // mask), at least one aligned pair
  if (F < 1 || F > 4 || L < 1 || L > KA_MAX_L || L * F > KA_MAX_LF || T < 2 ||
      (T & (T - 1)) != 0)
    return (int)cudaErrorInvalidValue;
  // the float4 pair loads and stores
  if ((reinterpret_cast<uintptr_t>(table) | reinterpret_cast<uintptr_t>(out))
      & 15)
    return (int)cudaErrorMisalignedAddress;
  if (N <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  switch (F) {
    case 1: return launch_encode<1>(table, x, scales, res, level_mask, out,
                                    N, L, T, include_xyz, xyz_scale,
                                    xyz_offset, s);
    case 2: return launch_encode<2>(table, x, scales, res, level_mask, out,
                                    N, L, T, include_xyz, xyz_scale,
                                    xyz_offset, s);
    case 3: return launch_encode<3>(table, x, scales, res, level_mask, out,
                                    N, L, T, include_xyz, xyz_scale,
                                    xyz_offset, s);
    default: return launch_encode<4>(table, x, scales, res, level_mask, out,
                                     N, L, T, include_xyz, xyz_scale,
                                     xyz_offset, s);
  }
}
