// Shared helpers for the port's hand-written Hopper kernels.
#pragma once

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

// A table entry as a float: float32 tables as they are, bf16 tables (the
// bf16-row forms of KA and KB) widened, which is exact.
__device__ __forceinline__ float entry(float v) { return v; }
__device__ __forceinline__ float entry(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// Rows of F = 2 entries: one row (Row) and an aligned pair of rows (Pair,
// rows 2m and 2m + 1), read with one load each and widened to float2s.
template <typename E>
struct Rows2;
template <>
struct Rows2<float> {
  using Row = float2;   // 8 bytes
  using Pair = float4;  // 16 bytes
  static __device__ __forceinline__ float2 row(Row r) { return r; }
  static __device__ __forceinline__ float2 lo(Pair p) {
    return make_float2(p.x, p.y);
  }
  static __device__ __forceinline__ float2 hi(Pair p) {
    return make_float2(p.z, p.w);
  }
};
template <>
struct Rows2<__nv_bfloat16> {
  using Row = __nv_bfloat162;  // 4 bytes
  using Pair = uint2;          // 8 bytes: two bf16 pairs
  static __device__ __forceinline__ float2 row(Row r) {
    return __bfloat1622float2(r);
  }
  static __device__ __forceinline__ float2 word(uint32_t w) {
    return make_float2(__uint_as_float(w << 16),
                       __uint_as_float(w & 0xffff0000u));
  }
  static __device__ __forceinline__ float2 lo(Pair p) { return word(p.x); }
  static __device__ __forceinline__ float2 hi(Pair p) { return word(p.y); }
};

// tcnn's spatial-hash primes (instant-ngp), applied in uint32 arithmetic.
__device__ __forceinline__ uint32_t hash_corner(int x, int y, int z,
                                                uint32_t mask) {
  return ((uint32_t)x * 1u ^ (uint32_t)y * 2654435761u
          ^ (uint32_t)z * 805459861u) & mask;
}

// Corner d (0 or 1) along one axis of cell c0 at a level of resolution r:
// dense levels (r^3 <= T) clamp the cell to [0, r-1] and the +1 corner to
// r-1; hashed levels clamp each corner to [0, r-1].  The hashed rule clamps
// c0 to [-1, r-1] first, which changes no corner and keeps c0 + 1 from
// overflowing where a far point saturated the float-to-int cast.
__device__ __forceinline__ int axis_corner(int c0, int d, int r, bool dense) {
  if (dense) {
    const int c = min(max(c0, 0), r - 1);
    return d ? min(c + 1, r - 1) : c;
  }
  const int c = min(max(c0, -1), r - 1);
  return d ? max(min(c + 1, r - 1), 0) : max(c, 0);
}

// Row of the [T, F] level table at corner (x, y, z) of axis_corner: dense
// levels put x fastest, hashed levels hash.
__device__ __forceinline__ uint32_t corner_index(int x, int y, int z, int r,
                                                 bool dense, uint32_t tmask) {
  return dense ? (uint32_t)((z * r + y) * r + x) : hash_corner(x, y, z, tmask);
}

// Row that corner (dx, dy, dz) of cell c0 reads.
__device__ __forceinline__ int64_t corner_row(int c0x, int c0y, int c0z,
                                              int dx, int dy, int dz, int r,
                                              bool dense, uint32_t tmask) {
  return (int64_t)corner_index(axis_corner(c0x, dx, r, dense),
                               axis_corner(c0y, dy, r, dense),
                               axis_corner(c0z, dz, r, dense), r, dense, tmask);
}

__device__ __forceinline__ bool level_is_dense(int r, int T) {
  return (int64_t)r * r * r <= (int64_t)T;
}

// Adds the F floats v into the F floats at global p (aligned to 4 F bytes)
// with one reduction: sm_90's vector float adds for F = 2 and 4 (the PTX
// red.global.add.v2/.v4.f32, PTX ISA 8.1), scalar adds otherwise.
template <int F>
__device__ __forceinline__ void red_add(float* p, const float (&v)[F]) {
  if constexpr (F == 2) {
    asm volatile("red.global.add.v2.f32 [%0], {%1, %2};"
                 :: "l"(__cvta_generic_to_global(p)), "f"(v[0]), "f"(v[1])
                 : "memory");
  } else if constexpr (F == 4) {
    asm volatile("red.global.add.v4.f32 [%0], {%1, %2, %3, %4};"
                 :: "l"(__cvta_generic_to_global(p)), "f"(v[0]), "f"(v[1]),
                    "f"(v[2]), "f"(v[3])
                 : "memory");
  } else {
#pragma unroll
    for (int c = 0; c < F; ++c) atomicAdd(p + c, v[c]);
  }
}

// Adds v into row `row` of the [rows, F] table at `table` for each lane of
// `active` (the calling lanes, all of which must call): the lanes that add
// into one row find each other with __match_any_sync, and the lowest of
// them sums their v in lane order through `scratch` (F * 32 floats of the
// warp's own shared memory) and issues the row's one reduction.
template <int F>
__device__ __forceinline__ void warp_row_add(float* __restrict__ table,
                                             uint32_t row,
                                             const float (&v)[F],
                                             unsigned active, float* scratch,
                                             int lane) {
  const unsigned peers = __match_any_sync(active, row);
#pragma unroll
  for (int c = 0; c < F; ++c) scratch[c * 32 + lane] = v[c];
  __syncwarp(active);
  if ((peers & ((1u << lane) - 1u)) == 0u) {
    float sum[F];
#pragma unroll
    for (int c = 0; c < F; ++c) sum[c] = v[c];
    for (unsigned b = peers & (peers - 1u); b; b &= b - 1u) {
      const int j = __ffs(b) - 1;
#pragma unroll
      for (int c = 0; c < F; ++c) sum[c] += scratch[c * 32 + j];
    }
    red_add<F>(table + (int64_t)row * F, sum);
  }
  __syncwarp(active);
}

inline int launch_status() { return (int)cudaGetLastError(); }

// The grid of a persistent kernel over `tiles` tiles of work: as many blocks
// of `kernel` (`threads` threads, `smem` bytes of dynamic shared memory) as
// fit on the current device at once, and no more than there are tiles.
// Counted once per device into `cache`, where dynamic shared memory above
// 48 KB is also allowed.
constexpr int kMaxDevices = 64;
template <typename Kernel>
cudaError_t persistent_grid(Kernel kernel, int threads, int smem,
                            long long tiles, int (&cache)[kMaxDevices],
                            unsigned& blocks) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (cache[dev] == 0) {
    int sms = 0, per_sm = 0;
    if (smem > 48 * 1024)
      err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                          threads, smem);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    cache[dev] = sms * per_sm;
  }
  blocks = (unsigned)(tiles < cache[dev] ? tiles : cache[dev]);
  return cudaSuccess;
}
