// KA: multi-level hash-grid encode, forward (KA', its backward, below).
//
// Replaces intrinsicavatar_tpu/ops/hashgrid.py:191 hashgrid_encode_raw (the
// TPU version gathers one corner-packed row per dense level and eight rows
// per hashed level, because TPU gathers are priced per row).
//
// What bounds it on an H100: the gathered bytes, N * L * 8 corners * F * 4 B
// of table rows at random addresses (each level's table is 2^19 x 2 floats,
// 4 MB, so the 16 levels do not all stay in the 50 MB L2 together with the
// other traffic), against 3.35 TB/s.  The arithmetic is a few dozen flops
// per (point, level).
//
// Design: one thread per (point, level), levels fastest, so the threads of a
// warp share points and read neighbouring output columns.  Each thread
// computes its cell and trilinear weights once and reads its 8 corner rows
// (F floats each) directly from the canonical [L, T, F] table: the corner
// packing of the TPU version is a layout for its row-priced gathers and is
// not copied.  The two index rules of the reference are kept exactly (dense
// levels clamp the cell, hashed levels clamp each corner).
#include "common.cuh"

namespace {

__global__ void hashgrid_encode_kernel(
    const float* __restrict__ table, const float* __restrict__ x,
    const float* __restrict__ scales, const int* __restrict__ res,
    const float* __restrict__ level_mask, float* __restrict__ out, int64_t N,
    int L, int T, int F, int include_xyz, float xyz_scale,
    float xyz_offset) {
  int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (tid >= N * L) return;
  int64_t n = tid / L;
  int l = (int)(tid - n * L);
  int D = L * F + (include_xyz ? 3 : 0);
  int off = include_xyz ? 3 : 0;
  float* o = out + n * D;
  const float* p = x + n * 3;

  if (include_xyz && l == 0) {
    for (int a = 0; a < 3; ++a)
      o[a] = __fadd_rn(__fmul_rn(p[a], xyz_scale), xyz_offset);
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
  uint32_t tmask = (uint32_t)(T - 1);
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  for (int k = 0; k < 8; ++k) {
    int dx = k >> 2, dy = (k >> 1) & 1, dz = k & 1;
    float wx = dx ? f[0] : 1.f - f[0];
    float wy = dy ? f[1] : 1.f - f[1];
    float wz = dz ? f[2] : 1.f - f[2];
    float w = wx * wy * wz;
    int64_t row = corner_row(c0[0], c0[1], c0[2], dx, dy, dz, r, dense, tmask);
    const float* tr = tab + row * F;
    for (int c = 0; c < F; ++c) acc[c] += w * __ldg(tr + c);
  }
  for (int c = 0; c < F; ++c) {
    float m = level_mask ? level_mask[l * F + c] : 1.f;
    o[off + l * F + c] = acc[c] * m;
  }
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
  if (N <= 0) return 0;
  const int threads = 256;
  int64_t total = (int64_t)N * L;
  unsigned blocks = (unsigned)((total + threads - 1) / threads);
  hashgrid_encode_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      table, x, scales, res, level_mask, out, N, L, T, F, include_xyz,
      xyz_scale, xyz_offset);
  return launch_status();
}
