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
// addresses, as for KA) against 3.35 TB/s; the MLP adds about
// 2 * (35*64 + 64*13 + 35*64) ~ 10.6 kflop per point of FP32 work, which at
// 67 TFLOP/s is well below the gather time.
//
// Design: one thread per point.  The MLP weights (at most 64 inputs, 64
// hidden units and 16 outputs) sit in shared memory for the whole block.
// Each level's 8 corner rows are read once: the same loop accumulates the
// encode value and its 3-vector derivative per feature (d enc / d pos), so
// the gradient needs no second gather.  The derivative is contracted with
// the MLP's input gradient after the MLP runs.  Per-thread arrays live in
// local memory (L1); a warp-per-point or tensor-core MLP is later work.
#include "common.cuh"

namespace {

constexpr int MAX_IN = 64;
constexpr int MAX_HIDDEN = 64;
constexpr int MAX_OUT = 16;
constexpr int MAX_LF = 32;

__device__ __forceinline__ float softplus100(float h) {
  float y = 100.f * h;
  return (fmaxf(y, 0.f) + log1pf(expf(-fabsf(y)))) / 100.f;
}

__global__ void encode_mlp_sdfgrad_kernel(
    const float* __restrict__ table, const float* __restrict__ x,
    const float* __restrict__ scales, const int* __restrict__ res,
    const float* __restrict__ level_mask, const float* __restrict__ W1,
    const float* __restrict__ b1, const float* __restrict__ W2,
    const float* __restrict__ b2, float* __restrict__ feat,
    float* __restrict__ grad, int64_t N, int L, int T, int F,
    int include_xyz, int d_in, int hidden, int d_out, float xyz_scale,
    float xyz_offset) {
  __shared__ float sW1[MAX_IN * MAX_HIDDEN];
  __shared__ float sb1[MAX_HIDDEN];
  __shared__ float sW2[MAX_HIDDEN * MAX_OUT];
  __shared__ float sb2[MAX_OUT];
  for (int i = threadIdx.x; i < d_in * hidden; i += blockDim.x) sW1[i] = W1[i];
  for (int i = threadIdx.x; i < hidden; i += blockDim.x) sb1[i] = b1[i];
  for (int i = threadIdx.x; i < hidden * d_out; i += blockDim.x)
    sW2[i] = W2[i];
  for (int i = threadIdx.x; i < d_out; i += blockDim.x) sb2[i] = b2[i];
  __syncthreads();

  int64_t n = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  const float* p = x + n * 3;
  float px = p[0], py = p[1], pz = p[2];
  int off = include_xyz ? 3 : 0;

  float enc[MAX_IN];
  float jac[MAX_LF][3];  // d enc_level / d pos_level (before the scale s_l)
  if (include_xyz) {
    enc[0] = __fadd_rn(__fmul_rn(px, xyz_scale), xyz_offset);
    enc[1] = __fadd_rn(__fmul_rn(py, xyz_scale), xyz_offset);
    enc[2] = __fadd_rn(__fmul_rn(pz, xyz_scale), xyz_offset);
  }
  uint32_t tmask = (uint32_t)(T - 1);
  for (int l = 0; l < L; ++l) {
    float s = scales[l];
    int r = res[l];
    bool dense = level_is_dense(r, T);
    float pos[3] = {__fadd_rn(__fmul_rn(px, s), 0.5f),
                    __fadd_rn(__fmul_rn(py, s), 0.5f),
                    __fadd_rn(__fmul_rn(pz, s), 0.5f)};
    int c0[3];
    float f[3];
    for (int a = 0; a < 3; ++a) {
      float fl = floorf(pos[a]);
      c0[a] = (int)fl;
      f[a] = pos[a] - fl;
    }
    float e[4] = {0.f, 0.f, 0.f, 0.f};
    float j[4][3] = {};
    const float* tab = table + (int64_t)l * T * F;
    for (int k = 0; k < 8; ++k) {
      int dx = k >> 2, dy = (k >> 1) & 1, dz = k & 1;
      float wx = dx ? f[0] : 1.f - f[0];
      float wy = dy ? f[1] : 1.f - f[1];
      float wz = dz ? f[2] : 1.f - f[2];
      float sx = dx ? 1.f : -1.f, sy = dy ? 1.f : -1.f, sz = dz ? 1.f : -1.f;
      float w = wx * wy * wz;
      float dwx = sx * wy * wz, dwy = wx * sy * wz, dwz = wx * wy * sz;
      int64_t row = corner_row(c0[0], c0[1], c0[2], dx, dy, dz, r, dense,
                               tmask);
      const float* tr = tab + row * F;
      for (int c = 0; c < F; ++c) {
        float v = __ldg(tr + c);
        e[c] += w * v;
        j[c][0] += dwx * v;
        j[c][1] += dwy * v;
        j[c][2] += dwz * v;
      }
    }
    for (int c = 0; c < F; ++c) {
      int q = l * F + c;
      enc[off + q] = e[c] * level_mask[q];
      jac[q][0] = j[c][0] * s;
      jac[q][1] = j[c][1] * s;
      jac[q][2] = j[c][2] * s;
    }
  }

  // MLP forward, keeping the hidden pre-activations for the reverse pass
  float h[MAX_HIDDEN];
  for (int u = 0; u < hidden; ++u) h[u] = 0.f;
  for (int i = 0; i < d_in; ++i) {
    float ei = enc[i];
    const float* wrow = sW1 + i * hidden;
    for (int u = 0; u < hidden; ++u) h[u] += ei * wrow[u];
  }
  float* fo = feat + n * d_out;
  for (int o = 0; o < d_out; ++o) fo[o] = 0.f;
  for (int u = 0; u < hidden; ++u) {
    h[u] += sb1[u];
    float a = softplus100(h[u]);
    const float* wrow = sW2 + u * d_out;
    for (int o = 0; o < d_out; ++o) fo[o] += a * wrow[o];
  }
  for (int o = 0; o < d_out; ++o) fo[o] += sb2[o];

  // reverse pass of output channel 0: softplus(100 h)' = sigmoid(100 h)
  for (int u = 0; u < hidden; ++u)
    h[u] = sW2[u * d_out] * (1.f / (1.f + expf(-100.f * h[u])));
  float g[3] = {0.f, 0.f, 0.f};
  for (int i = 0; i < d_in; ++i) {
    const float* wrow = sW1 + i * hidden;
    float gi = 0.f;
    for (int u = 0; u < hidden; ++u) gi += h[u] * wrow[u];
    if (i < off) {
      g[i] += gi * xyz_scale;
    } else {
      int q = i - off;
      float gq = gi * level_mask[q];
      g[0] += gq * jac[q][0];
      g[1] += gq * jac[q][1];
      g[2] += gq * jac[q][2];
    }
  }
  float* go = grad + n * 3;
  go[0] = g[0];
  go[1] = g[1];
  go[2] = g[2];
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
// N * L * 8 * F atomics into a 64 MB cotangent (counted at most at twice its
// size).  A few dozen flops per (point, level, corner) stay far below the
// gather time.
//
// Design: one thread per (point, level) in both passes, levels fastest as in
// KA; nothing is kept between the passes but enc and g_genc_cot (the corner
// weights are recomputed from xn).  Pass 2 adds its d_xn part with three
// atomics per thread.
__global__ void encode_mlp_sdfgrad_bwd_gather_kernel(
    const float* __restrict__ table, const float* __restrict__ x,
    const float* __restrict__ scales, const int* __restrict__ res,
    const float* __restrict__ level_mask, const float* __restrict__ g_grad,
    float* __restrict__ enc, float* __restrict__ gg, int64_t N, int L, int T,
    int F, int include_xyz, float xyz_scale, float xyz_offset) {
  int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (tid >= N * L) return;
  int64_t n = tid / L;
  int l = (int)(tid - n * L);
  int off = include_xyz ? 3 : 0;
  int D = L * F + off;
  const float* p = x + n * 3;
  const float* gn = g_grad + n * 3;
  float* eo = enc + n * D;
  float* go = gg + n * D;
  if (include_xyz && l == 0) {
    for (int a = 0; a < 3; ++a) {
      eo[a] = __fadd_rn(__fmul_rn(p[a], xyz_scale), xyz_offset);
      go[a] = gn[a] * xyz_scale;
    }
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
  float e[4] = {0.f, 0.f, 0.f, 0.f}, u[4] = {0.f, 0.f, 0.f, 0.f};
  for (int k = 0; k < 8; ++k) {
    int dx = k >> 2, dy = (k >> 1) & 1, dz = k & 1;
    float wx = dx ? f[0] : 1.f - f[0];
    float wy = dy ? f[1] : 1.f - f[1];
    float wz = dz ? f[2] : 1.f - f[2];
    float sx = dx ? 1.f : -1.f, sy = dy ? 1.f : -1.f, sz = dz ? 1.f : -1.f;
    float w = wx * wy * wz;
    float uk = s * (gn[0] * (sx * wy * wz) + gn[1] * (wx * sy * wz)
                    + gn[2] * (wx * wy * sz));
    int64_t row = corner_row(c0[0], c0[1], c0[2], dx, dy, dz, r, dense, tmask);
    const float* tr = tab + row * F;
    for (int c = 0; c < F; ++c) {
      float v = __ldg(tr + c);
      e[c] += w * v;
      u[c] += uk * v;
    }
  }
  for (int c = 0; c < F; ++c) {
    int q = l * F + c;
    float m = level_mask[q];
    eo[off + q] = e[c] * m;
    go[off + q] = u[c] * m;
  }
}

__global__ void encode_mlp_sdfgrad_bwd_scatter_kernel(
    const float* __restrict__ table, const float* __restrict__ x,
    const float* __restrict__ scales, const int* __restrict__ res,
    const float* __restrict__ level_mask, const float* __restrict__ g_grad,
    const float* __restrict__ d_enc, const float* __restrict__ g_enc,
    float* __restrict__ d_table, float* __restrict__ d_xn, int64_t N, int L,
    int T, int F, int include_xyz, float xyz_scale) {
  int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (tid >= N * L) return;
  int64_t n = tid / L;
  int l = (int)(tid - n * L);
  int off = include_xyz ? 3 : 0;
  int D = L * F + off;
  const float* p = x + n * 3;
  const float* gn = g_grad + n * 3;
  float de[4] = {0.f, 0.f, 0.f, 0.f}, gl[4] = {0.f, 0.f, 0.f, 0.f};
  for (int c = 0; c < F; ++c) {
    int q = l * F + c;
    float m = level_mask[q];
    de[c] = d_enc[n * D + off + q] * m;
    gl[c] = g_enc[n * D + off + q] * m;
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
  float ge[3] = {0.f, 0.f, 0.f}, g2[3] = {0.f, 0.f, 0.f};
  for (int k = 0; k < 8; ++k) {
    int dx = k >> 2, dy = (k >> 1) & 1, dz = k & 1;
    float wx = dx ? f[0] : 1.f - f[0];
    float wy = dy ? f[1] : 1.f - f[1];
    float wz = dz ? f[2] : 1.f - f[2];
    float sx = dx ? 1.f : -1.f, sy = dy ? 1.f : -1.f, sz = dz ? 1.f : -1.f;
    float w = wx * wy * wz;
    float dwx = sx * wy * wz, dwy = wx * sy * wz, dwz = wx * wy * sz;
    float uk = s * (gn[0] * dwx + gn[1] * dwy + gn[2] * dwz);
    int64_t row = corner_row(c0[0], c0[1], c0[2], dx, dy, dz, r, dense, tmask);
    for (int c = 0; c < F; ++c)
      atomicAdd(dtab + row * F + c, w * de[c] + uk * gl[c]);
    if (d_xn) {
      float re = 0.f, fg = 0.f;
      for (int c = 0; c < F; ++c) {
        float v = __ldg(tab + row * F + c);
        re += v * de[c];
        fg += v * gl[c];
      }
      ge[0] += re * dwx;
      ge[1] += re * dwy;
      ge[2] += re * dwz;
      g2[0] += fg * sx * (gn[1] * sy * wz + gn[2] * sz * wy);
      g2[1] += fg * sy * (gn[0] * sx * wz + gn[2] * sz * wx);
      g2[2] += fg * sz * (gn[0] * sx * wy + gn[1] * sy * wx);
    }
  }
  if (d_xn) {
    float* dxn = d_xn + n * 3;
    for (int a = 0; a < 3; ++a) {
      float v = s * ge[a] + (s * s) * g2[a];
      if (include_xyz && l == 0) v += d_enc[n * D + a] * xyz_scale;
      atomicAdd(dxn + a, v);
    }
  }
}

}  // namespace

extern "C" int encode_mlp_sdfgrad_bwd_gather(
    const float* table, const float* x, const float* scales, const int* res,
    const float* level_mask, const float* g_grad, float* enc, float* gg,
    long long N, int L, int T, int F, int include_xyz, float xyz_scale,
    float xyz_offset, void* stream) {
  if (F > 4) return (int)cudaErrorInvalidValue;
  if (N <= 0) return 0;
  const int threads = 256;
  int64_t total = (int64_t)N * L;
  unsigned blocks = (unsigned)((total + threads - 1) / threads);
  encode_mlp_sdfgrad_bwd_gather_kernel<<<blocks, threads, 0,
                                         (cudaStream_t)stream>>>(
      table, x, scales, res, level_mask, g_grad, enc, gg, N, L, T, F,
      include_xyz, xyz_scale, xyz_offset);
  return launch_status();
}

extern "C" int encode_mlp_sdfgrad_bwd_scatter(
    const float* table, const float* x, const float* scales, const int* res,
    const float* level_mask, const float* g_grad, const float* d_enc,
    const float* g_enc, float* d_table, float* d_xn, long long N, int L,
    int T, int F, int include_xyz, float xyz_scale, void* stream) {
  if (F > 4) return (int)cudaErrorInvalidValue;
  if (N <= 0) return 0;
  const int threads = 256;
  int64_t total = (int64_t)N * L;
  unsigned blocks = (unsigned)((total + threads - 1) / threads);
  encode_mlp_sdfgrad_bwd_scatter_kernel<<<blocks, threads, 0,
                                          (cudaStream_t)stream>>>(
      table, x, scales, res, level_mask, g_grad, d_enc, g_enc, d_table, d_xn,
      N, L, T, F, include_xyz, xyz_scale);
  return launch_status();
}

extern "C" int encode_mlp_sdfgrad_fwd(
    const float* table, const float* x, const float* scales, const int* res,
    const float* level_mask, const float* W1, const float* b1,
    const float* W2, const float* b2, float* feat, float* grad, long long N,
    int L, int T, int F, int include_xyz, int d_in, int hidden, int d_out,
    float xyz_scale, float xyz_offset, void* stream) {
  if (d_in > MAX_IN || hidden > MAX_HIDDEN || d_out > MAX_OUT ||
      L * F > MAX_LF || F > 4)
    return (int)cudaErrorInvalidValue;
  if (N <= 0) return 0;
  const int threads = 128;
  unsigned blocks = (unsigned)((N + threads - 1) / threads);
  encode_mlp_sdfgrad_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      table, x, scales, res, level_mask, W1, b1, W2, b2, feat, grad, N, L, T,
      F, include_xyz, d_in, hidden, d_out, xyz_scale, xyz_offset);
  return launch_status();
}
