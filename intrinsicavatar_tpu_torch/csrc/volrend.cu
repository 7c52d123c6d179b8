// KD weights: volume-rendering weights and transmittance
// (volrend_weights_fwd).
//
// Replaces intrinsicavatar_tpu/ops/volrend.py:61 render_weight_from_alpha
// (nerfacc's render_weight_from_alpha in the reference): per row of S
// samples, w_i = a_i T_i with T_i = prod_{j<i} (1 - a_j) and T_0 = 1; a
// masked slot reads as alpha 0 whatever it holds (NaN included), so it
// weighs nothing and attenuates nothing.  There is no division by 1 - a.
//
// What bounds it on an H100: bytes, 13 a sample (alpha 4, mask 1, w 4,
// T 4), with 3 flops between.  The Triton kernel it replaces ran one
// 4-warp program a row: at a shader chunk's [32768, 4] call that is 32,768
// blocks with 4 useful samples each, and the grid, not the bytes, set its
// time.
//
// Design: two forms, picked by the host entry from S and alignment.
// - Short rows of whole 16-byte words (S <= kShortMax, S % 4 == 0, every
//   pointer 16-byte aligned; the shader chunks' S = 4): a thread a row,
//   128 rows a block; each thread reads its row as float4 and uchar4 words
//   and writes w and T as float4 words.  The product runs serially in
//   float in sample order; the twin's cumprod differs from it by rounding
//   (on the CPU it accumulates in double).
// - Any other row (the importance rounds' S = 129 and 145): a warp a row,
//   kLongWarps rows a block.  The row goes through shared memory in
//   segments of 256 samples, loaded coalesced with the mask applied; lane
//   l multiplies its ceil(n / 32) consecutive samples serially, an
//   exclusive multiplicative scan over the lanes (__shfl_up_sync) gives
//   each lane the product before its samples, and the segment's product
//   carries into the next.  w and T are staged and stored coalesced.  The
//   scan associates the product otherwise than the short form.
#include "common.cuh"

namespace {

constexpr int kShortMax = 16;    // longest row of the short form
constexpr int kShortRows = 128;  // rows (threads) a block, short form
constexpr int kLongWarps = 8;    // rows (warps) a block, long form
constexpr int kSegment = 256;    // samples a staged segment, long form

__device__ __forceinline__ float masked(float a, bool m) {
  return m ? a : 0.f;
}

// The short form: a thread a row, 4 samples a word.
__device__ __forceinline__ void short_words(
    const float4* __restrict__ alpha, const uchar4* __restrict__ mask,
    float4* __restrict__ w, float4* __restrict__ t, int64_t R, int S4) {
  const int64_t r = (int64_t)blockIdx.x * kShortRows + threadIdx.x;
  if (r >= R) return;
  float carry = 1.f;
  for (int64_t q = r * S4, end = q + S4; q < end; ++q) {
    const float4 a4 = alpha[q];
    const uchar4 m4 = mask[q];
    float4 w4, t4;
    float a = masked(a4.x, m4.x);
    t4.x = carry; w4.x = a * carry; carry = carry * (1.f - a);
    a = masked(a4.y, m4.y);
    t4.y = carry; w4.y = a * carry; carry = carry * (1.f - a);
    a = masked(a4.z, m4.z);
    t4.z = carry; w4.z = a * carry; carry = carry * (1.f - a);
    a = masked(a4.w, m4.w);
    t4.w = carry; w4.w = a * carry; carry = carry * (1.f - a);
    w[q] = w4;
    t[q] = t4;
  }
}

// The long form: a warp a row.
__device__ __forceinline__ void long_rows(
    const float* __restrict__ alpha, const uint8_t* __restrict__ mask,
    float* __restrict__ w, float* __restrict__ t, int64_t R, int S) {
  __shared__ float s_a[kLongWarps][kSegment];  // masked alpha, then w
  __shared__ float s_t[kLongWarps][kSegment];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t r = (int64_t)blockIdx.x * kLongWarps + warp;
  if (r >= R) return;
  float* sa = s_a[warp];
  float* st = s_t[warp];
  const int64_t row = r * S;
  float carry = 1.f;
  for (int s0 = 0; s0 < S; s0 += kSegment) {
    const int n = min(kSegment, S - s0);
    for (int i = lane; i < n; i += 32)
      sa[i] = masked(alpha[row + s0 + i], mask[row + s0 + i]);
    __syncwarp();
    const int per = (n + 31) >> 5;
    const int i0 = min(lane * per, n), i1 = min(i0 + per, n);
    float prod = 1.f;
    for (int i = i0; i < i1; ++i) prod = prod * (1.f - sa[i]);
    float incl = prod;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const float v = __shfl_up_sync(0xffffffffu, incl, d);
      if (lane >= d) incl = v * incl;
    }
    const float excl = __shfl_up_sync(0xffffffffu, incl, 1);
    float run = carry * (lane ? excl : 1.f);
    for (int i = i0; i < i1; ++i) {
      const float a = sa[i];
      st[i] = run;
      sa[i] = a * run;
      run = run * (1.f - a);
    }
    carry = carry * __shfl_sync(0xffffffffu, incl, 31);
    __syncwarp();
    for (int i = lane; i < n; i += 32) {
      w[row + s0 + i] = sa[i];
      t[row + s0 + i] = st[i];
    }
    __syncwarp();
  }
}

template <bool kWords>
__global__ void __launch_bounds__(kLongWarps * 32) weights_kernel(
    const float* __restrict__ alpha, const uint8_t* __restrict__ mask,
    float* __restrict__ w, float* __restrict__ t, int64_t R, int S) {
  if constexpr (kWords)
    short_words(reinterpret_cast<const float4*>(alpha),
                reinterpret_cast<const uchar4*>(mask),
                reinterpret_cast<float4*>(w), reinterpret_cast<float4*>(t),
                R, S / 4);
  else
    long_rows(alpha, mask, w, t, R, S);
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

}  // namespace

extern "C" int volrend_weights_fwd(const float* alpha, const uint8_t* mask,
                                   float* w, float* t, long long R, int S,
                                   void* stream) {
  if (R <= 0 || S <= 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  if (S <= kShortMax && S % 4 == 0 && aligned16(alpha) && aligned16(mask) &&
      aligned16(w) && aligned16(t)) {
    const unsigned blocks = (unsigned)((R + kShortRows - 1) / kShortRows);
    weights_kernel<true><<<blocks, kShortRows, 0, st>>>(alpha, mask, w, t, R,
                                                         S);
  } else {
    const unsigned blocks = (unsigned)((R + kLongWarps - 1) / kLongWarps);
    weights_kernel<false><<<blocks, kLongWarps * 32, 0, st>>>(alpha, mask, w,
                                                              t, R, S);
  }
  return launch_status();
}
