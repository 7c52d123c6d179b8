// KF: merge importance resampling of an edge list.
//
// Replaces intrinsicavatar_tpu/ops/resample.py:166 merge_resample (batched
// at :339), the TPU form of cdf_resampling_merge_kernel (cdf.cu:218-333).
// Per ray: the "real" interval mask (edge i opens, edge i+1 closes, both
// valid), the CDF over w / (sum w + max(1 - sum w, 0)), B uniform bins,
// placed = u < cdf[last], the right-side search clamped to `last`, the
// linear t_new, then a merge of the old edges (ascending, +inf tail) with
// the new draws.  Old edges win ties, as in the stable sort of
// cat(old, new) that the plain version and JAX's lexsort take.
//
// What bounds it on an H100: bytes.  Per ray it reads E x 11 B of edge list
// and weights and writes (E+B) x 16 B; the compare count of the merge is
// ~2 E B, far below the card's rate.
//
// Design: one thread per ray.  The CDF is summed sequentially in double and
// rounded to float at each step, which is what torch.cumsum does on the CPU
// (a warp scan would reassociate the sum and could move a searchsorted
// result across a boundary).  The search is a walk over the CDF, since the
// bins are ascending.  The merge computes each element's rank in the stable
// order directly (old edge i: i plus the new values below it; new value j:
// the old values at or below it plus the new values before it), so it needs
// no assumption that the draws come out ascending.
#include "common.cuh"

namespace {

constexpr int kMaxBins = 64;

// total order of the sort: NaN after everything, equal to itself
__device__ __forceinline__ bool lt(float a, float b) {
  return a < b || (!isnan(a) && isnan(b));
}

__global__ void merge_resample_kernel(
    const float* __restrict__ vals, const uint8_t* __restrict__ is_left,
    const uint8_t* __restrict__ is_right, const uint8_t* __restrict__ valid,
    const float* __restrict__ weights, int64_t R, int E, int B, float u0,
    float du, float* __restrict__ o_vals, uint8_t* __restrict__ o_left,
    uint8_t* __restrict__ o_right, uint8_t* __restrict__ o_valid,
    uint8_t* __restrict__ o_new, int64_t* __restrict__ o_gather) {
  const int64_t r = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= R) return;
  const float* v = vals + r * E;
  const uint8_t *L = is_left + r * E, *Rt = is_right + r * E,
                *V = valid + r * E;
  const float* w = weights + r * E;
  auto real = [&](int i) {
    return i + 1 < E && V[i] && V[i + 1] && L[i] && Rt[i + 1];
  };

  // pass 1: valid count and foreground mass
  int steps = 0;
  double wsum_d = 0.0;
  for (int i = 0; i < E; ++i) {
    steps += V[i] ? 1 : 0;
    if (real(i)) wsum_d += (double)w[i];
  }
  const int last = steps > 0 ? steps - 1 : 0;
  const float wsum = (float)wsum_d;
  const float denom = wsum + fmaxf(1.f - wsum, 0.f);

  // pass 2: walk the CDF; bin j goes to the first i with cdf[i] > u_j
  float nv[kMaxBins];
  double csum = 0.0;
  float cdf_last = 0.f, prev_last = 0.f;
  int j = 0;
  auto draw = [&](int idx, float cdf, float cdf_prev, float u) {
    float t0 = v[idx], t1 = v[min(idx + 1, E - 1)];
    float seg = fmaxf(cdf - cdf_prev, 1e-20f);
    return t0 + (u - cdf_prev) * (t1 - t0) / seg;
  };
  for (int i = 0; i < E; ++i) {
    const float wi = real(i) ? w[i] : 0.f;
    csum += (double)wi;
    const float cdf = (float)csum / denom;
    const float cdf_prev = cdf - wi / denom;
    if (i == last) {
      cdf_last = cdf;
      prev_last = cdf_prev;
    }
    for (; j < B; ++j) {
      const float u = u0 + (float)j * du;
      if (!(cdf > u)) break;
      nv[j] = i <= last ? draw(i, cdf, cdf_prev, u)
                        : draw(last, cdf_last, prev_last, u);
    }
  }
  for (; j < B; ++j)
    nv[j] = draw(last, cdf_last, prev_last, u0 + (float)j * du);
  uint64_t placed = 0;
  for (int b = 0; b < B; ++b) {
    const float u = u0 + (float)b * du;
    if (steps > 0 && u < cdf_last) placed |= 1ull << b;
    else nv[b] = INFINITY;
  }

  // pass 3: merge by rank
  const int EB = E + B;
  float* ov_row = o_vals + r * EB;
  uint8_t *ol = o_left + r * EB, *orr = o_right + r * EB,
          *ova = o_valid + r * EB, *onw = o_new + r * EB;
  int64_t* og = o_gather + r * EB;
  for (int i = 0; i < E; ++i) {
    const bool vi = V[i] != 0;
    const float x = vi ? v[i] : INFINITY;
    int pos = i;
    for (int b = 0; b < B; ++b) pos += lt(nv[b], x) ? 1 : 0;
    ov_row[pos] = x;
    ol[pos] = vi && L[i];
    orr[pos] = vi && Rt[i];
    ova[pos] = vi;
    onw[pos] = 0;
    og[pos] = i;
  }
  for (int b = 0; b < B; ++b) {
    const float x = nv[b];
    int pos = 0;
    for (int i = 0; i < E; ++i) {
      const float y = V[i] ? v[i] : INFINITY;
      pos += lt(x, y) ? 0 : 1;  // old at or below x comes first
    }
    for (int c = 0; c < B; ++c)
      pos += (lt(nv[c], x) || (c < b && !lt(x, nv[c]))) ? 1 : 0;
    const uint8_t p = (placed >> b) & 1;
    ov_row[pos] = x;
    ol[pos] = p;
    orr[pos] = p;
    ova[pos] = p;
    onw[pos] = p;
    og[pos] = E + b;
  }
}

}  // namespace

extern "C" int merge_resample_fwd(
    const float* vals, const uint8_t* is_left, const uint8_t* is_right,
    const uint8_t* valid, const float* weights, long long R, int E, int B,
    float u0, float du, float* o_vals, uint8_t* o_left, uint8_t* o_right,
    uint8_t* o_valid, uint8_t* o_new, int64_t* o_gather, void* stream) {
  if (R <= 0) return 0;
  if (B < 1 || B > kMaxBins) return (int)cudaErrorInvalidValue;
  const int threads = 64;
  unsigned blocks = (unsigned)((R + threads - 1) / threads);
  merge_resample_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      vals, is_left, is_right, valid, weights, R, E, B, u0, du, o_vals,
      o_left, o_right, o_valid, o_new, o_gather);
  return launch_status();
}
