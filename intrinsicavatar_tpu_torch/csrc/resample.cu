// KF: merge importance resampling of an edge list (merge_resample_fwd);
// KI: scatter-point sampling (cdf_resample_fwd) and KJ: secondary fine
// resampling (fine_resample_fwd), described above each kernel below.
//
// KF:
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

// ---------------------------------------------------------------------------
// KI: scatter-point sampling by inverse CDF with a background bin.
//
// Replaces intrinsicavatar_tpu/ops/resample.py:62 cdf_resample (batched at
// :335), the TPU form of cdf_resampling_kernel (cdf.cu:10-148).  Per ray:
// the CDF of w / (sum w + max(1 - sum w, 0)) over the masked intervals, B
// stratified positions u_k, each drawn by a right-side search clamped to
// `last` (the last valid slot); a draw at or beyond the foreground mass is a
// background sample (t = t_ends[last] + BG_OFFSET, index `last`, offset
// BG_OFFSET).  Draws inside the first +/- SDF crossing interval whose
// interpolated SDF is negative, and all draws beyond it, are pinned: they
// repeat the t of the last unpinned draw before them, or t_starts[idx[0]]
// when there is none.  fg_counts counts the foreground draws per interval;
// surface_idx is the crossing's index only when u[B-1] >= cdf[crossing]
// (the serial kernel records it only when it walks past the crossing).
//
// What bounds it on an H100: bytes.  Per ray it reads S x 17 B and writes
// B x 13 B + S x 4 B; the math is a log2(S)-step search per draw.
//
// Design: one warp per ray (4,096 rays, one thread each, would fill 2% of
// the card).  The CDF is a warp scan over 32-slot chunks, summed in double
// and rounded to float, as the plain twin's double cumsum: both round the
// same sums, so the searches agree exactly.  cdf and cdf_prev live in
// shared memory; lane l draws positions l, l + 32, ... (16 of 512); the
// forward fill of pinned draws is a ballot over each 32-draw chunk (the
// highest unpinned lane at or below this one) with the last unpinned t
// carried from chunk to chunk.  fg_counts are shared-memory atomics.
// ---------------------------------------------------------------------------

namespace {

constexpr int kCdfWarps = 4;
constexpr int kCdfMaxS = 256;
constexpr float kBgOffset = 10000.f;

// warp-wide inclusive scan of one double per lane
__device__ __forceinline__ double warp_scan(double v, int lane) {
  for (int o = 1; o < 32; o <<= 1) {
    double n = __shfl_up_sync(0xffffffffu, v, o);
    if (lane >= o) v += n;
  }
  return v;
}

// number of entries of the ascending cdf[0, n) that are <= u
__device__ __forceinline__ int count_le(const float* cdf, int n, float u) {
  int lo = 0, hi = n;
  while (lo < hi) {
    int mid = (lo + hi) >> 1;
    if (cdf[mid] <= u) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

__global__ void cdf_resample_kernel(
    const float* __restrict__ t_starts, const float* __restrict__ t_ends,
    const float* __restrict__ weights, const float* __restrict__ sdfs,
    const uint8_t* __restrict__ mask, int64_t R, int S, int B, float u0,
    float du, float* __restrict__ o_ts, float* __restrict__ o_off,
    int* __restrict__ o_idx, uint8_t* __restrict__ o_bg,
    int* __restrict__ o_fg, int* __restrict__ o_bgc,
    int* __restrict__ o_surf) {
  __shared__ float s_cdf[kCdfWarps][kCdfMaxS];
  __shared__ float s_prev[kCdfWarps][kCdfMaxS];
  __shared__ int s_cnt[kCdfWarps][kCdfMaxS];
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const int64_t r = (int64_t)blockIdx.x * kCdfWarps + wid;
  if (r >= R) return;  // whole warps leave together
  const float *ts = t_starts + r * S, *te = t_ends + r * S,
              *w = weights + r * S, *sd = sdfs + r * S;
  const uint8_t* m = mask + r * S;
  float* cdf = s_cdf[wid];
  float* prev = s_prev[wid];
  int* cnt = s_cnt[wid];

  // pass 1: valid count, the first crossing and the double prefix sums
  int steps = 0, cross = S + 1;
  double run = 0.0;
  for (int base = 0; base < S; base += 32) {
    const int i = base + lane;
    const bool mi = i < S && m[i];
    const float wi = mi ? w[i] : 0.f;
    const bool cr = mi && i + 1 < S && m[i + 1] && sd[i] >= 0.f &&
                    sd[i + 1] < 0.f;
    steps += __popc(__ballot_sync(0xffffffffu, mi));
    const unsigned cb = __ballot_sync(0xffffffffu, cr);
    if (cb && cross == S + 1) cross = base + __ffs(cb) - 1;
    const double incl = run + warp_scan((double)wi, lane);
    if (i < S) {
      cdf[i] = (float)incl;  // un-normalized until the total is known
      cnt[i] = 0;
    }
    run = __shfl_sync(0xffffffffu, incl, 31);
  }
  const int last = steps > 0 ? steps - 1 : 0;
  const float wsum = (float)run;
  const float denom = wsum + fmaxf(1.f - wsum, 0.f);
  __syncwarp();
  for (int i = lane; i < S; i += 32) {
    const float wi = m[i] ? w[i] : 0.f;
    const float c = cdf[i] / denom;
    cdf[i] = c;
    prev[i] = c - wi / denom;
  }
  __syncwarp();
  const float fg_total = cdf[last];

  // pass 2: the draws, 32 at a time, with the pinned ones forward-filled
  const float t_bg = te[last] + kBgOffset;
  int bg_count = 0;
  bool have_src = false;
  float src_t = 0.f;
  float fallback = 0.f;
  for (int base = 0; base < B; base += 32) {
    const int b = base + lane;
    const bool live = b < B;
    const float u = u0 + (float)b * du;
    int idx = min(max(count_le(cdf, S, u), 0), last);
    const bool is_bg = (u >= fg_total) || steps == 0;
    const float c_hi = cdf[idx], c_lo = prev[idx];
    const float seg = fmaxf(c_hi - c_lo, 1e-20f);
    const float dist = te[idx] - ts[idx];
    const float offset = (u - c_lo) * dist / seg;
    const float t_raw = ts[idx] + offset;
    const float s_lo = sd[idx];
    const float s_hi = sd[idx + 1 < S ? idx + 1 : 0];  // roll(sdfs, -1)
    const float s_ap = s_lo + (s_hi - s_lo) * offset / fmaxf(dist, 1e-20f);
    const bool pinned = live && !is_bg &&
                        (idx > cross || (idx == cross && s_ap < 0.f));
    if (base == 0) fallback = __shfl_sync(0xffffffffu, ts[idx], 0);
    const float t_cand = is_bg ? t_bg : t_raw;
    const unsigned unp = __ballot_sync(0xffffffffu, live && !pinned);
    // the highest unpinned draw at or below this lane, else the carry
    const unsigned upto = unp & (0xffffffffu >> (31 - lane));
    const float got =
        __shfl_sync(0xffffffffu, t_cand, upto ? 31 - __clz(upto) : 0);
    const float t_out = upto ? got : (have_src ? src_t : fallback);
    const float chunk_last =
        __shfl_sync(0xffffffffu, t_cand, unp ? 31 - __clz(unp) : 0);
    if (unp) {
      src_t = chunk_last;
      have_src = true;
    }
    bg_count += __popc(__ballot_sync(0xffffffffu, live && is_bg));
    if (live) {
      const int64_t o = r * B + b;
      o_ts[o] = t_out;
      o_off[o] = is_bg ? kBgOffset : offset;
      o_idx[o] = is_bg ? last : idx;
      o_bg[o] = is_bg;
      if (!is_bg) atomicAdd(&cnt[idx], 1);
    }
  }
  __syncwarp();
  for (int i = lane; i < S; i += 32) o_fg[r * S + i] = cnt[i];
  if (lane == 0) {
    o_bgc[r] = bg_count;
    const float u_last = u0 + (float)(B - 1) * du;
    const bool passed = cross <= S - 1 && steps > 0 &&
                        u_last >= cdf[min(cross, S - 1)];
    o_surf[r] = passed ? cross : -1;
  }
}

// ---------------------------------------------------------------------------
// KJ: secondary fine resampling.
//
// Replaces intrinsicavatar_tpu/ops/resample.py:282 sdf_fine_resample (the
// zero-crossing search, cdf_resampling_sdf_fine_kernel, cdf.cu:537-638) and
// :243 fine_resample (cdf_resampling_fine_kernel, cdf.cu:404-534), batched
// at :343-350.  sdf mode: the first interval whose SDF crosses + -> - (none:
// the ray places nothing), the weights a_i T_i of the transmittance
// restarted there (a_i = alpha_i on valid slots at or after the crossing),
// their un-normalized CDF, n+1 stratified positions drawn by a right-side
// search clamped to S-1, placed while u < cdf[S-1].  Plain mode: the
// normalized CDF with the background bin, the search clamped to `last`,
// placed while u < cdf[last].  Interval k spans draws k and k+1 and is
// valid when both were placed.
//
// What bounds it on an H100: bytes.  Per ray it reads S x 17 B (t_starts,
// t_ends, alphas or weights, sdf, mask) and writes n x 9 B; ~20 flops per
// slot.
//
// Design: one thread per ray.  The secondary shader chunk has 32,768 rays,
// 1,024 warps, ~8 a streaming multiprocessor, enough to fill the card
// without splitting a 64-slot row over a warp.  A thread keeps no arrays:
// it walks its row three times (crossing or count; the total mass; the CDF
// with the ascending draws emitted as the walk passes them, as KF does),
// the row staying in L1 between walks.  Products and sums run sequentially
// in double and are rounded to float where the plain twin rounds its
// double cumprod and cumsum, so both build the same CDF.
// ---------------------------------------------------------------------------

struct FineRow {
  const float *ts, *te, *v;
  const uint8_t* m;
  int start;     // sdf mode: first slot of the restarted transmittance
  bool sdf_mode;
  float denom;
  double trans, csum;

  __device__ void reset() { trans = 1.0; csum = 0.0; }
  // slot i's weight; advances the running transmittance and sum
  __device__ float step(int i, float* cdf, float* cdf_prev) {
    float w;
    if (sdf_mode) {
      const float a = (m[i] && i >= start) ? v[i] : 0.f;
      w = a * (float)trans;
      trans *= (double)(1.f - a);
    } else {
      w = m[i] ? v[i] : 0.f;
    }
    csum += (double)w;
    *cdf = (float)csum / denom;
    *cdf_prev = *cdf - w / denom;
    return w;
  }
};

__global__ void fine_resample_kernel(
    const float* __restrict__ t_starts, const float* __restrict__ t_ends,
    const float* __restrict__ vals, const float* __restrict__ sdfs,
    const uint8_t* __restrict__ mask, int64_t R, int S, int nb, float u0,
    float du, int sdf_mode, float* __restrict__ o_ts,
    float* __restrict__ o_te, uint8_t* __restrict__ o_mask) {
  const int64_t r = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= R) return;
  FineRow row{t_starts + r * S, t_ends + r * S, vals + r * S, mask + r * S,
              0, sdf_mode != 0, 1.f, 1.0, 0.0};

  // walk 1: the crossing (sdf mode) or the valid count and mass (plain)
  int cross = -1, steps = 0;
  double mass = 0.0;
  if (row.sdf_mode) {
    const float* sd = sdfs + r * S;
    for (int i = 0; i + 1 < S; ++i)
      if (row.m[i] && row.m[i + 1] && sd[i] >= 0.f && sd[i + 1] < 0.f) {
        cross = i;
        break;
      }
  } else {
    for (int i = 0; i < S; ++i)
      if (row.m[i]) {
        ++steps;
        mass += (double)row.v[i];
      }
    const float wsum = (float)mass;
    row.denom = wsum + fmaxf(1.f - wsum, 0.f);
  }
  const bool found = row.sdf_mode ? cross >= 0 : steps > 0;
  row.start = cross < 0 ? 0 : cross;
  const int clip = row.sdf_mode ? S - 1 : (steps > 0 ? steps - 1 : 0);

  // walk 2: the mass the draws are placed against, cdf[clip]
  float total = 0.f, c, cp;
  row.reset();
  for (int i = 0; i <= clip; ++i) row.step(i, &c, &cp);
  total = c;

  // walk 3: draw j goes to the first i <= clip with cdf[i] > u_j, else to
  // clip; the draws ascend, so they are emitted in order
  float* ots = o_ts + r * (nb - 1);
  float* ote = o_te + r * (nb - 1);
  uint8_t* om = o_mask + r * (nb - 1);
  float t_prev = 0.f;
  bool placed_prev = false;
  int j = 0;
  auto emit = [&](int idx, float cdf, float cdf_prev) {
    const float u = u0 + (float)j * du;
    const float seg = fmaxf(cdf - cdf_prev, 1e-20f);
    const float t =
        row.ts[idx] + (u - cdf_prev) * (row.te[idx] - row.ts[idx]) / seg;
    const bool placed = u < total && found;
    if (j > 0) {
      ots[j - 1] = t_prev;
      ote[j - 1] = t;
      om[j - 1] = placed_prev && placed;
    }
    t_prev = t;
    placed_prev = placed;
    ++j;
  };
  row.reset();
  for (int i = 0; i <= clip && j < nb; ++i) {
    row.step(i, &c, &cp);
    while (j < nb && c > u0 + (float)j * du) emit(i, c, cp);
  }
  while (j < nb) emit(clip, c, cp);
}

}  // namespace

extern "C" int cdf_resample_fwd(
    const float* t_starts, const float* t_ends, const float* weights,
    const float* sdfs, const uint8_t* mask, long long R, int S, int B,
    float u0, float du, float* o_ts, float* o_off, int* o_idx,
    uint8_t* o_bg, int* o_fg, int* o_bgc, int* o_surf, void* stream) {
  if (R <= 0) return 0;
  if (S < 1 || S > kCdfMaxS || B < 1) return (int)cudaErrorInvalidValue;
  unsigned blocks = (unsigned)((R + kCdfWarps - 1) / kCdfWarps);
  cdf_resample_kernel<<<blocks, kCdfWarps * 32, 0, (cudaStream_t)stream>>>(
      t_starts, t_ends, weights, sdfs, mask, R, S, B, u0, du, o_ts, o_off,
      o_idx, o_bg, o_fg, o_bgc, o_surf);
  return launch_status();
}

extern "C" int fine_resample_fwd(
    const float* t_starts, const float* t_ends, const float* vals,
    const float* sdfs, const uint8_t* mask, long long R, int S, int nb,
    float u0, float du, int sdf_mode, float* o_ts, float* o_te,
    uint8_t* o_mask, void* stream) {
  if (R <= 0) return 0;
  if (S < 1 || nb < 2) return (int)cudaErrorInvalidValue;
  const int threads = 128;
  unsigned blocks = (unsigned)((R + threads - 1) / threads);
  fine_resample_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      t_starts, t_ends, vals, sdfs, mask, R, S, nb, u0, du, sdf_mode, o_ts,
      o_te, o_mask);
  return launch_status();
}
