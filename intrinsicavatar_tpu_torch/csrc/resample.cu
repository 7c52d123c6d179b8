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
// Design: one warp per ray (a serve chunk's 4,096 rays, one thread each,
// would fill 64 blocks of 2 warps on 132 SMs).  The warp stages the ray's
// row in shared memory with coalesced loads and counts the valid edges by
// ballot.  One lane sums the masked weights in double in edge order, which
// is what torch.cumsum does on the CPU (a warp scan would reassociate the
// sum and could move a search result across a boundary); the lanes round
// each prefix to float and divide as the sequential form does, so the CDF
// is the same bits.  Lane b draws u_b and finds its interval by a binary
// search over the running maximum of the CDF: the first CDF entry above
// u_b, which is what a walk over the CDF finds even where the CDF is not
// ascending or holds NaN.  The merge places each element at its rank in the
// stable order (old edge i: i plus the draws below it; draw b: the old
// edges at or below it, counted by the warp's lanes and a warp reduction,
// plus the draws before it), into a row staged in shared memory that the
// warp then writes out with coalesced stores.  No array lives in local
// memory.
#include "common.cuh"

namespace {

constexpr int kMaxBins = 64;
constexpr int kMaxEdges = 2048;
constexpr int KF_WARPS = 4;  // rays a block, one warp each

__host__ __device__ constexpr int align16(int n) { return (n + 15) & ~15; }

// shared memory of one ray: the double prefix sums (then the float pairs
// (cdf, cdf_prev) in their place), vals, the masked weights (then the
// CDF's running maximum), the draws, the merged vals and gather indices,
// the input flags and the merged flags
__host__ __device__ constexpr int kf_ray_bytes(int E, int B) {
  return align16(8 * E) + 2 * align16(4 * E) + align16(4 * B)
         + 2 * align16(4 * (E + B)) + align16(E) + align16(E + B);
}

// total order of the sort: NaN after everything, equal to itself
__device__ __forceinline__ bool lt(float a, float b) {
  return a < b || (!isnan(a) && isnan(b));
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

__global__ void __launch_bounds__(KF_WARPS * 32) merge_resample_kernel(
    const float* __restrict__ vals, const uint8_t* __restrict__ is_left,
    const uint8_t* __restrict__ is_right, const uint8_t* __restrict__ valid,
    const float* __restrict__ weights, int64_t R, int E, int B, float u0,
    float du, float* __restrict__ o_vals, uint8_t* __restrict__ o_left,
    uint8_t* __restrict__ o_right, uint8_t* __restrict__ o_valid,
    uint8_t* __restrict__ o_new, int64_t* __restrict__ o_gather) {
  extern __shared__ __align__(16) unsigned char kf_smem[];
  const unsigned full = 0xffffffffu;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t r = (int64_t)blockIdx.x * KF_WARPS + warp;
  if (r >= R) return;  // whole warps leave together
  const int EB = E + B;
  unsigned char* p = kf_smem + (int64_t)warp * kf_ray_bytes(E, B);
  double* s_cs = reinterpret_cast<double*>(p);
  float2* s_cdf = reinterpret_cast<float2*>(p);  // over s_cs, same slots
  p += align16(8 * E);
  float* s_v = reinterpret_cast<float*>(p);
  p += align16(4 * E);
  float* s_w = reinterpret_cast<float*>(p);  // masked weights, then the max
  p += align16(4 * E);
  float* s_nv = reinterpret_cast<float*>(p);
  p += align16(4 * B);
  float* s_ov = reinterpret_cast<float*>(p);
  p += align16(4 * EB);
  int* s_og = reinterpret_cast<int*>(p);
  p += align16(4 * EB);
  uint8_t* s_fl = p;  // bit 0: valid, 1: is_left, 2: is_right
  p += align16(E);
  uint8_t* s_of = p;  // bit 0: left, 1: right, 2: valid, 3: new

  // the row, and the valid count by ballot
  const int64_t row = r * E;
  int steps = 0;
  for (int i0 = 0; i0 < E; i0 += 32) {
    const int i = i0 + lane;
    bool vi = false;
    if (i < E) {
      vi = valid[row + i] != 0;
      s_v[i] = vals[row + i];
      s_w[i] = weights[row + i];
      s_fl[i] = (vi ? 1 : 0) | (is_left[row + i] ? 2 : 0)
                | (is_right[row + i] ? 4 : 0);
    }
    steps += __popc(__ballot_sync(full, vi));
  }
  const int last = steps > 0 ? steps - 1 : 0;
  __syncwarp();
  // real(i): edge i valid and opening, edge i + 1 valid and closing
  for (int i = lane; i < E; i += 32) {
    const bool real = i + 1 < E && (s_fl[i] & 3) == 3 &&
                      (s_fl[i + 1] & 5) == 5;
    if (!real) s_w[i] = 0.f;
  }
  __syncwarp();
  // the prefix sums, in double and in edge order, by one lane
  if (lane == 0) {
    double cs = 0.0;
    for (int i = 0; i < E; ++i) {
      cs += (double)s_w[i];
      s_cs[i] = cs;
    }
  }
  __syncwarp();
  const float wsum = (float)s_cs[E - 1];
  const float denom = wsum + fmaxf(1.f - wsum, 0.f);
  __syncwarp();  // every lane has read the total before the pairs overwrite
  for (int i = lane; i < E; i += 32) {
    const float cdf = (float)s_cs[i] / denom;
    s_cdf[i] = make_float2(cdf, cdf - s_w[i] / denom);
  }
  __syncwarp();
  // the CDF's running maximum (NaN skipped) over the masked weights: its
  // first entry above u is the CDF's first entry above u
  float run = -INFINITY;
  for (int i0 = 0; i0 < E; i0 += 32) {
    const int i = i0 + lane;
    float m = i < E ? fmaxf(s_cdf[i].x, -INFINITY) : -INFINITY;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float n = __shfl_up_sync(full, m, o);
      if (lane >= o) m = fmaxf(m, n);
    }
    m = fmaxf(m, run);
    if (i < E) s_w[i] = m;
    run = __shfl_sync(full, m, 31);
  }
  __syncwarp();

  // the draws: lane b, then b + 32
  const float cdf_last = s_cdf[last].x;
  bool placed[2] = {false, false};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int b = lane + 32 * h;
    if (b < B) {
      const float u = u0 + (float)b * du;
      const int idx = min(count_le(s_w, E, u), last);
      const float2 c = s_cdf[idx];
      const float t0 = s_v[idx], t1 = s_v[min(idx + 1, E - 1)];
      const float seg = fmaxf(c.x - c.y, 1e-20f);
      const float t = t0 + (u - c.y) * (t1 - t0) / seg;
      placed[h] = steps > 0 && u < cdf_last;
      s_nv[b] = placed[h] ? t : INFINITY;
    }
  }
  __syncwarp();

  // merge by rank: old edge i goes to i + #{draws below it}
  for (int i = lane; i < E; i += 32) {
    const int fl = s_fl[i];
    const bool vi = fl & 1;
    const float x = vi ? s_v[i] : INFINITY;
    int pos = i;
    for (int b = 0; b < B; ++b) pos += lt(s_nv[b], x) ? 1 : 0;
    s_ov[pos] = x;
    s_og[pos] = i;
    s_of[pos] = vi ? 4 | ((fl >> 1) & 3) : 0;
  }
  // draw b goes to #{old at or below it} + #{draws before it in the stable
  // order}; the old edges are counted by all lanes and a warp reduction
  int old_le[2] = {0, 0};
  for (int b = 0; b < B; ++b) {
    const float xb = s_nv[b];
    int n = 0;
    for (int i = lane; i < E; i += 32) {
      const float y = (s_fl[i] & 1) ? s_v[i] : INFINITY;
      n += lt(xb, y) ? 0 : 1;
    }
    n = __reduce_add_sync(full, n);
    if ((b & 31) == lane) {
      if (b < 32) old_le[0] = n;
      else old_le[1] = n;
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int b = lane + 32 * h;
    if (b < B) {
      const float xb = s_nv[b];
      int pos = old_le[h];
      for (int c = 0; c < B; ++c) {
        const float xc = s_nv[c];
        pos += (lt(xc, xb) || (c < b && !lt(xb, xc))) ? 1 : 0;
      }
      s_ov[pos] = xb;
      s_og[pos] = E + b;
      s_of[pos] = placed[h] ? 15 : 0;
    }
  }
  __syncwarp();

  // the merged row, with coalesced stores
  const int64_t orow = r * EB;
  for (int q = lane; q < EB; q += 32) {
    const int f = s_of[q];
    o_vals[orow + q] = s_ov[q];
    o_left[orow + q] = f & 1;
    o_right[orow + q] = (f >> 1) & 1;
    o_valid[orow + q] = (f >> 2) & 1;
    o_new[orow + q] = (f >> 3) & 1;
    o_gather[orow + q] = s_og[q];
  }
}

}  // namespace

extern "C" int merge_resample_fwd(
    const float* vals, const uint8_t* is_left, const uint8_t* is_right,
    const uint8_t* valid, const float* weights, long long R, int E, int B,
    float u0, float du, float* o_vals, uint8_t* o_left, uint8_t* o_right,
    uint8_t* o_valid, uint8_t* o_new, int64_t* o_gather, void* stream) {
  if (B < 1 || B > kMaxBins || E < 1 || E > kMaxEdges)
    return (int)cudaErrorInvalidValue;
  if (R <= 0) return 0;
  const int smem = KF_WARPS * kf_ray_bytes(E, B);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        merge_resample_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return (int)err;
  }
  const unsigned blocks = (unsigned)((R + KF_WARPS - 1) / KF_WARPS);
  merge_resample_kernel<<<blocks, KF_WARPS * 32, smem,
                          (cudaStream_t)stream>>>(
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
// What bounds it on an H100: bytes.  Per ray it reads S x 9 B (alphas or
// weights, sdf, mask), t_starts and t_ends at the n+1 drawn slots, and
// writes n x 9 B; ~20 flops per slot.
//
// Design: one thread per ray, 128 rays a block, whose rows the block's 16
// warps first stage in shared memory, 8 rows a warp, so that the whole
// block's loads are in flight at once (32,768 rays give only ~8 warps an
// SM).  The staging loads run along the rows (a warp reads 32 consecutive
// slots of a row), keep each value with its mask applied in a row of odd
// stride (32 lanes at one slot of 32 rows hit 32 banks), and reduce the
// mask and the SDF's signs to bit words by ballot: the crossing is the
// first set bit of m & m>>1 & (sd >= 0) & (sd < 0)>>1, where a NaN SDF sets
// neither sign, and the valid count is a popc.  One walk then builds the
// CDF, KJ_GROUP slots at a time (their values loaded first, sdf steps
// without a branch: with ~8 walking warps an SM the walk is bound by each
// step's latency), and records each draw's slot and CDF pair only in a
// group where one passes; the mass the draws are placed against is the
// CDF at the walk's last slot, so `placed` is resolved after it.  Products and sums run sequentially in
// double and are rounded to float where the plain twin rounds its double
// cumprod and cumsum, so both build the same CDF (sdf mode divides by a
// denominator of exactly 1, which it leaves out).  t_starts and t_ends are
// read only at the drawn slots, and each walking warp's outputs leave
// through shared memory as contiguous spans.
// ---------------------------------------------------------------------------

constexpr int KJ_RAYS = 128;     // rays a block, a walking thread each
constexpr int KJ_THREADS = 512;  // threads staging them, 8 rows a warp
constexpr int KJ_GROUP = 8;      // slots a walk step takes before its draws

// words of a row's bit mask, and the odd stride of its staged values
__host__ __device__ constexpr int kj_words(int S) { return (S + 31) / 32; }
__host__ __device__ constexpr int kj_stride(int S) { return S | 1; }

// dynamic shared memory of a block: the staged rows, three bit words a
// 32-slot group, and each draw's slot, CDF floor and segment (the floor's
// place then takes the drawn t), all [item][ray]; each ray's placing mass
__host__ __device__ constexpr int kj_smem(int S, int nb) {
  return 4 * KJ_RAYS * (kj_stride(S) + 3 * kj_words(S) + 3 * nb + 1);
}

template <bool kSdf>
__global__ void __launch_bounds__(KJ_THREADS, 2) fine_resample_kernel(
    const float* __restrict__ t_starts, const float* __restrict__ t_ends,
    const float* __restrict__ vals, const float* __restrict__ sdfs,
    const uint8_t* __restrict__ mask, int64_t R, int S, int nb, float u0,
    float du, float* __restrict__ o_ts, float* __restrict__ o_te,
    uint8_t* __restrict__ o_mask) {
  extern __shared__ float kj_shared[];
  const int W = kj_words(S), stride = kj_stride(S);
  float* s_v = kj_shared;
  uint32_t* s_m = reinterpret_cast<uint32_t*>(s_v + KJ_RAYS * stride);
  uint32_t* s_nn = s_m + W * KJ_RAYS;  // sd >= 0
  uint32_t* s_ng = s_nn + W * KJ_RAYS;  // sd < 0
  int* s_idx = reinterpret_cast<int*>(s_ng + W * KJ_RAYS);
  float* s_lo = reinterpret_cast<float*>(s_idx + nb * KJ_RAYS);
  float* s_seg = s_lo + nb * KJ_RAYS;
  float* s_lim = s_seg + nb * KJ_RAYS;

  const int lane = threadIdx.x & 31;
  const int64_t rb = (int64_t)blockIdx.x * KJ_RAYS;  // the block's first ray
  const int nrows = R - rb < KJ_RAYS ? (int)(R - rb) : KJ_RAYS;

  // staging: warp w reads rows 8w .. 8w + 7, 32 slots at a time
  constexpr int U = 8;
  const int row0 = (threadIdx.x >> 5) * U;
  const float* vb = vals + rb * S;
  const float* sb = sdfs + rb * S;
  const uint8_t* mb = mask + rb * S;
  for (int k = 0; k < W && row0 < nrows; ++k) {
    const int slot = k * 32 + lane;
    float v[U], sd[U];
    bool m[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const bool in = slot < S && row0 + u < nrows;
      const int e = (row0 + u) * S + slot;
      v[u] = in ? vb[e] : 0.f;
      m[u] = in && mb[e] != 0;
      // out of the row: a NaN, which sets neither sign
      sd[u] = (kSdf && in) ? sb[e] : __int_as_float(0x7fffffff);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      // rows past the block's last ray are staged too, never read
      const int q = row0 + u;
      if (slot < S) s_v[q * stride + slot] = m[u] ? v[u] : 0.f;
      const unsigned bm = __ballot_sync(0xffffffffu, m[u]);
      if (lane == 0) s_m[k * KJ_RAYS + q] = bm;
      if (kSdf) {
        const unsigned bnn = __ballot_sync(0xffffffffu, sd[u] >= 0.f);
        const unsigned bng = __ballot_sync(0xffffffffu, sd[u] < 0.f);
        if (lane == 0) {
          s_nn[k * KJ_RAYS + q] = bnn;
          s_ng[k * KJ_RAYS + q] = bng;
        }
      }
    }
  }
  __syncthreads();

  // the walk: a thread a ray
  const int q0 = threadIdx.x & ~31;
  if (q0 >= nrows) return;  // the same for the whole warp
  const int rows = min(nrows - q0, 32);
  const int64_t r0 = rb + q0;  // the warp's first ray
  const int q = q0 + lane;
  if (lane < rows) {
    const float* row = s_v + q * stride;
    // the crossing (sdf mode) or the valid count (plain)
    int cross = -1, steps = 0;
    for (int k = 0; k < W; ++k) {
      const uint32_t m = s_m[k * KJ_RAYS + q];
      if (kSdf) {
        const bool last = k + 1 == W;
        const uint32_t m1 = last ? 0u : s_m[(k + 1) * KJ_RAYS + q];
        const uint32_t g1 = last ? 0u : s_ng[(k + 1) * KJ_RAYS + q];
        const uint32_t x = m & ((m >> 1) | (m1 << 31)) & s_nn[k * KJ_RAYS + q]
                           & ((s_ng[k * KJ_RAYS + q] >> 1) | (g1 << 31));
        if (x && cross < 0) cross = k * 32 + __ffs(x) - 1;
      } else {
        steps += __popc(m);
      }
    }
    float denom = 1.f;
    if (!kSdf) {
      double mass = 0.0;  // a masked slot adds +0, which changes no sum
#pragma unroll 8
      for (int i = 0; i < S; ++i) mass += (double)row[i];
      const float wsum = (float)mass;
      denom = wsum + fmaxf(1.f - wsum, 0.f);
    }
    const bool found = kSdf ? cross >= 0 : steps > 0;
    const int start = cross < 0 ? 0 : cross;
    const int clip = kSdf ? S - 1 : (steps > 0 ? steps - 1 : 0);

    // the walk, KJ_GROUP slots at a time: the group's CDF pairs first, then
    // the draws in order, only in a group where some pair passes the next
    // draw: draw j goes to the first i <= clip with cdf[i] > u_j, else to
    // clip (the draws ascend, so they are recorded in order)
    double trans = 1.0, csum = 0.0;
    float c = 0.f, cp = 0.f;
    int j = 0;
    float u_next = u0 + (float)j * du;  // +inf once every draw is recorded
    auto record = [&](int i, float ci, float cpi) {
      s_idx[j * KJ_RAYS + q] = i;
      s_lo[j * KJ_RAYS + q] = cpi;
      s_seg[j * KJ_RAYS + q] = fmaxf(ci - cpi, 1e-20f);
      ++j;
    };
    for (int i0 = 0; i0 <= clip; i0 += KJ_GROUP) {
      // the group's values first, so that no step waits on shared memory;
      // a step past clip leaves the state as it is (in sdf mode without a
      // branch a step)
      float av[KJ_GROUP], cg[KJ_GROUP], cpg[KJ_GROUP];
#pragma unroll
      for (int g = 0; g < KJ_GROUP; ++g) av[g] = row[min(i0 + g, S - 1)];
      bool pass = false;
#pragma unroll
      for (int g = 0; g < KJ_GROUP; ++g) {
        const int i = i0 + g;
        const bool live = i <= clip;
        if (kSdf) {
          const float a = i >= start ? av[g] : 0.f;
          const float w = a * (float)trans;
          const double t_next = trans * (double)(1.f - a);
          const double s_next = csum + (double)w;
          const float c_next = (float)s_next;
          const float cp_next = c_next - w;
          trans = live ? t_next : trans;
          csum = live ? s_next : csum;
          c = live ? c_next : c;
          cp = live ? cp_next : cp;
        } else if (live) {  // plain mode: clip differs from ray to ray
          const float w = av[g];
          csum += (double)w;
          c = (float)csum / denom;
          cp = c - w / denom;
        }
        pass |= live && c > u_next;
        cg[g] = c;
        cpg[g] = cp;
      }
      if (pass) {
#pragma unroll
        for (int g = 0; g < KJ_GROUP; ++g) {
          if (i0 + g > clip) break;
          while (j < nb && cg[g] > u0 + (float)j * du)
            record(i0 + g, cg[g], cpg[g]);
        }
        u_next = j < nb ? u0 + (float)j * du : INFINITY;
      }
    }
    while (j < nb) record(clip, c, cp);
    s_lim[q] = found ? c : -INFINITY;  // placed: u < cdf[clip], if found

    // the drawn positions, t_starts and t_ends read at the drawn slots
    const int64_t base = (r0 + lane) * S;
#pragma unroll 4
    for (int d = 0; d < nb; ++d) {
      const int i = s_idx[d * KJ_RAYS + q];
      const float u = u0 + (float)d * du;
      const float ts = t_starts[base + i], te = t_ends[base + i];
      s_lo[d * KJ_RAYS + q] =
          ts + (u - s_lo[d * KJ_RAYS + q]) * (te - ts) / s_seg[d * KJ_RAYS + q];
    }
  }
  __syncwarp();

  // the warp's rows of the outputs, contiguous
  const int n = nb - 1;
  const int64_t out0 = r0 * n;
  for (int e = lane; e < rows * n; e += 32) {
    const int rw = e / n, k = e - rw * n, qq = q0 + rw;
    const float lim = s_lim[qq];
    o_ts[out0 + e] = s_lo[k * KJ_RAYS + qq];
    o_te[out0 + e] = s_lo[(k + 1) * KJ_RAYS + qq];
    o_mask[out0 + e] = u0 + (float)k * du < lim
                       && u0 + (float)(k + 1) * du < lim;
  }
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

// Dynamic shared memory KJ needs for rows of S slots and nb draws.
extern "C" int fine_resample_smem(int S, int nb) { return kj_smem(S, nb); }

extern "C" int fine_resample_fwd(
    const float* t_starts, const float* t_ends, const float* vals,
    const float* sdfs, const uint8_t* mask, long long R, int S, int nb,
    float u0, float du, int sdf_mode, float* o_ts, float* o_te,
    uint8_t* o_mask, void* stream) {
  if (R <= 0) return 0;
  if (S < 1 || nb < 2) return (int)cudaErrorInvalidValue;
  const int smem = kj_smem(S, nb);
  auto kernel = sdf_mode ? fine_resample_kernel<true>
                         : fine_resample_kernel<false>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  const unsigned blocks = (unsigned)((R + KJ_RAYS - 1) / KJ_RAYS);
  kernel<<<blocks, KJ_THREADS, smem, (cudaStream_t)stream>>>(
      t_starts, t_ends, vals, sdfs, mask, R, S, nb, u0, du, o_ts, o_te,
      o_mask);
  return launch_status();
}
