// KG: valid-first stable compaction into a static budget.
//
// Replaces intrinsicavatar_tpu/ops/compact.py:25 stable_partition_indices,
// :43 compact_indices and :52 compact_indices_interleaved: the first
// `budget` entries of the permutation that puts the valid entries first,
// each group in its order (the invalid ones follow when the budget exceeds
// the valid count), and whether each picked entry is valid.  In sample-major
// order entry j of the order is entry (j % R) * S + j / R of the ray-major
// [R, S] mask, and the index returned is that ray-major entry.  A valid
// entry goes to slot (valid entries before it); an invalid one to n_valid +
// (invalid entries before it), as compact.py:31-37 computes them with two
// cumsums.  Slots at or past the budget are not written.
//
// What bounds it on an H100: bytes.  It reads the mask (1 B an entry) twice
// and writes 9 B per budget slot.
//
// Design: two launches a call, a count pass and a scatter pass over the
// same blocks, and no host sync; both read the mask as it is stored, with
// 16-byte loads where the rows allow them.
// - Sample-major: a block takes 256 rays, a warp 32 of them, a lane its own
//   ray's row.  For each sample s a ballot over the warp's rays gives the
//   warp's count at s and each ray's rank among them; the count pass writes
//   the block's count at each sample.  The scatter pass sums, at each
//   sample, the counts of the blocks before its own and of all blocks, and
//   scans the totals over the samples; an entry's rank is then (valid
//   entries at earlier samples) + (valid entries at s in earlier blocks and
//   warps) + its rank in the ballot.  The valid entries of one (s, warp) go
//   to consecutive slots, and its invalid ones too, so the stores coalesce.
// - Ray-major: a block takes 4,096 entries, a lane 16 of them with one
//   16-byte load.  The count pass writes the block's count; the scatter pass
//   sums the counts before its block, scans the lanes' counts by shuffles
//   and the warps' in shared memory, stages each warp's 512 entries in
//   output order (its valid ones, then its invalid ones) in shared memory
//   and writes them out as two contiguous spans.
#include "common.cuh"

namespace {

constexpr int KG_WARPS = 8;
constexpr int KG_THREADS = 32 * KG_WARPS;
constexpr int KG_RAYS = KG_THREADS;       // sample-major: rays a block
constexpr int KG_SPAN = 16 * KG_THREADS;  // ray-major: entries a block
constexpr int kMaxS = 4096;               // sample-major: samples a ray

// bit b: byte b of x is not 0
__device__ __forceinline__ uint32_t nonzero_bytes(uint32_t x) {
  x |= x >> 4;
  x |= x >> 2;
  x |= x >> 1;
  return ((x & 0x01010101u) * 0x10204080u) >> 28;
}

// bit b: entry b of the 16 at p is valid; entries at or past `avail` are
// not read.  One 16-byte load where `vec` (p 16-byte aligned).
__device__ __forceinline__ uint32_t valid16(const uint8_t* p, int64_t avail,
                                            bool vec) {
  if (avail <= 0) return 0u;
  if (vec && avail >= 16) {
    const uint4 x = __ldg(reinterpret_cast<const uint4*>(p));
    return nonzero_bytes(x.x) | nonzero_bytes(x.y) << 4
           | nonzero_bytes(x.z) << 8 | nonzero_bytes(x.w) << 12;
  }
  uint32_t bits = 0u;
#pragma unroll
  for (int b = 0; b < 16; ++b)
    if (b < avail && p[b] != 0) bits |= 1u << b;
  return bits;
}

// bit b: sample s0 + b of the row of S samples at `row` is valid
__device__ __forceinline__ uint64_t valid64(const uint8_t* row, int s0, int S,
                                            bool vec) {
  uint64_t bits = 0;
#pragma unroll
  for (int c = 0; c < 4; ++c)
    bits |= (uint64_t)valid16(row + s0 + 16 * c, S - s0 - 16 * c, vec)
            << (16 * c);
  return bits;
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// The warp's valid entries at samples s0 + lane (lo) and s0 + 32 + lane
// (hi), from each lane's bits of samples s0 .. s0 + 63
__device__ __forceinline__ void warp_counts64(uint64_t bits, int lane,
                                              int& lo, int& hi) {
#pragma unroll
  for (int b = 0; b < 32; ++b) {
    const int c0 = __popc(__ballot_sync(0xffffffffu, (bits >> b) & 1));
    const int c1 = __popc(__ballot_sync(0xffffffffu, (bits >> (b + 32)) & 1));
    if (lane == b) {
      lo = c0;
      hi = c1;
    }
  }
}

// The scatter pass's prologue.  From the count pass's [blocks][S] counts
// (ray-major: S = 1): s_start[s] = the valid entries of the order before the
// first entry of this block at group s (all earlier groups, then group s in
// the earlier blocks) and *s_nvalid = all valid entries.  s_tot holds S
// entries, s_part 2 * KG_THREADS.
__device__ void kg_prologue(const int* __restrict__ counts, int nb, int S,
                            long long* s_tot, long long* s_start,
                            long long* s_part, long long* s_nvalid) {
  const int t = threadIdx.x, b = blockIdx.x;
  // G groups at a time, P (a power of 2) threads summing each over blocks
  for (int s0 = 0; s0 < S; s0 += KG_THREADS) {
    const int G = min(S - s0, KG_THREADS);
    int P = 1;
    while (2 * P * G <= KG_THREADS) P *= 2;
    const int g = t % G, p = t / G;
    long long tot = 0, bef = 0;
    constexpr int U = 16;  // loads in flight a thread
    if (p < P) {
      for (int bb0 = p; bb0 < nb; bb0 += U * P) {
        int c[U];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int bb = bb0 + u * P;
          c[u] = bb < nb ? counts[(int64_t)bb * S + s0 + g] : 0;
        }
#pragma unroll
        for (int u = 0; u < U; ++u) {
          tot += c[u];
          if (bb0 + u * P < b) bef += c[u];
        }
      }
    }
    s_part[t] = tot;
    s_part[KG_THREADS + t] = bef;
    __syncthreads();
    for (int h = P >> 1; h > 0; h >>= 1) {
      if (p < h) {
        s_part[t] += s_part[t + h * G];
        s_part[KG_THREADS + t] += s_part[KG_THREADS + t + h * G];
      }
      __syncthreads();
    }
    if (t < G) {
      s_tot[s0 + t] = s_part[t];
      s_start[s0 + t] = s_part[KG_THREADS + t];
    }
    __syncthreads();
  }
  // the totals' exclusive scan over the groups, by one warp
  if (t < 32) {
    long long carry = 0;
    for (int s0 = 0; s0 < S; s0 += 32) {
      const int s = s0 + t;
      const long long v = s < S ? s_tot[s] : 0;
      long long incl = v;
      for (int o = 1; o < 32; o <<= 1) {
        const long long y = __shfl_up_sync(0xffffffffu, incl, o);
        if (t >= o) incl += y;
      }
      if (s < S) s_start[s] += carry + incl - v;
      carry += __shfl_sync(0xffffffffu, incl, 31);
    }
    if (t == 0) *s_nvalid = carry;
  }
  __syncthreads();
}

__global__ void __launch_bounds__(KG_THREADS)
compact_count_sample_major_kernel(const uint8_t* __restrict__ mask,
                                  int64_t R, int S, int* __restrict__ counts) {
  extern __shared__ int kg_count[];  // [S]
  for (int s = threadIdx.x; s < S; s += KG_THREADS) kg_count[s] = 0;
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int64_t r = (int64_t)blockIdx.x * KG_RAYS + threadIdx.x;
  const bool vec = aligned16(mask) && S % 16 == 0;
  const uint8_t* row = mask + r * S;
  for (int s0 = 0; s0 < S; s0 += 64) {
    const uint64_t bits = r < R ? valid64(row, s0, S, vec) : 0;
    int lo = 0, hi = 0;
    warp_counts64(bits, lane, lo, hi);
    if (s0 + lane < S && lo) atomicAdd(&kg_count[s0 + lane], lo);
    if (s0 + 32 + lane < S && hi) atomicAdd(&kg_count[s0 + 32 + lane], hi);
  }
  __syncthreads();
  for (int s = threadIdx.x; s < S; s += KG_THREADS)
    counts[(int64_t)blockIdx.x * S + s] = kg_count[s];
}

__global__ void __launch_bounds__(KG_THREADS)
compact_scatter_sample_major_kernel(const uint8_t* __restrict__ mask,
                                    int64_t R, int S,
                                    const int* __restrict__ counts, int nb,
                                    int64_t budget, int64_t* __restrict__ idx,
                                    uint8_t* __restrict__ picked) {
  extern __shared__ long long kg_scatter[];
  long long* s_tot = kg_scatter;                        // [S]
  long long* s_start = s_tot + S;                       // [S]
  int* s_warp = reinterpret_cast<int*>(s_start + S);    // [S][KG_WARPS]
  __shared__ long long s_part[2 * KG_THREADS];
  __shared__ long long s_nvalid;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t r = (int64_t)blockIdx.x * KG_RAYS + threadIdx.x;
  const bool vec = aligned16(mask) && S % 16 == 0;
  const uint8_t* row = mask + r * S;

  // the warp's valid entries at each sample
  for (int s0 = 0; s0 < S; s0 += 64) {
    const uint64_t bits = r < R ? valid64(row, s0, S, vec) : 0;
    int lo = 0, hi = 0;
    warp_counts64(bits, lane, lo, hi);
    if (s0 + lane < S) s_warp[(s0 + lane) * KG_WARPS + warp] = lo;
    if (s0 + 32 + lane < S) s_warp[(s0 + 32 + lane) * KG_WARPS + warp] = hi;
  }
  kg_prologue(counts, nb, S, s_tot, s_start, s_part, &s_nvalid);
  // ... and those of the warps before it
  for (int s = threadIdx.x; s < S; s += KG_THREADS) {
    int acc = 0;
#pragma unroll
    for (int w = 0; w < KG_WARPS; ++w) {
      const int c = s_warp[s * KG_WARPS + w];
      s_warp[s * KG_WARPS + w] = acc;
      acc += c;
    }
  }
  __syncthreads();

  const long long n_valid = s_nvalid;
  const unsigned lower = (1u << lane) - 1u;
  for (int s0 = 0; s0 < S; s0 += 64) {
    const uint64_t bits = r < R ? valid64(row, s0, S, vec) : 0;
#pragma unroll
    for (int b = 0; b < 64; ++b) {
      const int s = s0 + b;
      if (s >= S) break;  // the same for every lane
      const bool v = (bits >> b) & 1;
      const unsigned ball = __ballot_sync(0xffffffffu, v);
      if (r < R) {
        const long long before = s_start[s] + s_warp[s * KG_WARPS + warp]
                                 + __popc(ball & lower);
        const long long pos =
            v ? before : n_valid + ((long long)s * R + r) - before;
        if (pos < budget) {
          idx[pos] = r * S + s;
          picked[pos] = v;
        }
      }
    }
  }
}

__global__ void __launch_bounds__(KG_THREADS)
compact_count_ray_major_kernel(const uint8_t* __restrict__ mask, int64_t M,
                               int* __restrict__ counts) {
  __shared__ int s_w[KG_WARPS];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t g = (int64_t)blockIdx.x * KG_SPAN + 16 * threadIdx.x;
  int n = __popc(valid16(mask + g, M - g, aligned16(mask)));
  for (int o = 16; o > 0; o >>= 1) n += __shfl_xor_sync(0xffffffffu, n, o);
  if (lane == 0) s_w[warp] = n;
  __syncthreads();
  if (threadIdx.x == 0) {
    int total = 0;
    for (int w = 0; w < KG_WARPS; ++w) total += s_w[w];
    counts[blockIdx.x] = total;
  }
}

__global__ void __launch_bounds__(KG_THREADS)
compact_scatter_ray_major_kernel(const uint8_t* __restrict__ mask, int64_t M,
                                 const int* __restrict__ counts, int nb,
                                 int64_t budget, int64_t* __restrict__ idx,
                                 uint8_t* __restrict__ picked) {
  __shared__ long long s_tot[1], s_start[1], s_nvalid;
  __shared__ long long s_part[2 * KG_THREADS];
  __shared__ int s_w[KG_WARPS];
  __shared__ uint16_t s_order[KG_WARPS][32 * 16];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t jw = (int64_t)blockIdx.x * KG_SPAN + warp * 32 * 16;
  const int64_t g = jw + 16 * lane;
  const uint32_t bits = valid16(mask + g, M - g, aligned16(mask));
  const int c = __popc(bits);
  int incl = c;
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += y;
  }
  const int nv_w = __shfl_sync(0xffffffffu, incl, 31);
  if (lane == 0) s_w[warp] = nv_w;
  kg_prologue(counts, nb, 1, s_tot, s_start, s_part, &s_nvalid);

  long long vbase = s_start[0];  // valid entries before the warp's first
  for (int w = 0; w < warp; ++w) vbase += s_w[w];
  const long long n_valid = s_nvalid;
  const long long ibase = jw - vbase;  // invalid entries before it
  const int64_t left = M - jw;  // the warp's entries
  const int n_e = left <= 0 ? 0 : (left < 32 * 16 ? (int)left : 32 * 16);
  if (vbase >= budget && n_valid + ibase >= budget) return;

  // the warp's entries in output order: its valid ones, then its invalid
  uint16_t* order = s_order[warp];
  const int excl = incl - c;
#pragma unroll
  for (int b = 0; b < 16; ++b) {
    const int e = 16 * lane + b;
    if (e < n_e) {
      const int vr = excl + __popc(bits & ((1u << b) - 1u));
      order[((bits >> b) & 1) ? vr : nv_w + e - vr] = (uint16_t)e;
    }
  }
  __syncwarp();
  for (int k = lane; k < n_e; k += 32) {
    const long long pos =
        k < nv_w ? vbase + k : n_valid + ibase + (k - nv_w);
    if (pos < budget) {
      idx[pos] = jw + order[k];
      picked[pos] = k < nv_w;
    }
  }
}

}  // namespace

// Length of the `counts` buffer compact_indices_fwd needs (one int per
// block, and per sample in sample-major order): the blocks are decided
// here and nowhere else.
extern "C" int compact_counts_len(long long M, long long R, long long S,
                                  int sample_major) {
  return sample_major ? (int)((R + KG_RAYS - 1) / KG_RAYS * S)
                      : (int)((M + KG_SPAN - 1) / KG_SPAN);
}

extern "C" int compact_indices_fwd(const uint8_t* mask, long long M,
                                   long long R, long long S, int sample_major,
                                   long long budget, int* counts,
                                   int64_t* idx, uint8_t* picked,
                                   void* stream) {
  if (M <= 0 || budget <= 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  if (sample_major) {
    if (S < 1 || S > kMaxS || R * S != M) return (int)cudaErrorInvalidValue;
    const int nb = (int)((R + KG_RAYS - 1) / KG_RAYS);
    const int smem = 48 * (int)S;  // s_tot, s_start, s_warp
    if (smem > 48 * 1024) {
      const cudaError_t err = cudaFuncSetAttribute(
          compact_scatter_sample_major_kernel,
          cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (err != cudaSuccess) return (int)err;
    }
    compact_count_sample_major_kernel<<<nb, KG_THREADS, 4 * (int)S, st>>>(
        mask, R, (int)S, counts);
    const int err = launch_status();
    if (err) return err;
    compact_scatter_sample_major_kernel<<<nb, KG_THREADS, smem, st>>>(
        mask, R, (int)S, counts, nb, budget, idx, picked);
    return launch_status();
  }
  const int nb = (int)((M + KG_SPAN - 1) / KG_SPAN);
  compact_count_ray_major_kernel<<<nb, KG_THREADS, 0, st>>>(mask, M, counts);
  const int err = launch_status();
  if (err) return err;
  compact_scatter_ray_major_kernel<<<nb, KG_THREADS, 0, st>>>(
      mask, M, counts, nb, budget, idx, picked);
  return launch_status();
}
