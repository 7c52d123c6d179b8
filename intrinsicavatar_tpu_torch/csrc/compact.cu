// KG: valid-first stable compaction into a static budget.
//
// Replaces intrinsicavatar_tpu/ops/compact.py:25 stable_partition_indices,
// :43 compact_indices and :52 compact_indices_interleaved: the first
// `budget` entries of the permutation that puts the valid entries first,
// each group in its order (the invalid ones follow when the budget exceeds
// the valid count), and whether each picked entry is valid.  In sample-major
// order entry j of the order is entry (j % R) * S + j / R of the ray-major
// [R, S] mask, and the index returned is that ray-major entry.
//
// What bounds it on an H100: bytes.  It reads the mask (1 B an entry) twice
// and writes 9 B per budget slot.
//
// Design: two passes over fixed chunks of the order.  Pass 1 counts each
// chunk's valid entries (__syncthreads_count).  Pass 2 sums the counts of
// the chunks before its own and of all chunks, then walks its chunk
// 1024 entries at a time: a warp ballot and __popc give each entry its rank
// among the valid entries of its warp, a scan of the 32 warp totals in
// shared memory gives the warp's offset.  A valid entry goes to slot
// (valid entries before it); an invalid one to n_valid + (invalid entries
// before it), as compact.py:31-37 computes them with two cumsums.  Slots
// at or past the budget are not written.
#include "common.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr int kChunk = 4 * kThreads;

__device__ __forceinline__ int64_t source(int64_t j, int64_t R, int64_t S,
                                          bool sample_major) {
  return sample_major ? (j % R) * S + j / R : j;
}

__global__ void count_kernel(const uint8_t* __restrict__ mask, int64_t M,
                             int64_t R, int64_t S, bool sample_major,
                             int* __restrict__ counts) {
  const int64_t begin = (int64_t)blockIdx.x * kChunk;
  int n = 0;
  for (int64_t base = begin; base < begin + kChunk && base < M;
       base += kThreads) {
    const int64_t j = base + threadIdx.x;
    const bool v = j < M && mask[source(j, R, S, sample_major)] != 0;
    n += __syncthreads_count(v);
  }
  if (threadIdx.x == 0) counts[blockIdx.x] = n;
}

__global__ void scatter_kernel(const uint8_t* __restrict__ mask, int64_t M,
                               int64_t R, int64_t S, bool sample_major,
                               const int* __restrict__ counts, int n_chunks,
                               int64_t budget, int64_t* __restrict__ idx,
                               uint8_t* __restrict__ picked) {
  __shared__ long long s_before[32], s_total[32];
  __shared__ int s_warp[32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  // valid entries in the chunks before this one, and in all chunks
  long long before = 0, total = 0;
  for (int c = threadIdx.x; c < n_chunks; c += kThreads) {
    total += counts[c];
    if (c < (int)blockIdx.x) before += counts[c];
  }
  for (int off = 16; off > 0; off >>= 1) {
    before += __shfl_down_sync(0xffffffffu, before, off);
    total += __shfl_down_sync(0xffffffffu, total, off);
  }
  if (lane == 0) {
    s_before[warp] = before;
    s_total[warp] = total;
  }
  __syncthreads();
  if (warp == 0) {
    before = s_before[lane];
    total = s_total[lane];
    for (int off = 16; off > 0; off >>= 1) {
      before += __shfl_down_sync(0xffffffffu, before, off);
      total += __shfl_down_sync(0xffffffffu, total, off);
    }
    if (lane == 0) {
      s_before[0] = before;
      s_total[0] = total;
    }
  }
  __syncthreads();
  const long long n_valid = s_total[0];
  long long valid_before = s_before[0];  // valid entries before this round

  const int64_t begin = (int64_t)blockIdx.x * kChunk;
  for (int64_t base = begin; base < begin + kChunk && base < M;
       base += kThreads) {
    const int64_t j = base + threadIdx.x;
    const int64_t src = source(j, R, S, sample_major);
    const bool v = j < M && mask[src] != 0;
    const unsigned ball = __ballot_sync(0xffffffffu, v);
    if (lane == 0) s_warp[warp] = __popc(ball);
    __syncthreads();
    // exclusive scan of the 32 warp totals, by every warp on its own
    int w_off = 0, round = 0;
    for (int k = 0; k < 32; ++k) {
      const int c = s_warp[k];
      if (k < warp) w_off += c;
      round += c;
    }
    const long long rank =
        valid_before + w_off + __popc(ball & ((1u << lane) - 1u));
    if (j < M) {
      const long long pos = v ? rank : n_valid + (j - rank);
      if (pos < budget) {
        idx[pos] = src;
        picked[pos] = v;
      }
    }
    valid_before += round;
    __syncthreads();  // s_warp is rewritten by the next round
  }
}

}  // namespace

// Length of the `counts` buffer compact_indices_fwd needs for M entries
// (one int per chunk): the chunk size is decided here and nowhere else.
extern "C" int compact_counts_len(long long M) {
  return (int)((M + kChunk - 1) / kChunk);
}

extern "C" int compact_indices_fwd(const uint8_t* mask, long long M,
                                   long long R, long long S, int sample_major,
                                   long long budget, int* counts,
                                   int64_t* idx, uint8_t* picked,
                                   void* stream) {
  if (M <= 0 || budget <= 0) return 0;
  const int n_chunks = compact_counts_len(M);
  cudaStream_t st = (cudaStream_t)stream;
  count_kernel<<<n_chunks, kThreads, 0, st>>>(mask, M, R, S,
                                              sample_major != 0, counts);
  int err = launch_status();
  if (err) return err;
  scatter_kernel<<<n_chunks, kThreads, 0, st>>>(
      mask, M, R, S, sample_major != 0, counts, n_chunks, budget, idx,
      picked);
  return launch_status();
}
