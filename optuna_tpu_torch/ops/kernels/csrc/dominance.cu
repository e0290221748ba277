// NSGA-II dominance and non-domination ranking for Hopper (sm_90a).
//
// Replaces optuna_tpu/ops/pallas/nds.py::_dominance_kernel (launched at
// ops/pallas/nds.py:45 by dominance_matrix) together with the
// lax.while_loop that peels fronts around it in
// optuna_tpu/ops/pareto.py::non_domination_rank. Under minimisation, row i
// dominates row j iff
//
//   v[i, k] <= v[j, k] for every k  and  v[i, k] < v[j, k] for at least one k.
//
// Every result is compares only, so it is bit-exact with the plain PyTorch
// versions, ties, duplicates and padded rows included. Both kernels below
// decide "i dominates j" with the same device function, fold_compare.
//
// 1. dominance_kernel: the (n, n) float32 matrix, out[i, j] = 1.0 iff row i
//    dominates row j. A check of fold_compare; no path launches it.
//    A 2-D grid of 32 x 32 output tiles, 256 threads: thread (tx, ty) owns
//    column tx and rows ty, ty + 8, ty + 16, ty + 24 of its tile. Both row
//    blocks are staged in shared memory in chunks of 32 objectives (any m
//    fits); the j block is padded to 33 floats a row so a warp reading 32
//    rows hits 32 banks, the i block is read at one address a warp.
//
// 2. The ranking, nds_rank_launch: ranks (n,) int32, 0 for the Pareto
//    front, n + 1 for masked rows, and the number of fronts in out[n].
//    Two kernels on the caller's stream, whatever the number of fronts:
//
//    a. dominated_by_kernel, over the grid: the bit-packed matrix
//       domby[w][j] (word-major, np = 32 * W columns), whose bit b is set
//       iff real row 32 w + b dominates real row j. Lane b of a warp
//       compares row 32 w + b with row j and __ballot_sync packs the warp's
//       32 answers into the word. A block walks 32 x 32 tiles (one word
//       column by 32 rows j), objectives staged as in (1).
//    b. peel_kernel, one block: the fronts, peeled until no row is left,
//       with no host read. Row j's count starts as the number of its
//       dominators (the popcounts of domby[.][j]); front 0 is the real rows
//       with count 0. Step r holds front r as a list of its nonzero words;
//       every row not yet ranked subtracts the dominators it has there
//       (popc(domby[w][j] & front word w) over the list), and the rows
//       whose count reaches 0 are front r + 1. That is the reference's
//       test "no remaining row dominates j", kept up to date instead of
//       rescanned: a step reads only the front's words, and a row needs no
//       scan to learn it is not dominated. When the packed matrix and the
//       counts fit in opted-in dynamic shared memory (n <= ~1,300) the
//       block copies the matrix there; beyond that it reads it from global
//       memory (L2-resident up to ~16k rows) and keeps the counts in
//       global scratch, so no n is refused.
//
// What bounds it. The ranking reads n m floats (and n mask floats) and
// writes n + 1 ints, and does 2 m n^2 compares; at (512, 2) that is 8 KB and
// 1e6 compares, under a microsecond. The peel is one dependent step per
// front, so the kernel is bound by the latency of a step times the number
// of fronts (up to n, a chain), not by bytes or operations. The design
// keeps the steps on one SM with the matrix in shared memory, gives a step
// one pass and one block barrier (bitsets and front lists double-buffered,
// list lengths triple-buffered), reads only the front's words, and visits
// only the words that still hold unranked rows. Layout [W][np] puts the 32
// rows of a warp on 32 consecutive words: conflict-free in shared memory,
// coalesced in global memory. Measured against a peel that rescanned
// domby[.][j] & remaining for every row each step (stopping at the first
// hit): equal at 512 rows, 4x faster at 4096 and 16384 rows and on long
// chains (PERF.md).
//
// C interface (bound with ctypes): each function sets the device it is
// given for the call, launches on the caller's stream, and returns
// cudaGetLastError() after its launches; the kernels allocate nothing.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 32;          // output tile edge; the rows of one packed word
constexpr int kRowsPerThread = 4;  // 32 rows / 8 thread rows
constexpr int kThreadRows = kTile / kRowsPerThread;
constexpr int kChunk = 32;         // objectives staged per shared-memory pass
constexpr int kPeelThreads = 1024;
constexpr unsigned kFull = 0xffffffffu;

// Folds objectives [0, kn) into the running flags of "a dominates b":
// leq = every a[k] <= b[k], lt = some a[k] < b[k].
__device__ __forceinline__ void fold_compare(const float* a, const float* b, int kn, bool& leq, bool& lt) {
  for (int k = 0; k < kn; ++k) {
    leq = leq && (a[k] <= b[k]);
    lt = lt || (a[k] < b[k]);
  }
}

// Stages objectives [k0, k0 + kn) of rows row0.. and col0.. (32 each) into
// si (the dominating side) and sj; rows at or past n read 0.
__device__ __forceinline__ void stage_rows(const float* __restrict__ v, int n, int m, int k0, int kn,
                                           int row0, int col0, float (*si)[kChunk + 1],
                                           float (*sj)[kChunk + 1], int tid, int nthreads) {
  for (int idx = tid; idx < kTile * kChunk; idx += nthreads) {
    const int r = idx / kChunk;
    const int k = idx % kChunk;
    const bool in_k = k < kn;
    const int gi = row0 + r;
    const int gj = col0 + r;
    si[r][k] = (in_k && gi < n) ? v[(size_t)gi * m + k0 + k] : 0.0f;
    sj[r][k] = (in_k && gj < n) ? v[(size_t)gj * m + k0 + k] : 0.0f;
  }
}

__global__ void __launch_bounds__(kTile * kThreadRows)
dominance_kernel(const float* __restrict__ v, float* __restrict__ out, int n, int m) {
  __shared__ float si[kTile][kChunk + 1];
  __shared__ float sj[kTile][kChunk + 1];

  const int tx = threadIdx.x;  // 0..31, output column within the tile
  const int ty = threadIdx.y;  // 0..7
  const int tid = ty * kTile + tx;
  const int row0 = blockIdx.y * kTile;
  const int col0 = blockIdx.x * kTile;

  bool leq[kRowsPerThread];
  bool lt[kRowsPerThread];
#pragma unroll
  for (int r = 0; r < kRowsPerThread; ++r) {
    leq[r] = true;
    lt[r] = false;
  }

  for (int k0 = 0; k0 < m; k0 += kChunk) {
    const int kn = min(kChunk, m - k0);
    stage_rows(v, n, m, k0, kn, row0, col0, si, sj, tid, kTile * kThreadRows);
    __syncthreads();
#pragma unroll
    for (int r = 0; r < kRowsPerThread; ++r) fold_compare(si[ty + r * kThreadRows], sj[tx], kn, leq[r], lt[r]);
    __syncthreads();
  }

  const int j = col0 + tx;
  if (j >= n) return;
#pragma unroll
  for (int r = 0; r < kRowsPerThread; ++r) {
    const int i = row0 + ty + r * kThreadRows;
    if (i < n) out[(size_t)i * n + j] = (leq[r] && lt[r]) ? 1.0f : 0.0f;
  }
}

// domby[w * np + j], bit b: real row 32 w + b dominates real row j. Tiles
// of one word column w by 32 rows j, walked by a grid-stride loop; thread
// (lane, ty) compares dominating row 32 w + lane with rows j0 + ty + 8 r.
__global__ void __launch_bounds__(kTile * kThreadRows)
dominated_by_kernel(const float* __restrict__ v, const float* __restrict__ mask, uint32_t* __restrict__ domby,
                    int n, int m, int words) {
  __shared__ float si[kTile][kChunk + 1];
  __shared__ float sj[kTile][kChunk + 1];

  const int lane = threadIdx.x;
  const int ty = threadIdx.y;
  const int tid = ty * kTile + lane;
  const size_t np = (size_t)words * kTile;
  const long long tiles = (long long)words * words;

  for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int w = (int)(t % words);
    const int i0 = w * kTile;
    const int j0 = (int)(t / words) * kTile;
    bool leq[kRowsPerThread];
    bool lt[kRowsPerThread];
#pragma unroll
    for (int r = 0; r < kRowsPerThread; ++r) {
      leq[r] = true;
      lt[r] = false;
    }
    for (int k0 = 0; k0 < m; k0 += kChunk) {
      const int kn = min(kChunk, m - k0);
      __syncthreads();  // the previous pass's reads are done
      stage_rows(v, n, m, k0, kn, i0, j0, si, sj, tid, kTile * kThreadRows);
      __syncthreads();
#pragma unroll
      for (int r = 0; r < kRowsPerThread; ++r) fold_compare(si[lane], sj[ty + r * kThreadRows], kn, leq[r], lt[r]);
    }
    const int i = i0 + lane;
    const bool real_i = i < n && mask[i] > 0.0f;
#pragma unroll
    for (int r = 0; r < kRowsPerThread; ++r) {
      const int j = j0 + ty + r * kThreadRows;
      const bool real_j = j < n && mask[j] > 0.0f;
      const uint32_t word = __ballot_sync(kFull, real_i && real_j && leq[r] && lt[r]);
      if (lane == 0) domby[(size_t)w * np + j] = word;
    }
  }
}

// Words of one word-indexed array in shared memory: W rounded up to 4, so
// that every array after it starts 16-byte aligned.
__host__ __device__ __forceinline__ int padded_words(int words) { return (words + 3) & ~3; }

// domby[w * np + j]: the packed matrix in shared or global memory.
template <bool kShared>
__device__ __forceinline__ uint32_t packed(const uint32_t* mat, const uint32_t* __restrict__ domby, size_t at) {
  return kShared ? mat[at] : __ldg(domby + at);
}

// The peel, one block. Row j's count is the number of its dominators not yet
// ranked. Step r takes front r as a list of its nonzero words; every row
// not yet ranked subtracts the dominators it has in them, and the rows
// whose count reaches 0 are front r + 1: they take their rank and leave the
// bitset, and their words make the next list. One pass and one barrier a
// step. Shared memory: two bitsets of the unranked rows and two front lists
// (step r reads set r % 2 and writes the other), three list lengths (step r
// reads one, appends to the next and clears the third), then, when
// kShared, the counts (np ints) and the packed matrix (W * np words);
// otherwise the counts live in global scratch.
template <bool kShared>
__global__ void __launch_bounds__(kPeelThreads)
peel_kernel(const uint32_t* __restrict__ domby, const float* __restrict__ mask, int* __restrict__ out,
            int* __restrict__ global_counts, int n, int words) {
  extern __shared__ uint4 smem_raw[];
  const int wp = padded_words(words);
  const int np = words * kTile;
  uint32_t* bitsets = reinterpret_cast<uint32_t*>(smem_raw);  // [2][wp]
  uint32_t* list_bits = bitsets + 2 * wp;                     // [2][wp]
  int* list_word = reinterpret_cast<int*>(list_bits + 2 * wp);  // [2][wp]
  int* list_len = list_word + 2 * wp;                         // [4], three used
  int* counts = kShared ? list_len + 4 : global_counts;
  const uint32_t* mat = reinterpret_cast<const uint32_t*>(list_len + 4 + np);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int nthreads = blockDim.x;

  if (kShared) {
    const uint4* src = reinterpret_cast<const uint4*>(domby);
    uint4* dst = reinterpret_cast<uint4*>(const_cast<uint32_t*>(mat));
    const int n4 = words * np / 4;
    for (int q = tid; q < n4; q += nthreads) dst[q] = src[q];
  }
  if (tid < 3) list_len[tid] = 0;
  __syncthreads();
  // Front 0: the real rows that no row dominates. np and nthreads are
  // multiples of 32, so a warp's rows share one word.
  for (int j = tid; j < np; j += nthreads) {
    int c = 0;
#pragma unroll 8
    for (int w = 0; w < words; ++w) c += __popc(packed<kShared>(mat, domby, (size_t)w * np + j));
    counts[j] = c;
    const bool real = j < n && mask[j] > 0.0f;
    const bool first = real && c == 0;
    const uint32_t f = __ballot_sync(kFull, first);
    const uint32_t rows = __ballot_sync(kFull, real);
    if (j < n) out[j] = first ? 0 : n + 1;
    if (lane == 0) {
      bitsets[j >> 5] = rows & ~f;
      if (f) {
        const int at = atomicAdd(&list_len[0], 1);
        list_bits[at] = f;
        list_word[at] = j >> 5;
      }
    }
  }
  __syncthreads();

  // [lo, hi] only shrinks, and every word of the current bitset outside it
  // is 0; a word outside it in the other bitset may be stale and is never read.
  int lo = 0, hi = words - 1, r = 0;
  while (r < n) {  // a front is never empty, so r stays below n
    const int len = list_len[r % 3];
    if (len == 0) break;
    const uint32_t* unranked = bitsets + (r & 1) * wp;
    uint32_t* next = bitsets + ((r + 1) & 1) * wp;
    const uint32_t* front_bits = list_bits + (r & 1) * wp;
    const int* front_word = list_word + (r & 1) * wp;
    uint32_t* next_bits = list_bits + ((r + 1) & 1) * wp;
    int* next_word = list_word + ((r + 1) & 1) * wp;
    while (lo <= hi && unranked[lo] == 0) ++lo;
    while (hi >= lo && unranked[hi] == 0) --hi;
    if (tid == 0) list_len[(r + 2) % 3] = 0;  // last read before the previous step's barrier
    for (int j = lo * kTile + tid; j < (hi + 1) * kTile; j += nthreads) {
      const uint32_t own = unranked[j >> 5];
      bool joins = false;
      if ((own >> (j & 31)) & 1u) {
        int lost = 0;
#pragma unroll 4
        for (int q = 0; q < len; ++q) {
          lost += __popc(packed<kShared>(mat, domby, (size_t)front_word[q] * np + j) & front_bits[q]);
        }
        const int c = counts[j] - lost;
        counts[j] = c;
        joins = c == 0;
      }
      const uint32_t f = __ballot_sync(kFull, joins);
      if (joins) out[j] = r + 1;
      if (lane == 0) {
        next[j >> 5] = own & ~f;
        if (f) {
          const int at = atomicAdd(&list_len[(r + 1) % 3], 1);
          next_bits[at] = f;
          next_word[at] = j >> 5;
        }
      }
    }
    ++r;
    __syncthreads();
  }
  if (tid == 0) out[n] = r + (list_len[r % 3] != 0);
}

// Sets the given device for the calling thread for one C call, and puts
// the caller's back after it.
struct DeviceGuard {
  int prev = -1;
  explicit DeviceGuard(int device) {
    if (cudaGetDevice(&prev) == cudaSuccess && prev != device) {
      cudaSetDevice(device);
    } else {
      prev = -1;
    }
  }
  ~DeviceGuard() {
    if (prev >= 0) cudaSetDevice(prev);
  }
};

// The card's SM count and opt-in shared memory a block, read once per
// device (so that no call under CUDA-graph capture asks the driver).
constexpr int kMaxDevices = 64;
struct DeviceInfo {
  int sms = 132;
  int smem_optin = 48 * 1024;
};

DeviceInfo device_info(int device) {
  static DeviceInfo cached[kMaxDevices];
  static bool known[kMaxDevices] = {false};
  const int slot = device >= 0 && device < kMaxDevices ? device : 0;
  if (!known[slot]) {
    DeviceInfo info;
    if (cudaDeviceGetAttribute(&info.sms, cudaDevAttrMultiProcessorCount, device) != cudaSuccess ||
        cudaDeviceGetAttribute(&info.smem_optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device) != cudaSuccess) {
      cudaGetLastError();
      return DeviceInfo{};
    }
    cached[slot] = info;
    known[slot] = true;
  }
  return cached[slot];
}

// Opts a peel kernel in to the card's shared-memory limit, once per device.
template <bool kShared>
cudaError_t opt_in_peel(int device) {
  static bool done[kMaxDevices] = {false};
  const int slot = device >= 0 && device < kMaxDevices ? device : 0;
  if (done[slot]) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(peel_kernel<kShared>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               device_info(device).smem_optin);
  done[slot] = err == cudaSuccess;
  return err;
}

// Dynamic shared memory of the peel: the bitsets, the front's words and
// their counters, and, when `shared`, the counts and the packed matrix.
long long peel_smem_bytes(int n, bool shared) {
  const long long words = (n + kTile - 1) / kTile;
  const long long np = words * kTile;
  return 4 * (6 * (long long)padded_words((int)words) + 4 + (shared ? np + words * np : 0));
}

}  // namespace

extern "C" int dominance_launch(const float* v, float* out, int n, int m, int device, void* stream) {
  if (n <= 0) return static_cast<int>(cudaSuccess);
  DeviceGuard guard(device);
  dim3 block(kTile, kThreadRows);
  dim3 grid((n + kTile - 1) / kTile, (n + kTile - 1) / kTile);
  dominance_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(v, out, n, m);
  return static_cast<int>(cudaGetLastError());
}

// Words of scratch the ranking of n rows needs: the packed matrix, W * 32 W
// words with W = ceil(n / 32), then 32 W counts.
extern "C" long long nds_rank_scratch_words(int n) {
  const long long words = (n + kTile - 1) / kTile;
  return words * words * kTile + words * kTile;
}

// 1 when the peel of n rows stages the packed matrix in shared memory, else 0.
extern "C" int nds_rank_in_shared(int n, int device) {
  return peel_smem_bytes(n, true) <= device_info(device).smem_optin;
}

// Ranks of (n, m) rows v under the mask into out[0:n], the number of fronts
// into out[n]; domby is nds_rank_scratch_words(n) words of scratch.
extern "C" int nds_rank_launch(const float* v, const float* mask, uint32_t* domby, int* out, int n, int m,
                               int device, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  DeviceGuard guard(device);
  if (n <= 0) return static_cast<int>(cudaSuccess);
  const int words = (n + kTile - 1) / kTile;
  const long long tiles = (long long)words * words;
  const int sms = device_info(device).sms;
  const int grid = (int)(tiles < 8LL * sms ? tiles : 8LL * sms);
  dominated_by_kernel<<<grid, dim3(kTile, kThreadRows), 0, s>>>(v, mask, domby, n, m, words);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const int np = words * kTile;
  const int threads = np < kPeelThreads ? np : kPeelThreads;
  int* counts = reinterpret_cast<int*>(domby + (size_t)words * np);
  const bool shared = nds_rank_in_shared(n, device);
  const size_t smem = (size_t)peel_smem_bytes(n, shared);
  if (shared) {
    if (smem > 48 * 1024 && (err = opt_in_peel<true>(device)) != cudaSuccess) return static_cast<int>(err);
    peel_kernel<true><<<1, threads, smem, s>>>(domby, mask, out, counts, n, words);
  } else {
    if (smem > 48 * 1024 && (err = opt_in_peel<false>(device)) != cudaSuccess) return static_cast<int>(err);
    peel_kernel<false><<<1, threads, smem, s>>>(domby, mask, out, counts, n, words);
  }
  return static_cast<int>(cudaGetLastError());
}
