// NSGA-II dominance matrix for Hopper (sm_90a).
//
// Replaces optuna_tpu/ops/pallas/nds.py::_dominance_kernel (launched at
// ops/pallas/nds.py:45 by dominance_matrix). Computes, under minimisation,
//
//   out[i, j] = 1.0  iff  v[i, k] <= v[j, k] for every k
//                    and  v[i, k] <  v[j, k] for at least one k,
//   out[i, j] = 0.0  otherwise,
//
// for an (n, m) float32 matrix v. The output is compares only, so the
// result is bit-exact with the plain PyTorch version, ties, duplicates and
// padded rows included.
//
// What bounds it. On the NSGA-II selection the shape is (512, 2) to
// (1024, 2): 4 n^2 bytes of output against 8 n bytes of input and 2 m n^2
// compares, so the output write bounds it (1.05 MB, about 0.3 us at
// 3.35 TB/s at n = 512). At that size one launch costs more than the work;
// the design aims at one coalesced write of each output element.
//
// Why it is shaped so.
//  * The Pallas kernel runs 128 x 128 tiles on the TPU's vector unit, one
//    grid step after another. Here a 2-D grid of 32 x 32 output tiles runs
//    in parallel, 256 threads a block: thread (tx, ty) owns column tx and
//    rows ty, ty + 8, ty + 16, ty + 24 of its tile, and keeps the running
//    "all <=" and "any <" flags of each in registers.
//  * The tile's row block i and column block j are staged in shared memory
//    in chunks of 32 objectives, so any m fits. The j block is padded to 33
//    floats a row, so a warp reading one objective of 32 rows hits 32
//    banks; the i block is read at one address a warp (a broadcast).
//  * The warp writes 32 consecutive floats of an output row: coalesced
//    along j. Ragged edges are masked; nothing is padded in device memory.
//
// C interface (bound with ctypes): returns cudaGetLastError() after the
// launch, on the caller's stream; the kernel allocates nothing.

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 32;          // output tile edge
constexpr int kRowsPerThread = 4;  // 32 rows / 8 thread rows
constexpr int kThreadRows = kTile / kRowsPerThread;
constexpr int kChunk = 32;         // objectives staged per shared-memory pass

__global__ void __launch_bounds__(kTile * kThreadRows)
dominance_kernel(const float* __restrict__ v, float* __restrict__ out, int n, int m) {
  __shared__ float si[kTile][kChunk];
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
    for (int idx = tid; idx < kTile * kChunk; idx += kTile * kThreadRows) {
      const int r = idx / kChunk;
      const int k = idx % kChunk;
      const bool in_k = k < kn;
      const int gi = row0 + r;
      const int gj = col0 + r;
      si[r][k] = (in_k && gi < n) ? v[(size_t)gi * m + k0 + k] : 0.0f;
      sj[r][k] = (in_k && gj < n) ? v[(size_t)gj * m + k0 + k] : 0.0f;
    }
    __syncthreads();

    for (int k = 0; k < kn; ++k) {
      const float b = sj[tx][k];
#pragma unroll
      for (int r = 0; r < kRowsPerThread; ++r) {
        const float a = si[ty + r * kThreadRows][k];
        leq[r] = leq[r] && (a <= b);
        lt[r] = lt[r] || (a < b);
      }
    }
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

}  // namespace

extern "C" int dominance_launch(const float* v, float* out, int n, int m, void* stream) {
  if (n <= 0) return static_cast<int>(cudaSuccess);
  dim3 block(kTile, kThreadRows);
  dim3 grid((n + kTile - 1) / kTile, (n + kTile - 1) / kTile);
  dominance_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(v, out, n, m);
  return static_cast<int>(cudaGetLastError());
}
