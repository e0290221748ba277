// Matérn-5/2 ARD cross-covariance for Hopper (sm_90a).
//
// Replaces optuna_tpu/ops/pallas/matern.py::_matern52_kernel (launched at
// ops/pallas/matern.py:102 by _gram_dispatch behind matern52_gram). Computes
// what the reference's XLA twin _matern52_xla computes:
//
//   d2[i, j]  = sum_k w_k * t_k(i, j),
//               t_k = (x1[i,k] - x2[j,k])^2       on continuous dims,
//               t_k = [x1[i,k] != x2[j,k]]        on categorical dims (Hamming)
//   out[i, j] = scale * (1 + sqrt(5) d + 5/3 d2) * exp(-sqrt(5) d),  d = sqrt(d2)
//
// What bounds it. On the GP main path the shape is Z (256, 20) x X (4096, 20):
// 4 MB of f32 output against 0.35 MB of input and ~2.6e7 flops, so the
// output write bounds it at about 1.3 us at 3.35 TB/s, and at that size the
// launch itself dominates. The design therefore aims at one coalesced write
// of each output element and no extra passes, not at arithmetic rate.
//
// Why it is shaped so.
//  * Direct difference, not expanded norms. The Pallas body forms
//    |a|^2 - 2 a.b + |b|^2 for the TPU's matrix unit, and that cancels
//    (1.2e-6 from f64 at (37, 23, 5), against 2.2e-7 for the twin). With d
//    around 20 the direct form is cheap, exact in sign, and lets the Hamming
//    term of categorical dims sit in the same loop, so mixed spaces need no
//    other path.
//  * A 2-D grid of 32 x 32 output tiles, 256 threads: thread (tx, ty) owns
//    column tx and rows ty, ty+8, ty+16, ty+24 of its tile, accumulating
//    d2 in f32 registers. The tile's x1 and x2 rows are staged in shared
//    memory in chunks of 32 dims, so any d fits; the x2 tile is padded to
//    33 floats a row so a warp reading one dim of 32 rows hits 32 banks.
//  * The epilogue (sqrtf, expf: IEEE, no fast math) runs in registers and
//    the warp writes 32 consecutive floats of a row: coalesced along n2.
//    Ragged edges are masked; nothing is padded in device memory.
//  * scale is read through a device pointer, so the caller never copies
//    the fitted scale to the host.
//
// C interface (bound with ctypes): returns cudaGetLastError() after the
// launch, on the caller's stream; the kernel allocates nothing.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kTile = 32;        // output tile edge
constexpr int kRowsPerThread = 4;  // 32 rows / 8 thread rows
constexpr int kThreadRows = kTile / kRowsPerThread;
constexpr int kChunk = 32;       // dims staged per shared-memory pass

__global__ void __launch_bounds__(kTile * kThreadRows)
matern52_gram_kernel(const float* __restrict__ x1, const float* __restrict__ x2,
                     const float* __restrict__ w, const float* __restrict__ scale,
                     const unsigned char* __restrict__ cat, float* __restrict__ out,
                     int n1, int n2, int d) {
  __shared__ float s1[kTile][kChunk];
  __shared__ float s2[kTile][kChunk + 1];
  __shared__ float sw[kChunk];
  __shared__ unsigned char sc[kChunk];

  const int tx = threadIdx.x;  // 0..31, output column within the tile
  const int ty = threadIdx.y;  // 0..7
  const int tid = ty * kTile + tx;
  const int row0 = blockIdx.y * kTile;
  const int col0 = blockIdx.x * kTile;

  float acc[kRowsPerThread];
#pragma unroll
  for (int r = 0; r < kRowsPerThread; ++r) acc[r] = 0.0f;

  for (int k0 = 0; k0 < d; k0 += kChunk) {
    const int kn = min(kChunk, d - k0);
    for (int idx = tid; idx < kTile * kChunk; idx += kTile * kThreadRows) {
      const int r = idx / kChunk;
      const int k = idx % kChunk;
      const bool in_k = k < kn;
      const int gi = row0 + r;
      const int gj = col0 + r;
      s1[r][k] = (in_k && gi < n1) ? x1[(size_t)gi * d + k0 + k] : 0.0f;
      s2[r][k] = (in_k && gj < n2) ? x2[(size_t)gj * d + k0 + k] : 0.0f;
    }
    if (tid < kChunk) {
      sw[tid] = tid < kn ? w[k0 + tid] : 0.0f;
      sc[tid] = tid < kn ? cat[k0 + tid] : 0;
    }
    __syncthreads();

    for (int k = 0; k < kn; ++k) {
      const float b = s2[tx][k];
      const float wk = sw[k];
      const bool is_cat = sc[k] != 0;
#pragma unroll
      for (int r = 0; r < kRowsPerThread; ++r) {
        const float diff = s1[ty + r * kThreadRows][k] - b;
        const float t = is_cat ? (diff != 0.0f ? 1.0f : 0.0f) : diff * diff;
        acc[r] += t * wk;
      }
    }
    __syncthreads();
  }

  const float sc_val = *scale;
  const float sqrt5 = 2.2360679774997896f;
  const int j = col0 + tx;
  if (j >= n2) return;
#pragma unroll
  for (int r = 0; r < kRowsPerThread; ++r) {
    const int i = row0 + ty + r * kThreadRows;
    if (i < n1) {
      const float d2 = acc[r];
      const float dist = d2 > 0.0f ? sqrtf(d2) : 0.0f;
      const float s5 = sqrt5 * dist;
      out[(size_t)i * n2 + j] = sc_val * (1.0f + s5 + (5.0f / 3.0f) * d2) * expf(-s5);
    }
  }
}

}  // namespace

extern "C" int matern52_gram_launch(const float* x1, const float* x2, const float* w,
                                    const float* scale, const unsigned char* cat,
                                    float* out, int n1, int n2, int d, void* stream) {
  if (n1 <= 0 || n2 <= 0) return static_cast<int>(cudaSuccess);
  dim3 block(kTile, kThreadRows);
  dim3 grid((n2 + kTile - 1) / kTile, (n1 + kTile - 1) / kTile);
  matern52_gram_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      x1, x2, w, scale, cat, out, n1, n2, d);
  return static_cast<int>(cudaGetLastError());
}
