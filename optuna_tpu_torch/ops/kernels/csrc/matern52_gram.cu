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
// 4 MB of f32 output against 0.35 MB of input and ~7e7 flops, so the output
// write bounds it at about 1.4 us at 3.35 TB/s; at that size one launch and
// the first loads' latency are a large part of the time. The design aims at
// few instructions per output element, one coalesced write of it, and no
// block that waits on loads it could have shared.
//
// Why it is shaped so.
//  * Direct difference, not expanded norms. The Pallas body forms
//    |a|^2 - 2 a.b + |b|^2 for the TPU's matrix unit, and that cancels
//    (1.2e-6 from f64 at (37, 23, 5), against 2.2e-7 for the twin). With d
//    around 20 the direct form is cheap, exact in sign, and lets the Hamming
//    term of categorical dims sit in the same loop.
//  * A persistent grid (SM count x resident blocks), each block walking a
//    contiguous run of tiles of 64 x1 rows by 32 x2 columns. The block
//    stages its 64 x1 rows in shared memory once (again only when its row
//    block changes, or per pass of kD dims when d > 32), zero-padded to kD
//    dims, with the weights and the categorical flags beside them.
//  * Each thread owns one x2 column and keeps its kD values in registers
//    (float4 loads when d % 4 == 0 and the base is 16-byte aligned), and
//    8 rows: warp w takes rows w, w + 8, ..., w + 56 of the tile. The x1
//    rows are read as warp broadcasts, 4 dims a load, so a dim of an output
//    costs a subtract and two multiply-adds and no select.
//  * A pass with no categorical dim (block-uniform, from the staged flags)
//    takes the continuous-only loop; otherwise the select is per dim.
//  * The epilogue (IEEE sqrtf, expf; no fast math) runs in registers and a
//    warp writes 32 consecutive floats (128 B) of a row. Ragged edges are
//    masked; nothing is padded in device memory. Zero-padded dims add
//    exactly 0, so d2 sums the same terms, k ascending, as before.
//  * scale is read through a device pointer, so the caller never copies
//    the fitted scale to the host.
//
// C interface (bound with ctypes): sets the device it is given for the
// call, launches on the caller's stream and returns cudaGetLastError(); the
// kernel allocates nothing.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowsPerThread = 8;
constexpr int kRowBlock = kWarps * kRowsPerThread;  // x1 rows of a tile
constexpr int kCols = 32;                           // x2 columns of a tile: one per lane
constexpr int kMaxDims = 32;                        // dims of one pass, in registers

template <bool kCat>
__device__ __forceinline__ float term(float z, float x, float w, bool is_cat, float acc) {
  const float diff = z - x;
  const float t = (kCat && is_cat) ? (diff != 0.0f ? 1.0f : 0.0f) : diff * diff;
  return fmaf(t, w, acc);
}

// One pass of kD dims over the tile: acc[r] += sum_k w_k t_k(row r, column).
template <int kD, bool kCat>
__device__ __forceinline__ void accumulate(const float (*sz)[kD], const float* sw, const float* xr,
                                           unsigned cat_bits, int warp, float* acc) {
#pragma unroll
  for (int q = 0; q < kD / 4; ++q) {
    const float4 w4 = *reinterpret_cast<const float4*>(sw + 4 * q);
#pragma unroll
    for (int r = 0; r < kRowsPerThread; ++r) {
      const float4 z4 = *reinterpret_cast<const float4*>(&sz[warp + r * kWarps][4 * q]);
      float a = acc[r];
      a = term<kCat>(z4.x, xr[4 * q + 0], w4.x, (cat_bits >> (4 * q + 0)) & 1u, a);
      a = term<kCat>(z4.y, xr[4 * q + 1], w4.y, (cat_bits >> (4 * q + 1)) & 1u, a);
      a = term<kCat>(z4.z, xr[4 * q + 2], w4.z, (cat_bits >> (4 * q + 2)) & 1u, a);
      a = term<kCat>(z4.w, xr[4 * q + 3], w4.w, (cat_bits >> (4 * q + 3)) & 1u, a);
      acc[r] = a;
    }
  }
}

template <int kD>
__global__ void __launch_bounds__(kThreads)
matern52_gram_kernel(const float* __restrict__ x1, const float* __restrict__ x2,
                     const float* __restrict__ w, const float* __restrict__ scale,
                     const unsigned char* __restrict__ cat, float* __restrict__ out,
                     int n1, int n2, int d, int tiles, int tiles_per_block, bool vec) {
  __shared__ __align__(16) float sz[kRowBlock][kD];
  __shared__ __align__(16) float sw[kD];
  __shared__ unsigned sbits;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int col_tiles = (n2 + kCols - 1) / kCols;
  const int passes = (d + kD - 1) / kD;
  const float sc_val = *scale;
  const float sqrt5 = 2.2360679774997896f;

  const int t_begin = blockIdx.x * tiles_per_block;
  const int t_end = min(tiles, t_begin + tiles_per_block);
  int staged = -1;  // the row block sz holds, when one pass covers d
  bool has_cat = false;
  unsigned cat_bits = 0;

  for (int t = t_begin; t < t_end; ++t) {
    const int rb = t / col_tiles;
    const int row0 = rb * kRowBlock;
    const int j = (t % col_tiles) * kCols + lane;
    float acc[kRowsPerThread];
#pragma unroll
    for (int r = 0; r < kRowsPerThread; ++r) acc[r] = 0.0f;

    for (int p = 0; p < passes; ++p) {
      const int k0 = p * kD;
      const int kn = min(kD, d - k0);
      // This thread's column first: its loads are in flight while the block
      // stages the x1 rows.
      float xr[kD];
      const float* xj = x2 + (size_t)j * d + k0;
      const bool live = j < n2;
#pragma unroll
      for (int q = 0; q < kD / 4; ++q) {
        if (live && vec && 4 * q + 3 < kn) {
          const float4 x4 = __ldg(reinterpret_cast<const float4*>(xj + 4 * q));
          xr[4 * q + 0] = x4.x;
          xr[4 * q + 1] = x4.y;
          xr[4 * q + 2] = x4.z;
          xr[4 * q + 3] = x4.w;
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e) xr[4 * q + e] = (live && 4 * q + e < kn) ? __ldg(xj + 4 * q + e) : 0.0f;
        }
      }
      if (passes > 1 || staged != rb) {
        __syncthreads();  // the previous tile's reads of sz are done
        for (int e = tid; e < kRowBlock * kD; e += kThreads) {
          const int r = e / kD;
          const int k = e % kD;
          const int i = row0 + r;
          sz[r][k] = (k < kn && i < n1) ? x1[(size_t)i * d + k0 + k] : 0.0f;
        }
        if (tid < kD) sw[tid] = tid < kn ? w[k0 + tid] : 0.0f;
        const bool flag = tid < kn && cat[k0 + tid] != 0;
        const unsigned bits = __ballot_sync(0xffffffffu, flag);  // kD <= 32: warp 0 holds every flag
        if (tid == 0) sbits = bits;
        has_cat = __syncthreads_or(flag) != 0;
        cat_bits = sbits;
        staged = rb;
      }

      if (has_cat) {
        accumulate<kD, true>(sz, sw, xr, cat_bits, warp, acc);
      } else {
        accumulate<kD, false>(sz, sw, xr, 0u, warp, acc);
      }
    }

    if (j < n2) {
#pragma unroll
      for (int r = 0; r < kRowsPerThread; ++r) {
        const int i = row0 + warp + r * kWarps;
        if (i < n1) {
          const float d2 = acc[r];
          const float dist = d2 > 0.0f ? sqrtf(d2) : 0.0f;
          const float s5 = sqrt5 * dist;
          out[(size_t)i * n2 + j] = sc_val * (1.0f + s5 + (5.0f / 3.0f) * d2) * expf(-s5);
        }
      }
    }
  }
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

// Blocks of kernel that fit on the card at once: SMs x resident blocks,
// kept per device and kernel after the first call.
constexpr int kMaxDevices = 64;

template <int kD>
int resident_blocks(int device) {
  static int cached[kMaxDevices] = {0};
  const int slot = device >= 0 && device < kMaxDevices ? device : 0;
  if (cached[slot] > 0) return cached[slot];
  int sms = 132, per_sm = 1;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, matern52_gram_kernel<kD>, kThreads, 0) != cudaSuccess) {
    cudaGetLastError();
    return 132;
  }
  cached[slot] = sms * (per_sm > 0 ? per_sm : 1);
  return cached[slot];
}

template <int kD>
cudaError_t launch(const float* x1, const float* x2, const float* w, const float* scale, const unsigned char* cat,
                   float* out, int n1, int n2, int d, int device, cudaStream_t stream) {
  const int tiles = ((n1 + kRowBlock - 1) / kRowBlock) * ((n2 + kCols - 1) / kCols);
  const int blocks = min(tiles, resident_blocks<kD>(device));
  const int per_block = (tiles + blocks - 1) / blocks;
  const int grid = (tiles + per_block - 1) / per_block;
  const bool vec = d % 4 == 0 && reinterpret_cast<size_t>(x2) % 16 == 0;
  matern52_gram_kernel<kD><<<grid, kThreads, 0, stream>>>(x1, x2, w, scale, cat, out, n1, n2, d, tiles,
                                                          per_block, vec);
  return cudaGetLastError();
}

}  // namespace

extern "C" int matern52_gram_launch(const float* x1, const float* x2, const float* w,
                                    const float* scale, const unsigned char* cat,
                                    float* out, int n1, int n2, int d, int device, void* stream) {
  if (n1 <= 0 || n2 <= 0) return static_cast<int>(cudaSuccess);
  DeviceGuard guard(device);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // The pass width: d rounded up to 4 dims, at most kMaxDims.
  switch (d <= kMaxDims ? (d + 3) / 4 : kMaxDims / 4) {
    case 0:
    case 1: return static_cast<int>(launch<4>(x1, x2, w, scale, cat, out, n1, n2, d, device, s));
    case 2: return static_cast<int>(launch<8>(x1, x2, w, scale, cat, out, n1, n2, d, device, s));
    case 3: return static_cast<int>(launch<12>(x1, x2, w, scale, cat, out, n1, n2, d, device, s));
    case 4: return static_cast<int>(launch<16>(x1, x2, w, scale, cat, out, n1, n2, d, device, s));
    case 5: return static_cast<int>(launch<20>(x1, x2, w, scale, cat, out, n1, n2, d, device, s));
    case 6: return static_cast<int>(launch<24>(x1, x2, w, scale, cat, out, n1, n2, d, device, s));
    case 7: return static_cast<int>(launch<28>(x1, x2, w, scale, cat, out, n1, n2, d, device, s));
    default: return static_cast<int>(launch<32>(x1, x2, w, scale, cat, out, n1, n2, d, device, s));
  }
}
