// One node of the WFG hypervolume stack machine for Hopper (sm_90a):
// limit to the pivot, Pareto-filter, fill pruned rows at the reference point.
//
// Replaces optuna_tpu/ops/pallas/wfg.py::_limit_filter_kernel (launched at
// ops/pallas/wfg.py:88 by limit_and_filter). Computes what the reference's
// XLA twin _limit_filter_xla computes, for a frame of n points in m
// objectives:
//
//   child[i]   = max(pts[i], p)                        (elementwise)
//   eff[i]     = child[i] if eligible[i] else +inf
//   dom(i, j)  = eligible[i] and eff[i] <= eff[j] in every objective
//                and (eff[i] < eff[j] in one objective, or i < j)
//   msk[j]     = eligible[j] and no i has dom(i, j)
//   out_pts[j] = child[j] if msk[j] else ref
//
// The i < j term keeps the lowest index of a group of duplicates. Max,
// compares and selects only, so the result is bit-exact with the plain
// PyTorch version.
//
// What bounds it. A frame is small: n is a power-of-two bucket >= 16 (128
// for a 5-objective front of 512 random points), m is 5 to 8. At (128, 5)
// one call moves about 5 KB and does about 1.6e5 compares: a few
// nanoseconds of the card. One hypervolume runs this body thousands of
// times, one node after another, so it is bound by launches. The design
// keeps one launch a node and writes each child frame once; the stack
// machine around it (ops/wfg.py) keeps the stack on the device and syncs
// with the host once every k nodes.
//
// Why it is shaped so.
//  * The Pallas kernel holds the whole (n, n) dominance block in VMEM,
//    one objective column at a time. Here no (n, n) block is formed. A
//    block of 32 x 32 threads owns 32 columns j: thread (tx, ty) compares
//    column j = 32 * blockIdx.x + tx against the rows i = ty, ty + 32, ...,
//    so the serial chain a thread walks is n / 32 rows long (4 at n = 128),
//    not n. A first version gave each thread a column and all n rows: at
//    (128, 5) it took 0.057 ms of device time, slower than the plain
//    version, because every row was a chain of dependent shared-memory
//    loads and branches. The rows' flags meet in a 32-entry shared array.
//  * Every block stages the whole clamped frame (eff, n * m floats) and the
//    eligibility bytes in shared memory: at most 48 KB, 33 KB at n = 1024,
//    m = 8. A warp is one row i against 32 columns: row i is one address a
//    warp (a broadcast), and a thread keeps its column's m values in
//    registers (m <= kMaxM). The compare loop is branch-free: the flags are
//    combined with bitwise operators, eligibility included.
//  * max() propagates NaN as torch.maximum does.
//
// C interface (bound with ctypes): returns cudaGetLastError() after the
// launch, on the caller's stream; the kernel allocates nothing.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kCols = 32;    // columns j per block (threadIdx.x)
constexpr int kLanes = 32;   // row lanes per block (threadIdx.y)
constexpr int kThreads = kCols * kLanes;
constexpr int kMaxM = 16;    // objectives a thread keeps in registers

__device__ __forceinline__ float nan_max(float a, float b) {
  if (a != a) return a;
  if (b != b) return b;
  return a > b ? a : b;
}

__global__ void __launch_bounds__(kThreads)
wfg_limit_filter_kernel(const float* __restrict__ pts, const float* __restrict__ p,
                        const unsigned char* __restrict__ elig, const float* __restrict__ ref,
                        float* __restrict__ out_pts, unsigned char* __restrict__ out_msk,
                        int n, int m) {
  extern __shared__ float smem[];
  float* s_eff = smem;                                                     // (n, m)
  unsigned char* s_elig = reinterpret_cast<unsigned char*>(smem + n * m);  // (n,)
  __shared__ float s_p[kMaxM];
  __shared__ int s_dom[kCols];

  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int tid = ty * kCols + tx;
  if (tid < m) s_p[tid] = p[tid];
  if (tid < kCols) s_dom[tid] = 0;
  __syncthreads();
  for (int idx = tid; idx < n * m; idx += kThreads) {
    const int i = idx / m;
    const float c = nan_max(pts[idx], s_p[idx - i * m]);
    s_eff[idx] = elig[i] ? c : INFINITY;
  }
  for (int i = tid; i < n; i += kThreads) s_elig[i] = elig[i];
  __syncthreads();

  const int j = blockIdx.x * kCols + tx;
  const bool in_j = j < n;
  float mine[kMaxM];
#pragma unroll
  for (int k = 0; k < kMaxM; ++k) mine[k] = (in_j && k < m) ? s_eff[j * m + k] : 0.0f;

  bool dominated = false;
  if (in_j) {
    for (int i = ty; i < n; i += kLanes) {
      const float* row = s_eff + i * m;
      bool leq = s_elig[i] != 0;
      bool strict = i < j;
#pragma unroll
      for (int k = 0; k < kMaxM; ++k) {
        if (k < m) {
          const float a = row[k];
          leq = leq & (a <= mine[k]);
          strict = strict | (a < mine[k]);
        }
      }
      dominated = dominated | (leq & strict);
    }
  }
  if (dominated) s_dom[tx] = 1;
  __syncthreads();

  if (ty != 0 || !in_j) return;
  const bool keep = s_elig[j] && !s_dom[tx];
  out_msk[j] = keep ? 1 : 0;
#pragma unroll
  for (int k = 0; k < kMaxM; ++k) {
    if (k < m) out_pts[j * m + k] = keep ? mine[k] : ref[k];
  }
}

}  // namespace

extern "C" int wfg_limit_filter_launch(const float* pts, const float* p, const unsigned char* elig,
                                       const float* ref, float* out_pts, unsigned char* out_msk,
                                       int n, int m, void* stream) {
  if (n <= 0) return static_cast<int>(cudaSuccess);
  const size_t smem = sizeof(float) * (size_t)n * m + (size_t)n;
  const dim3 block(kCols, kLanes);
  const int grid = (n + kCols - 1) / kCols;
  wfg_limit_filter_kernel<<<grid, block, smem, static_cast<cudaStream_t>(stream)>>>(
      pts, p, elig, ref, out_pts, out_msk, n, m);
  return static_cast<int>(cudaGetLastError());
}
