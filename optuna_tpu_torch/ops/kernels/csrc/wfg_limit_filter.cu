// The WFG hypervolume for Hopper (sm_90a): one node step as a device
// function, and two kernels around it.
//
// Replaces optuna_tpu/ops/pallas/wfg.py::_limit_filter_kernel (launched at
// ops/pallas/wfg.py:88 by limit_and_filter) and the lax.while_loop around
// it in optuna_tpu/ops/wfg.py::hypervolume_wfg.
//
// The node step computes what the reference's XLA twin _limit_filter_xla
// computes, for a frame of n points in m objectives:
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
// PyTorch version. max() propagates NaN as torch.maximum does.
//
// Kernels:
//  * wfg_limit_filter_kernel: one node (one block), the check that tells a
//    fault of the node step from a fault of the stack.
//  * wfg_stack_kernel: whole hypervolumes. One block per sorted root frame
//    runs the WFG stack machine of optuna_tpu_torch/ops/kernels/wfg.py::
//    _stack_plain from the root to the empty stack: no host read, no
//    launch per node.
//
// What bounds it. A node is small: at (128, 5), about 1.6e5 compares and a
// few KB, nanoseconds of the card. A 5-objective hypervolume of 512 points
// is ~30k nodes in a strict sequence (each depends on the stack the one
// before left), so the time is nodes x the latency of one node: its block
// barriers and dependent shared-memory reads, not bytes or operations. The
// design keeps everything of a node inside one block: no launch and no
// host round trip between nodes.
//
// Why it is shaped so.
//  * The working frame (the top's points and mask, the child being built,
//    the clamped eligible rows and their indices) lives in dynamic shared
//    memory, opted in up to the card's limit (227 KB). Where it does not
//    fit, the same code reads it through generic pointers into the block's
//    global scratch. The stacked frames (N + 1 of them), cursors and signs
//    live in global scratch (L2-resident at the main path's sizes): a push
//    writes the child frame once, a pop reloads the parent.
//  * Masks are 32-bit words. The pivot (first remaining index >= cursor)
//    comes from a warp ballot and __ffs; the eligible rows are compacted by
//    one warp (popc, a shuffle scan), so a node compares only the eligible
//    rows against the eligible columns, which shrink fast with depth.
//  * Dominance: a warp owns a tile of 32 compacted columns, the block's
//    kLanes warps split the rows, so the serial chain a thread walks is
//    n_el / kLanes rows. A thread keeps its column's objectives in registers
//    in chunks of kChunk, carrying leq/strict from one chunk to the next, so
//    any m works. The warps' flags meet in one shared word per tile
//    (double-buffered: one barrier a tile).
//  * The accumulation is one thread's, with __fsub_rn/__fmul_rn/__fadd_rn in
//    the plain version's order (ref - p, the product left to right, then
//    sign*inc - fold, then acc + delta): nvcc's FMA contraction cannot fuse
//    them, so the card and the CPU add the same float32 terms in the same
//    order and give the same bits.
//
// C interface (bound with ctypes): the launches return cudaGetLastError()
// after the launch, on the caller's stream; the kernels allocate nothing,
// the wrapper passes the scratch the *_bytes functions ask for.

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kCols = 32;   // columns of a tile (threadIdx.x: one warp)
constexpr int kLanes = 8;   // row lanes (threadIdx.y: one warp each)
constexpr int kThreads = kCols * kLanes;
constexpr int kChunk = 16;  // objectives a thread holds in registers at a time
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float nan_max(float a, float b) {
  if (a != a) return a;
  if (b != b) return b;
  return a > b ? a : b;
}

__host__ __device__ __forceinline__ int n_words(int n) { return (n + 31) >> 5; }

__device__ __forceinline__ bool has_bit(const uint32_t* w, int j) { return (w[j >> 5] >> (j & 31)) & 1u; }

// Bits of word w at indices >= lo (lo is a global index).
__device__ __forceinline__ uint32_t bits_from(uint32_t x, int w, int lo) {
  const int shift = lo - w * 32;
  if (shift >= 32) return 0u;
  return shift > 0 ? x & (kFull << shift) : x;
}

// Mask bytes (0/1) of n rows -> words; every warp takes words ty, ty + kLanes, ...
__device__ __forceinline__ void bytes_to_words(const unsigned char* b, uint32_t* w, int n) {
  for (int k = threadIdx.y; k < n_words(n); k += kLanes) {
    const int j = k * 32 + threadIdx.x;
    const unsigned bal = __ballot_sync(kFull, j < n && b[j] != 0);
    if (threadIdx.x == 0) w[k] = bal;
  }
}

struct NodeOut {
  int n_child;  // rows kept (valid in warp 0)
  int first;    // lowest kept row, -1 if none (valid in warp 0)
};

// One node step over all n columns. pts (n, m) frame, p (m,) pivot, elig
// (words) rows still eligible, ref (m,); writes out_pts (n, m) and out_w
// (words). eff (n * m floats) and cidx (n ints) are working space. Every
// thread of the block calls it; it returns with warp 0 holding the child's
// count and first row, and the caller must __syncthreads() before other
// warps read the outputs.
__device__ NodeOut node_step(const float* pts, const float* p, const uint32_t* elig, const float* ref,
                             float* out_pts, uint32_t* out_w, int n, int m, float* eff, int* cidx) {
  __shared__ unsigned s_dom[2];
  __shared__ int s_nel;
  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int tid = ty * kCols + tx;
  const int nw = n_words(n);

  // 1. Warp 0 compacts the eligible rows, in order, into cidx.
  if (ty == 0) {
    int base = 0;
    for (int w0 = 0; w0 < nw; w0 += 32) {
      const int w = w0 + tx;
      uint32_t x = w < nw ? elig[w] : 0u;
      const int c = __popc(x);
      int s = c;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int t = __shfl_up_sync(kFull, s, d);
        if (tx >= d) s += t;
      }
      int off = base + s - c;
      while (x) {
        cidx[off++] = w * 32 + __ffs(x) - 1;
        x &= x - 1;
      }
      base += __shfl_sync(kFull, s, 31);
    }
    if (tx == 0) {
      s_nel = base;
      s_dom[0] = 0u;
      s_dom[1] = 0u;
    }
  }
  for (int w = tid; w < nw; w += kThreads) out_w[w] = 0u;
  __syncthreads();
  const int n_el = s_nel;

  // 2. Stage the clamped eligible rows; rows not eligible go out at ref.
  for (int idx = tid; idx < n_el * m; idx += kThreads) {
    const int c = idx / m;
    const int k = idx - c * m;
    eff[idx] = nan_max(pts[cidx[c] * m + k], p[k]);
  }
  for (int idx = tid; idx < n * m; idx += kThreads) {
    const int j = idx / m;
    if (!has_bit(elig, j)) out_pts[idx] = ref[idx - j * m];
  }
  __syncthreads();

  // 3. Column tiles: rows (all eligible) over the lanes, compacted order
  //    is index order, so r < c is the i < j tie rule.
  NodeOut out{0, -1};
  int t = 0;
  for (int c0 = 0; c0 < n_el; c0 += kCols, ++t) {
    const int c = c0 + tx;
    const bool in_c = c < n_el;
    bool dominated = false;
    if (in_c) {
      const float* col = eff + c * m;
      float mine[kChunk];
      if (m <= kChunk) {
#pragma unroll
        for (int k = 0; k < kChunk; ++k) mine[k] = k < m ? col[k] : 0.0f;
        for (int r = ty; r < n_el; r += kLanes) {
          const float* row = eff + r * m;
          bool leq = true;
          bool strict = r < c;
#pragma unroll
          for (int k = 0; k < kChunk; ++k) {
            if (k < m) {
              const float a = row[k];
              leq = leq & (a <= mine[k]);
              strict = strict | (a < mine[k]);
            }
          }
          dominated = dominated | (leq & strict);
        }
      } else {
        for (int r = ty; r < n_el; r += kLanes) {
          const float* row = eff + r * m;
          bool leq = true;
          bool strict = r < c;
          for (int k0 = 0; k0 < m; k0 += kChunk) {
#pragma unroll
            for (int k = 0; k < kChunk; ++k) mine[k] = k0 + k < m ? col[k0 + k] : 0.0f;
#pragma unroll
            for (int k = 0; k < kChunk; ++k) {
              if (k0 + k < m) {
                const float a = row[k0 + k];
                leq = leq & (a <= mine[k]);
                strict = strict | (a < mine[k]);
              }
            }
          }
          dominated = dominated | (leq & strict);
        }
      }
    }
    const unsigned dom = __ballot_sync(kFull, dominated);
    if (tx == 0 && dom) atomicOr(&s_dom[t & 1], dom);
    __syncthreads();
    if (ty == 0) {
      // Warp 0 writes the tile while the others start the next one; the
      // buffer it read is next used two tiles on, after another barrier.
      const unsigned d = s_dom[t & 1];
      const bool kept = in_c && !((d >> tx) & 1u);
      if (in_c) {
        const int j = cidx[c];
        const float* src = eff + c * m;
        float* dst = out_pts + j * m;
        for (int k = 0; k < m; ++k) dst[k] = kept ? src[k] : ref[k];
        if (kept) atomicOr(&out_w[j >> 5], 1u << (j & 31));
      }
      const unsigned kb = __ballot_sync(kFull, kept);
      out.n_child += __popc(kb);
      if (out.first < 0 && kb) out.first = cidx[c0 + __ffs(kb) - 1];
      __syncwarp();
      if (tx == 0) s_dom[t & 1] = 0u;
    }
  }
  return out;
}

// Bytes of the node kernel's working space: eff, cidx, eligible and
// output words.
__host__ __device__ size_t node_work_bytes(int n, int m) { return 4 * ((size_t)n * m + n + 2 * (size_t)n_words(n)); }

// Floats (4-byte units) of one frame: points, then mask words.
__host__ __device__ size_t frame_units(int n, int m) { return (size_t)n * m + n_words(n); }

// Bytes of the stack kernel's working space: top and child frames, eff,
// cidx, eligible words.
__host__ __device__ size_t stack_work_bytes(int n, int m) {
  return 4 * (2 * frame_units(n, m) + (size_t)n * m + n + n_words(n));
}

// Bytes of one block's stack: N + 1 frames, their cursors and signs.
__host__ __device__ size_t stack_bytes(int n, int m) {
  const size_t units = (size_t)(n + 1) * frame_units(n, m) + 2 * (size_t)(n + 1);
  return (4 * units + 15) / 16 * 16;
}

__global__ void __launch_bounds__(kThreads)
wfg_limit_filter_kernel(const float* __restrict__ pts, const float* __restrict__ p,
                        const unsigned char* __restrict__ elig, const float* __restrict__ ref,
                        float* __restrict__ out_pts, unsigned char* __restrict__ out_msk,
                        unsigned char* work_global, int n, int m) {
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* work = work_global != nullptr ? work_global : smem;
  const int nw = n_words(n);
  float* eff = reinterpret_cast<float*>(work);
  int* cidx = reinterpret_cast<int*>(eff + (size_t)n * m);
  uint32_t* el_w = reinterpret_cast<uint32_t*>(cidx + n);
  uint32_t* out_w = el_w + nw;

  bytes_to_words(elig, el_w, n);
  __syncthreads();
  node_step(pts, p, el_w, ref, out_pts, out_w, n, m, eff, cidx);
  __syncthreads();
  const int tid = threadIdx.y * kCols + threadIdx.x;
  for (int j = tid; j < n; j += kThreads) out_msk[j] = has_bit(out_w, j) ? 1 : 0;
}

__global__ void __launch_bounds__(kThreads)
wfg_stack_kernel(const float* __restrict__ pts0, const unsigned char* __restrict__ m0,
                 const float* __restrict__ ref, float* __restrict__ acc_out,
                 long long* __restrict__ nodes_out, unsigned char* scratch, size_t block_bytes,
                 int work_in_global, int n, int m) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_nxt;
  __shared__ int s_nchild;
  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int tid = ty * kCols + tx;
  const int b = blockIdx.x;
  const int nw = n_words(n);
  const int nm = n * m;
  const size_t fu = frame_units(n, m);

  unsigned char* mine = scratch + (size_t)b * block_bytes;
  float* stack = reinterpret_cast<float*>(mine);  // (n + 1) frames
  int* s_cur = reinterpret_cast<int*>(stack + (size_t)(n + 1) * fu);
  float* s_sign = reinterpret_cast<float*>(s_cur + (n + 1));
  unsigned char* work = work_in_global ? mine + stack_bytes(n, m) : smem;
  float* top = reinterpret_cast<float*>(work);
  float* child = top + fu;
  float* eff = child + fu;
  int* cidx = reinterpret_cast<int*>(eff + nm);
  uint32_t* el_w = reinterpret_cast<uint32_t*>(cidx + n);

  // The root: into the working top and into stack slot 0.
  const float* root = pts0 + (size_t)b * nm;
  for (int idx = tid; idx < nm; idx += kThreads) {
    const float v = root[idx];
    top[idx] = v;
    stack[idx] = v;
  }
  bytes_to_words(m0 + (size_t)b * n, reinterpret_cast<uint32_t*>(top + nm), n);
  __syncthreads();
  for (int w = tid; w < nw; w += kThreads) reinterpret_cast<uint32_t*>(stack + nm)[w] = reinterpret_cast<uint32_t*>(top + nm)[w];
  if (tid == 0) {
    s_cur[0] = 0;
    s_sign[0] = 1.0f;
  }

  // Uniform over the block: every thread keeps depth, cursor and sign.
  int depth = 1;
  int cur = 0;
  float sign = 1.0f;
  long long nodes = 0;
  float acc = 0.0f;  // thread 0's
  for (;;) {
    const uint32_t* top_w = reinterpret_cast<const uint32_t*>(top + nm);
    if (ty == 0) {
      // The pivot: the first remaining row >= cur; then the rows after it.
      int found = -1;
      for (int w0 = 0; w0 < nw && found < 0; w0 += 32) {
        const int w = w0 + tx;
        const uint32_t x = w < nw ? bits_from(top_w[w], w, cur) : 0u;
        const unsigned bal = __ballot_sync(kFull, x != 0u);
        if (bal) {
          const int l = __ffs(bal) - 1;
          found = (w0 + l) * 32 + __ffs(__shfl_sync(kFull, x, l)) - 1;
        }
      }
      if (found >= 0) {
        for (int w = tx; w < nw; w += 32) el_w[w] = bits_from(top_w[w], w, found + 1);
      }
      if (tx == 0) s_nxt = found;
    }
    __syncthreads();
    const int nxt = s_nxt;
    ++nodes;
    if (nxt < 0) {  // the top is spent: pop, and reload the parent
      if (--depth == 0) break;
      const float* src = stack + (size_t)(depth - 1) * fu;
      for (size_t idx = tid; idx < fu; idx += kThreads) top[idx] = src[idx];
      cur = s_cur[depth - 1];
      sign = s_sign[depth - 1];
      __syncthreads();
      continue;
    }
    const float* p = top + nxt * m;
    const NodeOut r = node_step(top, p, el_w, ref, child, reinterpret_cast<uint32_t*>(child + nm), n, m, eff, cidx);
    if (ty == 0) {
      __syncwarp();
      if (tx == 0) {
        // The pivot's inclusive volume, and a one-point child's, folded in
        // place of a push: the plain version's operations in its order.
        float inc = __fsub_rn(ref[0], p[0]);
        for (int k = 1; k < m; ++k) inc = __fmul_rn(inc, __fsub_rn(ref[k], p[k]));
        float fold = 0.0f;
        if (r.n_child == 1) {
          const float* only = child + r.first * m;
          float inc_only = __fsub_rn(ref[0], only[0]);
          for (int k = 1; k < m; ++k) inc_only = __fmul_rn(inc_only, __fsub_rn(ref[k], only[k]));
          fold = __fmul_rn(sign, inc_only);
        }
        acc = __fadd_rn(acc, __fsub_rn(__fmul_rn(sign, inc), fold));
        s_nchild = r.n_child;
      }
    }
    __syncthreads();
    cur = nxt + 1;
    if (s_nchild > 1) {  // push the child: written to its slot once
      float* dst = stack + (size_t)depth * fu;
      for (size_t idx = tid; idx < fu; idx += kThreads) dst[idx] = child[idx];
      if (tid == 0) {
        s_cur[depth - 1] = cur;
        s_sign[depth] = -sign;
      }
      float* tmp = top;
      top = child;
      child = tmp;
      ++depth;
      cur = 0;
      sign = -sign;
    }
  }
  if (tid == 0) {
    acc_out[b] = acc;
    nodes_out[b] = nodes;
  }
}

// Dynamic shared memory a block of `kernel` may take: the card's opt-in
// limit less the kernel's static shared memory.
template <typename K>
size_t smem_limit(K kernel) {
  int dev = 0;
  int optin = 48 * 1024;
  cudaFuncAttributes attr{};
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev) != cudaSuccess ||
      cudaFuncGetAttributes(&attr, kernel) != cudaSuccess) {
    cudaGetLastError();
    return 48 * 1024 - 1024;
  }
  return (size_t)optin - attr.sharedSizeBytes;
}

// Opt the kernel in to `bytes` of dynamic shared memory when above 48 KB.
template <typename K>
cudaError_t opt_in(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace

// Global working space the node kernel needs for an (n, m) frame: 0 when
// it fits in shared memory.
extern "C" long long wfg_node_work_bytes(int n, int m) {
  const size_t w = node_work_bytes(n, m);
  return w <= smem_limit(wfg_limit_filter_kernel) ? 0 : (long long)w;
}

extern "C" int wfg_limit_filter_launch(const float* pts, const float* p, const unsigned char* elig,
                                       const float* ref, float* out_pts, unsigned char* out_msk,
                                       void* work, int n, int m, void* stream) {
  if (n <= 0) return static_cast<int>(cudaSuccess);
  const size_t w = node_work_bytes(n, m);
  const bool global = w > smem_limit(wfg_limit_filter_kernel);
  const size_t smem = global ? 0 : w;
  cudaError_t err = opt_in(wfg_limit_filter_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  wfg_limit_filter_kernel<<<1, dim3(kCols, kLanes), smem, static_cast<cudaStream_t>(stream)>>>(
      pts, p, elig, ref, out_pts, out_msk, global ? static_cast<unsigned char*>(work) : nullptr, n, m);
  return static_cast<int>(cudaGetLastError());
}

// Global scratch one hypervolume of an (n, m) frame needs: its stack, and
// its working space where that does not fit in shared memory.
extern "C" long long wfg_stack_scratch_bytes(int n, int m) {
  const size_t w = stack_work_bytes(n, m);
  const size_t extra = w <= smem_limit(wfg_stack_kernel) ? 0 : (w + 15) / 16 * 16;
  return (long long)(stack_bytes(n, m) + extra);
}

extern "C" int wfg_stack_launch(const float* pts0, const unsigned char* m0, const float* ref, float* acc,
                                long long* nodes, void* scratch, int b, int n, int m, void* stream) {
  if (b <= 0 || n <= 0) return static_cast<int>(cudaSuccess);
  const size_t w = stack_work_bytes(n, m);
  const bool global = w > smem_limit(wfg_stack_kernel);
  const size_t smem = global ? 0 : w;
  cudaError_t err = opt_in(wfg_stack_kernel, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t block_bytes = static_cast<size_t>(wfg_stack_scratch_bytes(n, m));
  wfg_stack_kernel<<<b, dim3(kCols, kLanes), smem, static_cast<cudaStream_t>(stream)>>>(
      pts0, m0, ref, acc, nodes, static_cast<unsigned char*>(scratch), block_bytes, global ? 1 : 0, n, m);
  return static_cast<int>(cudaGetLastError());
}
