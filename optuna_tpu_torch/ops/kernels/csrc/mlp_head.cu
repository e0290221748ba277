// Config #5's head for a batch of MLPs in the wide layout, for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package's trainer is plain jnp (a vmap of
// value_and_grad over optuna_tpu/models/mlp.py). It exists because the
// port trains a batch of B trials in the wide layout: every trial's first
// layer is one column block of W1 (in x B*H), so the first layer of all
// trials is one large product Z = X @ W1 (N x B*H) and its weight gradient
// one more, X^T @ dH. Between the two, each (example row, trial) pair needs
// the ReLU, the H -> O head, a softmax cross-entropy and its gradient back
// to the hidden layer: elementwise work over Z that autograd ran as a chain
// of passes, each writing and reading an (N, B, H) tensor. This kernel is
// that chain in one pass:
//
//   h   = relu(z + b1)                  z: the trial's H entries of Z's row
//   l   = h W2 + b2,  p = softmax(l)    W2: H x O, the trial's
//   g   = (p - onehot(y)) / N           the mean cross-entropy's gradient
//   dh  = (g W2^T) * [h > 0]            written over z, times the trial's rate
//
// and per block (a chunk of kChunk rows of one trial) partial sums of
// dW2 = h^T g, db2 = sum g, db1 = sum dh and the loss sum -log p_y, which a
// second pass (torch, over the chunks in order) finishes. No float atomics:
// a rerun gives the same bits. With kGrad false it computes the loss alone
// (the final forward pass) and leaves Z as it is.
//
// What bounds it. At config #5's shape (N = 60,000, B = 256, H = 32,
// O = 10) a step reads Z and writes dH, 2 x 1.97 GB: 1.17 ms at 3.35 TB/s.
// Its arithmetic, ~3 H O multiply-adds a pair (logits, dh, dW2), is about
// 0.5 ms at the f32 rate, so the design keeps instructions per pair low
// enough that the bytes stay the bound:
//
//  * A block is one trial and a chunk of rows; it stages tiles of
//    kTile rows x H floats (128 B a row at H = 32: whole sectors, 16 B a
//    thread) in shared memory, rows padded to H + 4 floats so that the
//    row phase's float4 reads are free of bank conflicts. Two buffers:
//    the next tile arrives by cp.async while this one is worked on (two
//    tiles fit the 48 KB of static shared memory up to H = 32). The build
//    carries config #5's widths, H = 32 and O = 10.
//  * Row phase: a thread owns one row. h, the logits and the softmax stay
//    in registers; W2 (rows padded to 4 floats), b1 and b2 sit in shared
//    memory and are read as warp broadcasts. g goes to shared memory.
//  * dW2 phase: thread (j, group) sums h_j g_o over its group's rows into
//    O registers, so h^T g costs one multiply-add a term and no shuffle.
//  * dh phase: the thread reads its row's z and g again and writes dh
//    over the staged row. Nothing but the accumulators is held in
//    registers across a barrier, and W2 is read again rather than kept
//    from the logits: holding dh or W2's values there spills registers.
//  * The staged dh rows are stored over Z (times the trial's rate, so
//    that W1 -= X^T dH is one in-place product), with the load's 16 B a
//    thread mapping; db1 is summed from those registers on the way out.
//  * Each block reduces its accumulators once, at its end, in a fixed
//    order (warp butterflies, then shared memory), into its partials row.
//
// C interface (bound with ctypes): sets the device it is given for the
// call, launches on the caller's stream and returns cudaGetLastError(); the
// kernel allocates nothing. The wrapper checks shapes, types, contiguity
// and alignment; labels must lie in [0, O).

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 128;  // one example row a thread in the row phase
constexpr int kTile = kThreads;  // rows staged at a time
constexpr int kChunk = 1024;  // rows of one block: one partials row per (chunk, trial)
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// relu as torch computes it: NaN stays NaN.
__device__ __forceinline__ float relu(float v) { return v < 0.0f ? 0.0f : v; }

// Asynchronous copies to shared memory; with `valid` false, zeros.
__device__ __forceinline__ void copy16(float* dst, const float* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void copy8(long long* dst, const long long* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src), "r"(valid ? 8 : 0));
}

// Stage the tile at row `at` (a trial's column block `zt`) into `dst`: its
// z rows, zeros past `row_end`, and their labels into `ydst`, without
// waiting for them.
template <int kStride, int kPassRows>
__device__ __forceinline__ void stage(float* dst, long long* ydst, const float* zt, const long long* labels, int at,
                                      int row_end, int ld, int vr, int vc) {
  const int rows = min(kTile, row_end - at);
#pragma unroll
  for (int r = vr; r < kTile; r += kPassRows) {
    const size_t src = static_cast<size_t>(at + min(r, rows - 1)) * ld + 4 * vc;
    copy16(&dst[r * kStride + 4 * vc], zt + src, r < rows);
  }
  const int t = threadIdx.x;
  copy8(&ydst[t], labels + at + min(t, rows - 1), t < rows);
  asm volatile("cp.async.commit_group;\n" ::);
}

// h of staged row r: relu(z + b1).
template <int H, int kStride>
__device__ __forceinline__ void hidden_row(const float* sz, const float* sb1, int r, float* h) {
#pragma unroll
  for (int q = 0; q < H / 4; ++q) {
    const float4 v = *reinterpret_cast<const float4*>(&sz[r * kStride + 4 * q]);
    const float4 c = *reinterpret_cast<const float4*>(&sb1[4 * q]);
    h[4 * q + 0] = relu(v.x + c.x);
    h[4 * q + 1] = relu(v.y + c.y);
    h[4 * q + 2] = relu(v.z + c.z);
    h[4 * q + 3] = relu(v.w + c.w);
  }
}

template <int H, int O, bool kGrad>
__global__ void __launch_bounds__(kThreads, 4)
mlp_head_kernel(float* __restrict__ z, const float* __restrict__ b1, const float* __restrict__ w2,
                const float* __restrict__ b2, const long long* __restrict__ labels,
                const float* __restrict__ lr, float* __restrict__ partials, int n, int ld, float inv_n) {
  static_assert(H % 4 == 0 && kThreads % H == 0 && H <= kThreads, "H: a multiple of 4 dividing the block");
  constexpr int kStride = H + 4;  // a staged row, padded
  constexpr int kVec = H / 4;  // float4s in a trial's row segment
  constexpr int kPassRows = kThreads / kVec;  // rows one load or store pass covers
  constexpr int kGroups = kThreads / H;  // row groups of the dW2 phase
  constexpr int kGroupRows = kTile / kGroups;
  constexpr int kGs = (O + 3) / 4 * 4;  // a row of g, padded
  constexpr int kParts = kGrad ? H * O + O + H + 1 : 1;
  // The end-of-block scratch, over the staged tile: dW2 (kGroups x H x O),
  // db1 (kPassRows x H), and per warp the loss and db2.
  constexpr int kScratch = kThreads * O + kThreads * 4 + kWarps * (O + 1);
  constexpr int kBuf = kTile * kStride > kScratch ? kTile * kStride : kScratch;

  __shared__ __align__(16) float sbuf[2 * kBuf];  // two staged tiles: one worked on, one arriving
  __shared__ __align__(16) long long sy[2][kTile];  // their labels
  __shared__ __align__(16) float sg[kGrad ? kTile * kGs : 4];
  __shared__ __align__(16) float sw2[H * kGs];
  __shared__ __align__(16) float sb1[H];
  __shared__ float sb2[O];

  const int t = threadIdx.x;
  const int lane = t & 31, warp = t >> 5;
  const int trial = blockIdx.y;
  const int row0 = blockIdx.x * kChunk;
  const int row_end = min(row0 + kChunk, n);
  for (int i = t; i < H * kGs; i += kThreads) {
    const int k = i / kGs, o = i % kGs;
    sw2[i] = o < O ? w2[(static_cast<size_t>(trial) * H + k) * O + o] : 0.0f;
  }
  if (t < H) sb1[t] = b1[trial * H + t];
  if (t < O) sb2[t] = b2[trial * O + t];
  const float rate = kGrad ? lr[trial] : 0.0f;
  __syncthreads();

  float* zt = z + static_cast<size_t>(trial) * H;  // the trial's column block
  const int vc = t % kVec, vr = t / kVec;  // load and store: 16 B of row vr + k * kPassRows
  const int gj = t % H, grp = t / H;  // dW2 phase: hidden unit gj over group grp's rows

  float loss = 0.0f;
  float db2[O], dw2[O], db1[4];
#pragma unroll
  for (int o = 0; o < O; ++o) db2[o] = dw2[o] = 0.0f;
#pragma unroll
  for (int k = 0; k < 4; ++k) db1[k] = 0.0f;

  stage<kStride, kPassRows>(sbuf, sy[0], zt, labels, row0, row_end, ld, vr, vc);
  int buf = 0;
  for (int tile0 = row0; tile0 < row_end; tile0 += kTile, buf ^= 1) {
    const int rows = min(kTile, row_end - tile0);
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();  // this tile staged, and the other buffer's tile consumed
    if (tile0 + kTile < row_end) {  // arrives while this one is worked on
      stage<kStride, kPassRows>(sbuf + (buf ^ 1) * kBuf, sy[buf ^ 1], zt, labels, tile0 + kTile, row_end, ld, vr, vc);
    }
    float* sz = sbuf + buf * kBuf;

    // Row phase: this thread's row tile0 + t. The loss; g to shared memory.
    const bool live = t < rows;
    {
      float h[H];
      hidden_row<H, kStride>(sz, sb1, t, h);
      float l[O];
#pragma unroll
      for (int o = 0; o < O; ++o) l[o] = sb2[o];
#pragma unroll
      for (int k = 0; k < H; ++k) {
#pragma unroll
        for (int o = 0; o < O; ++o) l[o] = fmaf(h[k], sw2[k * kGs + o], l[o]);
      }
      const int y = live ? static_cast<int>(sy[buf][t]) : 0;
      float m = -INFINITY, ly = 0.0f;
#pragma unroll
      for (int o = 0; o < O; ++o) {
        m = fmaxf(m, l[o]);
        ly = o == y ? l[o] : ly;
      }
      float s = 0.0f;
#pragma unroll
      for (int o = 0; o < O; ++o) {
        l[o] = expf(l[o] - m);
        s += l[o];
      }
      if (live) loss += m + logf(s) - ly;
      if constexpr (kGrad) {
        const float inv_s = 1.0f / s;
#pragma unroll
        for (int o = 0; o < kGs; ++o) {
          const float g = o < O && live ? (l[o] * inv_s - (o == y ? 1.0f : 0.0f)) * inv_n : 0.0f;
          if (o < O) db2[o] += g;
          sg[t * kGs + o] = g;
        }
      }
    }

    if constexpr (kGrad) {
      __syncthreads();  // g of every row staged

      // dW2 phase: sum over the group's rows of h_gj g_o.
      const float hb = sb1[gj];
      for (int i = 0; i < kGroupRows; ++i) {
        const int r = grp * kGroupRows + i;
        if (r >= rows) break;
        const float hv = relu(sz[r * kStride + gj] + hb);
#pragma unroll
        for (int o = 0; o < O; ++o) dw2[o] = fmaf(hv, sg[r * kGs + o], dw2[o]);
      }
      __syncthreads();  // the staged z rows are read

      // dh phase: this thread's row again, dh = (g W2^T) * [h > 0] over it.
      {
        float h[H], g[O];
        hidden_row<H, kStride>(sz, sb1, t, h);
#pragma unroll
        for (int o = 0; o < O; ++o) g[o] = sg[t * kGs + o];
#pragma unroll
        for (int q = 0; q < kVec; ++q) {
          float d[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float a = 0.0f;
#pragma unroll
            for (int o = 0; o < O; ++o) a = fmaf(g[o], sw2[(4 * q + e) * kGs + o], a);
            d[e] = h[4 * q + e] > 0.0f ? a : 0.0f;
          }
          *reinterpret_cast<float4*>(&sz[t * kStride + 4 * q]) = make_float4(d[0], d[1], d[2], d[3]);
        }
      }
      __syncthreads();  // dh of every row staged

      for (int r = vr; r < rows; r += kPassRows) {
        float4 v = *reinterpret_cast<const float4*>(&sz[r * kStride + 4 * vc]);
        db1[0] += v.x;
        db1[1] += v.y;
        db1[2] += v.z;
        db1[3] += v.w;
        v.x *= rate;
        v.y *= rate;
        v.z *= rate;
        v.w *= rate;
        *reinterpret_cast<float4*>(zt + static_cast<size_t>(tile0 + r) * ld + 4 * vc) = v;
      }
    }
  }
  __syncthreads();  // the last tile consumed: its buffer becomes the scratch

  // One reduction a block, in a fixed order, into its partials row:
  // [dW2 (H x O, as W2) | db2 (O) | db1 (H) | loss sum (1)].
  float* scratch = sbuf;
  float* per_warp = scratch + kThreads * O + kThreads * 4;
  loss = warp_sum(loss);
  if (lane == 0) per_warp[warp * (O + 1)] = loss;
  if constexpr (kGrad) {
#pragma unroll
    for (int o = 0; o < O; ++o) {
      const float v = warp_sum(db2[o]);
      if (lane == 0) per_warp[warp * (O + 1) + 1 + o] = v;
    }
#pragma unroll
    for (int o = 0; o < O; ++o) scratch[grp * H * O + gj * O + o] = dw2[o];
#pragma unroll
    for (int k = 0; k < 4; ++k) scratch[kThreads * O + vr * H + 4 * vc + k] = db1[k];
  }
  __syncthreads();
  float* out = partials + (static_cast<size_t>(blockIdx.x) * gridDim.y + trial) * kParts;
  if constexpr (kGrad) {
    for (int i = t; i < H * O; i += kThreads) {
      float a = 0.0f;
#pragma unroll
      for (int gi = 0; gi < kGroups; ++gi) a += scratch[gi * H * O + i];
      out[i] = a;
    }
    if (t < O) {
      float a = 0.0f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) a += per_warp[w * (O + 1) + 1 + t];
      out[H * O + t] = a;
    }
    if (t < H) {
      float a = 0.0f;
#pragma unroll
      for (int p = 0; p < kPassRows; ++p) a += scratch[kThreads * O + p * H + t];
      out[H * O + O + t] = a;
    }
  }
  if (t == 0) {
    float a = 0.0f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) a += per_warp[w * (O + 1)];
    out[kParts - 1] = a;
  }
}

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

template <int H, int O>
cudaError_t launch(float* z, const float* b1, const float* w2, const float* b2, const long long* labels,
                   const float* lr, float* partials, int n, int trials, bool grad, cudaStream_t stream) {
  const dim3 grid((n + kChunk - 1) / kChunk, trials);
  const float inv_n = 1.0f / static_cast<float>(n);
  if (grad) {
    mlp_head_kernel<H, O, true><<<grid, kThreads, 0, stream>>>(z, b1, w2, b2, labels, lr, partials, n, trials * H,
                                                               inv_n);
  } else {
    mlp_head_kernel<H, O, false><<<grid, kThreads, 0, stream>>>(z, b1, w2, b2, labels, lr, partials, n, trials * H,
                                                                inv_n);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" int mlp_head_chunk_rows() { return kChunk; }

// The (hidden, out) widths a build carries; the wrapper asks before it launches.
extern "C" int mlp_head_supports(int hidden, int n_out) { return hidden == 32 && n_out == 10; }

extern "C" int mlp_head_launch(float* z, const float* b1, const float* w2, const float* b2, const long long* labels,
                               const float* lr, float* partials, int n, int trials, int hidden, int n_out, int grad,
                               int device, void* stream) {
  if (n <= 0 || trials <= 0) return static_cast<int>(cudaSuccess);
  if (!mlp_head_supports(hidden, n_out)) return static_cast<int>(cudaErrorInvalidValue);
  DeviceGuard guard(device);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(launch<32, 10>(z, b1, w2, b2, labels, lr, partials, n, trials, grad, s));
}
