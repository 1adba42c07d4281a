// Decode attention over contiguous HotMem partition rows (flash decoding).
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/partition_attention.py::partition_attention
// and computes what it computes: for each partition row p and KV head h,
// the G query heads of the group attend over the row's ring cache of T
// slots, with online softmax in f32, ring validity
//   gidx = pos - ((pos - slot) mod T) >= 0      (floor modulo)
// an optional sliding window (gidx > pos - window) and an optional tanh
// logit cap.  Masked slots score NEG_INF = -2**30 (not -inf) and the final
// divide uses max(l, 1e-30), so an all-masked row stays finite exactly as
// in the TPU kernel.
//
// Bound on the H100: the kernel must read K and V of every row once,
// 2 * P * T * Hkv * Dh * sizeof(T) bytes, and does 4 * G * Dh operations per
// K/V slot, i.e. about 2 * G / sizeof(T) = 7 operations per byte in bf16 at
// G = 7: far below the ~295 operations per byte where bf16 compute would
// bind, so it is bound by device-memory bytes.
//
// Design: one block per (p, kv_head, group of up to 8 query heads).  The
// block loops over T in tiles of BT slots; each tile of K and V is staged
// once in shared memory with 16-byte loads and then shared by all G query
// heads of the group (the TPU kernel's (P, Hkv, T/BT) grid with its
// sequential T axis becomes this in-block loop).  Scores are one warp per
// slot (lanes split Dh, shuffle reduction), the running max and sum for
// query head g live in warp g, and each thread accumulates a fixed set of
// (g, d) outputs in f32 registers.  The grid has only P * Hkv blocks
// (32 at P = 8, Hkv = 4 on 132 SMs), so this first version is far from
// the memory bound; splitting T over more blocks is later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxG = 8;                    // query heads per block (= warps)
constexpr int kMaxDh = 256;
constexpr int kAcc = kMaxG * kMaxDh / kThreads;   // outputs per thread
constexpr float kNegInf = -1073741824.0f;   // -2**30, NEG_INF of the TPU kernel
static_assert(kWarps == kMaxG, "warp g owns the softmax state of head g");

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* o, float x) { *o = x; }
__device__ __forceinline__ void store(__nv_bfloat16* o, float x) {
  *o = __float2bfloat16(x);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}
__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
partition_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v,
                           const int* __restrict__ positions,
                           T* __restrict__ out, int t_len, int hkv,
                           int g_total, int dh, int bt, float scale,
                           float cap, int window) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* k_s = reinterpret_cast<T*>(smem);                    // [bt][dh]
  T* v_s = k_s + bt * dh;                                 // [bt][dh]
  float* q_s = reinterpret_cast<float*>(v_s + bt * dh);   // [kMaxG][dh]
  float* s_s = q_s + kMaxG * dh;                          // [kMaxG][bt]
  float* corr_s = s_s + kMaxG * bt;                       // [kMaxG]
  float* l_s = corr_s + kMaxG;                            // [kMaxG]

  const int p = blockIdx.x, h = blockIdx.y, g0 = blockIdx.z * kMaxG;
  const int ng = min(kMaxG, g_total - g0);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int pos = positions[p];

  const long long q_off = ((long long)(p * hkv + h) * g_total + g0) * dh;
  for (int i = tid; i < kMaxG * dh; i += kThreads)
    q_s[i] = i < ng * dh ? to_f(q[q_off + i]) : 0.f;

  const long long tok_stride = (long long)hkv * dh;       // elements
  const T* k_row = k + ((long long)p * t_len * hkv + h) * dh;
  const T* v_row = v + ((long long)p * t_len * hkv + h) * dh;
  const int vec = 16 / (int)sizeof(T);                    // elements / 16 B
  const int vecs_per_slot = dh / vec;

  float m_run = kNegInf, l_run = 0.f;   // head `warp`'s state (warp < ng)
  float acc[kAcc];
#pragma unroll
  for (int j = 0; j < kAcc; ++j) acc[j] = 0.f;

  for (int t0 = 0; t0 < t_len; t0 += bt) {
    const int nt = min(bt, t_len - t0);
    // 1. stage the K and V tile (16-byte vectors; the ragged tail of the
    //    last tile is simply not loaded)
    for (int i = tid; i < nt * vecs_per_slot; i += kThreads) {
      const int r = i / vecs_per_slot, c = i - r * vecs_per_slot;
      const long long src = (long long)(t0 + r) * tok_stride;
      reinterpret_cast<uint4*>(k_s + r * dh)[c] =
          __ldg(reinterpret_cast<const uint4*>(k_row + src) + c);
      reinterpret_cast<uint4*>(v_s + r * dh)[c] =
          __ldg(reinterpret_cast<const uint4*>(v_row + src) + c);
    }
    __syncthreads();

    // 2. scores, one warp per slot
    for (int r = warp; r < bt; r += kWarps) {
      float part[kMaxG];
#pragma unroll
      for (int g = 0; g < kMaxG; ++g) part[g] = 0.f;
      if (r < nt) {
        for (int d = lane; d < dh; d += 32) {
          const float kd = to_f(k_s[r * dh + d]);
#pragma unroll
          for (int g = 0; g < kMaxG; ++g) part[g] += q_s[g * dh + d] * kd;
        }
      }
#pragma unroll
      for (int g = 0; g < kMaxG; ++g) part[g] = warp_sum(part[g]);
      if (lane < ng) {
        float s;
        if (r >= nt) {
          s = -INFINITY;               // past the end of the ring: no slot
        } else {
          float sg = part[0];
#pragma unroll
          for (int g = 1; g < kMaxG; ++g)
            if (g == lane) sg = part[g];
          s = sg * scale;
          if (cap > 0.f) s = tanhf(s / cap) * cap;
          const int slot = t0 + r;
          int m = (pos - slot) % t_len;
          if (m < 0) m += t_len;       // floor modulo, as jnp's %
          const int gidx = pos - m;
          const bool ok = gidx >= 0 && (window == 0 || gidx > pos - window);
          if (!ok) s = kNegInf;
        }
        s_s[lane * bt + r] = s;
      }
    }
    __syncthreads();

    // 3. online softmax update, warp g for query head g
    if (warp < ng) {
      float* row = s_s + warp * bt;
      float mt = -INFINITY;
      for (int r = lane; r < bt; r += 32) mt = fmaxf(mt, row[r]);
      mt = warp_max(mt);
      const float m_new = fmaxf(m_run, mt);
      float sum = 0.f;
      for (int r = lane; r < bt; r += 32) {
        const float e = expf(row[r] - m_new);
        row[r] = e;
        sum += e;
      }
      sum = warp_sum(sum);
      const float corr = expf(m_run - m_new);
      l_run = l_run * corr + sum;
      m_run = m_new;
      if (lane == 0) corr_s[warp] = corr;
    }
    __syncthreads();

    // 4. rescale and accumulate p @ V for this thread's (g, d) outputs
#pragma unroll
    for (int j = 0; j < kAcc; ++j) {
      const int idx = tid + j * kThreads;
      const int g = idx / dh, d = idx - g * dh;
      if (g < ng) {
        const float* prow = s_s + g * bt;
        float a = acc[j] * corr_s[g];
        for (int r = 0; r < nt; ++r) a += prow[r] * to_f(v_s[r * dh + d]);
        acc[j] = a;
      }
    }
    __syncthreads();   // the next tile overwrites k_s, v_s and s_s
  }

  if (warp < ng && lane == 0) l_s[warp] = l_run;
  __syncthreads();
#pragma unroll
  for (int j = 0; j < kAcc; ++j) {
    const int idx = tid + j * kThreads;
    const int g = idx / dh, d = idx - g * dh;
    if (g < ng) store(out + q_off + g * dh + d, acc[j] / fmaxf(l_s[g], 1e-30f));
  }
}

template <typename T>
size_t smem_bytes(int dh, int bt) {
  return 2 * (size_t)bt * dh * sizeof(T) +
         sizeof(float) * ((size_t)kMaxG * dh + (size_t)kMaxG * bt + 2 * kMaxG);
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* pos,
           void* out, int p, int t, int hkv, int g, int dh, float scale,
           float cap, int window, cudaStream_t stream) {
  // K/V tiles of at most 16 KiB each keep the block under 48 KiB of
  // shared memory for every Dh <= 256
  const int bt = min(64, 16384 / (dh * (int)sizeof(T)));
  dim3 grid(p, hkv, (g + kMaxG - 1) / kMaxG);
  partition_attention_kernel<T><<<grid, kThreads, smem_bytes<T>(dh, bt),
                                  stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(pos),
      static_cast<T*>(out), t, hkv, g, dh, bt, scale, cap, window);
  return (int)cudaGetLastError();
}

}  // namespace

// Entry points, bound to Python by binding.cpp.
//
// q (P, Hkv, G, Dh), k/v (P, T, Hkv, Dh), out (P, Hkv, G, Dh): contiguous,
// one dtype (bf16 when is_bf16, else f32); positions (P,) int32.  Returns
// the CUDA error code of the launch (0 on success).
int partition_attention(const void* q, const void* k, const void* v,
                        const void* positions, void* out, int p, int t,
                        int hkv, int g, int dh, int is_bf16, float scale,
                        float cap, int window, void* stream) {
  if (p <= 0 || t <= 0 || hkv <= 0 || g <= 0 || dh <= 0 || dh > kMaxDh ||
      dh % 8 != 0 || hkv > 65535 ||
      (g + kMaxG - 1) / kMaxG > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch<__nv_bfloat16>(q, k, v, positions, out, p, t, hkv, g, dh,
                                 scale, cap, window, s);
  return launch<float>(q, k, v, positions, out, p, t, hkv, g, dh, scale, cap,
                       window, s);
}

// Loads the kernels' code onto the current device without launching them,
// so that a first launch inside a timed region pays no module load.
int partition_attention_prepare() {
  cudaFuncAttributes a;
  cudaError_t e = cudaFuncGetAttributes(
      &a, partition_attention_kernel<__nv_bfloat16>);
  if (e == cudaSuccess)
    e = cudaFuncGetAttributes(&a, partition_attention_kernel<float>);
  return (int)e;
}
