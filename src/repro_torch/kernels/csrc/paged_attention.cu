// Decode attention over the vanilla paged KV layout (block tables).
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/paged_attention.py::paged_attention
// and computes what it computes: for each row p and KV head h, the G query
// heads of the group attend over the K/V blocks the row's table names,
// k/v_pool (NB, BT, Hkv, Dh), token i of the row living in table slot
// i / BT at offset i % BT (linear fill, no ring), masked to tok <= pos.
// Online softmax in f32; masked slots score NEG_INF = -2**30 (not -inf) and
// the final divide uses max(l, 1e-30), as in the TPU kernel.  A table entry
// of -1 is skipped, as the TPU kernel skips it (the plain version gathers
// block 0 and masks it instead; the two differ only for a row with no
// valid token).  An entry outside [0, NB) is skipped too, so that a bad
// table can never read outside the pool.
//
// Bound on the H100: the kernel must read the K and V of every valid slot
// once, 2 * sum_p min(pos_p + 1, MB * BT) * Hkv * Dh * sizeof(T) bytes, and
// does 4 * G * Dh operations per slot, about 7 operations per byte in bf16
// at G = 7: bound by device-memory bytes.
//
// Design: as csrc/partition_attention.cu, one block per (row, kv_head,
// group of up to 8 query heads); the TPU kernel's sequential (P, Hkv, MB)
// grid axis over table slots becomes an in-block loop over the row's
// table.  Each mapped block is staged in shared memory in tiles of at most
// 64 slots (16-byte loads) and shared by all query heads of the group.
// Tiles wholly past pos are not read once the row has seen a valid token:
// their weights would be exp(NEG_INF - m) == 0 exactly, so skipping them
// changes no bit and reads only the bytes the bound counts.  Scores are one
// warp per slot, the softmax state of query head g lives in warp g, and
// each thread accumulates a fixed set of (g, d) outputs in f32 registers.
// The grid has only P * Hkv blocks (32 at P = 8, Hkv = 4 on 132 SMs), the
// same limit as partition_attention's first version.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxG = 8;                    // query heads per block (= warps)
constexpr int kMaxDh = 256;
constexpr int kMaxTile = 64;
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
paged_attention_kernel(const T* __restrict__ q, const T* __restrict__ k_pool,
                       const T* __restrict__ v_pool,
                       const int* __restrict__ tables,
                       const int* __restrict__ positions,
                       T* __restrict__ out, int nb, int bt, int mb, int hkv,
                       int g_total, int dh, int tile, float scale,
                       float cap) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* k_s = reinterpret_cast<T*>(smem);                    // [tile][dh]
  T* v_s = k_s + tile * dh;                               // [tile][dh]
  float* q_s = reinterpret_cast<float*>(v_s + tile * dh); // [kMaxG][dh]
  float* s_s = q_s + kMaxG * dh;                          // [kMaxG][tile]
  float* corr_s = s_s + kMaxG * tile;                     // [kMaxG]
  float* l_s = corr_s + kMaxG;                            // [kMaxG]

  const int p = blockIdx.x, h = blockIdx.y, g0 = blockIdx.z * kMaxG;
  const int ng = min(kMaxG, g_total - g0);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int pos = positions[p];
  const int* table = tables + (long long)p * mb;

  const long long q_off = ((long long)(p * hkv + h) * g_total + g0) * dh;
  for (int i = tid; i < kMaxG * dh; i += kThreads)
    q_s[i] = i < ng * dh ? to_f(q[q_off + i]) : 0.f;

  const long long tok_stride = (long long)hkv * dh;       // elements
  const int vec = 16 / (int)sizeof(T);                    // elements / 16 B
  const int vecs_per_slot = dh / vec;

  float m_run = kNegInf, l_run = 0.f;   // head `warp`'s state (warp < ng)
  float acc[kAcc];
#pragma unroll
  for (int j = 0; j < kAcc; ++j) acc[j] = 0.f;
  bool seen_valid = false;              // uniform over the block

  for (int j = 0; j < mb; ++j) {
    const int b = table[j];
    if (b < 0 || b >= nb) continue;     // unmapped: skipped, as on the TPU
    const long long blk = ((long long)b * bt * hkv + h) * dh;
    const T* k_blk = k_pool + blk;
    const T* v_blk = v_pool + blk;
    for (int t0 = 0; t0 < bt; t0 += tile) {
      const int first = j * bt + t0;    // the tile's first token
      if (first > pos && seen_valid) continue;   // weight exactly 0
      if (first <= pos) seen_valid = true;
      const int nt = min(tile, bt - t0);
      // 1. stage the K and V tile (16-byte vectors)
      for (int i = tid; i < nt * vecs_per_slot; i += kThreads) {
        const int r = i / vecs_per_slot, c = i - r * vecs_per_slot;
        const long long src = (long long)(t0 + r) * tok_stride;
        reinterpret_cast<uint4*>(k_s + r * dh)[c] =
            __ldg(reinterpret_cast<const uint4*>(k_blk + src) + c);
        reinterpret_cast<uint4*>(v_s + r * dh)[c] =
            __ldg(reinterpret_cast<const uint4*>(v_blk + src) + c);
      }
      __syncthreads();

      // 2. scores, one warp per slot
      for (int r = warp; r < tile; r += kWarps) {
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
            s = -INFINITY;             // past the end of the block: no slot
          } else {
            float sg = part[0];
#pragma unroll
            for (int g = 1; g < kMaxG; ++g)
              if (g == lane) sg = part[g];
            s = sg * scale;
            if (cap > 0.f) s = tanhf(s / cap) * cap;
            if (first + r > pos) s = kNegInf;
          }
          s_s[lane * tile + r] = s;
        }
      }
      __syncthreads();

      // 3. online softmax update, warp g for query head g
      if (warp < ng) {
        float* row = s_s + warp * tile;
        float mt = -INFINITY;
        for (int r = lane; r < tile; r += 32) mt = fmaxf(mt, row[r]);
        mt = warp_max(mt);
        const float m_new = fmaxf(m_run, mt);
        float sum = 0.f;
        for (int r = lane; r < tile; r += 32) {
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
      for (int a = 0; a < kAcc; ++a) {
        const int idx = tid + a * kThreads;
        const int g = idx / dh, d = idx - g * dh;
        if (g < ng) {
          const float* prow = s_s + g * tile;
          float x = acc[a] * corr_s[g];
          for (int r = 0; r < nt; ++r) x += prow[r] * to_f(v_s[r * dh + d]);
          acc[a] = x;
        }
      }
      __syncthreads();   // the next tile overwrites k_s, v_s and s_s
    }
  }

  if (warp < ng && lane == 0) l_s[warp] = l_run;
  __syncthreads();
#pragma unroll
  for (int a = 0; a < kAcc; ++a) {
    const int idx = tid + a * kThreads;
    const int g = idx / dh, d = idx - g * dh;
    if (g < ng) store(out + q_off + g * dh + d, acc[a] / fmaxf(l_s[g], 1e-30f));
  }
}

template <typename T>
size_t smem_bytes(int dh, int tile) {
  return 2 * (size_t)tile * dh * sizeof(T) +
         sizeof(float) * ((size_t)kMaxG * dh + (size_t)kMaxG * tile +
                          2 * kMaxG);
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* tables,
           const void* pos, void* out, int p, int nb, int bt, int mb, int hkv,
           int g, int dh, float scale, float cap, cudaStream_t stream) {
  // K/V tiles of at most 16 KiB each keep the block under 48 KiB of
  // shared memory for every Dh <= 256
  const int tile =
      min(bt, min(kMaxTile, 16384 / (dh * (int)sizeof(T))));
  dim3 grid(p, hkv, (g + kMaxG - 1) / kMaxG);
  paged_attention_kernel<T><<<grid, kThreads, smem_bytes<T>(dh, tile),
                              stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(tables),
      static_cast<const int*>(pos), static_cast<T*>(out), nb, bt, mb, hkv, g,
      dh, tile, scale, cap);
  return (int)cudaGetLastError();
}

}  // namespace

// Entry points, bound to Python by binding.cpp.
//
// q (P, Hkv, G, Dh), k/v_pool (NB, BT, Hkv, Dh), out (P, Hkv, G, Dh):
// contiguous, one dtype (bf16 when is_bf16, else f32); tables (P, MB) and
// positions (P,) int32.  Returns the CUDA error code of the launch (0 on
// success).
int paged_attention(const void* q, const void* k, const void* v,
                    const void* tables, const void* positions, void* out,
                    int p, int nb, int bt, int mb, int hkv, int g, int dh,
                    int is_bf16, float scale, float cap, void* stream) {
  if (p <= 0 || nb <= 0 || bt <= 0 || mb <= 0 || hkv <= 0 || g <= 0 ||
      dh <= 0 || dh > kMaxDh || dh % 8 != 0 || hkv > 65535 ||
      (g + kMaxG - 1) / kMaxG > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch<__nv_bfloat16>(q, k, v, tables, positions, out, p, nb, bt,
                                 mb, hkv, g, dh, scale, cap, s);
  return launch<float>(q, k, v, tables, positions, out, p, nb, bt, mb, hkv, g,
                       dh, scale, cap, s);
}

// Loads the kernels' code onto the current device without launching them,
// so that a first launch inside a timed region pays no module load.
int paged_attention_prepare() {
  cudaFuncAttributes a;
  cudaError_t e =
      cudaFuncGetAttributes(&a, paged_attention_kernel<__nv_bfloat16>);
  if (e == cudaSuccess)
    e = cudaFuncGetAttributes(&a, paged_attention_kernel<float>);
  return (int)e;
}
