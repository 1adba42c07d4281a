// The front end of one attention block's decode step: the q/k/v bias adds,
// the rotary embedding of q and k, and the write of the new K/V into each
// row's ring slot, in one launch.
//
// Replaces no Pallas kernel: the JAX package leaves this elementwise work
// to XLA, which fuses it.  As separate torch operations it is 47 device
// operations a block (three bias adds, two rotary embeddings of 19
// operations each, and the slot's index write): 1,316 of the 2,254 nodes of
// qwen2-7b's replayed decode step, each a few microseconds of launch and
// graph-node overhead around a few hundred KB of work.  In one launch the
// replayed step at 64 rows takes 11.3 ms of device time on one H100 SXM
// (80 GB, 700 W), against 14.0 ms.
//
// What it computes, in models/attention.py's order, for each row p at
// position pos (kernels/ref.py::decode_qkv_rope is the plain version):
//   x = x + b, rounded to the activation dtype       (q, k and v; if biased)
//   angle_i = float(pos) * freq_i                    (f32; freqs from torch)
//   x1' = x1 cos - x2 sin, x2' = x2 cos + x1 sin     (q and k; f32)
//   rounded to the dtype (round-to-nearest-even)
//   K/V cache[p, pos mod t] = k', v                  (floor modulo)
// and returns q' as (P, Hkv, G, Dh), the attention kernel's layout.  Every
// product and sum is rounded on its own (__fmul_rn, __fsub_rn, __fadd_rn),
// so nvcc contracts nothing into an FMA: torch rounds after each
// operation, and the result is torch's bit for bit.  cosf and sinf are the
// CUDA math library's full-precision functions, which torch's cos and sin
// call for f32.  Every row is written, a row at pos < 0 too, into slot
// t + pos % t, as torch.remainder gives.
//
// Bound on the H100: bytes.  Each input element is read once and each
// output written once: for qwen2-7b at 64 rows (Hq 28, Hkv 4, Dh 128,
// bf16) 1.19 MB a block, 0.36 us at 3.35 TB/s, at about 10 operations an
// element; the launch itself costs more.
//
// Design: one thread per rotary pair (i, i + Dh/2) of one head of one row,
// over the q heads, then the k heads, then the v heads (v is not rotated),
// so neighbouring threads read and write neighbouring elements.  It
// launches on the caller's stream, allocates nothing and never
// synchronises, so a CUDA graph can capture it.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

struct Args {
  const void* q;          // (P, Hq * Dh)
  const void* k;          // (P, Hkv * Dh)
  const void* v;          // (P, Hkv * Dh)
  const void* bq;         // (Hq * Dh) or null
  const void* bk;         // (Hkv * Dh) or null
  const void* bv;         // (Hkv * Dh) or null
  const int* positions;   // (P,)
  const float* freqs;     // (Dh / 2,)
  void* k_cache;          // (P, t, Hkv, Dh)
  void* v_cache;          // (P, t, Hkv, Dh)
  void* q_out;            // (P, Hq * Dh), read as (P, Hkv, G, Dh)
  int p, hq, hkv, dh, t;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
decode_qkv_rope_kernel(const Args a) {
  const int half = a.dh / 2;
  const int heads = a.hq + 2 * a.hkv;
  const long long n = (long long)a.p * heads * half;
  const long long idx = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (idx >= n) return;
  const int i = (int)(idx % half);
  const int h = (int)((idx / half) % heads);
  const int row = (int)(idx / ((long long)half * heads));
  const int pos = a.positions[row];

  const T* src;
  const T* bias;
  int head;                  // the head within q, k or v
  if (h < a.hq) {
    head = h;
    src = static_cast<const T*>(a.q) + (long long)row * a.hq * a.dh;
    bias = static_cast<const T*>(a.bq);
  } else if (h < a.hq + a.hkv) {
    head = h - a.hq;
    src = static_cast<const T*>(a.k) + (long long)row * a.hkv * a.dh;
    bias = static_cast<const T*>(a.bk);
  } else {
    head = h - a.hq - a.hkv;
    src = static_cast<const T*>(a.v) + (long long)row * a.hkv * a.dh;
    bias = static_cast<const T*>(a.bv);
  }
  const int e = head * a.dh + i;         // element of the pair's first half
  float x1 = to_f32(src[e]), x2 = to_f32(src[e + half]);
  if (bias != nullptr) {
    x1 = to_f32(from_f32<T>(__fadd_rn(x1, to_f32(bias[e]))));
    x2 = to_f32(from_f32<T>(__fadd_rn(x2, to_f32(bias[e + half]))));
  }
  if (h < a.hq + a.hkv) {                // rotate q and k
    const float angle = __fmul_rn((float)pos, a.freqs[i]);
    const float c = cosf(angle), s = sinf(angle);
    const float y1 = __fsub_rn(__fmul_rn(x1, c), __fmul_rn(x2, s));
    const float y2 = __fadd_rn(__fmul_rn(x2, c), __fmul_rn(x1, s));
    x1 = y1;
    x2 = y2;
  }
  T* dst;
  if (h < a.hq) {
    dst = static_cast<T*>(a.q_out) + (long long)row * a.hq * a.dh + e;
  } else {
    int slot = pos % a.t;                // floor modulo
    if (slot < 0) slot += a.t;
    T* cache = static_cast<T*>(h < a.hq + a.hkv ? a.k_cache : a.v_cache);
    dst = cache + ((long long)row * a.t + slot) * a.hkv * a.dh + e;
  }
  dst[0] = from_f32<T>(x1);
  dst[half] = from_f32<T>(x2);
}

template <typename T>
int launch(const Args& a, cudaStream_t stream) {
  const long long n = (long long)a.p * (a.hq + 2 * a.hkv) * (a.dh / 2);
  const long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  decode_qkv_rope_kernel<T><<<(unsigned)blocks, kThreads, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T>
cudaError_t prepare_one() {
  cudaFuncAttributes attr;
  return cudaFuncGetAttributes(&attr, decode_qkv_rope_kernel<T>);
}

}  // namespace

// Entry points, bound to Python by binding.cpp.
//
// q (P, Hq * Dh), k and v (P, Hkv * Dh), the biases (H * Dh) or null,
// k/v_cache (P, t, Hkv, Dh) and q_out (P, Hq * Dh): contiguous, one dtype
// (bf16 when is_bf16, else f32); positions (P,) int32; freqs (Dh / 2,) f32.
// Hq a multiple of Hkv, Dh even.  Returns the CUDA error code of the launch
// (0 on success).
int decode_qkv_rope(const void* q, const void* k, const void* v,
                    const void* bq, const void* bk, const void* bv,
                    const void* positions, const void* freqs, void* k_cache,
                    void* v_cache, void* q_out, int p, int hq, int hkv,
                    int dh, int t, int is_bf16, void* stream) {
  if (p <= 0 || hkv <= 0 || hq <= 0 || hq % hkv != 0 || dh <= 0 ||
      dh % 2 != 0 || t <= 0)
    return (int)cudaErrorInvalidValue;
  Args a = {q, k, v, bq, bk, bv, static_cast<const int*>(positions),
            static_cast<const float*>(freqs), k_cache, v_cache, q_out,
            p, hq, hkv, dh, t};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch<__nv_bfloat16>(a, s) : launch<float>(a, s);
}

// Loads the kernel's code onto the current device without launching it,
// so that a first launch inside a timed region pays no module load.
int decode_qkv_rope_prepare() {
  cudaError_t e = prepare_one<__nv_bfloat16>();
  if (e == cudaSuccess) e = prepare_one<float>();
  return (int)e;
}
