// Decode attention over contiguous HotMem partition rows (flash decoding).
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/partition_attention.py:70 (partition_attention)
// and computes what it computes: for each partition row p and KV head h,
// the G query heads of the group attend over the row's ring cache of T
// slots, with online softmax in f32, ring validity
//   gidx = pos - ((pos - slot) mod T) >= 0      (floor modulo)
// an optional sliding window (gidx > pos - window) and an optional tanh
// logit cap.  Masked slots score NEG_INF = -2**30 (not -inf) and the final
// divide uses max(l, 1e-30): a row with pos < 0 has every slot masked and
// gets the mean of V over all T slots, as on the TPU.
//
// Bound on the H100: the K and V of the valid slots, read once,
// 2 * sum_p min(pos_p + 1, T, window) * Hkv * Dh * sizeof(T) bytes, at
// about 7 operations per byte in bf16 (G = 7): bound by device-memory bytes.
//
// Design (the split-K, cp.async-pipelined, tensor-core machinery is in
// decode_attention.cuh): a row's valid slots are the ring range of
// L = min(pos + 1, T, window or T) slots that ends at slot pos mod T;
// every slot in it is valid by construction, and the slots outside it are
// never read (their weight exp(NEG_INF - m) is exactly 0).  Logical token
// j of the range is global index pos - L + 1 + j, in slot (that) mod T, so
// a split's slice may wrap once around the ring.  Against the first port,
// which read all T slots of every row with one block per (row, head) and
// blocking loads: the grid is rows x heads x splits, and the bytes read
// are the bytes the bound counts.
#include "decode_attention.cuh"

namespace {

using namespace decode_attention;

template <typename T, int DMAX>
__global__ void __launch_bounds__(kThreads)
partition_attention_kernel(Params prm) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Coords c = coords(prm);
  load_q<T>(prm, c, smem);
  const int t = prm.t_len, pos = prm.positions[c.p];
  int n, first;
  bool masked;
  if (pos < 0) {                 // no valid slot: all T at NEG_INF
    n = t;
    first = 0;
    masked = true;
  } else {
    n = min(pos + 1, t);
    if (prm.window > 0) n = min(n, prm.window);
    first = pos - n + 1;         // the global index of logical token 0
    masked = false;
  }
  const Slice sl = split_slice(n, prm.splits, c.s);
  const long long row = (long long)c.p * t;
  const int hkv = prm.hkv, h = c.h, dh = prm.dh, slot0 = first % t;
  run<T, DMAX>(
      prm, c, sl, masked,
      [=](int j) -> long long {
        const int slot = slot0 + j;      // < 2 T: wraps at most once
        return ((row + (slot < t ? slot : slot - t)) * hkv + h) * dh;
      },
      smem);
}

template <typename T, int DMAX>
int launch(const Params& prm, cudaStream_t stream) {
  return launch_clusters(partition_attention_kernel<T, DMAX>, prm,
                         smem_bytes<T>(prm.dh, 0), stream);
}

template <typename T>
int dispatch(const Params& prm, cudaStream_t stream) {
  if (prm.dh <= 64) return launch<T, 64>(prm, stream);
  if (prm.dh <= 128) return launch<T, 128>(prm, stream);
  return launch<T, 256>(prm, stream);
}

template <typename T>
cudaError_t prepare_all() {
  cudaError_t e = prepare_kernel(partition_attention_kernel<T, 64>);
  if (e == cudaSuccess) e = prepare_kernel(partition_attention_kernel<T, 128>);
  if (e == cudaSuccess) e = prepare_kernel(partition_attention_kernel<T, 256>);
  return e;
}

}  // namespace

// Entry points, bound to Python by binding.cpp.
//
// q (P, Hkv, G, Dh), k/v (P, T, Hkv, Dh), out (P, Hkv, G, Dh): contiguous,
// one dtype (bf16 when is_bf16, else f32), K/V 16-byte aligned; positions
// (P,) int32; splits (<= 16) the slices of each row, one cluster of blocks.
// Returns the CUDA error code of the launch (0 on success).
int partition_attention(const void* q, const void* k, const void* v,
                        const void* positions, void* out, int p, int t,
                        int hkv, int g, int dh, int splits, int is_bf16,
                        float scale, float cap, int window, void* stream) {
  Params prm = {};
  prm.q = q;
  prm.k = k;
  prm.v = v;
  prm.out = out;
  prm.positions = static_cast<const int*>(positions);
  prm.p = p;
  prm.hkv = hkv;
  prm.g = g;
  prm.dh = dh;
  prm.splits = splits;
  prm.g_blocks = (g + kRows - 1) / kRows;
  prm.t_len = t;
  prm.window = window;
  prm.scale = scale;
  prm.cap = cap;
  if (t <= 0 || window < 0) return (int)cudaErrorInvalidValue;
  if (const int e = check_common(prm)) return e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? dispatch<__nv_bfloat16>(prm, s) : dispatch<float>(prm, s);
}

// Loads the kernels' code onto the current device without launching them,
// so that a first launch inside a timed region pays no module load, and
// lets them take more than 48 KB of shared memory and clusters of 16.
int partition_attention_prepare() {
  cudaError_t e = prepare_all<__nv_bfloat16>();
  if (e == cudaSuccess) e = prepare_all<float>();
  return (int)e;
}
