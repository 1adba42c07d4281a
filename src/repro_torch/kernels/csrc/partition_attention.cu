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
// The rows may also be one block of a ring split along "kv_seq" over
// ranks: slots [off, off + T) of t_ring (kernels/ref.py's off and t).  Such
// a call returns its softmax partials (max, normaliser, unnormalised
// output; decode_attention.cuh, item 5), which the ranks merge.
//
// Bound on the H100: the K and V of the valid slots, read once,
// 2 * sum_p |valid slots of the block| * Hkv * Dh * sizeof(T) bytes, at
// about 7 operations per byte in bf16 (G = 7): bound by device-memory bytes.
//
// Design (the split-K, cp.async-pipelined, tensor-core machinery is in
// decode_attention.cuh): a row's valid slots are the ring range of
// L = min(pos + 1, t_ring, window or t_ring) slots that ends at slot
// pos mod t_ring; every slot in it is valid by construction, and the slots
// outside it are never read (their weight exp(NEG_INF - m) is exactly 0).
// Its intersection with the block is at most two contiguous runs of
// slots; the kernel cuts the splits over the tokens of those runs only, in
// the range's order, so the bytes read are the bytes the bound counts (a
// block with no valid slot reads nothing and reports max NEG_INF, l 0).
// Over a whole ring (off = 0, t_ring = T) the runs are the range's slots
// before and after its wrap, in the order the first split-K kernel read
// them.  Against the first port, which read all T slots of every row with
// one block per (row, head) and blocking loads: the grid is rows x heads x
// splits.
#include "decode_attention.cuh"

namespace {

using namespace decode_attention;

template <typename T, int DMAX>
__global__ void __launch_bounds__(kThreads)
partition_attention_kernel(Params prm) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Coords c = coords(prm);
  load_q<T>(prm, c, smem);
  // this launch holds slots [off, off + tb) of a ring of t slots (the
  // whole ring: off = 0, t = tb); local slot i holds logical token
  // (d + i) mod t of the row's valid range
  const int tb = prm.t_len, t = prm.t_ring, pos = prm.positions[c.p];
  int n, a0, na;                 // token k < na: slot a0 + k; else k - na
  bool masked;
  if (pos < 0) {                 // no valid slot: all tb at NEG_INF
    n = na = tb;
    a0 = 0;
    masked = true;
  } else {
    int len = min(pos + 1, t);
    if (prm.window > 0) len = min(len, prm.window);
    const int slot0 = (pos - len + 1) % t;   // the slot of logical token 0
    int d = (prm.off - slot0) % t;
    if (d < 0) d += t;
    // the valid slots here, in logical order: the run past the ring's
    // wrap [t - d, ...) (tokens 0, 1, ...), then the run from slot 0
    // (tokens d, d + 1, ...); either may be empty
    a0 = t - d;
    na = a0 < tb ? max(0, min(tb, a0 + len) - a0) : 0;
    n = na + max(0, min(min(tb, t - d), len - d));
    masked = false;
  }
  const Slice sl = split_slice(n, prm.splits, c.s);
  const long long row = (long long)c.p * tb;
  const int hkv = prm.hkv, h = c.h, dh = prm.dh;
  run<T, DMAX>(
      prm, c, sl, masked,
      [=](int k) -> long long {
        const int slot = k < na ? a0 + k : k - na;
        return ((row + slot) * hkv + h) * dh;
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
int occupancy_of(int splits, int dh, int* clusters, int* blocks_per_sm) {
  const size_t smem = smem_bytes<T>(dh, 0);
  if (dh <= 64)
    return occupancy(partition_attention_kernel<T, 64>, splits, smem,
                     clusters, blocks_per_sm);
  if (dh <= 128)
    return occupancy(partition_attention_kernel<T, 128>, splits, smem,
                     clusters, blocks_per_sm);
  return occupancy(partition_attention_kernel<T, 256>, splits, smem,
                   clusters, blocks_per_sm);
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
// The T slots of k/v are slots [off, off + T) of a ring of t_ring slots.
// With top and lsum (P, Hkv, G) f32 given (else null), the call writes the
// softmax partials: top, lsum and, into out as f32, the unnormalised output.
// Returns the CUDA error code of the launch (0 on success).
int partition_attention(const void* q, const void* k, const void* v,
                        const void* positions, void* out, void* top,
                        void* lsum, int p, int t, int hkv, int g, int dh,
                        int splits, int is_bf16, float scale, float cap,
                        int window, int off, int t_ring, void* stream) {
  Params prm = {};
  prm.q = q;
  prm.k = k;
  prm.v = v;
  prm.out = out;
  prm.top = static_cast<float*>(top);
  prm.lsum = static_cast<float*>(lsum);
  prm.positions = static_cast<const int*>(positions);
  prm.p = p;
  prm.hkv = hkv;
  prm.g = g;
  prm.dh = dh;
  prm.splits = splits;
  prm.g_blocks = (g + kRows - 1) / kRows;
  prm.t_len = t;
  prm.t_ring = t_ring;
  prm.off = off;
  prm.window = window;
  prm.scale = scale;
  prm.cap = cap;
  if (t <= 0 || window < 0 || off < 0 || off + t > t_ring ||
      (top == nullptr) != (lsum == nullptr))
    return (int)cudaErrorInvalidValue;
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

// The clusters of `splits` blocks of the kernel for head dim dh that the
// card holds at once, and its blocks an SM (decode_attention.cuh's
// occupancy), after partition_attention_prepare.  Returns a CUDA error
// code, 0 on success.
int partition_attention_occupancy(int splits, int dh, int is_bf16,
                                  int* clusters, int* blocks_per_sm) {
  if (splits < 1 || splits > kMaxSplits || dh < 16 || dh > kMaxDh ||
      dh % 16 != 0)
    return (int)cudaErrorInvalidValue;
  return is_bf16 ? occupancy_of<__nv_bfloat16>(splits, dh, clusters,
                                               blocks_per_sm)
                 : occupancy_of<float>(splits, dh, clusters, blocks_per_sm);
}
