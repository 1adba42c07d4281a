// Decode attention over the vanilla paged KV layout (block tables).
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/paged_attention.py:65 (paged_attention)
// and computes what it computes: for each row p and KV head h, the G query
// heads of the group attend over the K/V blocks the row's table names,
// k/v_pool (NB, BT, Hkv, Dh), token i of the row living in table slot
// i / BT at offset i % BT (linear fill, no ring), masked to tok <= pos.
// Online softmax in f32; masked slots score NEG_INF = -2**30 (not -inf)
// and the final divide uses max(l, 1e-30), as in the TPU kernel.  A table
// entry of -1 is skipped, as the TPU kernel skips it (the plain version
// gathers block 0 and masks it instead; the two differ only for a row with
// no valid token).  An entry outside [0, NB) is skipped too, so that a bad
// table can never read outside the pool.
//
// Bound on the H100: the K and V of every valid token, read once,
// 2 * sum_p min(pos_p + 1, MB * BT) * Hkv * Dh * sizeof(T) bytes (less the
// unmapped entries), about 7 operations per byte in bf16 at G = 7: bound
// by device-memory bytes.
//
// Design (the split-K, cp.async-pipelined, tensor-core machinery is in
// decode_attention.cuh): a row's range is its tokens [0, min(pos + 1,
// MB * BT)); a split reads the table entries its slice spans into shared
// memory once and finds each token's pool block there, so a tile may
// gather from several blocks.  Tokens past pos are never read (weight
// exactly 0); tokens of an unmapped entry are not read and weigh 0.  A row
// with no mapped token at or before pos keeps the TPU kernel's result:
// every mapped token of its whole table at NEG_INF (the mean of V over the
// mapped slots), or zeros when no entry is mapped.  Against the first
// port: the grid is rows x heads x splits instead of one block per (row,
// head), and loads overlap the math.
#include "decode_attention.cuh"

namespace {

using namespace decode_attention;

template <typename T, int DMAX>
__global__ void __launch_bounds__(kThreads)
paged_attention_kernel(Params prm) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Coords c = coords(prm);
  load_q<T>(prm, c, smem);
  const int bt = prm.bt, mb = prm.mb, nb = prm.nb, pos = prm.positions[c.p];
  const int* row = prm.tables + (long long)c.p * mb;
  // is any entry that holds a token at or before pos mapped?
  const int nvb = pos < 0 ? 0 : min(pos / bt + 1, mb);
  bool found = false;
  for (int i = threadIdx.x; i < nvb && !found; i += kThreads) {
    const int e = row[i];
    found = e >= 0 && e < nb;
  }
  const bool any = __syncthreads_or(found);
  const int n = any ? min(pos, mb * bt - 1) + 1 : mb * bt;
  const Slice sl = split_slice(n, prm.splits, c.s);
  // the table entries the slice spans
  int* tab = reinterpret_cast<int*>(smem + tab_offset<T>(prm.dh));
  const int e0 = sl.j0 / bt;
  const int ne = sl.j1 > sl.j0 ? (sl.j1 - 1) / bt - e0 + 1 : 0;
  for (int i = threadIdx.x; i < ne; i += kThreads) tab[i] = row[e0 + i];
  __syncthreads();
  const int hkv = prm.hkv, h = c.h, dh = prm.dh;
  run<T, DMAX>(
      prm, c, sl, !any,
      [=](int j) -> long long {
        const int e = tab[j / bt - e0];
        if (e < 0 || e >= nb) return -1;
        return (((long long)e * bt + j % bt) * hkv + h) * dh;
      },
      smem);
}

template <typename T, int DMAX>
int launch(const Params& prm, cudaStream_t stream) {
  return launch_clusters(paged_attention_kernel<T, DMAX>, prm,
                         smem_bytes<T>(prm.dh, prm.tab_cap), stream);
}

template <typename T>
int dispatch(const Params& prm, cudaStream_t stream) {
  if (prm.dh <= 64) return launch<T, 64>(prm, stream);
  if (prm.dh <= 128) return launch<T, 128>(prm, stream);
  return launch<T, 256>(prm, stream);
}

template <typename T>
cudaError_t prepare_all() {
  cudaError_t e = prepare_kernel(paged_attention_kernel<T, 64>);
  if (e == cudaSuccess) e = prepare_kernel(paged_attention_kernel<T, 128>);
  if (e == cudaSuccess) e = prepare_kernel(paged_attention_kernel<T, 256>);
  return e;
}

}  // namespace

// Entry points, bound to Python by binding.cpp.
//
// q (P, Hkv, G, Dh), k/v_pool (NB, BT, Hkv, Dh), out (P, Hkv, G, Dh):
// contiguous, one dtype (bf16 when is_bf16, else f32), pools 16-byte
// aligned; tables (P, MB) and positions (P,) int32; splits as for
// partition_attention.  Returns the CUDA error code of the launch (0 on
// success).
int paged_attention(const void* q, const void* k, const void* v,
                    const void* tables, const void* positions, void* out,
                    int p, int nb, int bt, int mb, int hkv, int g, int dh,
                    int splits, int is_bf16, float scale, float cap,
                    void* stream) {
  Params prm = {};
  prm.q = q;
  prm.k = k;
  prm.v = v;
  prm.out = out;
  prm.positions = static_cast<const int*>(positions);
  prm.tables = static_cast<const int*>(tables);
  prm.p = p;
  prm.hkv = hkv;
  prm.g = g;
  prm.dh = dh;
  prm.splits = splits;
  prm.g_blocks = (g + kRows - 1) / kRows;
  prm.nb = nb;
  prm.bt = bt;
  prm.mb = mb;
  prm.scale = scale;
  prm.cap = cap;
  if (nb <= 0 || bt <= 0 || mb <= 0 || (long long)mb * bt > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  if (const int e = check_common(prm)) return e;
  // the longest slice (split_slice at n = MB * BT) spans at most
  // len / BT + 2 table entries
  const int n = mb * bt;
  const int len = ((n + splits - 1) / splits + 15) / 16 * 16;
  prm.tab_cap = len / bt + 2;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? dispatch<__nv_bfloat16>(prm, s) : dispatch<float>(prm, s);
}

// Loads the kernels' code onto the current device without launching them,
// so that a first launch inside a timed region pays no module load, and
// lets them take more than 48 KB of shared memory and clusters of 16.
int paged_attention_prepare() {
  cudaError_t e = prepare_all<__nv_bfloat16>();
  if (e == cudaSuccess) e = prepare_all<float>();
  return (int)e;
}
