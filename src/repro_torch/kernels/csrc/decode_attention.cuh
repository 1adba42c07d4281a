// Split-K, pipelined, tensor-core decode attention: the machinery shared by
// csrc/partition_attention.cu and csrc/paged_attention.cu.
//
// Both replace Pallas TPU kernels that compute, for each row p and KV head
// h, the G query heads of the group attending over the row's K/V with
// online softmax in f32, masked slots scored NEG_INF = -2**30 (finite) and
// a final divide by max(l, 1e-30):
//   src/repro/kernels/partition_attention.py:70 (ring rows, window, cap)
//   src/repro/kernels/paged_attention.py:65     (block tables, -1 skipped)
// The two kernels here differ only in how the address of a row's j-th
// token is found (a ring slot, or a table entry); this header is the rest.
//
// Bound on the H100: the K and V of every valid token, read once, over
// 3.35 TB/s.  A token costs 4 * G * Dh operations for 2 * Dh * sizeof(T)
// bytes, about 7 operations per byte in bf16 at G = 7: far below the ~295
// where the tensor cores would bind, so the kernels are bound by bytes and
// the design is about keeping enough bytes in flight on every SM.
//
// Design, against the four faults of the first port (P * Hkv blocks of
// blocking 16-byte loads over every ring slot, shuffle-bound scores):
//  1. Split-K over the *valid* range.  Each row's valid tokens are a
//     logical range [0, n) (the ring range ending at pos, or the table's
//     tokens up to pos).  Block (row group, split s) takes the s-th slice
//     of ceil(n / S) tokens rounded up to 16; the host picks S from the
//     shapes alone (kernels/partition_attention.py::num_splits) so that
//     the grid fills the SMs.  Tokens that carry no weight are never read:
//     their weight exp(NEG_INF - m) is exactly 0, so skipping them changes
//     no bit.  An empty slice writes an empty partial (m = NEG_INF, l = 0,
//     acc = 0) and reads no K/V.
//  2. A ring of kStages shared-memory stages of kTile tokens of K and V,
//     filled by cp.async.cg 16-byte copies (zero-fill for skipped tokens),
//     so that the next tiles' loads are in flight while a tile is used.
//  3. bf16: mma.sync m16n8k16 with f32 accumulation, the G <= 16 query
//     heads of a block padded to 16 rows.  S = Q K^T takes K as the B
//     operand through ldmatrix; the online softmax runs on the accumulator
//     fragments (row max and sum by quad shuffles, in units of log2 so that
//     each exponential is one ex2); P goes to bf16 in registers as the A
//     operand of P V, with V through ldmatrix.trans (FlashAttention-2's
//     register layout; the bf16 cast of P is the Pallas kernels'
//     p.astype(v.dtype)).  f32 keeps CUDA-core FMAs in the same fragment
//     layout, split and pipeline (TF32 would lose 2e-5).
//  4. Each warp keeps its own (m, l, acc) over its 16 tokens of every
//     tile; the block merges its warps in shared memory.  The S blocks of
//     one (row, KV head, query block) are one thread-block cluster, and
//     merge their f32 partials through distributed shared memory, each
//     block writing a share of the output: one launch a call, with no
//     workspace in device memory and no serial merge by one last block.
//  5. Partials (Params::top set): the cluster's merge writes the row's
//     merged max (natural-log units), normaliser and unnormalised output
//     in f32 instead of the output, so that the blocks of a ring split
//     over ranks merge as one softmax (kernels/ref.py's `partials`).
//
// Rows with no valid token keep the Pallas semantics: the kernels give
// such a row its full range with every score at NEG_INF (the mean of V),
// and the merges never form exp(-inf - -inf): every m is >= NEG_INF.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <cooperative_groups.h>

#include <map>
#include <type_traits>
#include <utility>

namespace decode_attention {

// 64 threads, 2 stages of 32 tokens: about 39 KB of shared memory at
// Dh = 128 in bf16, 5 blocks an SM (the occupancy query below, which
// kernels/partition_attention.py::blocks_per_sm asks for the split
// count's one-wave term).  More blocks with one tile in flight each beat
// fewer with two: a block's tile loop waits on its own instructions more
// than on its bytes (at 64 rows of qwen2-7b on an H100, 3 stages and 4
// blocks an SM took 0.078 ms at their best split count, 2 stages 0.071 ms;
// launch/attention_sweep.py)
constexpr int kWarps = 2;                  // 16 tokens of each tile a warp
constexpr int kThreads = 32 * kWarps;
constexpr int kTile = 16 * kWarps;         // tokens per pipeline stage
constexpr int kStages = 2;
constexpr int kRows = 16;                  // query heads a block (mma M)
constexpr int kMaxDh = 256;
// At most this many splits: the splits of a row group are one cluster,
// and 16 is the largest cluster Hopper schedules (non-portable above 8).
// kernels/partition_attention.py::MAX_SPLITS is the same.
constexpr int kMaxSplits = 16;
constexpr float kNegInf = -1073741824.0f;  // -2**30, NEG_INF of the TPU kernels
constexpr float kLog2e = 1.4426950408889634f;

// Everything a launch needs; one struct for both kernels.
struct Params {
  const void* q;        // (P, Hkv, G, Dh)
  const void* k;        // ring block (P, T, Hkv, Dh) or pool (NB, BT, Hkv, Dh)
  const void* v;
  void* out;            // (P, Hkv, G, Dh): q's dtype, or f32 acc (partials)
  float* top;           // (P, Hkv, G) f32, partials only (else null)
  float* lsum;          // (P, Hkv, G) f32, partials only
  const int* positions; // (P,)
  const int* tables;    // (P, MB), paged only
  int p, hkv, g, dh, splits, g_blocks;
  int t_len, window;    // ring: t_len slots of K/V rows held here
  int t_ring, off;      // ring: they are slots [off, off + t_len) of t_ring
  int nb, bt, mb, tab_cap;   // paged; tab_cap = table entries a slice spans
  float scale, cap;
};

template <typename T>
__host__ __device__ inline int row_ld(int dh) {
  return dh + 16 / (int)sizeof(T);         // one 16-byte pad: no bank conflicts
}
template <typename T>
__host__ __device__ inline size_t stage_bytes(int dh) {
  return 2 * (size_t)kTile * row_ld<T>(dh) * sizeof(T);   // K and V
}
// Dynamic shared memory: stages | live flags | q | f32 P (f32 only) | table
template <typename T>
__host__ __device__ inline size_t live_offset(int dh) {
  return kStages * stage_bytes<T>(dh);
}
template <typename T>
__host__ __device__ inline size_t q_offset(int dh) {
  return live_offset<T>(dh) + kStages * kTile;
}
template <typename T>
__host__ __device__ inline size_t p_offset(int dh) {
  return q_offset<T>(dh) + (size_t)kRows * row_ld<T>(dh) * sizeof(T);
}
template <typename T>
__host__ __device__ inline size_t tab_offset(int dh) {
  const bool f32 = std::is_same<T, float>::value;
  return p_offset<T>(dh) + (f32 ? sizeof(float) * kWarps * 16 * 16 : 0);
}
// The block merges its warps' and then its cluster's partials in the same
// shared memory once the tile loop is done (run, below): f32 (m, l, acc)
// of each warp, the block's partial, and every split's weights
__host__ __device__ inline size_t merge_bytes(int dh) {
  return sizeof(float) *
         ((size_t)kWarps * kRows * (dh + 8) + 2 * kWarps * kRows +
          (size_t)kRows * dh + 3 * kRows + 2 * kRows * kMaxSplits);
}
template <typename T>
__host__ __device__ inline size_t smem_bytes(int dh, int tab_cap) {
  const size_t layout = tab_offset<T>(dh) + sizeof(int) * (size_t)tab_cap;
  return layout > merge_bytes(dh) ? layout : merge_bytes(dh);
}

// The s-th slice of a range of n tokens over `splits` slices, as
// kernels/partition_attention.py::split_bounds computes it.
struct Slice { int j0, j1; };
__device__ inline Slice split_slice(int n, int splits, int s) {
  const int len = ((n + splits - 1) / splits + 15) / 16 * 16;
  const long long j0 = (long long)s * len;
  Slice r;
  r.j0 = j0 < n ? (int)j0 : n;
  r.j1 = j0 + len < n ? (int)(j0 + len) : n;
  return r;
}

// Which block this is: (row p, kv head h, query block gb, split s).
struct Coords { int p, h, gb, s, r, g0, ng; };
__device__ inline Coords coords(const Params& prm) {
  Coords c;
  const int b = blockIdx.x;
  c.s = b % prm.splits;
  c.r = b / prm.splits;                    // (p * Hkv + h) * g_blocks + gb
  c.gb = c.r % prm.g_blocks;
  c.h = (c.r / prm.g_blocks) % prm.hkv;
  c.p = c.r / (prm.g_blocks * prm.hkv);
  c.g0 = c.gb * kRows;
  c.ng = min(kRows, prm.g - c.g0);
  return c;
}

// ------------------------------------------------------------ primitives

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r,
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}
// c += a (16x16 bf16, row) * b (16x8 bf16, col), f32 accumulate
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}
__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* o, float x) { *o = x; }
__device__ __forceinline__ void store(__nv_bfloat16* o, float x) {
  *o = __float2bfloat16(x);
}
// 2**x in one instruction (2 ulp; 2**-inf = 0): scores are kept in units
// of log2 so that exp(s - m) = 2**(s * log2(e) - m * log2(e))
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// ------------------------------------------------------------ tile math
//
// Fragment layout (mma.sync m16n8k16, C operand): s[nb][e] is the score of
// query row (lane / 4 + 8 * (e / 2)) and token (w * 16 + nb * 8 +
// 2 * (lane % 4) + e % 2) of the tile; acc[nn][e] is output row
// (lane / 4 + 8 * (e / 2)), column (nn * 8 + 2 * (lane % 4) + e % 2).

template <typename T, int DMAX>
__device__ __forceinline__ void tile_scores(float (&s)[2][4], const T* q_s,
                                            const T* k_st, int ld, int dh,
                                            int w, int lane) {
#pragma unroll
  for (int nb = 0; nb < 2; ++nb)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[nb][e] = 0.f;
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    // A = Q (16 rows x 16 of Dh), B = K^T (16 of Dh x 8 tokens), twice
    const T* qa = q_s + (lane & 15) * ld + (lane >> 4) * 8;
    const T* kb = k_st + (w * 16 + (lane & 7) + (lane >> 4) * 8) * ld +
                  ((lane >> 3) & 1) * 8;
    // two accumulator chains (even and odd steps of Dh) halve the chain
    // of dependent mma
    float t[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
    for (int kk = 0; kk < DMAX / 16; ++kk) {
      if (kk * 16 < dh) {
        uint32_t a[4], b[4];
        ldmatrix_x4(a, qa + kk * 16);
        ldmatrix_x4(b, kb + kk * 16);
        float (&acc)[2][4] = (kk & 1) ? t : s;
        mma_bf16(acc[0], a, b[0], b[1]);
        mma_bf16(acc[1], a, b[2], b[3]);
      }
    }
#pragma unroll
    for (int nb = 0; nb < 2; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nb][e] += t[nb][e];
  } else {
#pragma unroll
    for (int nb = 0; nb < 2; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float4* qr = reinterpret_cast<const float4*>(
            q_s + ((lane >> 2) + 8 * (e >> 1)) * ld);
        const float4* kr = reinterpret_cast<const float4*>(
            k_st + (w * 16 + nb * 8 + 2 * (lane & 3) + (e & 1)) * ld);
        float x = 0.f;
        for (int d = 0; d < dh / 4; ++d) {
          const float4 a = qr[d], b = kr[d];
          x = fmaf(a.x, b.x, x);
          x = fmaf(a.y, b.y, x);
          x = fmaf(a.z, b.z, x);
          x = fmaf(a.w, b.w, x);
        }
        s[nb][e] = x;
      }
  }
}

// acc += P (16 rows x the warp's 16 tokens) V (16 tokens x Dh)
template <typename T, int DMAX>
__device__ __forceinline__ void tile_pv(float (&acc)[DMAX / 8][4],
                                        const float (&p)[2][4],
                                        const T* v_st, float* p_s, int ld,
                                        int dh, int w, int lane) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    // the score fragments are the A operand once packed to bf16
    const uint32_t a[4] = {pack_bf16(p[0][0], p[0][1]),
                           pack_bf16(p[0][2], p[0][3]),
                           pack_bf16(p[1][0], p[1][1]),
                           pack_bf16(p[1][2], p[1][3])};
    const T* vb = v_st + (w * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * ld +
                  (lane >> 4) * 8;
#pragma unroll
    for (int nn = 0; nn < DMAX / 16; ++nn) {
      if (nn * 16 < dh) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, vb + nn * 16);
        mma_bf16(acc[2 * nn], a, b[0], b[1]);
        mma_bf16(acc[2 * nn + 1], a, b[2], b[3]);
      }
    }
  } else {
    float* pw = p_s + w * 256;                 // [16 rows][16 tokens]
#pragma unroll
    for (int nb = 0; nb < 2; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        pw[((lane >> 2) + 8 * (e >> 1)) * 16 + nb * 8 + 2 * (lane & 3) +
           (e & 1)] = p[nb][e];
    __syncwarp();
    const T* vw = v_st + w * 16 * ld;
#pragma unroll
    for (int nn = 0; nn < DMAX / 8; ++nn) {
      if (nn * 8 < dh) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float* pr = pw + ((lane >> 2) + 8 * (e >> 1)) * 16;
          const int d = nn * 8 + 2 * (lane & 3) + (e & 1);
          float x = acc[nn][e];
#pragma unroll
          for (int t = 0; t < 16; ++t) x = fmaf(pr[t], to_f(vw[t * ld + d]), x);
          acc[nn][e] = x;
        }
      }
    }
    __syncwarp();                              // pw is rewritten next tile
  }
}

// The block's query heads into shared memory, zero-padded to 16 rows, as
// one cp.async group: the kernels issue it first, before they read the
// positions, and the first tile's wait covers it.
template <typename T>
__device__ __forceinline__ void load_q(const Params& prm, const Coords& c,
                                       unsigned char* smem) {
  const int dh = prm.dh, ld = row_ld<T>(dh), vec = 16 / (int)sizeof(T);
  const int cpr = dh / vec;
  T* q_s = reinterpret_cast<T*>(smem + q_offset<T>(dh));
  const T* q = static_cast<const T*>(prm.q) +
               ((long long)(c.p * prm.hkv + c.h) * prm.g + c.g0) * dh;
  for (int i = threadIdx.x; i < kRows * cpr; i += kThreads) {
    const int g = i / cpr, ch = i - g * cpr;
    const bool ok = g < c.ng;
    cp_async16(q_s + g * ld + ch * vec, ok ? q + g * dh + ch * vec : q,
               ok ? 16 : 0);
  }
  cp_async_commit();
}

// ------------------------------------------------------------ the body
//
// Runs block (c) over the tokens [sl.j0, sl.j1) of its row: `offset(j)`
// gives the element offset of token j's K/V vector for this KV head, or
// -1 for a token that carries no weight at all (an unmapped table entry);
// `masked` scores every other token NEG_INF (a row with no valid token).
// Writes the block's partial, and the last block of the row group merges
// every split's partial into the output.
template <typename T, int DMAX, class Offset>
__device__ __forceinline__ void run(const Params& prm, const Coords& c,
                                    Slice sl, bool masked, Offset offset,
                                    unsigned char* smem) {
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int dh = prm.dh, ld = row_ld<T>(dh);
  T* stages = reinterpret_cast<T*>(smem);
  unsigned char* live = smem + live_offset<T>(dh);
  T* q_s = reinterpret_cast<T*>(smem + q_offset<T>(dh));
  float* p_s = reinterpret_cast<float*>(smem + p_offset<T>(dh));
  const T* k = static_cast<const T*>(prm.k);
  const T* v = static_cast<const T*>(prm.v);

  const long long q_off =
      ((long long)(c.p * prm.hkv + c.h) * prm.g + c.g0) * dh;

  const int vec = 16 / (int)sizeof(T), cpr = dh / vec;
  const int n_tiles = (sl.j1 - sl.j0 + kTile - 1) / kTile;
  auto load = [&](int t) {
    const int st = t % kStages;
    T* ks = stages + (size_t)st * 2 * kTile * ld;
    T* vs = ks + kTile * ld;
    const int jt = sl.j0 + t * kTile;
    for (int i = tid; i < kTile * cpr; i += kThreads) {
      const int key = i / cpr, ch = i - key * cpr, j = jt + key;
      const long long off = j < sl.j1 ? offset(j) : -1;
      const bool ok = off >= 0;
      const long long src = ok ? off + ch * vec : 0;
      cp_async16(ks + key * ld + ch * vec, k + src, ok ? 16 : 0);
      cp_async16(vs + key * ld + ch * vec, v + src, ok ? 16 : 0);
      if (ch == 0) live[st * kTile + key] = ok;
    }
  };

  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float acc[DMAX / 8][4];
#pragma unroll
  for (int nn = 0; nn < DMAX / 8; ++nn)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nn][e] = 0.f;

#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) {
    if (t < n_tiles) load(t);
    cp_async_commit();
  }
  for (int t = 0; t < n_tiles; ++t) {
    if (t + kStages - 1 < n_tiles) load(t + kStages - 1);
    cp_async_commit();
    cp_async_wait<kStages - 1>();              // tile t has landed
    __syncthreads();
    const int st = t % kStages;
    const T* ks = stages + (size_t)st * 2 * kTile * ld;
    const T* vs = ks + kTile * ld;
    const unsigned char* lv = live + st * kTile;

    float s[2][4];
    tile_scores<T, DMAX>(s, q_s, ks, ld, dh, w, lane);
#pragma unroll
    for (int nb = 0; nb < 2; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[nb][e] * prm.scale;
        if (prm.cap > 0.f) x = tanhf(x / prm.cap) * prm.cap;
        x *= kLog2e;
        const int key = w * 16 + nb * 8 + 2 * (lane & 3) + (e & 1);
        s[nb][e] = !lv[key] ? -INFINITY : (masked ? kNegInf : x);
      }
    // online softmax of rows lane/4 (hh = 0) and lane/4 + 8 (hh = 1), in
    // units of log2; m starts at NEG_INF, so a token at -inf weighs exactly
    // 0, and NEG_INF's weight beside a valid score is 2**(-2**30) = 0
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const float mx = quad_max(fmaxf(fmaxf(s[0][2 * hh], s[0][2 * hh + 1]),
                                      fmaxf(s[1][2 * hh], s[1][2 * hh + 1])));
      const float mn = fmaxf(m[hh], mx);
      const float corr = ex2(m[hh] - mn);
      m[hh] = mn;
      float sum = 0.f;
#pragma unroll
      for (int nb = 0; nb < 2; ++nb)
#pragma unroll
        for (int e = 2 * hh; e < 2 * hh + 2; ++e) {
          s[nb][e] = ex2(s[nb][e] - mn);
          sum += s[nb][e];
        }
      l[hh] = l[hh] * corr + sum;              // per thread; quad-summed last
#pragma unroll
      for (int nn = 0; nn < DMAX / 8; ++nn) {
        acc[nn][2 * hh] *= corr;
        acc[nn][2 * hh + 1] *= corr;
      }
    }
    tile_pv<T, DMAX>(acc, s, vs, p_s, ld, dh, w, lane);
    __syncthreads();                           // stage st is refilled next
  }
  cp_async_wait<0>();
  __syncthreads();

  // merge the warps in shared memory (every region is free now; smem_bytes
  // holds at least merge_bytes): the block's partial, (m, l) and acc of its
  // 16 rows, stays in its own shared memory for the cluster's merge
  const int sld = dh + 8;                           // 2-way bank conflicts
  float* sc_acc = reinterpret_cast<float*>(smem);   // [kWarps][16][sld]
  float* sc_m = sc_acc + kWarps * kRows * sld;      // [kWarps][16]
  float* sc_l = sc_m + kWarps * kRows;
  float* part_acc = sc_l + kWarps * kRows;          // [16][dh]
  float* part_m = part_acc + kRows * dh;            // [16]
  float* part_l = part_m + kRows;
  float* wgt = part_l + kRows;                      // [16][kMaxSplits]
  float* lsum = wgt + kRows * kMaxSplits;           // [16][kMaxSplits]
  float* denom = lsum + kRows * kMaxSplits;         // [16]
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) l[hh] = quad_sum(l[hh]);
#pragma unroll
  for (int nn = 0; nn < DMAX / 8; ++nn)
    if (nn * 8 < dh)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
        *reinterpret_cast<float2*>(
            sc_acc + (w * kRows + (lane >> 2) + 8 * hh) * sld + nn * 8 +
            2 * (lane & 3)) = make_float2(acc[nn][2 * hh], acc[nn][2 * hh + 1]);
  if ((lane & 3) == 0)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      sc_m[w * kRows + (lane >> 2) + 8 * hh] = m[hh];
      sc_l[w * kRows + (lane >> 2) + 8 * hh] = l[hh];
    }
  __syncthreads();
  // each warp's weight for head g, exp(m_w - max m), in place of m_w
  if (tid < c.ng) {
    float mm = sc_m[tid];
#pragma unroll
    for (int u = 1; u < kWarps; ++u) mm = fmaxf(mm, sc_m[u * kRows + tid]);
    float ll = 0.f;
#pragma unroll
    for (int u = 0; u < kWarps; ++u) {
      const float e = ex2(sc_m[u * kRows + tid] - mm);
      sc_m[u * kRows + tid] = e;
      ll += sc_l[u * kRows + tid] * e;
    }
    part_m[tid] = mm;
    part_l[tid] = ll;
  }
  __syncthreads();
  const int d4 = dh / 4;
  for (int i = tid; i < c.ng * d4; i += kThreads) {
    const int g = i / d4, d = (i - g * d4) * 4;
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int u = 0; u < kWarps; ++u) {
      const float e = sc_m[u * kRows + g];
      const float4 x = *reinterpret_cast<const float4*>(
          sc_acc + (u * kRows + g) * sld + d);
      a.x += x.x * e;
      a.y += x.y * e;
      a.z += x.z * e;
      a.w += x.w * e;
    }
    *reinterpret_cast<float4*>(part_acc + g * dh + d) = a;
  }

  // merge the S partials of the cluster (one split each) through
  // distributed shared memory: every block stages all splits' (m, l),
  // computes their weights exp(m_s - max m) (every m is >= NEG_INF: no
  // exp(-inf - -inf)) and writes its share of the output columns; every
  // remote load of a loop is issued before the first is used
  cooperative_groups::cluster_group cluster =
      cooperative_groups::this_cluster();
  cluster.sync();
  const int splits = prm.splits;
  for (int i = tid; i < c.ng * splits; i += kThreads) {
    const int g = i / splits, s = i - g * splits;
    wgt[g * kMaxSplits + s] = *cluster.map_shared_rank(part_m + g, s);
    lsum[g * kMaxSplits + s] = *cluster.map_shared_rank(part_l + g, s);
  }
  __syncthreads();
  if (tid < c.ng) {
    float* wg = wgt + tid * kMaxSplits;
    float mm = kNegInf;
    for (int s = 0; s < splits; ++s) mm = fmaxf(mm, wg[s]);
    float ll = 0.f;
    for (int s = 0; s < splits; ++s) {
      wg[s] = ex2(wg[s] - mm);
      ll += lsum[tid * kMaxSplits + s] * wg[s];
    }
    denom[tid] = fmaxf(ll, 1e-30f);
    if (prm.top != nullptr && c.s == 0) {
      // the row's partials: its max in natural-log units (NEG_INF itself
      // where no token of the block scored: a masked row, or a block with
      // no valid slot) and the normaliser at that max
      const long long o = (long long)(c.p * prm.hkv + c.h) * prm.g + c.g0 +
                          tid;
      prm.top[o] = mm == kNegInf ? kNegInf : mm * (1.0f / kLog2e);
      prm.lsum[o] = ll;
    }
  }
  __syncthreads();
  const bool partials = prm.top != nullptr;
  T* out = static_cast<T*>(prm.out) + q_off;
  float* acc_out = static_cast<float*>(prm.out) + q_off;
  for (int i = c.s * kThreads + tid; i < c.ng * d4; i += splits * kThreads) {
    const int g = i / d4, d = (i - g * d4) * 4;
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int s0 = 0; s0 < splits; s0 += 4) {   // 4 remote loads in flight
      float4 x[4];
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (s0 + u < splits)
          x[u] = *reinterpret_cast<const float4*>(
              cluster.map_shared_rank(part_acc + g * dh + d, s0 + u));
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (s0 + u < splits) {
          const float e = wgt[g * kMaxSplits + s0 + u];
          a.x += x[u].x * e;
          a.y += x[u].y * e;
          a.z += x[u].z * e;
          a.w += x[u].w * e;
        }
    }
    if (partials) {                  // unnormalised, f32
      *reinterpret_cast<float4*>(acc_out + g * dh + d) = a;
      continue;
    }
    const float dn = denom[g];
    store(out + g * dh + d, a.x / dn);
    store(out + g * dh + d + 1, a.y / dn);
    store(out + g * dh + d + 2, a.z / dn);
    store(out + g * dh + d + 3, a.w / dn);
  }
  cluster.sync();   // every block's partial stays readable until all read
}

// ------------------------------------------------------------ host side

// Checks what every launch needs; the kernel-specific checks are the
// caller's.  Returns a CUDA error code, 0 when the launch may go ahead.
inline int check_common(const Params& prm) {
  if (prm.p <= 0 || prm.hkv <= 0 || prm.g <= 0 || prm.dh < 16 ||
      prm.dh > kMaxDh || prm.dh % 16 != 0 || prm.splits < 1 ||
      prm.splits > kMaxSplits || prm.g_blocks != (prm.g + kRows - 1) / kRows)
    return (int)cudaErrorInvalidValue;
  const long long blocks =
      (long long)prm.p * prm.hkv * prm.g_blocks * prm.splits;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  return 0;
}

// Lets `kernel` take the device's whole opt-in shared memory (above the
// default 48 KB a launch may ask for) and clusters of up to 16 blocks.
template <class Kernel>
inline cudaError_t prepare_kernel(Kernel kernel) {
  int dev = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  cudaFuncAttributes a;
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&a, kernel);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             optin - (int)a.sharedSizeBytes);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  return e;
}

// How many clusters of `splits` blocks of `kernel`, each block with `smem`
// bytes of shared memory, the card holds at once, and how many of its
// blocks one SM holds: what decides how many waves a grid of clusters
// takes (the split count's one-wave term reads the second;
// launch/attention_sweep.py prints both).  Returns a CUDA error code, 0 on
// success.
template <class Kernel>
inline int occupancy(Kernel kernel, int splits, size_t smem, int* clusters,
                     int* blocks_per_sm) {
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3(splits, 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t e = cudaOccupancyMaxActiveClusters(clusters, kernel, &cfg);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, kernel,
                                                      kThreads, smem);
  return (int)e;
}

// Launches `kernel` with one cluster per row group: the splits of a group
// are one cluster.  Where the card cannot hold a cluster of prm.splits
// blocks with this much shared memory, the row is cut into fewer splits
// (the largest cluster it can hold; split_slice covers the range for any
// count).  The answer is cached per kernel and shared-memory size.
template <class Kernel>
inline int launch_clusters(Kernel kernel, Params prm, size_t smem,
                           cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const int groups = prm.p * prm.hkv * prm.g_blocks;
  if (prm.splits > 8) {
    static std::map<std::pair<const void*, size_t>, int> fits;
    const auto key = std::make_pair((const void*)kernel, smem);
    auto it = fits.find(key);
    if (it == fits.end()) {
      int n = 0;
      attr[0].val.clusterDim.x = 1;
      attr[0].val.clusterDim.y = 1;
      attr[0].val.clusterDim.z = 1;
      cfg.gridDim = dim3(kMaxSplits, 1, 1);
      cfg.numAttrs = 0;          // the query takes no cluster attribute
      const cudaError_t e =
          cudaOccupancyMaxPotentialClusterSize(&n, kernel, &cfg);
      cfg.numAttrs = 1;
      if (e != cudaSuccess) return (int)e;
      it = fits.emplace(key, n).first;
    }
    if (it->second < 1) return (int)cudaErrorInvalidConfiguration;
    prm.splits = it->second < prm.splits ? it->second : prm.splits;
  }
  cfg.gridDim = dim3(groups * prm.splits, 1, 1);
  attr[0].val.clusterDim.x = prm.splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, prm);
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}

}  // namespace decode_attention
