// Fused snapshot capture (gather) and restore (scatter) of arena rows.
//
// Replaces the Pallas TPU kernels
//   src/repro/kernels/kv_snapshot.py::snapshot_capture
//   src/repro/kernels/kv_snapshot.py::snapshot_restore
// Capture gathers row rows[i] of every cache leaf, each along its own batch
// axis, into row i of one contiguous (N, row_elems) blob; the leaves' slices
// sit at the RowLayout offsets in C order and tree-flatten order, so the
// blob's bytes equal the JAX blob's bytes.  Restore is the exact inverse
// scatter, written in place into the live leaves (the TPU kernel's
// input_output_aliases): rows not named are never touched.
//
// Bound on the H100: pure data movement, every byte of the selected rows is
// read once and written once, 2 * N * row_bytes over the device-memory rate.
//
// Design: one launch for all leaves and rows.  A leaf's row slice is
// `outer` chunks of `inner` contiguous elements (outer = product of the dims
// before the batch axis, e.g. n_groups for the stacked (G, P, T, Hkv, Dh)
// KV leaves), so the kernel is a strided copy with no per-element index
// math beyond one division.  Block (x, leaf, i) walks its part of leaf
// `leaf`'s slice of row i; the copy unit is the widest of 16, 8, 4, 2 or 1
// bytes that divides every size, offset and base address (16-byte vectors
// for the KV caches), chosen by the caller.  Each thread issues kUnroll
// loads before its stores, so that many copies are in flight per thread:
// with one at a time the copies reached about a third of the byte rate.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxLeaves = 32;
constexpr unsigned kMaxBlocksX = 1024;
constexpr int kUnroll = 4;   // copies in flight per thread

struct LeafDesc {
  long long outer;    // chunks in one row slice
  long long batch;    // extent of the batch (row) axis
  long long inner;    // units per chunk
  long long offset;   // units from the start of a blob row
};

struct Leaves {
  void* ptr[kMaxLeaves];
  LeafDesc d[kMaxLeaves];
};

template <typename U, bool kCapture>
__global__ void __launch_bounds__(kThreads)
snapshot_kernel(const Leaves leaves, U* __restrict__ blob,
                const int* __restrict__ rows, long long row_units) {
  const LeafDesc d = leaves.d[blockIdx.y];
  const long long row = rows[blockIdx.z];
  U* leaf = static_cast<U*>(leaves.ptr[blockIdx.y]);
  U* brow = blob + blockIdx.z * row_units + d.offset;
  // every slice is under 2**31 units (checked by snapshot_copy) and the
  // stride at most 2**18, so 32-bit index math cannot wrap
  const unsigned n = (unsigned)(d.outer * d.inner);
  const unsigned inner = (unsigned)d.inner;
  const unsigned stride = gridDim.x * kThreads;
  auto leaf_at = [&](unsigned u) {   // unit u of this leaf's row slice
    const unsigned o = u / inner, e = u - o * inner;
    return leaf + ((long long)o * d.batch + row) * d.inner + e;
  };
  unsigned u = blockIdx.x * kThreads + threadIdx.x;
  for (; u + (kUnroll - 1) * stride < n; u += kUnroll * stride) {
    U v[kUnroll];
#pragma unroll
    for (int j = 0; j < kUnroll; ++j)
      v[j] = kCapture ? *leaf_at(u + j * stride) : brow[u + j * stride];
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) {
      if (kCapture)
        brow[u + j * stride] = v[j];
      else
        *leaf_at(u + j * stride) = v[j];
    }
  }
  for (; u < n; u += stride) {
    if (kCapture)
      brow[u] = *leaf_at(u);
    else
      *leaf_at(u) = brow[u];
  }
}

template <typename U, bool kCapture>
int launch(const Leaves& leaves, int n_leaves, void* blob, const void* rows,
           int n_rows, long long row_units, unsigned blocks_x,
           cudaStream_t stream) {
  dim3 grid(blocks_x, n_leaves, n_rows);
  snapshot_kernel<U, kCapture><<<grid, kThreads, 0, stream>>>(
      leaves, static_cast<U*>(blob), static_cast<const int*>(rows),
      row_units);
  return (int)cudaGetLastError();
}

template <bool kCapture>
int dispatch(int unit_bytes, const Leaves& leaves, int n_leaves, void* blob,
             const void* rows, int n_rows, long long row_units,
             unsigned blocks_x, cudaStream_t s) {
  switch (unit_bytes) {
    case 16: return launch<uint4, kCapture>(leaves, n_leaves, blob, rows,
                                            n_rows, row_units, blocks_x, s);
    case 8: return launch<uint2, kCapture>(leaves, n_leaves, blob, rows,
                                           n_rows, row_units, blocks_x, s);
    case 4: return launch<uint32_t, kCapture>(leaves, n_leaves, blob, rows,
                                              n_rows, row_units, blocks_x, s);
    case 2: return launch<uint16_t, kCapture>(leaves, n_leaves, blob, rows,
                                              n_rows, row_units, blocks_x, s);
    case 1: return launch<uint8_t, kCapture>(leaves, n_leaves, blob, rows,
                                             n_rows, row_units, blocks_x, s);
  }
  return (int)cudaErrorInvalidValue;
}

template <typename U, bool kCapture>
cudaError_t prepare_one() {
  cudaFuncAttributes a;
  return cudaFuncGetAttributes(&a, snapshot_kernel<U, kCapture>);
}

}  // namespace

// Entry points, bound to Python by binding.cpp.
//
// capture != 0: gather leaves -> blob; else scatter blob -> leaves.
// ptrs[n_leaves]: leaf base addresses; desc[4 * n_leaves]: per leaf
// (outer, batch, inner, offset) in copy units of unit_bytes; blob
// (n_rows, row_units) units; rows (n_rows,) int32 on the device, each
// already checked to lie in [0, batch).  Returns the CUDA error code of the
// launch (0 on success).
int snapshot_copy(int capture, const void* const* ptrs,
                  const long long* desc, int n_leaves, void* blob,
                  const void* rows, int n_rows, long long row_units,
                  int unit_bytes, void* stream) {
  if (n_leaves <= 0 || n_leaves > kMaxLeaves || n_rows <= 0 ||
      n_rows > 65535)
    return (int)cudaErrorInvalidValue;
  Leaves leaves = {};
  long long most = 0;
  for (int l = 0; l < n_leaves; ++l) {
    leaves.ptr[l] = const_cast<void*>(ptrs[l]);
    leaves.d[l] = {desc[4 * l], desc[4 * l + 1], desc[4 * l + 2],
                   desc[4 * l + 3]};
    const long long n = desc[4 * l] * desc[4 * l + 2];
    if (n <= 0 || n >= (1LL << 31)) return (int)cudaErrorInvalidValue;
    if (n > most) most = n;
  }
  long long bx = (most + kThreads - 1) / kThreads;
  const unsigned blocks_x = bx < kMaxBlocksX ? (unsigned)bx : kMaxBlocksX;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (capture)
    return dispatch<true>(unit_bytes, leaves, n_leaves, blob, rows, n_rows,
                          row_units, blocks_x, s);
  return dispatch<false>(unit_bytes, leaves, n_leaves, blob, rows, n_rows,
                         row_units, blocks_x, s);
}

// Loads the kernels' code onto the current device without launching them,
// so that a first launch inside a timed region pays no module load.
int snapshot_prepare() {
  cudaError_t e = cudaSuccess;
  cudaError_t (*fns[])() = {
      prepare_one<uint4, true>,    prepare_one<uint4, false>,
      prepare_one<uint2, true>,    prepare_one<uint2, false>,
      prepare_one<uint32_t, true>, prepare_one<uint32_t, false>,
      prepare_one<uint16_t, true>, prepare_one<uint16_t, false>,
      prepare_one<uint8_t, true>,  prepare_one<uint8_t, false>};
  for (auto fn : fns)
    if (e == cudaSuccess) e = fn();
  return (int)e;
}
