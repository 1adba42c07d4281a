// Block migration (compaction) of the vanilla paged KV pool, in place.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/kv_compact.py::kv_compact
// and computes what the JAX oracle computes for the live moves:
// pool[dst[i]] = pool[src[i]] for every pool leaf, each block copied as
// opaque bytes, blocks not named left untouched (the TPU kernel's
// input_output_aliases).  The moves arrive already filtered and checked by
// the wrapper (ops.kv_compact): every src and dst in range, no two moves
// with one dst, and no dst that is another move's src.  Under that rule the
// moves are independent, so running them all at once gives the oracle's
// gather-then-scatter result.
//
// Bound on the H100: pure data movement, every byte of the moved blocks is
// read once and written once, 2 * M * block_bytes over the device-memory
// rate (2 * 128 * 1,835,008 B = 470 MB, 0.14 ms, for the engine's two
// (NB, 32, 28, 4, 128) bf16 leaves at 128 moves).
//
// Design: the TPU kernel's sequential grid of one whole-block DMA per move
// becomes one launch over (chunk of a block, move, leaf), all in parallel.
// The copy unit is the widest of 16, 8, 4, 2 or 1 bytes that divides every
// leaf's block size and base address (16-byte vectors for the KV pools),
// chosen by the caller, and each thread issues kUnroll loads before its
// stores so that many copies are in flight, as in kv_snapshot.cu.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxLeaves = 32;
constexpr unsigned kMaxBlocksX = 1024;
constexpr int kUnroll = 4;   // copies in flight per thread

struct Pools {
  void* ptr[kMaxLeaves];
  long long block_units[kMaxLeaves];   // copy units in one block of the leaf
};

template <typename U>
__global__ void __launch_bounds__(kThreads)
kv_compact_kernel(const Pools pools, const int* __restrict__ moves,
                  int n_moves) {
  const long long n = pools.block_units[blockIdx.z];
  U* base = static_cast<U*>(pools.ptr[blockIdx.z]);
  const U* src = base + (long long)moves[blockIdx.y] * n;
  U* dst = base + (long long)moves[n_moves + blockIdx.y] * n;
  const long long stride = (long long)gridDim.x * kThreads;
  long long u = (long long)blockIdx.x * kThreads + threadIdx.x;
  for (; u + (kUnroll - 1) * stride < n; u += kUnroll * stride) {
    U v[kUnroll];
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) v[j] = src[u + j * stride];
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) dst[u + j * stride] = v[j];
  }
  for (; u < n; u += stride) dst[u] = src[u];
}

template <typename U>
int launch(const Pools& pools, int n_leaves, const void* moves, int n_moves,
           long long most, cudaStream_t stream) {
  const long long bx = (most + kThreads * kUnroll - 1) / (kThreads * kUnroll);
  dim3 grid(bx < kMaxBlocksX ? (unsigned)bx : kMaxBlocksX, n_moves, n_leaves);
  kv_compact_kernel<U><<<grid, kThreads, 0, stream>>>(
      pools, static_cast<const int*>(moves), n_moves);
  return (int)cudaGetLastError();
}

template <typename U>
cudaError_t prepare_one() {
  cudaFuncAttributes a;
  return cudaFuncGetAttributes(&a, kv_compact_kernel<U>);
}

}  // namespace

// Entry points, bound to Python by binding.cpp.
//
// ptrs[n_leaves]: base addresses of the pool leaves; block_bytes[n_leaves]:
// bytes of one block of each leaf, a multiple of unit_bytes; moves: int32 on
// the device, n_moves sources followed by n_moves destinations.  Returns the
// CUDA error code of the launch (0 on success).
int kv_compact(const void* const* ptrs, const long long* block_bytes,
               int n_leaves, const void* moves, int n_moves, int unit_bytes,
               void* stream) {
  if (n_leaves <= 0 || n_leaves > kMaxLeaves || n_moves <= 0 ||
      n_moves > 65535 || unit_bytes <= 0)
    return (int)cudaErrorInvalidValue;
  Pools pools = {};
  long long most = 0;
  for (int l = 0; l < n_leaves; ++l) {
    if (block_bytes[l] <= 0 || block_bytes[l] % unit_bytes != 0)
      return (int)cudaErrorInvalidValue;
    pools.ptr[l] = const_cast<void*>(ptrs[l]);
    pools.block_units[l] = block_bytes[l] / unit_bytes;
    if (pools.block_units[l] > most) most = pools.block_units[l];
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (unit_bytes) {
    case 16: return launch<uint4>(pools, n_leaves, moves, n_moves, most, s);
    case 8: return launch<uint2>(pools, n_leaves, moves, n_moves, most, s);
    case 4: return launch<uint32_t>(pools, n_leaves, moves, n_moves, most, s);
    case 2: return launch<uint16_t>(pools, n_leaves, moves, n_moves, most, s);
    case 1: return launch<uint8_t>(pools, n_leaves, moves, n_moves, most, s);
  }
  return (int)cudaErrorInvalidValue;
}

// Loads the kernels' code onto the current device without launching them,
// so that a first launch inside a timed region pays no module load.
int kv_compact_prepare() {
  cudaError_t e = cudaSuccess;
  cudaError_t (*fns[])() = {prepare_one<uint4>, prepare_one<uint2>,
                            prepare_one<uint32_t>, prepare_one<uint16_t>,
                            prepare_one<uint8_t>};
  for (auto fn : fns)
    if (e == cudaSuccess) e = fn();
  return (int)e;
}
