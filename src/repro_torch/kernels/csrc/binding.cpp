// Python binding of the port's CUDA kernels (partition_attention.cu,
// paged_attention.cu, kv_snapshot.cu, kv_compact.cu, decode_qkv_rope.cu),
// built with
// torch.utils.cpp_extension.load.  This is the one source that includes
// torch's headers; the kernels' own sources see only the CUDA runtime.  The
// Python wrappers (kernels/partition_attention.py, paged_attention.py,
// kv_snapshot.py, kv_compact.py, decode_qkv_rope.py) check devices, dtypes, shapes and alignment
// and pass the current stream; here each entry point hands the tensors'
// pointers to its launcher and raises if the launch was refused.
#include <torch/extension.h>

#include <vector>

int partition_attention(const void* q, const void* k, const void* v,
                        const void* positions, void* out, void* top,
                        void* lsum, int p, int t, int hkv, int g, int dh,
                        int splits, int is_bf16, float scale, float cap,
                        int window, int off, int t_ring, void* stream);
int partition_attention_prepare();
int partition_attention_occupancy(int splits, int dh, int is_bf16,
                                  int* clusters, int* blocks_per_sm);
int paged_attention(const void* q, const void* k, const void* v,
                    const void* tables, const void* positions, void* out,
                    int p, int nb, int bt, int mb, int hkv, int g, int dh,
                    int splits, int is_bf16, float scale, float cap,
                    void* stream);
int paged_attention_prepare();
int snapshot_copy(int capture, const void* const* ptrs,
                  const long long* desc, int n_leaves, void* blob,
                  const void* rows, int n_rows, long long row_units,
                  int unit_bytes, void* stream);
int snapshot_prepare();
int kv_compact(const void* const* ptrs, const long long* block_bytes,
               int n_leaves, const void* moves, int n_moves, int unit_bytes,
               void* stream);
int kv_compact_prepare();
int decode_qkv_rope(const void* q, const void* k, const void* v,
                    const void* bq, const void* bk, const void* bv,
                    const void* positions, const void* freqs, void* k_cache,
                    void* v_cache, void* q_out, int p, int hq, int hkv,
                    int dh, int t, int is_bf16, void* stream);
int decode_qkv_rope_prepare();

namespace {

void check(int err, const char* what) {
  TORCH_CHECK(err == 0, what, " failed: CUDA error ", err);
}

// q (P, Hkv, G, Dh), k/v (P, T, Hkv, Dh) (slots [off, off + T) of a ring
// of t_ring), out like q, positions (P,) int32; splits the slices of each
// row.  With top and lsum (P, Hkv, G) f32 (empty tensors otherwise) the
// call writes its softmax partials, out (f32) unnormalised.
void attention(const torch::Tensor& q, const torch::Tensor& k,
               const torch::Tensor& v, const torch::Tensor& positions,
               const torch::Tensor& out, const torch::Tensor& top,
               const torch::Tensor& lsum, int64_t splits, double scale,
               double cap, int64_t window, int64_t off, int64_t t_ring,
               int64_t stream) {
  check(partition_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), positions.data_ptr(),
            out.data_ptr(), top.numel() ? top.data_ptr() : nullptr,
            lsum.numel() ? lsum.data_ptr() : nullptr, q.size(0), k.size(1),
            q.size(1), q.size(2), q.size(3), splits,
            q.scalar_type() == torch::kBFloat16, scale, cap, window, off,
            t_ring, reinterpret_cast<void*>(stream)),
        "partition_attention launch");
}

// (clusters the card holds at once, blocks an SM) of partition_attention's
// kernel at `splits` blocks a cluster, head dim dh, bf16 or f32
std::vector<int64_t> occupancy(int64_t splits, int64_t dh, bool is_bf16) {
  int clusters = 0, blocks_per_sm = 0;
  check(partition_attention_occupancy(splits, dh, is_bf16, &clusters,
                                      &blocks_per_sm),
        "partition_attention occupancy query");
  return {clusters, blocks_per_sm};
}

// q (P, Hkv, G, Dh), k/v_pool (NB, BT, Hkv, Dh), out like q,
// tables (P, MB) and positions (P,) int32; splits as above
void paged(const torch::Tensor& q, const torch::Tensor& k,
           const torch::Tensor& v, const torch::Tensor& tables,
           const torch::Tensor& positions, const torch::Tensor& out,
           int64_t splits, double scale, double cap, int64_t stream) {
  check(paged_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), tables.data_ptr(),
            positions.data_ptr(), out.data_ptr(), q.size(0), k.size(0),
            k.size(1), tables.size(1), q.size(1), q.size(2), q.size(3),
            splits,
            q.scalar_type() == torch::kBFloat16, scale, cap,
            reinterpret_cast<void*>(stream)),
        "paged_attention launch");
}

// desc: per leaf (outer, batch, inner, offset) in copy units
void snapshot(bool capture, const std::vector<torch::Tensor>& leaves,
              const std::vector<int64_t>& desc, const torch::Tensor& blob,
              const torch::Tensor& rows, int64_t row_units,
              int64_t unit_bytes, int64_t stream) {
  std::vector<const void*> ptrs;
  for (const auto& leaf : leaves) ptrs.push_back(leaf.data_ptr());
  const std::vector<long long> d(desc.begin(), desc.end());
  check(snapshot_copy(capture, ptrs.data(), d.data(), (int)ptrs.size(),
                      blob.data_ptr(), rows.data_ptr(), rows.size(0),
                      row_units, unit_bytes, reinterpret_cast<void*>(stream)),
        "snapshot kernel launch");
}

// moves: int32 (2, M) on the device, sources then destinations
void compact(const std::vector<torch::Tensor>& pools,
             const std::vector<int64_t>& block_bytes,
             const torch::Tensor& moves, int64_t unit_bytes, int64_t stream) {
  std::vector<const void*> ptrs;
  for (const auto& pool : pools) ptrs.push_back(pool.data_ptr());
  const std::vector<long long> b(block_bytes.begin(), block_bytes.end());
  check(kv_compact(ptrs.data(), b.data(), (int)ptrs.size(), moves.data_ptr(),
                   moves.size(1), unit_bytes,
                   reinterpret_cast<void*>(stream)),
        "kv_compact launch");
}

// q (P, Hq * Dh), k/v (P, Hkv * Dh), biases (H * Dh) or empty, positions
// (P,) int32, freqs (Dh / 2,) f32, k/v_cache (P, t, Hkv, Dh), out like q
void qkv_rope(const torch::Tensor& q, const torch::Tensor& k,
              const torch::Tensor& v, const torch::Tensor& bq,
              const torch::Tensor& bk, const torch::Tensor& bv,
              const torch::Tensor& positions, const torch::Tensor& freqs,
              const torch::Tensor& k_cache, const torch::Tensor& v_cache,
              const torch::Tensor& out, int64_t stream) {
  auto ptr = [](const torch::Tensor& x) -> const void* {
    return x.numel() ? x.data_ptr() : nullptr;
  };
  check(decode_qkv_rope(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), ptr(bq), ptr(bk),
            ptr(bv), positions.data_ptr(), freqs.data_ptr(),
            k_cache.data_ptr(), v_cache.data_ptr(), out.data_ptr(),
            k_cache.size(0), q.size(1) / k_cache.size(3), k_cache.size(2),
            k_cache.size(3), k_cache.size(1),
            q.scalar_type() == torch::kBFloat16,
            reinterpret_cast<void*>(stream)),
        "decode_qkv_rope launch");
}

// loads every kernel's code onto the current device without launching it
void prepare() {
  check(partition_attention_prepare(), "loading partition_attention");
  check(paged_attention_prepare(), "loading paged_attention");
  check(snapshot_prepare(), "loading the snapshot kernels");
  check(kv_compact_prepare(), "loading kv_compact");
  check(decode_qkv_rope_prepare(), "loading decode_qkv_rope");
}

}  // namespace

PYBIND11_MODULE(TORCH_EXTENSION_NAME, m) {
  m.def("partition_attention", &attention);
  m.def("partition_attention_occupancy", &occupancy);
  m.def("paged_attention", &paged);
  m.def("snapshot_copy", &snapshot);
  m.def("kv_compact", &compact);
  m.def("decode_qkv_rope", &qkv_rope);
  m.def("prepare", &prepare);
}
