// Python binding of the port's CUDA kernels (partition_attention.cu,
// kv_snapshot.cu), built with torch.utils.cpp_extension.load.  This is the
// one source that includes torch's headers; the kernels' own sources see
// only the CUDA runtime.  The Python wrappers (kernels/partition_attention.py,
// kernels/kv_snapshot.py) check devices, dtypes, shapes and alignment and
// pass the current stream; here each entry point hands the tensors' pointers
// to its launcher and raises if the launch was refused.
#include <torch/extension.h>

#include <vector>

int partition_attention(const void* q, const void* k, const void* v,
                        const void* positions, void* out, int p, int t,
                        int hkv, int g, int dh, int is_bf16, float scale,
                        float cap, int window, void* stream);
int partition_attention_prepare();
int snapshot_copy(int capture, const void* const* ptrs,
                  const long long* desc, int n_leaves, void* blob,
                  const void* rows, int n_rows, long long row_units,
                  int unit_bytes, void* stream);
int snapshot_prepare();

namespace {

void check(int err, const char* what) {
  TORCH_CHECK(err == 0, what, " failed: CUDA error ", err);
}

// q (P, Hkv, G, Dh), k/v (P, T, Hkv, Dh), out like q, positions (P,) int32
void attention(const torch::Tensor& q, const torch::Tensor& k,
               const torch::Tensor& v, const torch::Tensor& positions,
               const torch::Tensor& out, double scale, double cap,
               int64_t window, int64_t stream) {
  check(partition_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), positions.data_ptr(),
            out.data_ptr(), q.size(0), k.size(1), q.size(1), q.size(2),
            q.size(3), q.scalar_type() == torch::kBFloat16, scale, cap,
            window, reinterpret_cast<void*>(stream)),
        "partition_attention launch");
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

// loads every kernel's code onto the current device without launching it
void prepare() {
  check(partition_attention_prepare(), "loading partition_attention");
  check(snapshot_prepare(), "loading the snapshot kernels");
}

}  // namespace

PYBIND11_MODULE(TORCH_EXTENSION_NAME, m) {
  m.def("partition_attention", &attention);
  m.def("snapshot_copy", &snapshot);
  m.def("prepare", &prepare);
}
