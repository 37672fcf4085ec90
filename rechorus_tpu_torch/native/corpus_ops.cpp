// Host-side corpus kernels of the port (rechorus_tpu_torch/native): the
// transforms that turn a parsed corpus into the fixed-shape arrays the
// batchers put on the device. Port of rechorus_tpu/native/corpus_ops.cpp
// with the same semantics; the history kernel reads the readers' CSR of
// [item, time] rows (`CSRRows.flat`, [L, 2] int64, row-major) in place.
//
// Build: g++ -O3 -shared -fPIC corpus_ops.cpp -o libcorpus_ops-<hash>.so
// (native/__init__.py, at first use). ABI: plain C, called through ctypes.

#include <cstdint>

extern "C" {

// Row r of the output takes his[users[r]][:positions[r]][-H:], left-aligned
// and zero-padded; a row with position <= 0 is empty.
//   users[n], positions[n]: each row's user and its index into the user's
//     history
//   his[L, 2]: the users' [item, time] rows one after another; user u's
//     rows are his[offsets[u] : offsets[u + 1]]
// Outputs, zeroed by the caller: out_items [n, H] int32, out_times [n, H]
// int64, out_len [n] int32.
void build_history_arrays(
    const int64_t* users, const int64_t* positions, int64_t n,
    const int64_t* his, const int64_t* offsets, int64_t history_max,
    int32_t* out_items, int64_t* out_times, int32_t* out_len) {
  const int64_t H = history_max;
  for (int64_t r = 0; r < n; ++r) {
    const int64_t p = positions[r];
    if (p <= 0) {
      out_len[r] = 0;
      continue;
    }
    const int64_t start = p > H ? p - H : 0;
    const int64_t L = p - start;
    const int64_t* src = his + 2 * (offsets[users[r]] + start);
    int32_t* dst_i = out_items + r * H;
    int64_t* dst_t = out_times + r * H;
    for (int64_t j = 0; j < L; ++j) {
      dst_i[j] = static_cast<int32_t>(src[2 * j]);
      dst_t[j] = src[2 * j + 1];
    }
    out_len[r] = static_cast<int32_t>(L);
  }
}

// The CSR rows copied left-aligned into out [n_users, max_len] int32,
// zeroed by the caller: row u takes flat[offsets[u] : offsets[u + 1]].
void fill_clicked_matrix(
    const int64_t* flat, const int64_t* offsets, int64_t n_users,
    int64_t max_len, int32_t* out) {
  for (int64_t u = 0; u < n_users; ++u) {
    const int64_t s = offsets[u], e = offsets[u + 1];
    int32_t* dst = out + u * max_len;
    for (int64_t j = s; j < e; ++j) dst[j - s] = static_cast<int32_t>(flat[j]);
  }
}

}  // extern "C"
