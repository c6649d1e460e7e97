// Pool gather of the coded KV page pool, written by hand for Hopper (sm_90a).
//
// Replaces the TPU kernel
//   src/repro/kernels/coded_kv_decode/kernel.py::gather_pool_pallas
//   (bodies _pool_gather_kernel and _pool_gather_uncoded_kernel).
//
// What it computes, for each logical page i = b * MP + p and for K and V:
//   phys = page_table[i], bank = phys % NB, slot = phys / NB
//   out[i] = 0                                          if phys < 0
//          = banks[bank ^ 1][slot] ^ par[bank / 2][slot] if use_parity[i]
//          = banks[bank][slot]                           otherwise
// The uncoded pool (NG == 0) passes null parity and use_parity pointers,
// which are then never read.
//
// Bound: device memory. A page is read once (twice when degraded: sibling
// and parity) and written once; the only arithmetic is an XOR. At the
// serving shape (B=8, MP=32, P=64, Hkv=2, D=128, bf16 lanes) one launch
// writes 2 x 8.4 MB and reads at least as much, so it needs >= 10 us at
// 3.35 TB/s.
//
// Design. The TPU version maps the whole bank arrays into VMEM and walks
// one page per sequential grid step; nothing of that carries over. Here
// one block copies one (logical page, K|V) pair, grid (B*MP, 2), and reads
// its own page-table and use_parity entries. A page is raw bytes, so one
// kernel serves every lane width. It is moved with the widest vector (16,
// 8, 4, 2 or 1 bytes) that divides the page size and every base pointer,
// so all page starts stay aligned for that vector and no tail is left;
// neighbouring threads touch neighbouring vectors, and each thread keeps
// several independent loads in flight. The branch (hole, direct,
// degraded) is uniform over the block.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

template <typename V>
__device__ __forceinline__ V vxor(V a, V b) { return a ^ b; }

template <>
__device__ __forceinline__ uint4 vxor<uint4>(uint4 a, uint4 b) {
  return make_uint4(a.x ^ b.x, a.y ^ b.y, a.z ^ b.z, a.w ^ b.w);
}

template <>
__device__ __forceinline__ uint2 vxor<uint2>(uint2 a, uint2 b) {
  return make_uint2(a.x ^ b.x, a.y ^ b.y);
}

constexpr int kThreads = 256;

template <typename V>
__global__ void __launch_bounds__(kThreads)
gather_pool_kernel(const V* __restrict__ k_banks, const V* __restrict__ v_banks,
                   const V* __restrict__ k_par, const V* __restrict__ v_par,
                   const int32_t* __restrict__ page_table,
                   const uint8_t* __restrict__ use_parity,
                   V* __restrict__ k_out, V* __restrict__ v_out,
                   int nb, int slots, long long page_vecs) {
  const long long i = blockIdx.x;
  const bool is_v = blockIdx.y == 1;
  const V* banks = is_v ? v_banks : k_banks;
  const V* par = is_v ? v_par : k_par;
  V* out = (is_v ? v_out : k_out) + i * page_vecs;

  const int phys = page_table[i];
  if (phys < 0 || phys >= nb * slots) {
    // a hole reads as zeros; an id past the pool never reads outside it
    const V zero{};
#pragma unroll 4
    for (long long t = threadIdx.x; t < page_vecs; t += kThreads) out[t] = zero;
    return;
  }
  const int bank = phys % nb;
  const int slot = phys / nb;
  if (par != nullptr && use_parity[i] != 0) {
    const V* sib = banks + ((long long)(bank ^ 1) * slots + slot) * page_vecs;
    const V* pp = par + ((long long)(bank >> 1) * slots + slot) * page_vecs;
#pragma unroll 4
    for (long long t = threadIdx.x; t < page_vecs; t += kThreads)
      out[t] = vxor(sib[t], pp[t]);
  } else {
    const V* src = banks + ((long long)bank * slots + slot) * page_vecs;
#pragma unroll 4
    for (long long t = threadIdx.x; t < page_vecs; t += kThreads) out[t] = src[t];
  }
}

template <typename V>
int launch(const void* kb, const void* vb, const void* kp, const void* vp,
           const void* pt, const void* up, void* ko, void* vo, int nb,
           int slots, long long page_bytes, long long n_pages,
           cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>(n_pages), 2);
  gather_pool_kernel<V><<<grid, kThreads, 0, stream>>>(
      static_cast<const V*>(kb), static_cast<const V*>(vb),
      static_cast<const V*>(kp), static_cast<const V*>(vp),
      static_cast<const int32_t*>(pt), static_cast<const uint8_t*>(up),
      static_cast<V*>(ko), static_cast<V*>(vo), nb, slots,
      page_bytes / static_cast<long long>(sizeof(V)));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches the gather on `stream` and returns cudaGetLastError() (0: the
// launch was accepted). k_par/v_par/use_parity are null for an uncoded pool.
extern "C" int gather_pool(const void* k_banks, const void* v_banks,
                           const void* k_par, const void* v_par,
                           const void* page_table, const void* use_parity,
                           void* k_out, void* v_out, int nb, int slots,
                           long long page_bytes, long long n_pages,
                           void* stream) {
  if (n_pages <= 0 || n_pages > INT_MAX || page_bytes <= 0 || nb <= 0 ||
      slots <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const uintptr_t align =
      static_cast<uintptr_t>(page_bytes) | reinterpret_cast<uintptr_t>(k_banks) |
      reinterpret_cast<uintptr_t>(v_banks) | reinterpret_cast<uintptr_t>(k_par) |
      reinterpret_cast<uintptr_t>(v_par) | reinterpret_cast<uintptr_t>(k_out) |
      reinterpret_cast<uintptr_t>(v_out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (align % 16 == 0)
    return launch<uint4>(k_banks, v_banks, k_par, v_par, page_table,
                         use_parity, k_out, v_out, nb, slots, page_bytes,
                         n_pages, s);
  if (align % 8 == 0)
    return launch<uint2>(k_banks, v_banks, k_par, v_par, page_table,
                         use_parity, k_out, v_out, nb, slots, page_bytes,
                         n_pages, s);
  if (align % 4 == 0)
    return launch<uint32_t>(k_banks, v_banks, k_par, v_par, page_table,
                            use_parity, k_out, v_out, nb, slots, page_bytes,
                            n_pages, s);
  if (align % 2 == 0)
    return launch<uint16_t>(k_banks, v_banks, k_par, v_par, page_table,
                            use_parity, k_out, v_out, nb, slots, page_bytes,
                            n_pages, s);
  return launch<uint8_t>(k_banks, v_banks, k_par, v_par, page_table,
                         use_parity, k_out, v_out, nb, slots, page_bytes,
                         n_pages, s);
}

extern "C" const char* gather_pool_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
