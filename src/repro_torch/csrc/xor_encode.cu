// XOR parity encoder (the ReCoding unit's datapath, paper §IV-D), written by
// hand for Hopper (sm_90a).
//
// Replaces the TPU kernel
//   src/repro/kernels/xor_encode/kernel.py::encode_parities_pallas
//   (body _encode_kernel).
//
// What it computes: for every parity j, row i and lane,
//   out[j][i] = XOR over k < 3 with members[j][k] >= 0 of banks[members[j][k]][i]
// (a member index past the last bank is clamped to it, as JAX's gather
// clamps). Rows are raw bytes, so one kernel serves every lane type and
// width.
//
// Bound: device memory, (n_data + n_par) * L * W * bytes: each bank read
// once and each parity written once; the arithmetic is at most two XORs
// per word. In the simulator (one region of 16 rows of one int32 word, 12
// parities) a launch moves well under a kilobyte and is bound by the launch.
//
// Design. The TPU kernel tiles rows through VMEM with every bank resident;
// nothing of that carries over. Here each thread produces one vector (the
// widest of 16, 8, 4, 2 or 1 bytes that divides the row's bytes and both
// base pointers) of one parity row, reading at most three member vectors;
// neighbouring threads take neighbouring vectors of the same row. A bank
// shared by several parities is read again by each; L2 (50 MB) absorbs
// those re-reads at the shapes used here. A grid-stride loop covers any
// size.

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
constexpr int kMembers = 3;       // MAX_SIBS + 1
constexpr long long kMaxBlocks = 132LL * 32;

template <typename V>
__global__ void __launch_bounds__(kThreads)
xor_encode_kernel(const V* __restrict__ banks,
                  const int32_t* __restrict__ members, V* __restrict__ out,
                  int n_data, long long bank_vecs, long long total) {
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long idx = static_cast<long long>(blockIdx.x) * kThreads +
                       threadIdx.x;
       idx < total; idx += stride) {
    const long long j = idx / bank_vecs;
    const long long off = idx - j * bank_vecs;
    V acc{};
#pragma unroll
    for (int k = 0; k < kMembers; ++k) {
      int m = members[j * kMembers + k];
      if (m >= 0) {
        if (m >= n_data) m = n_data - 1;
        acc = vxor(acc, banks[static_cast<long long>(m) * bank_vecs + off]);
      }
    }
    out[idx] = acc;
  }
}

template <typename V>
int launch(const void* banks, const void* members, void* out, int n_data,
           int n_par, long long bank_bytes, cudaStream_t stream) {
  const long long bank_vecs = bank_bytes / static_cast<long long>(sizeof(V));
  const long long total = bank_vecs * n_par;
  long long blocks = (total + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  xor_encode_kernel<V><<<static_cast<unsigned>(blocks), kThreads, 0,
                         stream>>>(
      static_cast<const V*>(banks), static_cast<const int32_t*>(members),
      static_cast<V*>(out), n_data, bank_vecs, total);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches the encoder on `stream` and returns cudaGetLastError() (0: the
// launch was accepted). banks is (n_data, bank_bytes) and out (n_par,
// bank_bytes) as raw bytes, where bank_bytes = L * W * lane bytes; members
// is (n_par, 3) int32, -1 padded.
extern "C" int xor_encode(const void* banks, const void* members, void* out,
                          int n_data, int n_par, long long bank_bytes,
                          void* stream) {
  if (n_data <= 0 || n_par <= 0 || bank_bytes <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const uintptr_t align = static_cast<uintptr_t>(bank_bytes) |
                          reinterpret_cast<uintptr_t>(banks) |
                          reinterpret_cast<uintptr_t>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (align % 16 == 0)
    return launch<uint4>(banks, members, out, n_data, n_par, bank_bytes, s);
  if (align % 8 == 0)
    return launch<uint2>(banks, members, out, n_data, n_par, bank_bytes, s);
  if (align % 4 == 0)
    return launch<uint32_t>(banks, members, out, n_data, n_par, bank_bytes,
                            s);
  if (align % 2 == 0)
    return launch<uint16_t>(banks, members, out, n_data, n_par, bank_bytes,
                            s);
  return launch<uint8_t>(banks, members, out, n_data, n_par, bank_bytes, s);
}

extern "C" const char* xor_encode_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
