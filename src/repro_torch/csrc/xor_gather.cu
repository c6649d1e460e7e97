// Coded row gather (one memory cycle's read datapath), written by hand for
// Hopper (sm_90a).
//
// Replaces the TPU kernel
//   src/repro/kernels/xor_gather/kernel.py::gather_decode_pallas
//   (bodies _gather_kernel and _lane_xor).
//
// What it computes, for each request r with b = bank[r], i = row[r],
// j = par[r], pr = prow[r] (every index clamped into range, as JAX's
// gather clamps it):
//   out[r] = 0                                        if mode[r] < 0
//          = par[j][pr] ^ banks[sib0][i] ^ banks[sib1][i]
//                                                     if 2 <= mode[r] < 6
//            (a sibling of -1 is skipped)
//          = par[j][pr]                               if mode[r] == 6
//          = banks[b][i]                              otherwise (0, 1: direct)
// Rows are raw bytes (int8/int16/int32 lanes, any width W), so one kernel
// serves every lane type.
//
// Bound: device memory. A request reads only the rows its mode needs (one
// for a direct or redirected read, up to three for a degraded one) and
// writes one row; the only arithmetic is XOR. The byte bound counts each
// needed row once, the output and the seven int32 columns. In the
// simulator (W = 1 int32 word, N = 80 requests) a launch moves about 3 KB,
// so it is bound by the launch itself, not by the card.
//
// Design. The TPU kernel streams row tiles of every bank through VMEM and
// picks lanes with one-hot masks, because the TPU has no dynamic gather;
// none of that carries over. Here one warp serves one request (eight per
// block): it reads its seven columns, and only the rows its mode needs,
// with the widest vector (16, 8, 4, 2 or 1 bytes) that divides the row's
// bytes and every base pointer, neighbouring lanes on neighbouring vectors.
// The branch is uniform over the warp.

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
constexpr int kWarps = kThreads / 32;
constexpr int kModeOpt0 = 2;      // MODE_OPT0
constexpr int kModeRedirect = 6;  // MODE_OPT0 + MAX_OPTS

__device__ __forceinline__ long long clamp_index(int v, long long n) {
  return v < 0 ? 0 : (v >= n ? n - 1 : static_cast<long long>(v));
}

template <typename V>
__global__ void __launch_bounds__(kThreads)
xor_gather_kernel(const V* __restrict__ banks, const V* __restrict__ par,
                  const int32_t* __restrict__ bank,
                  const int32_t* __restrict__ row,
                  const int32_t* __restrict__ mode,
                  const int32_t* __restrict__ pidx,
                  const int32_t* __restrict__ prow,
                  const int32_t* __restrict__ sib0,
                  const int32_t* __restrict__ sib1, V* __restrict__ out,
                  int n_data, long long rows, int n_par, long long par_rows,
                  long long row_vecs, long long n_req) {
  const long long r =
      static_cast<long long>(blockIdx.x) * kWarps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (r >= n_req) return;
  V* o = out + r * row_vecs;
  const int m = mode[r];
  if (m < 0) {
    const V zero{};
    for (long long t = lane; t < row_vecs; t += 32) o[t] = zero;
    return;
  }
  const long long i = clamp_index(row[r], rows);
  if (m >= kModeOpt0 && m <= kModeRedirect) {
    const V* pp = par + (clamp_index(pidx[r], n_par) * par_rows +
                         clamp_index(prow[r], par_rows)) * row_vecs;
    if (m == kModeRedirect) {
      for (long long t = lane; t < row_vecs; t += 32) o[t] = pp[t];
      return;
    }
    const int s0 = sib0[r];
    const int s1 = sib1[r];
    const V* q0 =
        s0 >= 0 ? banks + (clamp_index(s0, n_data) * rows + i) * row_vecs
                : nullptr;
    const V* q1 =
        s1 >= 0 ? banks + (clamp_index(s1, n_data) * rows + i) * row_vecs
                : nullptr;
    for (long long t = lane; t < row_vecs; t += 32) {
      V v = pp[t];
      if (q0 != nullptr) v = vxor(v, q0[t]);
      if (q1 != nullptr) v = vxor(v, q1[t]);
      o[t] = v;
    }
    return;
  }
  const V* src = banks + (clamp_index(bank[r], n_data) * rows + i) * row_vecs;
  for (long long t = lane; t < row_vecs; t += 32) o[t] = src[t];
}

template <typename V>
int launch(const void* banks, const void* par, const int32_t* const* cols,
           void* out, int n_data, long long rows, int n_par,
           long long par_rows, long long row_bytes, long long n_req,
           cudaStream_t stream) {
  const long long blocks = (n_req + kWarps - 1) / kWarps;
  xor_gather_kernel<V><<<static_cast<unsigned>(blocks), kThreads, 0,
                         stream>>>(
      static_cast<const V*>(banks), static_cast<const V*>(par), cols[0],
      cols[1], cols[2], cols[3], cols[4], cols[5], cols[6],
      static_cast<V*>(out), n_data, rows, n_par, par_rows,
      row_bytes / static_cast<long long>(sizeof(V)), n_req);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches the gather on `stream` and returns cudaGetLastError() (0: the
// launch was accepted). The seven columns are int32 arrays of n_req
// entries; banks is (n_data, rows, row_bytes) and par (n_par, par_rows,
// row_bytes) as raw bytes.
extern "C" int xor_gather(const void* banks, const void* par,
                          const void* bank, const void* row, const void* mode,
                          const void* pidx, const void* prow,
                          const void* sib0, const void* sib1, void* out,
                          int n_data, long long rows, int n_par,
                          long long par_rows, long long row_bytes,
                          long long n_req, void* stream) {
  if (n_req <= 0 || (n_req + kWarps - 1) / kWarps > INT_MAX ||
      row_bytes <= 0 || n_data <= 0 || rows <= 0 || n_par <= 0 ||
      par_rows <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int32_t* cols[7] = {
      static_cast<const int32_t*>(bank), static_cast<const int32_t*>(row),
      static_cast<const int32_t*>(mode), static_cast<const int32_t*>(pidx),
      static_cast<const int32_t*>(prow), static_cast<const int32_t*>(sib0),
      static_cast<const int32_t*>(sib1)};
  const uintptr_t align = static_cast<uintptr_t>(row_bytes) |
                          reinterpret_cast<uintptr_t>(banks) |
                          reinterpret_cast<uintptr_t>(par) |
                          reinterpret_cast<uintptr_t>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (align % 16 == 0)
    return launch<uint4>(banks, par, cols, out, n_data, rows, n_par,
                         par_rows, row_bytes, n_req, s);
  if (align % 8 == 0)
    return launch<uint2>(banks, par, cols, out, n_data, rows, n_par,
                         par_rows, row_bytes, n_req, s);
  if (align % 4 == 0)
    return launch<uint32_t>(banks, par, cols, out, n_data, rows, n_par,
                            par_rows, row_bytes, n_req, s);
  if (align % 2 == 0)
    return launch<uint16_t>(banks, par, cols, out, n_data, rows, n_par,
                            par_rows, row_bytes, n_req, s);
  return launch<uint8_t>(banks, par, cols, out, n_data, rows, n_par,
                         par_rows, row_bytes, n_req, s);
}

extern "C" const char* xor_gather_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
