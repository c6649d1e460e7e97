// XOR parity encoder (the ReCoding unit's datapath, paper §IV-D), written by
// hand for Hopper (sm_90a).
//
// Replaces the TPU kernel
//   src/repro/kernels/xor_encode/kernel.py::encode_parities_pallas
//   (body _encode_kernel).
//
// What it computes: for every point, parity j, row i and lane,
//   out[pt][j][i] = XOR over k < 3 with members[j][k] >= 0 of
//                   banks[pt][members[j][k]][i]
// (a member index past the last bank is clamped to it, as JAX's gather
// clamps). Rows are raw bytes, so one kernel serves every lane type and
// width. Two entries share the body (the work item's layout, Whole or
// Regions, is its template parameter):
//   xor_encode          B points' whole banks (B, n_data, L, W) ->
//                       (B, n_par, L, W);
//   xor_encode_regions  dynamic coding's region encode
//                       (repro/core/dynamic.py::_encode_region_data) for
//                       each completing point of a (C, 4) int32 block of
//                       (point, region, slot, rs_a): the region's rows
//                       clamp(region * rs_a + off, 0, n_rows - 1), off <
//                       region_size, are encoded and written straight into
//                       the parity rows of the slot, from the clamped start
//                       min(max(slot, 0) * region_size, Lp - region_size);
//                       rows at off >= rs_a write 0.
//
// Bound: device memory, (n_data + n_par) * rows * row bytes a point: each
// bank read once and each parity written once; the arithmetic is at most
// two XORs per word. In the simulator (one region of 16 rows of one int32
// word, 12 parities) a launch moves well under a kilobyte and is bound by
// the launch; the region entry also takes the gathers, XOR passes and
// slot writes of the eager bridge (some 50 ops a completing cycle) into
// the one launch.
//
// Design. The TPU kernel tiles rows through VMEM with every bank resident;
// nothing of that carries over. Here a thread owns one vector (the widest
// of 16, 8, 4, 2 or 1 bytes that divides the row's bytes and the base
// pointers) at one offset of one point: it loads that vector of each of
// the point's banks ONCE into registers (all loads issued before any
// XOR), then writes every parity of the member table from them. The
// table is staged in shared memory as one bit mask of member banks a
// parity (duplicate members cancel, as XOR does), so the registers are
// indexed at compile time (kMaxData = 8 or 16 banks; a point with more
// banks takes the general body, which reads each parity's members).
// Under scheme_i each bank belongs to 3 of the 12 parities, so the former
// body (one thread a parity vector, reading its members) moved 1.8x the
// bound's bytes once the re-reads missed L2; this one moves the bound's.
// A grid-stride loop covers any size.

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
constexpr int kBlocksPerSm = 32;  // the grid-stride loop's blocks an SM

// Where one work item reads and writes: bank k's vector at src + k *
// bank_stride, parity j's at dst + j * par_stride; inactive items write 0.
struct Item {
  const void* src;
  void* dst;
  bool active;
};

struct Whole {                    // xor_encode: item = pt * vecs + v
  long long vecs;                 // vectors a bank (= a parity)
  int n_data, n_par;
  __device__ Item item(const char* banks, char* out, long long idx,
                       int vbytes) const {
    const long long pt = idx / vecs, v = idx - pt * vecs;
    return Item{banks + ((pt * n_data) * vecs + v) * vbytes,
                out + ((pt * n_par) * vecs + v) * vbytes, true};
  }
  __device__ long long bank_stride() const { return vecs; }
  __device__ long long par_stride() const { return vecs; }
};

struct Regions {                  // item = (c * rs + off) * row_vecs + v
  const int32_t* done;            // (C, 4): point, region, slot, rs_a
  long long row_vecs, n_rows, par_rows;
  int region_size, n_data, n_par, n_points;
  __device__ Item item(const char* banks, char* out, long long idx,
                       int vbytes) const {
    const long long v = idx % row_vecs;
    const long long line = idx / row_vecs;
    const long long c = line / region_size;
    const long long off = line - c * region_size;
    const long long pt = done[c * 4], region = done[c * 4 + 1];
    const long long slot = done[c * 4 + 2], rs_a = done[c * 4 + 3];
    if (pt < 0 || pt >= n_points) return Item{nullptr, nullptr, false};
    long long row = region * rs_a + off;
    row = row < 0 ? 0 : (row >= n_rows ? n_rows - 1 : row);
    long long start = (slot < 0 ? 0 : slot) * region_size;
    if (start > par_rows - region_size) start = par_rows - region_size;
    if (start < 0) start = 0;
    return Item{
        banks + ((pt * n_data * n_rows + row) * row_vecs + v) * vbytes,
        out + ((pt * n_par * par_rows + start + off) * row_vecs + v) * vbytes,
        off < rs_a};
  }
  __device__ long long bank_stride() const { return n_rows * row_vecs; }
  __device__ long long par_stride() const { return par_rows * row_vecs; }
};

__device__ __forceinline__ int load_member(const void* m, int k, int bytes) {
  return bytes == 8 ? static_cast<int>(static_cast<const long long*>(m)[k])
                    : static_cast<const int*>(m)[k];
}

// kMaxData > 0: the registers body (n_data <= kMaxData), the table staged
// as one member mask a parity. kMaxData == 0: the general body, the table
// staged as clamped member ids (-1: none).
template <typename V, int kMaxData, typename Work>
__global__ void __launch_bounds__(kThreads)
xor_encode_kernel(const V* __restrict__ banks, const void* members,
                  int member_bytes, V* __restrict__ out, Work w,
                  long long total) {
  extern __shared__ uint32_t table[];
  const int n_data = w.n_data, n_par = w.n_par;
  for (int j = threadIdx.x; j < n_par; j += blockDim.x) {
    uint32_t mask = 0;
#pragma unroll
    for (int k = 0; k < kMembers; ++k) {
      int m = load_member(members, j * kMembers + k, member_bytes);
      if (m >= n_data) m = n_data - 1;
      if (kMaxData > 0) {
        if (m >= 0) mask ^= 1u << m;
      } else {
        table[j * kMembers + k] = static_cast<uint32_t>(m < 0 ? -1 : m);
      }
    }
    if (kMaxData > 0) table[j] = mask;
  }
  __syncthreads();
  const long long bs = w.bank_stride(), ps = w.par_stride();
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long idx = static_cast<long long>(blockIdx.x) * kThreads +
                       threadIdx.x;
       idx < total; idx += stride) {
    const Item it = w.item(reinterpret_cast<const char*>(banks),
                           reinterpret_cast<char*>(out), idx, sizeof(V));
    const V* src = static_cast<const V*>(it.src);
    V* dst = static_cast<V*>(it.dst);
    if (dst == nullptr) continue;            // a point outside the batch
    if (!it.active) {
      for (int j = 0; j < n_par; ++j) dst[j * ps] = V{};
      continue;
    }
    if constexpr (kMaxData > 0) {
      V x[kMaxData];
#pragma unroll
      for (int k = 0; k < kMaxData; ++k)
        x[k] = k < n_data ? src[k * bs] : V{};
      for (int j = 0; j < n_par; ++j) {
        const uint32_t mask = table[j];
        V acc{};
#pragma unroll
        for (int k = 0; k < kMaxData; ++k)
          if ((mask >> k) & 1u) acc = vxor(acc, x[k]);
        dst[j * ps] = acc;
      }
    } else {
      for (int j = 0; j < n_par; ++j) {
        V acc{};
#pragma unroll
        for (int k = 0; k < kMembers; ++k) {
          const int m = static_cast<int>(table[j * kMembers + k]);
          if (m >= 0) acc = vxor(acc, src[m * bs]);
        }
        dst[j * ps] = acc;
      }
    }
  }
}

template <typename V, typename Work>
int launch(const void* banks, const void* members, int member_bytes,
           void* out, Work w, long long total, cudaStream_t stream) {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  long long blocks = (total + kThreads - 1) / kThreads;
  if (blocks > static_cast<long long>(sms) * kBlocksPerSm)
    blocks = static_cast<long long>(sms) * kBlocksPerSm;
  const dim3 grid(static_cast<unsigned>(blocks));
  const auto* b = static_cast<const V*>(banks);
  auto* o = static_cast<V*>(out);
  const size_t masks = static_cast<size_t>(w.n_par) * sizeof(uint32_t);
  if (w.n_data <= 8)
    xor_encode_kernel<V, 8, Work><<<grid, kThreads, masks, stream>>>(
        b, members, member_bytes, o, w, total);
  else if (w.n_data <= 16)
    xor_encode_kernel<V, 16, Work><<<grid, kThreads, masks, stream>>>(
        b, members, member_bytes, o, w, total);
  else
    xor_encode_kernel<V, 0, Work><<<grid, kThreads, masks * kMembers,
                                    stream>>>(b, members, member_bytes, o, w,
                                              total);
  return static_cast<int>(cudaGetLastError());
}

// The widest vector that divides `align` (row or bank bytes | pointers).
template <typename Make>
int by_vector(uintptr_t align, Make make) {
  if (align % 16 == 0) return make(uint4{});
  if (align % 8 == 0) return make(uint2{});
  if (align % 4 == 0) return make(uint32_t{});
  if (align % 2 == 0) return make(uint16_t{});
  return make(uint8_t{});
}

bool bad_members(int n_par, int member_bytes) {
  return n_par <= 0 || (member_bytes != 4 && member_bytes != 8) ||
         static_cast<long long>(n_par) * kMembers * 4 > 48 * 1024;
}

}  // namespace

// Launches the encoder on `stream` and returns cudaGetLastError() (0: the
// launch was accepted). banks is (n_points, n_data, bank_bytes) and out
// (n_points, n_par, bank_bytes) as raw bytes, where bank_bytes = L * W *
// lane bytes; members is (n_par, 3) ints of member_bytes (4 or 8), -1
// padded, the same table for every point.
extern "C" int xor_encode(const void* banks, const void* members, void* out,
                          int n_points, int n_data, int n_par,
                          long long bank_bytes, int member_bytes,
                          void* stream) {
  if (n_points <= 0 || n_data <= 0 || bank_bytes <= 0 ||
      bad_members(n_par, member_bytes))
    return static_cast<int>(cudaErrorInvalidValue);
  const uintptr_t align = static_cast<uintptr_t>(bank_bytes) |
                          reinterpret_cast<uintptr_t>(banks) |
                          reinterpret_cast<uintptr_t>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return by_vector(align, [&](auto v) {
    using V = decltype(v);
    const long long vecs = bank_bytes / static_cast<long long>(sizeof(V));
    return launch<V>(banks, members, member_bytes, out,
                     Whole{vecs, n_data, n_par}, vecs * n_points, s);
  });
}

// Launches the region encode on `stream`: for each of the n_done rows of
// `done` ((n_done, 4) int32 on the card: point, region, slot, rs_a) the
// point's region is encoded into its slot's rows of `out`, which holds
// (n_points, n_par, par_rows, row_bytes) raw bytes (a copy of the parity
// state; nothing else of it is written). banks is (n_points, n_data,
// n_rows, row_bytes). A row of `done` whose point lies outside [0,
// n_points) writes nothing.
extern "C" int xor_encode_regions(const void* banks, const void* members,
                                  const void* done, void* out, int n_done,
                                  int n_points, int n_data, int n_par,
                                  long long n_rows,
                                  long long par_rows, long long row_bytes,
                                  int region_size, int member_bytes,
                                  void* stream) {
  if (n_done <= 0 || n_points <= 0 || n_data <= 0 || n_rows <= 0 ||
      row_bytes <= 0 ||
      region_size <= 0 || par_rows < region_size ||
      bad_members(n_par, member_bytes))
    return static_cast<int>(cudaErrorInvalidValue);
  const uintptr_t align = static_cast<uintptr_t>(row_bytes) |
                          reinterpret_cast<uintptr_t>(banks) |
                          reinterpret_cast<uintptr_t>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return by_vector(align, [&](auto v) {
    using V = decltype(v);
    const long long row_vecs = row_bytes / static_cast<long long>(sizeof(V));
    const Regions w{static_cast<const int32_t*>(done), row_vecs, n_rows,
                    par_rows, region_size, n_data, n_par, n_points};
    return launch<V>(banks, members, member_bytes, out, w,
                     static_cast<long long>(n_done) * region_size * row_vecs,
                     s);
  });
}

extern "C" const char* xor_encode_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
