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
// Two entries share the body (the request source, Columns or Plan, is its
// template parameter):
//   xor_gather       reads the seven int32 columns above from memory (JAX's
//                    column API, gather_decode);
//   xor_gather_plan  computes them per request from the controller's read
//                    plan, in the thread that serves it, as
//                    kernels/xor_gather/ops.py::plan_columns does with
//                    eager ops: bank and row clamped at 0, the option
//                    k = mode - 2, its parity and siblings from the code
//                    tables (staged in shared memory), a redirect's holder
//                    fresh_loc[b][i] - 1, the slot row
//                    max(region_slot[i / rs_a], 0) * region_size + i % rs_a,
//                    and each point's bank, parity and sibling ids offset
//                    into the batch (every id clamped inside its point).
//                    The simulator's read branch is then one launch.
//
// Bound: device memory. A request reads only the rows its mode needs (one
// for a direct or redirected read, up to three for a degraded one) and
// writes one row; the only arithmetic is XOR. The byte bound counts each
// needed row once, the output and the seven int32 columns (the plan's
// operands for xor_gather_plan); random requests read a row again where
// L2 no longer holds it, so at size the kernel moves more than the
// bound's bytes. In the simulator (W = 1 int32 word, 80
// requests a point) a launch moves about 3 KB: it is bound by the launch,
// and its gain is the dozens of eager launches of the bridge it absorbs.
//
// Design. The TPU kernel streams row tiles of every bank through VMEM and
// picks lanes with one-hot masks, because the TPU has no dynamic gather;
// none of that carries over. Here
//   * rows of at most four vectors (the simulator's 4-byte rows): one
//     thread per request, so a batch of 80-1,040 requests is one to nine
//     blocks of 128 threads;
//   * longer rows: one warp per request, neighbouring lanes on
//     neighbouring vectors;
//   * every column (or plan) load of a request is issued before any row
//     load, so a direct read waits on two memory round trips (three for a
//     parity read fed the plan: the slot row depends on the row id);
//   * the row loop is unrolled by kUnroll and issues all its loads (up to
//     3 x kUnroll 16-byte vectors a lane) before its first store, so a
//     warp keeps several kilobytes in flight per request;
// with the widest vector (16, 8, 4, 2 or 1 bytes) that divides the row's
// bytes and every base pointer.

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

constexpr int kThreads = 128;
constexpr int kUnroll = 4;
constexpr int kSmallRowVecs = 4;  // rows of <= 4 vectors: a thread each
constexpr int kModeOpt0 = 2;      // MODE_OPT0
constexpr int kMaxOpts = 4;       // MAX_OPTS
constexpr int kMaxSibs = 2;       // MAX_SIBS
constexpr int kModeRedirect = 6;  // MODE_OPT0 + MAX_OPTS
constexpr int kMaxTableBytes = 48 * 1024;

__device__ __forceinline__ long long clamp_index(long long v, long long n) {
  return v < 0 ? 0 : (v >= n ? n - 1 : v);
}

// One request resolved to the rows it reads (flat row indices into banks
// viewed (n_banks * rows) and parities (n_parities * par_rows); -1: not
// read). out = [par row p] ^ [bank row a0] ^ [bank row a1], where a direct
// read reads only a0 and an unserved one nothing.
struct Rows {
  long long p, a0, a1;
};

struct Geometry {
  int n_data;            // banks a point (all of them for the column API)
  long long rows;
  int n_par;             // parities a point
  long long par_rows;
  long long row_vecs;
};

struct Columns {
  const int32_t* bank;
  const int32_t* row;
  const int32_t* mode;
  const int32_t* par;
  const int32_t* prow;
  const int32_t* sib0;
  const int32_t* sib1;
};

// The controller's read plan of B points, N candidates each. Every (B, N)
// operand is addressed plan[pt * stride + q]; region_slot (B, n_regions),
// fresh_loc (B, n_data, rows) likewise by their point strides.
struct Plan {
  const int32_t* cand_bank;
  const int32_t* cand_row;
  const int32_t* mode;
  const uint8_t* served;
  const int32_t* region_slot;
  const int32_t* fresh_loc;
  const void* rs_active;      // (B,) int32/int64, or null: rs_scalar
  const void* opt_parity;     // (n_data, MAX_OPTS) int32/int64
  const void* opt_sibs;       // (n_data, MAX_OPTS, MAX_SIBS)
  long long cb_stride, ci_stride, mode_stride, served_stride;
  long long slot_stride, fresh_stride;
  int n_cand;
  int n_regions;
  int region_size;
  int rs_scalar;
  int rs_bytes;               // 0 (scalar), 4 or 8
  int table_bytes;            // 4 or 8
};

__device__ __forceinline__ long long load_index(const void* p, long long k,
                                                int bytes) {
  return bytes == 8 ? static_cast<const long long*>(p)[k]
                    : static_cast<long long>(static_cast<const int*>(p)[k]);
}

// Column API. The first round trip: the request's seven columns, loaded
// together.
struct ColumnFetch {
  int b, i, m, j, pr, s0, s1;
};

__device__ __forceinline__ ColumnFetch fetch(const Columns& c, int r) {
  return ColumnFetch{c.bank[r], c.row[r], c.mode[r], c.par[r], c.prow[r],
                     c.sib0[r], c.sib1[r]};
}

__device__ __forceinline__ Rows resolve(const Columns&, const Geometry& g,
                                        const ColumnFetch& f, const int*) {
  Rows out{-1, -1, -1};
  if (f.m < 0) return out;
  const long long ic = clamp_index(f.i, g.rows);
  const long long pline =
      clamp_index(f.j, g.n_par) * g.par_rows + clamp_index(f.pr, g.par_rows);
  if (f.m >= kModeOpt0 && f.m < kModeRedirect) {
    out.p = pline;
    if (f.s0 >= 0) out.a0 = clamp_index(f.s0, g.n_data) * g.rows + ic;
    if (f.s1 >= 0) out.a1 = clamp_index(f.s1, g.n_data) * g.rows + ic;
  } else if (f.m == kModeRedirect) {
    out.p = pline;
  } else {
    out.a0 = clamp_index(f.b, g.n_data) * g.rows + ic;
  }
  return out;
}

// Plan API, request r = pt * N + q. The first round trip: the candidate,
// its mode and served flag and the point's rs_a, loaded together (and
// before the code tables are staged, so the two overlap).
struct PlanFetch {
  int pt, rs_a, cb, ci, m;
  bool served;
};

__device__ __forceinline__ PlanFetch fetch(const Plan& c, int r) {
  const int pt = r / c.n_cand;
  const int q = r - pt * c.n_cand;
  return PlanFetch{
      pt,
      c.rs_bytes == 0 ? c.rs_scalar
                      : static_cast<int>(load_index(c.rs_active, pt,
                                                    c.rs_bytes)),
      c.cand_bank[pt * c.cb_stride + q], c.cand_row[pt * c.ci_stride + q],
      c.mode[pt * c.mode_stride + q], c.served[pt * c.served_stride + q] != 0};
}

// plan_columns' arithmetic. `tab` holds the code tables in shared memory:
// opt_parity at [b * 4 + k] and the siblings at n_data * 4 + (b * 4 + k) *
// 2 + s.
__device__ __forceinline__ Rows resolve(const Plan& c, const Geometry& g,
                                        const PlanFetch& f, const int* tab) {
  Rows out{-1, -1, -1};
  const int m = f.m;
  if (!f.served || m < 0) return out;
  const long long bc = clamp_index(f.cb, g.n_data);
  const int i = f.ci < 0 ? 0 : f.ci;               // clamped at 0 only
  const long long ic = i >= g.rows ? g.rows - 1 : i;
  const long long bank0 = static_cast<long long>(f.pt) * g.n_data;
  if (m < kModeOpt0 || m > kModeRedirect) {        // direct
    out.a0 = (bank0 + bc) * g.rows + ic;
    return out;
  }
  // second round trip: the slot of the row's region (and a redirect's
  // holder); the parity row is the third
  const long long region = clamp_index(i / f.rs_a, c.n_regions);
  const int slot = c.region_slot[f.pt * c.slot_stride + region];
  long long j;
  if (m == kModeRedirect) {
    j = c.fresh_loc[f.pt * c.fresh_stride + bc * g.rows + ic] - 1;
  } else {
    const int k = m - kModeOpt0;
    j = tab[bc * kMaxOpts + k];
    const int* sib = tab + g.n_data * kMaxOpts + (bc * kMaxOpts + k) * kMaxSibs;
    const int s0 = sib[0], s1 = sib[1];
    if (s0 >= 0) out.a0 = (bank0 + clamp_index(s0, g.n_data)) * g.rows + ic;
    if (s1 >= 0) out.a1 = (bank0 + clamp_index(s1, g.n_data)) * g.rows + ic;
  }
  const long long prow = clamp_index(
      static_cast<long long>(slot < 0 ? 0 : slot) * c.region_size +
          i % f.rs_a, g.par_rows);
  out.p = (static_cast<long long>(f.pt) * g.n_par + clamp_index(j, g.n_par))
          * g.par_rows + prow;
  return out;
}

__device__ __forceinline__ void stage_tables(const Columns&, int, int*) {}

__device__ __forceinline__ void stage_tables(const Plan& c, int n_data,
                                             int* tab) {
  const int n_opt = n_data * kMaxOpts;
  for (int t = threadIdx.x; t < n_opt * (1 + kMaxSibs); t += blockDim.x)
    tab[t] = static_cast<int>(
        t < n_opt ? load_index(c.opt_parity, t, c.table_bytes)
                  : load_index(c.opt_sibs, t - n_opt, c.table_bytes));
  __syncthreads();
}

// One request's row: the loads of kUnroll vectors of up to three source
// rows are issued before any of them is stored.
template <typename V, int G>
__device__ __forceinline__ void move_row(const V* __restrict__ banks,
                                         const V* __restrict__ par,
                                         const Rows& rw, long long n,
                                         V* __restrict__ o, int lane) {
  const V* pp = rw.p >= 0 ? par + rw.p * n : nullptr;
  const V* q0 = rw.a0 >= 0 ? banks + rw.a0 * n : nullptr;
  const V* q1 = rw.a1 >= 0 ? banks + rw.a1 * n : nullptr;
  for (long long t0 = lane; t0 < n; t0 += static_cast<long long>(G) * kUnroll) {
    V v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long t = t0 + static_cast<long long>(u) * G;
      V x{};
      if (t < n) {
        if (pp != nullptr) x = pp[t];
        if (q0 != nullptr) x = vxor(x, q0[t]);
        if (q1 != nullptr) x = vxor(x, q1[t]);
      }
      v[u] = x;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long t = t0 + static_cast<long long>(u) * G;
      if (t < n) o[t] = v[u];
    }
  }
}

// G threads serve one request (G = 1 or 32). The request's first loads
// are issued before the code tables are staged, so the two overlap.
template <typename V, int G, typename Src>
__global__ void __launch_bounds__(kThreads)
xor_gather_kernel(const V* __restrict__ banks, const V* __restrict__ par,
                  Src src, Geometry g, V* __restrict__ out, int n_req) {
  extern __shared__ int tab[];
  const int r = blockIdx.x * (kThreads / G) + threadIdx.x / G;
  const auto f = fetch(src, r < n_req ? r : n_req - 1);
  stage_tables(src, g.n_data, tab);
  if (r >= n_req) return;
  move_row<V, G>(banks, par, resolve(src, g, f, tab), g.row_vecs,
                 out + static_cast<long long>(r) * g.row_vecs,
                 threadIdx.x % G);
}

template <typename V, typename Src>
int launch(const void* banks, const void* par, const Src& src, Geometry g,
           void* out, long long n_req, int table_bytes, cudaStream_t stream) {
  g.row_vecs /= static_cast<long long>(sizeof(V));   // bytes -> vectors
  const int G = g.row_vecs <= kSmallRowVecs ? 1 : 32;
  const long long per_block = kThreads / G;
  const dim3 grid(static_cast<unsigned>((n_req + per_block - 1) / per_block));
  const auto* b = static_cast<const V*>(banks);
  const auto* p = static_cast<const V*>(par);
  auto* o = static_cast<V*>(out);
  if (G == 1)
    xor_gather_kernel<V, 1, Src><<<grid, kThreads, table_bytes, stream>>>(
        b, p, src, g, o, static_cast<int>(n_req));
  else
    xor_gather_kernel<V, 32, Src><<<grid, kThreads, table_bytes, stream>>>(
        b, p, src, g, o, static_cast<int>(n_req));
  return static_cast<int>(cudaGetLastError());
}

template <typename Src>
int dispatch(const void* banks, const void* par, const Src& src, Geometry g,
             void* out, long long n_req, int table_bytes, void* stream) {
  if (n_req <= 0 || n_req > INT_MAX || g.row_vecs <= 0 || g.n_data <= 0 ||
      g.rows <= 0 || g.n_par <= 0 || g.par_rows <= 0 ||
      table_bytes > kMaxTableBytes)
    return static_cast<int>(cudaErrorInvalidValue);
  const uintptr_t align = static_cast<uintptr_t>(g.row_vecs) |
                          reinterpret_cast<uintptr_t>(banks) |
                          reinterpret_cast<uintptr_t>(par) |
                          reinterpret_cast<uintptr_t>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (align % 16 == 0)
    return launch<uint4>(banks, par, src, g, out, n_req, table_bytes, s);
  if (align % 8 == 0)
    return launch<uint2>(banks, par, src, g, out, n_req, table_bytes, s);
  if (align % 4 == 0)
    return launch<uint32_t>(banks, par, src, g, out, n_req, table_bytes, s);
  if (align % 2 == 0)
    return launch<uint16_t>(banks, par, src, g, out, n_req, table_bytes, s);
  return launch<uint8_t>(banks, par, src, g, out, n_req, table_bytes, s);
}

}  // namespace

// Launches the column gather on `stream` and returns cudaGetLastError() (0:
// the launch was accepted). The seven columns are int32 arrays of n_req
// entries; banks is (n_data, rows, row_bytes) and par (n_par, par_rows,
// row_bytes) as raw bytes.
extern "C" int xor_gather(const void* banks, const void* par,
                          const void* bank, const void* row, const void* mode,
                          const void* pidx, const void* prow,
                          const void* sib0, const void* sib1, void* out,
                          int n_data, long long rows, int n_par,
                          long long par_rows, long long row_bytes,
                          long long n_req, void* stream) {
  const Columns c{static_cast<const int32_t*>(bank),
                  static_cast<const int32_t*>(row),
                  static_cast<const int32_t*>(mode),
                  static_cast<const int32_t*>(pidx),
                  static_cast<const int32_t*>(prow),
                  static_cast<const int32_t*>(sib0),
                  static_cast<const int32_t*>(sib1)};
  const Geometry g{n_data, rows, n_par, par_rows, row_bytes};
  return dispatch(banks, par, c, g, out, n_req, 0, stream);
}

// Launches the plan-fed gather of B points' read plans (N candidates each)
// on `stream`; banks is (B, n_data, rows, row_bytes) and par (B, n_par,
// par_rows, row_bytes) as raw bytes, out (B, N, row_bytes). `strides`
// holds the point strides, in elements, of cand_bank, cand_row, mode,
// served, region_slot and fresh_loc (each contiguous within a point).
// rs_active is null (every point's rs_a is rs_scalar) or a (B,) array of
// rs_bytes-wide ints; the code tables are table_bytes-wide ints.
extern "C" int xor_gather_plan(
    const void* banks, const void* par, const void* cand_bank,
    const void* cand_row, const void* mode, const void* served,
    const void* region_slot, const void* fresh_loc, const void* rs_active,
    const void* opt_parity, const void* opt_sibs,
    const long long* strides, void* out, int n_points, int n_cand,
    int n_data, long long rows, int n_par, long long par_rows,
    long long row_bytes, int n_regions, int region_size, int rs_scalar,
    int rs_bytes, int table_bytes, void* stream) {
  if (n_points <= 0 || n_cand <= 0 || n_regions <= 0 || region_size <= 0 ||
      (rs_active == nullptr && rs_scalar <= 0) ||
      (rs_active != nullptr && rs_bytes != 4 && rs_bytes != 8) ||
      (table_bytes != 4 && table_bytes != 8))
    return static_cast<int>(cudaErrorInvalidValue);
  const Plan c{static_cast<const int32_t*>(cand_bank),
               static_cast<const int32_t*>(cand_row),
               static_cast<const int32_t*>(mode),
               static_cast<const uint8_t*>(served),
               static_cast<const int32_t*>(region_slot),
               static_cast<const int32_t*>(fresh_loc),
               rs_active, opt_parity, opt_sibs,
               strides[0], strides[1], strides[2], strides[3], strides[4],
               strides[5], n_cand, n_regions, region_size, rs_scalar,
               rs_active == nullptr ? 0 : rs_bytes, table_bytes};
  const Geometry g{n_data, rows, n_par, par_rows, row_bytes};
  const long long tab = static_cast<long long>(n_data) * kMaxOpts *
                        (1 + kMaxSibs) * static_cast<long long>(sizeof(int));
  return dispatch(banks, par, c, g, out,
                  static_cast<long long>(n_points) * n_cand,
                  static_cast<int>(tab > INT_MAX ? INT_MAX : tab), stream);
}

extern "C" const char* xor_gather_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
