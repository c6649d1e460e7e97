// One-token GQA decode attention read straight from per-sequence coded KV
// banks, written by hand for Hopper (sm_90a).
//
// Replaces the TPU kernel
//   src/repro/kernels/coded_kv_decode/kernel.py::coded_kv_decode_pallas
//   (body _kv_decode_kernel).
//
// What it computes, for each sequence b and query head h (kv head
// kh = h % Hkv, group g = h / Hkv: q is read as (G, Hkv, D)):
//   page t < n_pages lives in bank t % NB, slot t / NB; where
//   use_parity[b, t] is set the page is banks[bank ^ 1][slot] ^
//   par[bank / 2][slot] (the plan is followed even where that parity is
//   stale), else banks[bank][slot]; the lanes are bit-cast to the value
//   type; keys at token index >= seq_len[b] are masked;
//   out[b, h] = softmax(q . K^T * D^-0.5) V, in f32, stored in q's type.
// A sequence with no key (seq_len 0) reads exact zeros, as the TPU kernel's
// isfinite(m) guard and its max(s, 1e-30) give.
//
// Bound: device memory. Per kv head and key it reads one K row and one V
// row of D lanes (twice that on a degraded page: sibling and parity) and
// does about 4 * G * D flops, far below the card's flop/byte ridge. At
// B=16, T=16384, Hkv=2, D=128 in bf16 with 40% of pages degraded the reads
// are ~376 MB: >= 112 us at 3.35 TB/s.
//
// Design, flash-decoding style. The TPU grid is (B,) with a sequential page
// loop per block; here the pages of each (sequence, kv head) are cut into
// n_splits ranges and each range is one block: grid (n_splits, Hkv, B),
// 128 threads. Within a block a row of D lanes is read as L = D*bytes/16
// threads' 16-byte vectors; the block's 128/L lane groups take the page's
// tokens in turn, two tokens per pass so that four (eight when degraded)
// 16-byte loads per thread are in flight. Each thread keeps its slice of
// the G query heads and of the G accumulators in registers, the dot
// products are summed across the L lanes with shuffles, and every lane
// group keeps its own running max, sum and accumulator per head. The page
// choice (direct or sibling ^ parity) is uniform over a block's page (its
// plan flag is read a page ahead), and the XOR is done on the raw lanes
// before any conversion. Pages whose first token is at or past seq_len are
// not read. The wrapper picks n_splits so that the blocks fit the card in
// one wave (two blocks an SM at these register counts). At the end the
// lane groups are
// merged through shared memory into one (m, s, acc) partial per (b, kh,
// split, g), and a second kernel merges the splits and divides, with the
// same guard for all-masked ranges (weight 0 where m = -inf).
//
// Taken: value type f32 (32-bit lanes) or bf16/f16 (16-bit lanes); q and
// the output in f32, bf16 or f16; D*bytes a multiple of 16 with
// D*bytes/16 a power of two <= 32; G <= 8 (16-bit lanes) or <= 16 (f32);
// 16-byte aligned banks and parity. Anything else is refused.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

enum : int { kF32 = 0, kBF16 = 1, kF16 = 2 };

constexpr int kThreads = 128;
constexpr unsigned kFull = 0xffffffffu;

template <int VT> struct Lane { using T = uint16_t; };
template <> struct Lane<kF32> { using T = uint32_t; };

template <int VT>
__device__ __forceinline__ float lane_to_f32(uint32_t bits) {
  if constexpr (VT == kF32) return __uint_as_float(bits);
  else if constexpr (VT == kBF16) return __uint_as_float(bits << 16);
  else return __half2float(__ushort_as_half(static_cast<unsigned short>(bits)));
}

__device__ __forceinline__ float load_f32(const void* p, long long i, int dt) {
  if (dt == kF32) return static_cast<const float*>(p)[i];
  const uint32_t bits = static_cast<const uint16_t*>(p)[i];
  if (dt == kBF16) return __uint_as_float(bits << 16);
  return __half2float(__ushort_as_half(static_cast<unsigned short>(bits)));
}

__device__ __forceinline__ void store_f32(void* p, long long i, int dt,
                                          float x) {
  if (dt == kF32)
    static_cast<float*>(p)[i] = x;
  else if (dt == kBF16)
    static_cast<__nv_bfloat16*>(p)[i] = __float2bfloat16_rn(x);
  else
    static_cast<__half*>(p)[i] = __float2half_rn(x);
}

__device__ __forceinline__ uint4 xor4(uint4 a, uint4 b) {
  return make_uint4(a.x ^ b.x, a.y ^ b.y, a.z ^ b.z, a.w ^ b.w);
}

// The lanes of one 16-byte vector as floats.
template <int VT, int VEC>
__device__ __forceinline__ void unpack(uint4 v, float (&out)[VEC]) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
  if constexpr (VEC == 4) {
#pragma unroll
    for (int e = 0; e < 4; ++e) out[e] = lane_to_f32<VT>(w[e]);
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      out[2 * e] = lane_to_f32<VT>(w[e] & 0xffffu);
      out[2 * e + 1] = lane_to_f32<VT>(w[e] >> 16);
    }
  }
}

struct Args {
  const void* q;
  const uint4* k_banks;
  const uint4* v_banks;
  const uint4* k_par;
  const uint4* v_par;
  const int32_t* use_parity;
  const int32_t* seq_len;
  float* part_m;      // (B, Hkv, n_splits, G)
  float* part_s;      // (B, Hkv, n_splits, G)
  float* part_acc;    // (B, Hkv, n_splits, G, D)
  void* out;          // (B, H, D)
  int q_dt, out_dt;
  int H, Hkv, D, NB, S, P, n_pages, pages_per_split, n_splits;
  float scale;
};

template <int VT, int GM>
__global__ void __launch_bounds__(kThreads)
kv_decode_split_kernel(const Args a) {
  constexpr int VEC = 16 / sizeof(typename Lane<VT>::T);  // lanes a vector
  const float kNegInf = -__int_as_float(0x7f800000);
  const int split = blockIdx.x, kh = blockIdx.y, b = blockIdx.z;
  const int G = a.H / a.Hkv;
  const int L = a.D / VEC;                 // threads per row, power of 2
  const int sub = threadIdx.x % L;         // vector index within the row
  const int grp = threadIdx.x / L;         // lane group within the block
  const int n_grp = kThreads / L;

  float qv[GM][VEC];
#pragma unroll
  for (int g = 0; g < GM; ++g) {
    const long long row = ((long long)b * a.H + g * a.Hkv + kh) * a.D;
#pragma unroll
    for (int e = 0; e < VEC; ++e)
      qv[g][e] = g < G ? load_f32(a.q, row + sub * VEC + e, a.q_dt) : 0.f;
  }
  float m[GM], s[GM], acc[GM][VEC];
#pragma unroll
  for (int g = 0; g < GM; ++g) {
    m[g] = kNegInf;
    s[g] = 0.f;
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[g][e] = 0.f;
  }

  const int slen = a.seq_len[b];
  const int t0 = split * a.pages_per_split;
  // pages from ceil(seq_len / P) on are all masked and not read
  const int t_need = slen <= 0 ? 0 : (int)(((long long)slen + a.P - 1) / a.P);
  const int t_end = min(min(a.n_pages, t0 + a.pages_per_split), t_need);
  const int NG = a.NB / 2;
  const long long row_vecs = L;            // 16-byte vectors in a row
  const int32_t* plan = a.use_parity + (long long)b * a.n_pages;
  int deg_next = t0 < t_end ? plan[t0] : 0;  // the plan read a page ahead
  for (int t = t0; t < t_end; ++t) {
    const int bank = t % a.NB, slot = t / a.NB;
    const bool deg = deg_next != 0;
    if (t + 1 < t_end) deg_next = plan[t + 1];
    const long long row0 =
        ((long long)(b * a.NB + (deg ? bank ^ 1 : bank)) * a.S + slot) * a.P;
    const long long prow0 = ((long long)(b * NG + (bank >> 1)) * a.S + slot) *
                            a.P;
    for (int p0 = 0; p0 < a.P; p0 += 2 * n_grp) {
      int tok[2];
      bool valid[2];
      uint4 kr[2], vr[2];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int p = p0 + u * n_grp + grp;
        tok[u] = t * a.P + p;
        valid[u] = p < a.P && tok[u] < slen;
        kr[u] = vr[u] = make_uint4(0, 0, 0, 0);
        if (valid[u]) {
          const long long off = ((row0 + p) * a.Hkv + kh) * row_vecs + sub;
          kr[u] = a.k_banks[off];
          vr[u] = a.v_banks[off];
          if (deg) {
            const long long poff =
                ((prow0 + p) * a.Hkv + kh) * row_vecs + sub;
            kr[u] = xor4(kr[u], a.k_par[poff]);
            vr[u] = xor4(vr[u], a.v_par[poff]);
          }
        }
      }
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        float kf[VEC];
        unpack<VT, VEC>(kr[u], kf);
        float sc[GM];
#pragma unroll
        for (int g = 0; g < GM; ++g) {
          float d = 0.f;
#pragma unroll
          for (int e = 0; e < VEC; ++e) d = fmaf(qv[g][e], kf[e], d);
          sc[g] = d;
        }
        // every lane of the warp takes part, masked tokens included
        for (int off = L >> 1; off > 0; off >>= 1) {
#pragma unroll
          for (int g = 0; g < GM; ++g)
            sc[g] += __shfl_xor_sync(kFull, sc[g], off);
        }
        if (valid[u]) {
          float vf[VEC];
          unpack<VT, VEC>(vr[u], vf);
#pragma unroll
          for (int g = 0; g < GM; ++g) {
            const float l = sc[g] * a.scale;
            const float mn = fmaxf(m[g], l);
            const float alpha = m[g] == kNegInf ? 0.f : expf(m[g] - mn);
            const float pr = expf(l - mn);
            s[g] = s[g] * alpha + pr;
#pragma unroll
            for (int e = 0; e < VEC; ++e)
              acc[g][e] = fmaf(acc[g][e], alpha, pr * vf[e]);
            m[g] = mn;
          }
        }
      }
    }
  }

  // merge the lane groups' states into one partial per head
  extern __shared__ float smem[];
  float* sm_m = smem;                          // (n_grp, GM)
  float* sm_s = sm_m + n_grp * GM;             // (n_grp, GM)
  float* sm_acc = sm_s + n_grp * GM;           // (n_grp, GM, D)
  if (sub == 0) {
#pragma unroll
    for (int g = 0; g < GM; ++g) {
      sm_m[grp * GM + g] = m[g];
      sm_s[grp * GM + g] = s[g];
    }
  }
#pragma unroll
  for (int g = 0; g < GM; ++g) {
#pragma unroll
    for (int e = 0; e < VEC; ++e)
      sm_acc[(grp * GM + g) * a.D + sub * VEC + e] = acc[g][e];
  }
  __syncthreads();
  const long long base = (((long long)b * a.Hkv + kh) * a.n_splits + split) * G;
  for (int i = threadIdx.x; i < G * a.D; i += kThreads) {
    const int g = i / a.D, d = i % a.D;
    float M = kNegInf;
    for (int j = 0; j < n_grp; ++j) M = fmaxf(M, sm_m[j * GM + g]);
    float S = 0.f, A = 0.f;
    for (int j = 0; j < n_grp; ++j) {
      const float mj = sm_m[j * GM + g];
      const float w = mj == kNegInf ? 0.f : expf(mj - M);
      S = fmaf(sm_s[j * GM + g], w, S);
      A = fmaf(sm_acc[(j * GM + g) * a.D + d], w, A);
    }
    a.part_acc[(base + g) * a.D + d] = A;
    if (d == 0) {
      a.part_m[base + g] = M;
      a.part_s[base + g] = S;
    }
  }
}

// Merge the splits of each (b, h) and write out[b, h] in the output type.
__global__ void __launch_bounds__(kThreads)
kv_decode_combine_kernel(const Args a) {
  const float kNegInf = -__int_as_float(0x7f800000);
  const int h = blockIdx.x, b = blockIdx.y;
  const int G = a.H / a.Hkv;
  const int g = h / a.Hkv, kh = h % a.Hkv;
  const long long first = ((long long)b * a.Hkv + kh) * a.n_splits * G + g;
  // unrolled so that the loads of several splits are in flight at once
  float M = kNegInf;
#pragma unroll 8
  for (int j = 0; j < a.n_splits; ++j)
    M = fmaxf(M, a.part_m[first + (long long)j * G]);
  for (int d = threadIdx.x; d < a.D; d += kThreads) {
    float S = 0.f, A = 0.f;
#pragma unroll 8
    for (int j = 0; j < a.n_splits; ++j) {
      const long long i = first + (long long)j * G;
      const float mj = a.part_m[i];
      const float w = mj == kNegInf ? 0.f : expf(mj - M);
      S = fmaf(a.part_s[i], w, S);
      A = fmaf(a.part_acc[i * a.D + d], w, A);
    }
    store_f32(a.out, ((long long)b * a.H + h) * a.D + d, a.out_dt,
              A / fmaxf(S, 1e-30f));
  }
}

template <int VT, int GM>
int launch(const Args& a, int B, cudaStream_t stream) {
  constexpr int VEC = 16 / sizeof(typename Lane<VT>::T);
  const int n_grp = kThreads / (a.D / VEC);
  const size_t smem = sizeof(float) * (size_t)n_grp * GM * (2 + a.D);
  if (smem > 48 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(a.n_splits, a.Hkv, B);
  kv_decode_split_kernel<VT, GM><<<grid, kThreads, smem, stream>>>(a);
  int err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  kv_decode_combine_kernel<<<dim3(a.H, B), kThreads, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <int VT>
int launch_g(const Args& a, int B, int G, cudaStream_t stream) {
  if (G <= 1) return launch<VT, 1>(a, B, stream);
  if (G <= 2) return launch<VT, 2>(a, B, stream);
  if (G <= 4) return launch<VT, 4>(a, B, stream);
  if (G <= 8) return launch<VT, 8>(a, B, stream);
  if constexpr (VT == kF32) {
    if (G <= 16) return launch<VT, 16>(a, B, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

bool is_dt(int dt) { return dt == kF32 || dt == kBF16 || dt == kF16; }

}  // namespace

// Launches the split and combine kernels on `stream` and returns
// cudaGetLastError() (0: both launches were accepted; cudaErrorInvalidValue
// for a shape or type the kernel does not take). dtype codes: 0 f32,
// 1 bf16, 2 f16. The partial buffers hold B*Hkv*n_splits*G floats (m, s)
// and that times D (acc).
extern "C" int coded_kv_decode(
    const void* q, int q_dt, const void* k_banks, const void* v_banks,
    const void* k_par, const void* v_par, const void* use_parity,
    const void* seq_len, void* part_m, void* part_s, void* part_acc,
    void* out, int out_dt, int value_dt, int B, int H, int Hkv, int D, int NB,
    int S, int P, int n_pages, int n_splits, float scale, void* stream) {
  if (!is_dt(q_dt) || !is_dt(out_dt) || !is_dt(value_dt) || B <= 0 ||
      H <= 0 || Hkv <= 0 || H % Hkv != 0 || D <= 0 || NB <= 0 || NB % 2 ||
      S <= 0 || P <= 0 || n_pages < 0 || n_pages > NB * S || n_splits <= 0 ||
      Hkv > 65535 || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const int lane_bytes = value_dt == kF32 ? 4 : 2;
  const int row_bytes = D * lane_bytes;
  const int L = row_bytes / 16;
  if (row_bytes % 16 != 0 || L > 32 || (L & (L - 1)) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const uintptr_t align =
      reinterpret_cast<uintptr_t>(k_banks) | reinterpret_cast<uintptr_t>(v_banks) |
      reinterpret_cast<uintptr_t>(k_par) | reinterpret_cast<uintptr_t>(v_par);
  if (align % 16 != 0) return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.q = q;
  a.k_banks = static_cast<const uint4*>(k_banks);
  a.v_banks = static_cast<const uint4*>(v_banks);
  a.k_par = static_cast<const uint4*>(k_par);
  a.v_par = static_cast<const uint4*>(v_par);
  a.use_parity = static_cast<const int32_t*>(use_parity);
  a.seq_len = static_cast<const int32_t*>(seq_len);
  a.part_m = static_cast<float*>(part_m);
  a.part_s = static_cast<float*>(part_s);
  a.part_acc = static_cast<float*>(part_acc);
  a.out = out;
  a.q_dt = q_dt;
  a.out_dt = out_dt;
  a.H = H;
  a.Hkv = Hkv;
  a.D = D;
  a.NB = NB;
  a.S = S;
  a.P = P;
  a.n_pages = n_pages;
  a.n_splits = n_splits;
  a.pages_per_split = n_pages == 0 ? 1 : (n_pages + n_splits - 1) / n_splits;
  a.scale = scale;
  const int G = H / Hkv;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (value_dt) {
    case kF32: return launch_g<kF32>(a, B, G, s);
    case kBF16: return launch_g<kBF16>(a, B, G, s);
    default: return launch_g<kF16>(a, B, G, s);
  }
}

extern "C" const char* coded_kv_decode_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
