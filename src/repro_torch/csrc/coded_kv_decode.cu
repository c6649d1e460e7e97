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
// does about 4 * G * D flops, ~8 flops a byte, far below the card's ridge
// (~295). At B=16, T=16384, Hkv=2, D=128 in bf16 with 40% of pages
// degraded it must move ~290 MB: >= 87 us at 3.35 TB/s.
//
// Two launches a call. The three split kernels are flash-decoding: the
// pages of each (sequence, kv head) are cut into n_splits ranges, and the
// query heads of a kv head into head groups of at most GM heads (one
// group unless G exceeds the kernel's GM); one block of 128 threads takes
// a (range, head group) (grid (n_splits, groups x Hkv, B)), so a kv
// head's K/V tiles are read once a group, the later groups mostly from
// L2, and leaves one (m, s, acc) partial per head. Then
// kv_decode_combine_kernel (one block per (head, sequence)) merges them:
// online over chunks of 16 ranges, a partial with m = -inf weighed by 0,
// divided by the summed weights. Two designs with fewer launches were
// measured and not kept: a merge inside the split kernel (the last block
// of a head group to finish merges the group's ranges, found through an
// arrival count in a device workspace) saved no time against the second
// launch, and a split kernel that writes the outputs itself where a call
// has one range cost 0.3-0.7 us at the shapes with several (its second
// epilogue slows the kernel even where it is not taken). The wrapper
// picks n_splits to minimise waves x (pages a range + 1) over
// 1..n_pages, from the split kernel's occupancy (coded_kv_decode_occupancy)
// and the card's SM count.
//
// 16-bit lanes (bf16, f16): kv_decode_tc_kernel, on the tensor cores.
//   Work: the block's 4 warps form 4 / CW tile chains of CW warps; each
//   chain walks its own 8-token tiles of the block's token range (tiles c,
//   c + chains, ...) with its own ring of 3 shared-memory stages filled by
//   cp.async.cg 16-byte copies (the chain's warps issue a share each); a
//   chain asks for tile j + 2 before it waits for tile j, so three tiles
//   are in flight while it waits. Every warp of a chain computes the whole
//   S = Q K^T of the tile and O for its D / CW columns, so a chain's warps
//   keep the same running max and sum and meet at a named barrier twice a
//   tile. CW = 2 at D = 256 (1 elsewhere): 16 columns' tiles of O a warp
//   (64 registers, no spill) and a 96 KB ring, so two blocks fit an SM.
//   The block first asks for q, seq_len and the plan flags of its first
//   pages at once (the flags as one ballot mask a warp, moved on every 32
//   pages), then for its first tiles, and only then stages q through
//   shared memory into the A fragments. A tile may span pages: each token
//   row's address comes from its own page (bank, slot, plan bit). A stage
//   holds the tile's K and V rows and a parity row for each: a direct
//   row's parity is zero-filled (src-size 0) and a masked token's K, V
//   and parity too, so the XOR is one branch-free instruction per
//   fragment register and reads nothing more from device memory. (Skipping
//   the parity copies, reads and XORs of a tile with no degraded row, a
//   flag per stage, was measured and lost 0.5-4 us at the serving shapes:
//   the branches broke up the fragment loads' schedule.) Rows are stored
//   with a 16-byte-chunk swizzle so that ldmatrix reads no bank twice. TMA
//   is later work: the rows of one tile come from up to 8 pages, each from
//   its bank or its sibling and parity.
//   Math (the FlashAttention-2 register pattern): S = Q K^T with
//   mma.sync.m16n8k16 (query rows in M, the tile's tokens in N, K from
//   ldmatrix; K ^ parity on the raw fragment registers), one online
//   softmax per (head, key) in the C fragment (row max: two quad
//   shuffles; O is rescaled only when some row's max moved), then
//   O += P V with P's A fragment built in registers from S and V from
//   ldmatrix.trans (V ^ parity likewise). O stays in f32 accumulators.
//   wgmma is the wrong tool here: its 64-row minimum against G <= 16 query
//   rows would waste 3/4 to 7/8 of it, and the flops are not the limit
//   anyway; mma.sync is there to replace the scalar FMAs and shuffles that
//   made the first version issue-bound.
//   Precision with f32 accumulation and no looser tolerance than the
//   scalar kernel: K and V are exact in their type, q and p are not. q is
//   split into hi + lo parts of the lane type (lo = type(q - hi)); for
//   G <= 8 hi(q) fills rows 0..G-1 and lo(q) rows 8..8+G-1 of the one
//   16-row A tile, so the score is c[0] + c[2] (and c[1] + c[3]) inside
//   the thread; for 8 < G <= 16 the lo part is a second mma, skipped when
//   q has no lo part. p is split into three parts: in the k16 P.V product
//   the k columns 0..7 are the tile's tokens with hi(p) in row gid and
//   lo(p) in row gid+8, the columns 8..15 the same tokens again (V's
//   fragment register given twice) with lo2(p) in row gid; O's two row
//   halves are added at the end (G > 8: lo2 is an m16n8k8 product of its
//   own). A bf16 or f16 q has no lo part, so a q given in f32 with the
//   same values gives bit-identical f32 results. The scores are scaled by
//   D^-0.5 log2(e) after the product and exponentiated with exp2f; the
//   split's maximum is written back in natural units (times ln 2), as the
//   f32 kernels write it, for the one merge.
//   Taken: D = 8, 16, 32, 64, 96, 128, 160 or 256 (the repo's configs'
//   head widths and their reduced forms; D = 8 pads the k dimension with
//   zeros); head groups of up to 16 heads, 8 at D = 160 and 256, where 16
//   heads' O would not fit the registers. At D = 96 and 160 a row is 12
//   and 20 chunks, not a power of two: the swizzle then flips only the low
//   two chunk bits, inside aligned groups of 4 chunks, which still puts the
//   8 rows an ldmatrix reads in 8 distinct bank groups (the 192- and
//   320-byte row strides move odd rows by 4 groups).
//
// f32 lanes: kv_decode_split_kernel, scalar. Within a block a row of D
//   lanes is read by L = D*4/(16 NV) threads, NV 16-byte vectors each;
//   the block's 128/L lane groups take the page's tokens in turn, two
//   tokens per pass.
//   Each thread keeps its slice of the G query heads and accumulators in
//   registers, the dot products are summed across the L lanes with
//   shuffles, and every lane group keeps its own running max, sum and
//   accumulator per head, merged through shared memory at the end. The
//   page choice (direct or sibling ^ parity) is uniform over a page (its
//   plan flag is read a page ahead). f32 on tensor cores would be TF32,
//   which breaks the 1e-5 contract. Taken: D*4 a power-of-two multiple of
//   16 up to 512 bytes (one vector a thread, NV = 1) in head groups of up
//   to 16, or D = 160 (40 vectors a row: 8 threads of NV = 5 vectors
//   each) in head groups of up to 2, which keeps q and the accumulators
//   in registers.
//
// Every other width, in any lane type: kv_decode_general_kernel, scalar,
//   D given at run time. A row is read in W-byte vectors, W the largest of
//   16, 8, 4 and 2 that divides the row's bytes and the banks' alignment
//   (a 200-byte bf16 row at D = 100: 8 bytes; D = 13: single lanes). Each
//   thread owns a fixed set of a row's vectors (vectors sub, sub + L, ...
//   of the L threads of its lane group, L a power of two <= 32) and keeps
//   q's lanes there for the block's heads, and their running max, sum and
//   accumulators, in registers; a score is summed over the thread's lanes
//   and then across the lane group with shuffles. The block's 128 / L lane
//   groups take the range's tokens in turn. Rows of up to 256 lanes take
//   the small tiling (at most 8 lanes a thread, head groups of up to 8);
//   there each thread copies its own vectors of K, V (and, on a degraded
//   page, of both parities) with cp.async into its own slots of a ring of
//   4 token stages in shared memory, three tokens ahead of the one it
//   computes, and reads back only what it copied (no barrier, no row read
//   once per head). W = 2 (rows that are no whole number of 4 bytes, or
//   banks aligned to 2 bytes only) loads straight into registers. Wider
//   rows take the large tiling (at most 64 lanes a thread, one head a
//   block) and load straight into registers too; a row of more than
//   2,048 lanes (32 x 64) is cut into column slices of about equal width,
//   one block each (grid z B x slices): every slice's block sums the whole
//   row's scores, its own lanes' q from registers and the others' from
//   device memory, slice by slice in the same order, so that all of them
//   agree on each score bit for bit, and keeps its own slice's
//   accumulators (K is read once a slice, mostly from L2). The online softmax runs in log2 units with exp2f, one exp a
//   head and token (of alpha = exp(m - max) and p = exp(x - max) one is
//   exp(0)), and the accumulators are multiplied by alpha only on steps
//   where some head's max moved in the warp (a vote). Same splits from its
//   own occupancy, f32 partials and the same merge. Its bound is the bytes
//   above; at one token a lane group a step its work is issue-bound FMAs
//   and shuffles, far fewer instructions a byte than the shared-memory
//   staging it replaced.
//
// q and the output may be f32, bf16 or f16 whatever the lanes are. The
// tensor-core and scalar kernels need 16-byte aligned banks and parity
// (refused otherwise); the general kernel only lane-aligned ones.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

enum : int { kF32 = 0, kBF16 = 1, kF16 = 2 };

constexpr int kThreads = 128;
constexpr unsigned kFull = 0xffffffffu;

// A 16-bit lane (the low half of `bits`) of type VT as a float.
template <int VT>
__device__ __forceinline__ float lane_to_f32(uint32_t bits) {
  if constexpr (VT == kBF16) return __uint_as_float(bits << 16);
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

// A shared-memory address as the 32-bit operand of cp.async and ldmatrix.
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The four f32 lanes of one 16-byte vector.
__device__ __forceinline__ void unpack4(uint4 v, float (&out)[4]) {
  out[0] = __uint_as_float(v.x);
  out[1] = __uint_as_float(v.y);
  out[2] = __uint_as_float(v.z);
  out[3] = __uint_as_float(v.w);
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
  int GB;             // query heads a block takes (its head group)
  float scale;
  int p_shift, nb_shift;  // log2 of P and NB where powers of two, else -1
  int v_dt;           // the lanes' value type (the general kernel's)
  int gen_l, gen_nv;  // general kernel: threads a row, vectors a thread
  int slices;        // general kernel: column slices of a row (grid z is
                      // B x slices); 1 elsewhere
};

constexpr int kWarps = kThreads / 32;

// x / d and x % d for x >= 0, with a shift where d is a power of two
__device__ __forceinline__ int div_by(int x, int d, int shift) {
  return shift >= 0 ? x >> shift : x / d;
}

// The head group of block row blockIdx.y: its kv head, its first query
// head g0 (heads g0 .. g0 + n - 1 of that kv head) and its head count n.
struct HeadGroup {
  int kh, g0, n;
};
__device__ __forceinline__ HeadGroup head_group(const Args& a) {
  const int kh = blockIdx.y % a.Hkv;
  const int g0 = (blockIdx.y / a.Hkv) * a.GB;
  return {kh, g0, min(a.GB, a.H / a.Hkv - g0)};
}

// Where head g0's partial of range `split` lives (head g0 + g's at
// part_base + g): m and s at that index, acc at D times it.
__device__ __forceinline__ long long part_base(const Args& a, int b,
                                               const HeadGroup& hg,
                                               int split) {
  return (((long long)b * a.Hkv + hg.kh) * a.n_splits + split) *
             (a.H / a.Hkv) + hg.g0;
}

// ------------------------------------------------------- the split merge
// The merge kernel, launched after a split kernel with more than one
// range: block (h, b) merges the n_splits partials of out[b, h] and
// writes it in the output type, an online merge over chunks of kChunk
// ranges, each chunk's loads issued together (one round trip for up to
// kChunk ranges); a partial with m = -inf weighs 0.
constexpr int kChunk = 16;

__global__ void __launch_bounds__(kThreads)
kv_decode_combine_kernel(const Args a) {
  const float kNegInf = -__int_as_float(0x7f800000);
  const int h = blockIdx.x, b = blockIdx.y;
  const int G = a.H / a.Hkv;
  const int g = h / a.Hkv, kh = h % a.Hkv;
  const long long first = ((long long)b * a.Hkv + kh) * a.n_splits * G + g;
  for (int d = threadIdx.x; d < a.D; d += kThreads) {
    float M = kNegInf, S = 0.f, A = 0.f;
    for (int j0 = 0; j0 < a.n_splits; j0 += kChunk) {
      float mj[kChunk], sj[kChunk], aj[kChunk];
#pragma unroll
      for (int u = 0; u < kChunk; ++u) {
        const int j = j0 + u;
        mj[u] = kNegInf;
        sj[u] = aj[u] = 0.f;
        if (j < a.n_splits) {
          const long long i = first + (long long)j * G;
          mj[u] = a.part_m[i];
          sj[u] = a.part_s[i];
          aj[u] = a.part_acc[i * a.D + d];
        }
      }
      float Mc = M;
#pragma unroll
      for (int u = 0; u < kChunk; ++u) Mc = fmaxf(Mc, mj[u]);
      if (Mc == kNegInf) continue;       // no live key so far
      const float r = M == kNegInf ? 0.f : expf(M - Mc);
      S *= r;
      A *= r;
#pragma unroll
      for (int u = 0; u < kChunk; ++u) {
        const float w = mj[u] == kNegInf ? 0.f : expf(mj[u] - Mc);
        S = fmaf(sj[u], w, S);
        A = fmaf(aj[u], w, A);
      }
      M = Mc;
    }
    store_f32(a.out, ((long long)b * a.H + h) * a.D + d, a.out_dt,
              A / fmaxf(S, 1e-30f));
  }
}

// ------------------------------------------------------ f32 lanes, scalar
// NV: 16-byte vectors a thread takes of each row (thread sub takes
// vectors sub, sub + L, ...).
template <int GM, int NV>
__global__ void __launch_bounds__(kThreads)
kv_decode_split_kernel(const Args a) {
  constexpr int VEC = 4;                   // f32 lanes a 16-byte vector
  const float kNegInf = -__int_as_float(0x7f800000);
  const int split = blockIdx.x, b = blockIdx.z;
  const HeadGroup hg = head_group(a);
  const int kh = hg.kh, G = hg.n;
  const int L = a.D / (VEC * NV);          // threads per row, power of 2
  const int sub = threadIdx.x % L;         // first vector within the row
  const int grp = threadIdx.x / L;         // lane group within the block
  const int n_grp = kThreads / L;

  float qv[GM][NV][VEC];
#pragma unroll
  for (int g = 0; g < GM; ++g) {
    const long long row =
        ((long long)b * a.H + (hg.g0 + g) * a.Hkv + kh) * a.D;
#pragma unroll
    for (int v = 0; v < NV; ++v)
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        qv[g][v][e] = g < G ? load_f32(a.q, row + (sub + L * v) * VEC + e,
                                       a.q_dt)
                            : 0.f;
  }
  float m[GM], s[GM], acc[GM][NV][VEC];
#pragma unroll
  for (int g = 0; g < GM; ++g) {
    m[g] = kNegInf;
    s[g] = 0.f;
#pragma unroll
    for (int v = 0; v < NV; ++v)
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[g][v][e] = 0.f;
  }

  const int slen = a.seq_len[b];
  const int t0 = split * a.pages_per_split;
  // pages from ceil(seq_len / P) on are all masked and not read
  const int t_need = slen <= 0 ? 0 : (int)(((long long)slen + a.P - 1) / a.P);
  const int t_end = min(min(a.n_pages, t0 + a.pages_per_split), t_need);
  const int NG = a.NB / 2;
  const long long row_vecs = L * NV;       // 16-byte vectors in a row
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
      uint4 kr[2][NV], vr[2][NV];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int p = p0 + u * n_grp + grp;
        tok[u] = t * a.P + p;
        valid[u] = p < a.P && tok[u] < slen;
#pragma unroll
        for (int v = 0; v < NV; ++v) {
          kr[u][v] = vr[u][v] = make_uint4(0, 0, 0, 0);
          if (valid[u]) {
            const long long off =
                ((row0 + p) * a.Hkv + kh) * row_vecs + sub + L * v;
            kr[u][v] = a.k_banks[off];
            vr[u][v] = a.v_banks[off];
            if (deg) {
              const long long poff =
                  ((prow0 + p) * a.Hkv + kh) * row_vecs + sub + L * v;
              kr[u][v] = xor4(kr[u][v], a.k_par[poff]);
              vr[u][v] = xor4(vr[u][v], a.v_par[poff]);
            }
          }
        }
      }
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        float kf[NV][VEC];
#pragma unroll
        for (int v = 0; v < NV; ++v) unpack4(kr[u][v], kf[v]);
        float sc[GM];
#pragma unroll
        for (int g = 0; g < GM; ++g) {
          float d = 0.f;
#pragma unroll
          for (int v = 0; v < NV; ++v)
#pragma unroll
            for (int e = 0; e < VEC; ++e) d = fmaf(qv[g][v][e], kf[v][e], d);
          sc[g] = d;
        }
        // every lane of the warp takes part, masked tokens included
        for (int off = L >> 1; off > 0; off >>= 1) {
#pragma unroll
          for (int g = 0; g < GM; ++g)
            sc[g] += __shfl_xor_sync(kFull, sc[g], off);
        }
        if (valid[u]) {
          float vf[NV][VEC];
#pragma unroll
          for (int v = 0; v < NV; ++v) unpack4(vr[u][v], vf[v]);
#pragma unroll
          for (int g = 0; g < GM; ++g) {
            const float l = sc[g] * a.scale;
            const float mn = fmaxf(m[g], l);
            const float alpha = m[g] == kNegInf ? 0.f : expf(m[g] - mn);
            const float pr = expf(l - mn);
            s[g] = s[g] * alpha + pr;
#pragma unroll
            for (int v = 0; v < NV; ++v)
#pragma unroll
              for (int e = 0; e < VEC; ++e)
                acc[g][v][e] = fmaf(acc[g][v][e], alpha, pr * vf[v][e]);
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
    for (int v = 0; v < NV; ++v)
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        sm_acc[(grp * GM + g) * a.D + (sub + L * v) * VEC + e] = acc[g][v][e];
  }
  __syncthreads();
  const long long base = part_base(a, b, hg, split);
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

// ------------------------------------------------- 16-bit lanes, tensor cores
constexpr int kTile = 8;        // tokens a chain takes at a time
constexpr int kStages = 3;      // ring stages a chain

// Bytes of shared memory: q as f32 (GM rows of D), then each chain's ring
// of kStages stages, each stage four buffers (K, K parity, V, V parity)
// of kTile rows of D 2-byte lanes. After the walk the same memory holds
// the chains' states for the block's merge.
template <int D, int GM>
__host__ __device__ constexpr size_t tc_q_bytes() {
  return sizeof(float) * GM * D;
}
template <int D, int GM, int CW>
constexpr size_t tc_smem_bytes() {
  return tc_q_bytes<D, GM>() +
         (size_t)(kWarps / CW) * kStages * 4 * kTile * D * 2;
}

// The 16-byte chunk a row's chunk c is stored in: rows of a tile at the
// same chunk fall in distinct 16-byte bank groups (ldmatrix reads 8 rows).
// NC = 12 (D = 96) and 20 (D = 160) are 4 mod 8: the row stride moves odd
// rows by 4 of the 8 bank groups, so flipping the low two chunk bits by
// r / 2 spreads the 8 rows over 8 groups inside each aligned group of 4
// chunks (NC = 4 is the same case).
template <int NC>
__device__ __forceinline__ int swz(int r, int c) {
  if constexpr (NC % 8 == 0) return c ^ r;                 // 8, 16, 32
  else if constexpr (NC % 8 == 4) return c ^ ((r >> 1) & 3);  // 4, 12, 20
  else if constexpr (NC == 2) return c ^ ((r >> 2) & 1);
  else {
    static_assert(NC == 1, "no swizzle for this row width");
    return c;
  }
}

// 16 bytes from global to shared, or zeros where src_bytes is 0
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}
// W = 4, 8 or 16 bytes from global to shared (through L1), or zeros where
// src_bytes is 0
template <int W>
__device__ __forceinline__ void cp_async_ca(uint32_t dst, const void* src,
                                            int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(dst),
               "l"(src), "n"(W), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The CW warps of tile chain `chain` meet (a named barrier; a warp alone:
// __syncwarp). Barrier 0 is __syncthreads'.
template <int CW>
__device__ __forceinline__ void chain_sync(int chain) {
  if constexpr (CW == 1)
    __syncwarp();
  else
    asm volatile("bar.sync %0, %1;\n" ::"r"(chain + 1), "n"(CW * 32)
                 : "memory");
}

// X 8x8 matrices of 16-bit lanes (X = 1, 2, 4), plain or transposed
template <int X, bool TRANS>
__device__ __forceinline__ void ldsm(uint32_t (&r)[X], uint32_t addr) {
  if constexpr (X == 4) {
    if constexpr (TRANS)
      asm volatile(
          "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, "
          "[%4];\n"
          : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
          : "r"(addr)
          : "memory");
    else
      asm volatile(
          "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
          : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
          : "r"(addr)
          : "memory");
  } else if constexpr (X == 2) {
    if constexpr (TRANS)
      asm volatile(
          "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
          : "=r"(r[0]), "=r"(r[1])
          : "r"(addr)
          : "memory");
    else
      asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
                   : "=r"(r[0]), "=r"(r[1])
                   : "r"(addr)
                   : "memory");
  } else {
    if constexpr (TRANS)
      asm volatile(
          "ldmatrix.sync.aligned.m8n8.x1.trans.shared.b16 {%0}, [%1];\n"
          : "=r"(r[0])
          : "r"(addr)
          : "memory");
    else
      asm volatile("ldmatrix.sync.aligned.m8n8.x1.shared.b16 {%0}, [%1];\n"
                   : "=r"(r[0])
                   : "r"(addr)
                   : "memory");
  }
}

// d += a(16x16) . b(16x8), f32 accumulate
template <int VT>
__device__ __forceinline__ void mma16816(float (&d)[4], uint32_t a0,
                                         uint32_t a1, uint32_t a2, uint32_t a3,
                                         uint32_t b0, uint32_t b1) {
  if constexpr (VT == kBF16)
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
  else
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// d += a(16x8) . b(8x8), f32 accumulate
template <int VT>
__device__ __forceinline__ void mma1688(float (&d)[4], uint32_t a0,
                                        uint32_t a1, uint32_t b0) {
  if constexpr (VT == kBF16)
    asm volatile(
        "mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5}, {%6}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a0), "r"(a1), "r"(b0));
  else
    asm volatile(
        "mma.sync.aligned.m16n8k8.row.col.f32.f16.f16.f32 "
        "{%0,%1,%2,%3}, {%4,%5}, {%6}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a0), "r"(a1), "r"(b0));
}

// Two floats rounded to the lane type, x in the low half (the lower
// column of an mma fragment register), and back.
template <int VT>
__device__ __forceinline__ uint32_t pack2(float x, float y) {
  if constexpr (VT == kBF16) {
    const __nv_bfloat162 v = __floats2bfloat162_rn(x, y);
    return *reinterpret_cast<const uint32_t*>(&v);
  } else {
    const __half2 v = __floats2half2_rn(x, y);
    return *reinterpret_cast<const uint32_t*>(&v);
  }
}
template <int VT>
__device__ __forceinline__ float2 unpack2(uint32_t r) {
  return make_float2(lane_to_f32<VT>(r & 0xffffu), lane_to_f32<VT>(r >> 16));
}

// x = hi + lo (+ the rest): both parts packed two to a register
template <int VT>
__device__ __forceinline__ void split2(float x, float y, uint32_t& hi,
                                       uint32_t& lo) {
  hi = pack2<VT>(x, y);
  const float2 h = unpack2<VT>(hi);
  lo = pack2<VT>(x - h.x, y - h.y);
}
template <int VT>
__device__ __forceinline__ void split3(float x, float y, uint32_t& hi,
                                       uint32_t& lo, uint32_t& lo2) {
  hi = pack2<VT>(x, y);
  const float2 h = unpack2<VT>(hi);
  const float rx = x - h.x, ry = y - h.y;
  lo = pack2<VT>(rx, ry);
  const float2 l = unpack2<VT>(lo);
  lo2 = pack2<VT>(rx - l.x, ry - l.y);
}

// A warp's window of the plan: bit i of `bits` is use_parity[b, base + i]
// (0 past the block's last page).
struct PlanWindow {
  int base;
  uint32_t bits;
};

__device__ __forceinline__ PlanWindow load_plan(const Args& a, int b,
                                                int base, int t_end,
                                                int lane) {
  const int t = base + lane;
  const bool deg = t < t_end && a.use_parity[(long long)b * a.n_pages + t];
  return {base, __ballot_sync(kFull, deg)};
}

// Copies of one tile: chunk e = ct + 32 CW u of its kTile rows x NC
// chunks (ct: the thread's index in its chain), into each of the stage's
// four buffers. Every row's page is in `win`.
template <int D, int CW>
__device__ __forceinline__ void issue_tile(const Args& a, int b, int kh,
                                           int tok0, int tok_end,
                                           const PlanWindow& win,
                                           uint32_t stage, int ct) {
  constexpr int NC = D / 8;              // 16-byte chunks in a row
  constexpr int BUF = kTile * NC * 16;   // bytes of one buffer
  constexpr int N = kTile * NC;          // chunks a buffer
  constexpr int PER = (N + 32 * CW - 1) / (32 * CW);
  const int NG = a.NB / 2;
#pragma unroll
  for (int u = 0; u < PER; ++u) {
    const int e = ct + 32 * CW * u;
    if constexpr (N % (32 * CW) != 0) {
      if (e >= N) break;
    }
    const int r = e / NC, c = e % NC;
    const int tok = tok0 + r;
    const uint32_t dst = stage + (r * NC + swz<NC>(r, c)) * 16;
    const uint4* ks = a.k_banks;
    const uint4* vs = a.v_banks;
    const uint4* kps = a.k_par;
    const uint4* vps = a.v_par;
    int n_row = 0, n_par = 0;            // bytes to copy (0: zero-fill)
    if (tok < tok_end) {
      const int t = div_by(tok, a.P, a.p_shift), p = tok - t * a.P;
      const int slot = div_by(t, a.NB, a.nb_shift), bank = t - slot * a.NB;
      const bool deg = (win.bits >> (t - win.base)) & 1u;
      const long long row =
          ((long long)(b * a.NB + (deg ? bank ^ 1 : bank)) * a.S + slot) *
              a.P + p;
      const long long off = (row * a.Hkv + kh) * NC + c;
      ks += off;
      vs += off;
      n_row = 16;
      if (deg) {
        const long long prow =
            ((long long)(b * NG + (bank >> 1)) * a.S + slot) * a.P + p;
        const long long poff = (prow * a.Hkv + kh) * NC + c;
        kps += poff;
        vps += poff;
        n_par = 16;
      }
    }
    cp_async16(dst, ks, n_row);
    cp_async16(dst + 2 * BUF, vs, n_row);
    cp_async16(dst + BUF, kps, n_par);
    cp_async16(dst + 3 * BUF, vps, n_par);
  }
}

// One split of one (sequence, kv head): GM = 8 packs hi(q) and lo(q) of
// up to 8 heads into one 16-row tile; GM = 16 takes up to 16 heads, one
// row each, with hi and lo as two products. CW warps share a tile chain,
// each with D / CW of O's columns.
template <int VT, int D, int GM, int CW>
__global__ void __launch_bounds__(kThreads)
kv_decode_tc_kernel(const Args a) {
  constexpr int NC = D / 8;              // chunks a row = n8 tiles of O
  constexpr int NCW = NC / CW;           // O's n8 tiles this warp keeps
  constexpr int KS = (D + 15) / 16;      // k16 steps of q.k
  constexpr int X = NC < 4 ? NC : 4;     // matrices an ldmatrix takes
  constexpr int XV = NCW < 4 ? NCW : 4;  // ... of V, in this warp's columns
  constexpr int BUF = kTile * NC * 16;
  constexpr int STAGE = 4 * BUF;
  constexpr int CHAINS = kWarps / CW;
  constexpr bool PACKED = GM == 8;
  static_assert(NC % CW == 0 && NCW % XV == 0, "columns split unevenly");
  const float kNegInf = -__int_as_float(0x7f800000);
  extern __shared__ __align__(16) unsigned char tc_smem[];

  const int split = blockIdx.x, b = blockIdx.z;
  const HeadGroup hg = head_group(a);
  const int kh = hg.kh, G = hg.n;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int chain = warp / CW, part = warp % CW;
  const int gid = lane >> 2, t4 = lane & 3;

  // q's lanes, the sequence's length and the first tile's plan window:
  // every load in flight at once, before the first tiles are asked for
  constexpr int QN = (GM * D + kThreads - 1) / kThreads;
  uint32_t qraw[QN];
#pragma unroll
  for (int u = 0; u < QN; ++u) {
    const int i = threadIdx.x + u * kThreads, g = i / D;
    qraw[u] = 0u;
    if (i < GM * D && g < G) {
      const long long at =
          ((long long)b * a.H + (hg.g0 + g) * a.Hkv + kh) * D + i % D;
      qraw[u] = a.q_dt == kF32 ? __ldg(static_cast<const uint32_t*>(a.q) + at)
                               : __ldg(static_cast<const uint16_t*>(a.q) + at);
    }
  }
  const int slen = a.seq_len[b];
  const int t0 = split * a.pages_per_split;
  const int t_end = min(a.n_pages, t0 + a.pages_per_split);
  const int tok_begin = t0 * a.P;
  PlanWindow win = load_plan(
      a, b, div_by(tok_begin + chain * kTile, a.P, a.p_shift), t_end, lane);
  const int tok_end = slen <= 0 ? tok_begin : min(t_end * a.P, slen);
  const int n_tiles = tok_end > tok_begin
                          ? (tok_end - tok_begin + kTile - 1) / kTile : 0;
  const int my_tiles =
      n_tiles > chain ? (n_tiles - chain + CHAINS - 1) / CHAINS : 0;
  const uint32_t ring =
      smem_u32(tc_smem) + tc_q_bytes<D, GM>() + chain * kStages * STAGE;
  // a chain's j-th tile: its first token, and the copies that ask for it,
  // with the plan window moved on where the tile's last page is past it
  // (the same decision on every lane of the chain)
  auto tile_tok = [&](int j) {
    return tok_begin + (chain + CHAINS * j) * kTile;
  };
  auto issue = [&](int j) {
    const int tok0 = tile_tok(j);
    const int last = div_by(min(tok0 + kTile, tok_end) - 1, a.P, a.p_shift);
    if (last - win.base >= 32)
      win = load_plan(a, b, div_by(tok0, a.P, a.p_shift), t_end, lane);
    issue_tile<D, CW>(a, b, kh, tok0, tok_end, win,
                      ring + (j % kStages) * STAGE, part * 32 + lane);
  };
#pragma unroll
  for (int j = 0; j < kStages - 1; ++j) {
    if (j < my_tiles) issue(j);
    cp_async_commit();
  }

  float* sq = reinterpret_cast<float*>(tc_smem);     // (GM, D)
#pragma unroll
  for (int u = 0; u < QN; ++u) {
    const int i = threadIdx.x + u * kThreads;
    if (i < GM * D)
      sq[i] = a.q_dt == kF32 ? __uint_as_float(qraw[u])
              : a.q_dt == kBF16 ? lane_to_f32<kBF16>(qraw[u])
                                : lane_to_f32<kF16>(qraw[u]);
  }
  // q's A fragments: register i of k-step kk holds columns 16 kk + 2 t4
  // (+8 for i = 2, 3), rows gid (i = 0, 2) and gid + 8 (i = 1, 3)
  __syncthreads();
  uint32_t qa[KS][4], qlo[PACKED ? 1 : KS][4];
  bool any_lo = false;
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int d0 = 16 * kk + 8 * half + 2 * t4;
#pragma unroll
      for (int row = 0; row < 2; ++row) {
        // PACKED: both rows are head gid (hi, then lo); else heads gid and
        // gid + 8
        const int g = PACKED ? gid : gid + 8 * row;
        const float x = d0 < D ? sq[g * D + d0] : 0.f;
        const float y = d0 < D ? sq[g * D + d0 + 1] : 0.f;
        uint32_t hi, lo;
        split2<VT>(x, y, hi, lo);
        any_lo |= lo != 0u;
        if constexpr (PACKED) {
          if (row == 0) qa[kk][2 * half] = hi;
          else qa[kk][2 * half + 1] = lo;
        } else {
          qa[kk][2 * half + row] = hi;
          qlo[kk][2 * half + row] = lo;
        }
      }
    }
  }
  const bool has_lo = __any_sync(kFull, any_lo);
  // ldmatrix row addresses: lane gives row (lane & 7) of matrix lane >> 3
  const int lrow = lane & 7, lmat = (lane >> 3) % X, lmatv = (lane >> 3) % XV;

  float o[NCW][4];
#pragma unroll
  for (int n = 0; n < NCW; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  // running max (log2 units) and this thread's part of the sum, per row
  // half: PACKED uses half 0 (head gid), else halves 0 and 1 (gid, gid + 8)
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  const float scale2 = a.scale * 1.4426950408889634f;

  for (int j = 0; j < my_tiles; ++j) {
    // the stage tile j - 1 used is free once every warp of the chain is
    // done with it: ask for tile j + kStages - 1 there before waiting for
    // tile j, so that kStages tiles are in flight
    chain_sync<CW>(chain);
    if (j + kStages - 1 < my_tiles) issue(j + kStages - 1);
    cp_async_commit();
    cp_async_wait<kStages - 1>();
    chain_sync<CW>(chain);               // the chain's copies of tile j
    const uint32_t st = ring + (j % kStages) * STAGE;
    const int tok0 = tile_tok(j);

    // S = Q K^T over the tile's 8 tokens, even and odd k-steps in two
    // chains of products
    float sc[4] = {0.f, 0.f, 0.f, 0.f}, sc1[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int c0 = 0; c0 < NC; c0 += X) {
      const uint32_t addr = st + (lrow * NC + swz<NC>(lrow, c0 + lmat)) * 16;
      uint32_t kf[X], pf[X];
      ldsm<X, false>(kf, addr);
      ldsm<X, false>(pf, addr + BUF);
#pragma unroll
      for (int i = 0; i < X; ++i) kf[i] ^= pf[i];
#pragma unroll
      for (int i = 0; i < X; i += 2) {
        const int kk = (c0 + i) / 2;
        const uint32_t b1 = i + 1 < X ? kf[i + 1] : 0u;
        float (&acc)[4] = kk % 2 ? sc1 : sc;
        mma16816<VT>(acc, qa[kk][0], qa[kk][1], qa[kk][2], qa[kk][3], kf[i],
                     b1);
        if constexpr (!PACKED) {
          if (has_lo)
            mma16816<VT>(acc, qlo[kk][0], qlo[kk][1], qlo[kk][2], qlo[kk][3],
                         kf[i], b1);
        }
      }
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) sc[e] += sc1[e];
    // scores of this thread's 2 tokens per row half, masked, in log2 units
    float s2[2][2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const bool live = tok0 + 2 * t4 + e < tok_end;
      if constexpr (PACKED) {
        s2[0][e] = live ? (sc[e] + sc[2 + e]) * scale2 : kNegInf;
        s2[1][e] = kNegInf;
      } else {
        s2[0][e] = live ? sc[e] * scale2 : kNegInf;
        s2[1][e] = live ? sc[2 + e] * scale2 : kNegInf;
      }
    }
    constexpr int NH = PACKED ? 1 : 2;
    uint32_t ph[2], pl[2], pl2[2];
    float alpha[2] = {1.f, 1.f};
#pragma unroll
    for (int r = 0; r < NH; ++r) {
      float mt = fmaxf(s2[r][0], s2[r][1]);
      mt = fmaxf(mt, __shfl_xor_sync(kFull, mt, 1));
      mt = fmaxf(mt, __shfl_xor_sync(kFull, mt, 2));
      const float mn = fmaxf(m[r], mt);
      alpha[r] = m[r] == kNegInf ? 0.f : exp2f(m[r] - mn);
      const float p0 = s2[r][0] == kNegInf ? 0.f : exp2f(s2[r][0] - mn);
      const float p1 = s2[r][1] == kNegInf ? 0.f : exp2f(s2[r][1] - mn);
      l[r] = l[r] * alpha[r] + (p0 + p1);
      m[r] = mn;
      split3<VT>(p0, p1, ph[r], pl[r], pl2[r]);
    }
    // O *= alpha, unless no row's max moved (alpha 1 is exact)
    if (__any_sync(kFull, alpha[0] != 1.f || alpha[1] != 1.f)) {
#pragma unroll
      for (int n = 0; n < NCW; ++n) {
        o[n][0] *= alpha[0];
        o[n][1] *= alpha[0];
        o[n][2] *= PACKED ? alpha[0] : alpha[1];
        o[n][3] *= PACKED ? alpha[0] : alpha[1];
      }
    }
    // O += P V over this warp's columns
#pragma unroll
    for (int c0 = 0; c0 < NCW; c0 += XV) {
      const int c = part * NCW + c0;
      const uint32_t addr =
          st + 2 * BUF + (lrow * NC + swz<NC>(lrow, c + lmatv)) * 16;
      uint32_t vf[XV], pf[XV];
      ldsm<XV, true>(vf, addr);
      ldsm<XV, true>(pf, addr + BUF);
#pragma unroll
      for (int i = 0; i < XV; ++i) {
        const int n = c0 + i;
        const uint32_t v = vf[i] ^ pf[i];
        if constexpr (PACKED) {
          // k 0..7: hi(p) row gid, lo(p) row gid + 8; k 8..15 (the same
          // tokens again): lo2(p) row gid
          mma16816<VT>(o[n], ph[0], pl[0], pl2[0], 0u, v, v);
        } else {
          mma16816<VT>(o[n], ph[0], ph[1], pl[0], pl[1], v, v);
          mma1688<VT>(o[n], pl2[0], pl2[1], v);
        }
      }
    }
  }
  cp_async_wait<0>();

  // the quad's sums; this chain's state per head into shared memory (the
  // chain's warps hold the same m and l, and their own columns of O)
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(kFull, l[r], 1);
    l[r] += __shfl_xor_sync(kFull, l[r], 2);
  }
  __syncthreads();                       // every chain is done with its ring
  float* sm_m = reinterpret_cast<float*>(tc_smem);   // (CHAINS, GM)
  float* sm_s = sm_m + CHAINS * GM;                  // (CHAINS, GM)
  float* sm_acc = sm_s + CHAINS * GM;                // (CHAINS, GM, D)
#pragma unroll
  for (int r = 0; r < (PACKED ? 1 : 2); ++r) {
    const int g = gid + 8 * r;
    if (t4 == 0 && part == 0) {
      sm_m[chain * GM + g] = m[r];
      sm_s[chain * GM + g] = l[r];
    }
#pragma unroll
    for (int n = 0; n < NCW; ++n) {
      float* dst =
          sm_acc + (chain * GM + g) * D + 8 * (part * NCW + n) + 2 * t4;
      if constexpr (PACKED) {
        dst[0] = o[n][0] + o[n][2];
        dst[1] = o[n][1] + o[n][3];
      } else {
        dst[0] = o[n][2 * r];
        dst[1] = o[n][2 * r + 1];
      }
    }
  }
  __syncthreads();
  // each head's max over the chains, the chains' weights (in place of
  // their maxima) and the weighted sum; then the accumulators, GM * D /
  // kThreads columns a thread, unrolled, into this range's partials
  const long long base = part_base(a, b, hg, split);
  if (threadIdx.x < G) {
    const int g = threadIdx.x;
    float M = kNegInf;
#pragma unroll
    for (int c = 0; c < CHAINS; ++c) M = fmaxf(M, sm_m[c * GM + g]);
    float S = 0.f;
#pragma unroll
    for (int c = 0; c < CHAINS; ++c) {
      const float mc = sm_m[c * GM + g];
      const float wt = mc == kNegInf ? 0.f : exp2f(mc - M);
      sm_m[c * GM + g] = wt;
      S = fmaf(sm_s[c * GM + g], wt, S);
    }
    a.part_m[base + g] = M * 0.6931471805599453f;   // log2 -> natural
    a.part_s[base + g] = S;
  }
  __syncthreads();
  constexpr int PER = (GM * D + kThreads - 1) / kThreads;
#pragma unroll
  for (int u = 0; u < PER; ++u) {
    const int i = threadIdx.x + u * kThreads;
    if (i >= G * D) break;
    const int g = i / D, d = i % D;
    float A = 0.f;
#pragma unroll
    for (int c = 0; c < CHAINS; ++c)
      A = fmaf(sm_acc[(c * GM + g) * D + d], sm_m[c * GM + g], A);
    a.part_acc[(base + g) * D + d] = A;
  }
}

// ----------------------------------------------- any width, general kernel
// The register tilings: rows of up to 32 x kGenLanesSmall lanes take at
// most kGenLanesSmall lanes a thread and head groups of up to 8; rows of
// up to 32 x kGenLanesLarge lanes at most kGenLanesLarge lanes a thread
// and one head a block (q and the accumulators: 2 x 64 registers either
// way).
constexpr int kGenLanesSmall = 8;
constexpr int kGenLanesLarge = 64;
constexpr int kGenStages = 4;    // token stages of a thread's cp.async ring

__host__ __device__ constexpr int gen_heads(int lt) {
  return lt <= kGenLanesSmall ? 8 : 1;
}
// cp.async (4, 8 or 16 bytes) on the small tiling; else straight loads
__host__ __device__ constexpr bool gen_async(int w, int lt) {
  return w >= 4 && lt <= kGenLanesSmall;
}

// W bytes as 32-bit words (W = 2: one word, its high half zero)
template <int W>
__device__ __forceinline__ void ld_words(const unsigned char* p,
                                         uint32_t (&w)[(W + 3) / 4]) {
  if constexpr (W == 16) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
  } else if constexpr (W == 8) {
    const uint2 v = *reinterpret_cast<const uint2*>(p);
    w[0] = v.x; w[1] = v.y;
  } else if constexpr (W == 4) {
    w[0] = *reinterpret_cast<const uint32_t*>(p);
  } else {
    w[0] = *reinterpret_cast<const uint16_t*>(p);
  }
}

// The LV lanes of a vector's words as f32 (LB: the lane's bytes; 16-bit
// lanes of the value type vt, one branch for the vector)
template <int LB, int LV, int NW>
__device__ __forceinline__ void vec_f32(const uint32_t (&w)[NW], int vt,
                                        float (&x)[LV]) {
  if constexpr (LB == 4) {
#pragma unroll
    for (int e = 0; e < LV; ++e) x[e] = __uint_as_float(w[e]);
  } else if (vt == kBF16) {
#pragma unroll
    for (int e = 0; e < LV; ++e)
      x[e] = __uint_as_float(e & 1 ? w[e >> 1] & 0xffff0000u : w[e >> 1] << 16);
  } else {
#pragma unroll
    for (int e = 0; e < LV; ++e)
      x[e] = lane_to_f32<kF16>((w[e >> 1] >> (16 * (e & 1))) & 0xffffu);
  }
}

// Any D (up to 32 x LT lanes), any lane type (LB bytes a lane), rows read
// in W-byte vectors. A block of 128 threads takes a (range, head group)
// as the other split kernels do. Thread sub of a lane group of L threads
// owns the row's vectors sub, sub + L, ... (gen_nv of them, at most
// NVM); it keeps q's lanes there for the block's heads, and each head's
// running max, sum and accumulators, in registers. The lane groups take
// the range's tokens in turn; a token's score is the thread's sum over
// its lanes, then over the lane group by shuffles; the online softmax
// runs in natural units with expf, as the f32 kernel's.
template <int LB, int W, int LT>
__global__ void __launch_bounds__(kThreads)
kv_decode_general_kernel(const Args a) {
  constexpr int LV = W / LB;             // lanes a vector
  constexpr int NVM = LT / LV;           // most vectors a thread owns
  constexpr int NW = (W + 3) / 4;        // 32-bit words a vector
  constexpr int GM = gen_heads(LT);
  constexpr bool ASYNC = gen_async(W, LT);
  const float kNegInf = -__int_as_float(0x7f800000);
  extern __shared__ __align__(16) unsigned char gen_smem[];
  const int split = blockIdx.x, b = blockIdx.z / a.slices;
  const int cs = blockIdx.z - b * a.slices;   // this block's column slice
  const HeadGroup hg = head_group(a);
  const int kh = hg.kh, G = hg.n, D = a.D;
  const int L = a.gen_l, nv = a.gen_nv;
  const int VR = D / LV;                 // vectors a row
  const int VS = L * nv;                 // vectors a column slice
  const int sub = threadIdx.x & (L - 1), grp = threadIdx.x / L;
  const int n_grp = kThreads / L;
  const int own = cs * VS + sub;         // this thread's first vector

  float qv[GM][NVM][LV];
  long long q_row[GM];                   // q's row of each head
#pragma unroll
  for (int g = 0; g < GM; ++g) {
    q_row[g] = ((long long)b * a.H + (hg.g0 + g) * a.Hkv + kh) * D;
#pragma unroll
    for (int v = 0; v < NVM; ++v) {
      const int vec = own + L * v;
#pragma unroll
      for (int e = 0; e < LV; ++e)
        qv[g][v][e] = g < G && v < nv && vec < VR
                          ? load_f32(a.q, q_row[g] + vec * LV + e, a.q_dt)
                          : 0.f;
    }
  }
  float m[GM], s[GM], acc[GM][NVM][LV];
#pragma unroll
  for (int g = 0; g < GM; ++g) {
    m[g] = kNegInf;
    s[g] = 0.f;
#pragma unroll
    for (int v = 0; v < NVM; ++v)
#pragma unroll
      for (int e = 0; e < LV; ++e) acc[g][v][e] = 0.f;
  }

  const int slen = a.seq_len[b];
  const int t0 = split * a.pages_per_split;
  const int t_end = min(a.n_pages, t0 + a.pages_per_split);
  const int tok_begin = t0 * a.P;
  const int tok_end = slen <= 0 ? tok_begin : min(t_end * a.P, slen);
  const int NG = a.NB / 2;
  const int32_t* plan = a.use_parity + (long long)b * a.n_pages;
  const unsigned char* kb = reinterpret_cast<const unsigned char*>(a.k_banks);
  const unsigned char* vb = reinterpret_cast<const unsigned char*>(a.v_banks);
  const unsigned char* kp = reinterpret_cast<const unsigned char*>(a.k_par);
  const unsigned char* vp = reinterpret_cast<const unsigned char*>(a.v_par);
  // lane group grp takes tokens tok_begin + grp + n_grp * i; a warp runs
  // as many steps as its first lane group, so every lane takes part in
  // every shuffle
  const int n_tok = tok_end - tok_begin;
  const int grp0 = (threadIdx.x & ~31) / L;
  const float scale2 = a.scale * 1.4426950408889634f;   // log2 units
  const int steps = n_tok > grp0 ? (n_tok - grp0 + n_grp - 1) / n_grp : 0;

  // token i of this lane group: whether it is live, whether its page is
  // degraded, and the byte offsets of its row (sibling's on a degraded
  // page) and of its parity row
  struct Tok {
    bool live, deg;
    long long off, poff;
  };
  auto token = [&](int i) {
    Tok t{false, false, 0, 0};
    const int tok = tok_begin + grp + n_grp * i;
    if (i < steps && tok < tok_end) {
      const int pg = div_by(tok, a.P, a.p_shift), p = tok - pg * a.P;
      const int slot = div_by(pg, a.NB, a.nb_shift), bank = pg - slot * a.NB;
      t.live = true;
      t.deg = __ldg(plan + pg) != 0;
      const long long row =
          ((long long)(b * a.NB + (t.deg ? bank ^ 1 : bank)) * a.S + slot) *
              a.P + p;
      const long long prow =
          ((long long)(b * NG + (bank >> 1)) * a.S + slot) * a.P + p;
      t.off = (row * a.Hkv + kh) * D * LB;
      t.poff = (prow * a.Hkv + kh) * D * LB;
    }
    return t;
  };
  // this thread's slot of stage st, buffer buf (K, K parity, V, V parity),
  // vector v: a warp's 32 slots are consecutive W-byte words
  const uint32_t ring = smem_u32(gen_smem);
  auto slot = [&](int st, int buf, int v) -> uint32_t {
    return ring + ((((st * 4 + buf) * NVM + v) * kThreads) + threadIdx.x) * W;
  };
  // vector vi of a row (and its parity on a degraded page) as words
  auto vec_words = [&](const unsigned char* banks, const unsigned char* par,
                       const Tok& t, int vi, uint32_t (&w)[NW]) {
#pragma unroll
    for (int e = 0; e < NW; ++e) w[e] = 0u;
    if (t.live && vi < VR) {
      const long long step = (long long)vi * W;
      ld_words<W>(banks + t.off + step, w);
      if (t.deg) {
        uint32_t pw[NW];
        ld_words<W>(par + t.poff + step, pw);
#pragma unroll
        for (int e = 0; e < NW; ++e) w[e] ^= pw[e];
      }
    }
  };
  auto ring_words = [&](int st, int buf, bool deg, int v,
                        uint32_t (&w)[NW]) {
    ld_words<W>(gen_smem + (slot(st, buf, v) - ring), w);
    if (deg) {
      uint32_t pw[NW];
      ld_words<W>(gen_smem + (slot(st, buf + 1, v) - ring), pw);
#pragma unroll
      for (int e = 0; e < NW; ++e) w[e] ^= pw[e];
    }
  };
  // asks for token i's vectors in stage i % kGenStages: K and V, and both
  // parities on a degraded page (zeros past the row and the range)
  auto fetch = [&](int i, uint32_t& degs) {
    const Tok t = token(i);
    const int st = i % kGenStages;
    degs = (degs & ~(1u << st)) | (t.deg ? 1u << st : 0u);
#pragma unroll
    for (int v = 0; v < NVM; ++v) {
      if (v >= nv) break;
      const bool in = t.live && own + L * v < VR;
      const long long step = in ? (long long)(own + L * v) * W : 0;
      const int n = in ? W : 0;
      cp_async_ca<W>(slot(st, 0, v), kb + t.off + step, n);
      cp_async_ca<W>(slot(st, 2, v), vb + t.off + step, n);
      if (t.deg) {
        cp_async_ca<W>(slot(st, 1, v), kp + t.poff + step, n);
        cp_async_ca<W>(slot(st, 3, v), vp + t.poff + step, n);
      }
    }
  };

  uint32_t degs = 0;        // bit st: stage st's token is degraded
  if constexpr (ASYNC) {
#pragma unroll
    for (int i = 0; i < kGenStages - 1; ++i) {
      fetch(i, degs);
      cp_async_commit();
    }
  }
  for (int i = 0; i < steps; ++i) {
    Tok t{tok_begin + grp + n_grp * i < tok_end, false, 0, 0};
    if constexpr (!ASYNC) t = token(i);
    const int st = i % kGenStages;
    const bool deg = (degs >> st) & 1u;
    if constexpr (ASYNC) {
      // the stage step i - 1 used is this thread's own and read: refill it
      fetch(i + kGenStages - 1, degs);
      cp_async_commit();
      cp_async_wait<kGenStages - 1>();
    }
    float sc[GM];
#pragma unroll
    for (int g = 0; g < GM; ++g) sc[g] = 0.f;
    // the score over the whole row, slice by slice in one order in every
    // block of the row's slices (another slice's q from device memory),
    // so that they agree on each score bit for bit
    for (int oc = 0; oc < (LT == kGenLanesLarge ? a.slices : 1); ++oc) {
      if (oc != cs) {
        if constexpr (LT == kGenLanesLarge) {
#pragma unroll 1
          for (int v = 0; v < NVM; ++v) {
            const int vi = oc * VS + sub + L * v;
            if (v >= nv || vi >= VR) break;
            uint32_t w[NW];
            vec_words(kb, kp, t, vi, w);
            float k[LV];
            vec_f32<LB, LV, NW>(w, a.v_dt, k);
#pragma unroll
            for (int e = 0; e < LV; ++e)
#pragma unroll
              for (int g = 0; g < GM; ++g)
                sc[g] = fmaf(g < G ? load_f32(a.q, q_row[g] + vi * LV + e,
                                              a.q_dt)
                                   : 0.f,
                             k[e], sc[g]);
          }
        }
        continue;
      }
#pragma unroll
      for (int v = 0; v < NVM; ++v) {
        if (v >= nv) break;
        uint32_t w[NW];
        if constexpr (ASYNC) ring_words(st, 0, deg, v, w);
        else vec_words(kb, kp, t, own + L * v, w);
        float k[LV];
        vec_f32<LB, LV, NW>(w, a.v_dt, k);
#pragma unroll
        for (int e = 0; e < LV; ++e)
#pragma unroll
          for (int g = 0; g < GM; ++g)
            sc[g] = fmaf(qv[g][v][e], k[e], sc[g]);
      }
    }
    for (int off = L >> 1; off > 0; off >>= 1) {
#pragma unroll
      for (int g = 0; g < GM; ++g)
        sc[g] += __shfl_xor_sync(kFull, sc[g], off);
    }
    // alpha = exp(m - max), p = exp(x - max): one of the two is exp(0)
    // = 1, the other exp(-|x - m|) (0 while m is -inf). A masked token
    // (every lane takes part in the vote below) weighs 0 and rescales
    // nothing: its K and V read as zeros.
    float alpha[GM], pr[GM];
    bool moved = false;
#pragma unroll
    for (int g = 0; g < GM; ++g) {
      const float x = sc[g] * scale2;
      const bool up = t.live && x > m[g];
      const float e = exp2f(-fabsf(x - m[g]));
      alpha[g] = up ? e : 1.f;
      pr[g] = !t.live ? 0.f : up ? 1.f : e;
      if (t.live) {
        s[g] = s[g] * alpha[g] + pr[g];
        m[g] = up ? x : m[g];
      }
      moved |= alpha[g] != 1.f;
    }
    // acc = acc alpha + p v, the product by alpha only where some head's
    // max moved in the warp (alpha 1 is exact)
    moved = __any_sync(kFull, moved);
#pragma unroll
    for (int v = 0; v < NVM; ++v) {
      if (v >= nv) break;
      uint32_t w[NW];
      if constexpr (ASYNC) ring_words(st, 2, deg, v, w);
      else vec_words(vb, vp, t, own + L * v, w);
      float x[LV];
      vec_f32<LB, LV, NW>(w, a.v_dt, x);
      if (moved) {
#pragma unroll
        for (int e = 0; e < LV; ++e)
#pragma unroll
          for (int g = 0; g < GM; ++g)
            acc[g][v][e] = fmaf(acc[g][v][e], alpha[g], pr[g] * x[e]);
      } else {
#pragma unroll
        for (int e = 0; e < LV; ++e)
#pragma unroll
          for (int g = 0; g < GM; ++g)
            acc[g][v][e] = fmaf(pr[g], x[e], acc[g][v][e]);
      }
    }
  }
  if constexpr (ASYNC) cp_async_wait<0>();

  // merge the lane groups' states into this range's partial per head,
  // in the slice's DS columns from column c0
  __syncthreads();                       // the ring is read: reuse it
  const int c0 = cs * VS * LV, DS = min(D - c0, VS * LV);
  float* sm_m = reinterpret_cast<float*>(gen_smem);   // (n_grp, GM)
  float* sm_s = sm_m + n_grp * GM;                    // (n_grp, GM)
  float* sm_acc = sm_s + n_grp * GM;                  // (n_grp, GM, DS)
#pragma unroll
  for (int g = 0; g < GM; ++g) {
    if (sub == 0) {
      sm_m[grp * GM + g] = m[g];
      sm_s[grp * GM + g] = s[g];
    }
#pragma unroll
    for (int v = 0; v < NVM; ++v) {
      if (v >= nv || own + L * v >= VR) break;
#pragma unroll
      for (int e = 0; e < LV; ++e)
        sm_acc[(grp * GM + g) * DS + (sub + L * v) * LV + e] = acc[g][v][e];
    }
  }
  __syncthreads();
  const long long base = part_base(a, b, hg, split);
  for (int i = threadIdx.x; i < G * DS; i += kThreads) {
    const int g = i / DS, dl = i - g * DS, d = c0 + dl;
    float M = kNegInf;
    for (int j = 0; j < n_grp; ++j) M = fmaxf(M, sm_m[j * GM + g]);
    float S = 0.f, A = 0.f;
    for (int j = 0; j < n_grp; ++j) {
      const float mj = sm_m[j * GM + g];
      const float w = mj == kNegInf ? 0.f : exp2f(mj - M);
      S = fmaf(sm_s[j * GM + g], w, S);
      A = fmaf(sm_acc[(j * GM + g) * DS + dl], w, A);
    }
    a.part_acc[(base + g) * D + d] = A;
    if (d == 0) {
      a.part_m[base + g] = M * 0.6931471805599453f;     // log2 -> natural
      a.part_s[base + g] = S;
    }
  }
}

// The split kernels: the scalar f32 one, the tensor-core one and the
// general one (info[2] of coded_kv_decode_occupancy).
enum : int { kScalar = 0, kTensorCore = 1, kGeneral = 2 };

// The split kernel that serves (value type, G, D) as a function pointer,
// its dynamic shared memory, which kernel it is and its template
// arguments; the f32 and general kernels' shared memory depends on D at
// run time.
struct Split {
  void (*fn)(Args) = nullptr;
  size_t smem = 0;
  int kind = kScalar;
  int gm = 0;         // most query heads a block of the kernel takes
  int nv = 0;         // f32 kernel: NV; general: vectors a thread owns
  int gb = 0;         // query heads a block takes
  int groups = 0;     // head groups a kv head is cut into
  int vec = 0;        // general kernel: bytes a vector load
  int cw = 0;         // tensor-core kernel: warps a tile chain
  int lt = 0;         // general kernel: most lanes a thread owns
  int l = 0;          // general kernel: threads a row
  int slices = 1;     // general kernel: column slices of a row
};

template <int GM, int NV>
Split f32_split_gm(int D) {
  const int n_grp = kThreads / (D / (4 * NV));
  Split k;
  k.fn = kv_decode_split_kernel<GM, NV>;
  k.smem = sizeof(float) * (size_t)n_grp * GM * (2 + D);
  k.kind = kScalar;
  k.gm = GM;
  k.nv = NV;
  return k;
}

Split f32_split(int gb, int D) {
  if (D == 160) return f32_split_gm<2, 5>(D);
  if (gb <= 1) return f32_split_gm<1, 1>(D);
  if (gb <= 2) return f32_split_gm<2, 1>(D);
  if (gb <= 4) return f32_split_gm<4, 1>(D);
  if (gb <= 8) return f32_split_gm<8, 1>(D);
  return f32_split_gm<16, 1>(D);
}

template <int VT, int D, int GM, int CW>
Split tc_make() {
  Split k;
  k.fn = kv_decode_tc_kernel<VT, D, GM, CW>;
  k.smem = tc_smem_bytes<D, GM, CW>();
  k.kind = kTensorCore;
  k.gm = GM;
  k.cw = CW;
  return k;
}

template <int VT, int D>
Split tc_split_d(int gb) {
  if (gb <= 8) return tc_make<VT, D, 8, 1>();
  return tc_make<VT, D, 16, 1>();
}

// Each width the tensor-core kernel is instantiated for, and only those:
// no D reaches a kernel built for another width.
template <int VT>
Split tc_split(int gb, int D) {
  switch (D) {
    case 8: return tc_split_d<VT, 8>(gb);
    case 16: return tc_split_d<VT, 16>(gb);
    case 32: return tc_split_d<VT, 32>(gb);
    case 64: return tc_split_d<VT, 64>(gb);
    case 96: return tc_split_d<VT, 96>(gb);
    case 128: return tc_split_d<VT, 128>(gb);
    // groups of at most 8 heads at D = 160 and 256 (tc_heads): one
    // instantiation each; two warps a tile chain at 256
    case 160: return tc_make<VT, 160, 8, 1>();
    case 256: return tc_make<VT, 256, 8, 2>();
    default: return {};
  }
}

// The tensor-core kernel's widths: the repo's configs' head widths and
// their reduced forms.
bool tc_width(int D) {
  switch (D) {
    case 8: case 16: case 32: case 64: case 96: case 128: case 160: case 256:
      return true;
    default:
      return false;
  }
}

// Most heads a tensor-core block takes at width D: 16 heads' O fits the
// registers up to D = 128.
int tc_heads(int D) { return D >= 160 ? 8 : 16; }

// The scalar f32 kernel's widths: a row of 16, 32, ..., 512 bytes (one
// vector a thread), or D = 160.
bool f32_width(int D) {
  const int L = D * 4 / 16;
  return D == 160 || (D % 4 == 0 && L <= 32 && (L & (L - 1)) == 0);
}

template <int LB, int W>
Split gen_make(int lt) {
  Split k;
  k.fn = lt == kGenLanesSmall ? kv_decode_general_kernel<LB, W, kGenLanesSmall>
                              : kv_decode_general_kernel<LB, W, kGenLanesLarge>;
  return k;
}

// The general kernel at width D, its loads W bytes wide: the largest of
// 16, 8, 4, 2 that divides the row's bytes and the banks' address bits
// `align` (W is never below the lane: a tensor's lanes are aligned to
// their size); the small register tiling where a row is at most 32 x 8
// lanes, else the large one, whose blocks take a row wider than 32 x 64
// lanes in column slices of about equal width (each sums the whole row's
// scores and keeps its slice's accumulators).
Split general_split(int value_dt, int D, uintptr_t align) {
  const int lb = value_dt == kF32 ? 4 : 2;
  const unsigned x = static_cast<unsigned>(D * lb) |
                     static_cast<unsigned>(align & 15u) | 16u;
  const int W = static_cast<int>(x & (~x + 1u));
  if (W < lb) return {};
  const int lv = W / lb, vr = D / lv;
  const int lt =
      vr <= 32 * (kGenLanesSmall / lv) ? kGenLanesSmall : kGenLanesLarge;
  const int nvm = lt / lv;
  const int slices = (vr + 32 * nvm - 1) / (32 * nvm);
  const int per = (vr + slices - 1) / slices;   // vectors a slice
  int L = 1;
  while (L * nvm < per) L <<= 1;
  Split k = lb == 4 ? (W == 16  ? gen_make<4, 16>(lt)
                       : W == 8 ? gen_make<4, 8>(lt) : gen_make<4, 4>(lt))
                    : (W == 16  ? gen_make<2, 16>(lt)
                       : W == 8 ? gen_make<2, 8>(lt)
                       : W == 4 ? gen_make<2, 4>(lt) : gen_make<2, 2>(lt));
  k.kind = kGeneral;
  k.gm = gen_heads(lt);
  k.vec = W;
  k.lt = lt;
  k.l = L;
  k.nv = (per + L - 1) / L;
  k.slices = slices;
  const size_t ring = gen_async(W, lt)
                          ? (size_t)kGenStages * 4 * lt * lb * kThreads : 0;
  const int ds = D < L * k.nv * lv ? D : L * k.nv * lv;  // columns a slice
  const size_t merge = sizeof(float) * (size_t)(kThreads / L) * k.gm * (2 + ds);
  k.smem = ring > merge ? ring : merge;
  return k;
}

// The split kernel for G query heads a kv head, cut into the fewest head
// groups of at most the kernel's GM heads, all of one size but the last:
// 16-bit lanes at a width of tc_width run the tensor-core kernel, f32
// lanes at a width of f32_width the scalar one, every other D >= 1 the
// general kernel. `align` is the OR of the banks' addresses (the general
// kernel's vector width); the other two need 16-byte aligned banks and
// are refused (fn null) without them, as is G < 1 or D < 1.
Split pick_split(int value_dt, int G, int D, uintptr_t align) {
  if (G < 1 || D < 1) return {};
  const bool tc = value_dt != kF32 && tc_width(D);
  const bool scalar = value_dt == kF32 && f32_width(D);
  if ((tc || scalar) && align % 16 != 0) return {};
  Split gen;
  if (!tc && !scalar) {
    gen = general_split(value_dt, D, align);
    if (gen.fn == nullptr) return {};
  }
  const int gmax = tc ? tc_heads(D)
                   : scalar ? (D == 160 ? 2 : 16) : gen.gm;
  const int n = (G + gmax - 1) / gmax;
  const int gb = (G + n - 1) / n;
  Split k = tc ? (value_dt == kBF16 ? tc_split<kBF16>(gb, D)
                                    : tc_split<kF16>(gb, D))
            : scalar ? f32_split(gb, D) : gen;
  k.gb = gb;
  k.groups = (G + gb - 1) / gb;
  return k;
}

// Lets the kernel use its dynamic shared memory (beyond 48 KB only by
// this attribute).
int allow_smem(const Split& k) {
  if (k.smem <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      k.fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(k.smem)));
}

int log2_or_neg(int x) {
  if (x <= 0 || (x & (x - 1)) != 0) return -1;
  int s = 0;
  while ((1 << s) < x) ++s;
  return s;
}

bool is_dt(int dt) { return dt == kF32 || dt == kBF16 || dt == kF16; }

}  // namespace

// Launches the split and merge kernels on `stream` and returns
// cudaGetLastError() (0: both launches were accepted; cudaErrorInvalidValue
// for a type or geometry no kernel takes, or banks not 16-byte aligned at
// a width of the tensor-core or scalar kernel). dtype codes: 0 f32, 1 bf16,
// 2 f16. The partial buffers hold B*Hkv*n_splits*G floats (m, s) and that
// times D (acc).
extern "C" int coded_kv_decode(
    const void* q, int q_dt, const void* k_banks, const void* v_banks,
    const void* k_par, const void* v_par, const void* use_parity,
    const void* seq_len, void* part_m, void* part_s, void* part_acc,
    void* out, int out_dt, int value_dt, int B, int H, int Hkv, int D,
    int NB, int S, int P, int n_pages, int n_splits, float scale,
    void* stream) {
  if (!is_dt(q_dt) || !is_dt(out_dt) || !is_dt(value_dt) || B <= 0 ||
      H <= 0 || Hkv <= 0 || H % Hkv != 0 || D <= 0 || NB <= 0 || NB % 2 ||
      S <= 0 || P <= 0 || n_pages < 0 || n_pages > NB * S || n_splits <= 0 ||
      n_splits > 65535 || Hkv > 65535 || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const uintptr_t align =
      reinterpret_cast<uintptr_t>(k_banks) | reinterpret_cast<uintptr_t>(v_banks) |
      reinterpret_cast<uintptr_t>(k_par) | reinterpret_cast<uintptr_t>(v_par);
  const Split k = pick_split(value_dt, H / Hkv, D, align);
  if (k.fn == nullptr || (long long)Hkv * k.groups > 65535 ||
      (long long)B * k.slices > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
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
  a.v_dt = value_dt;
  a.H = H;
  a.Hkv = Hkv;
  a.D = D;
  a.NB = NB;
  a.S = S;
  a.P = P;
  a.n_pages = n_pages;
  a.n_splits = n_splits;
  a.GB = k.gb;
  a.pages_per_split = n_pages == 0 ? 1 : (n_pages + n_splits - 1) / n_splits;
  a.scale = scale;
  a.p_shift = log2_or_neg(P);
  a.nb_shift = log2_or_neg(NB);
  a.gen_l = k.l;
  a.gen_nv = k.nv;
  a.slices = k.slices;
  if (part_m == nullptr || part_s == nullptr || part_acc == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int err = allow_smem(k);
  if (err != 0) return err;
  k.fn<<<dim3(n_splits, Hkv * k.groups, B * k.slices), kThreads, k.smem,
         s>>>(a);
  err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  kv_decode_combine_kernel<<<dim3(H, B), kThreads, 0, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// The split kernel that serves (value_dt, H / Hkv, D) over 16-byte aligned
// banks, as eleven ints in `info`: how many of its blocks fit one SM of the
// current card, its dynamic shared memory in bytes, which kernel it is
// (0 the scalar f32 one, 1 the tensor-core one, 2 the general one), how
// many head groups a kv head is cut into (the grid has groups x Hkv rows),
// the query heads a block takes, the kernel's GM, the f32 kernel's NV or
// the general kernel's vectors a thread (0 for the tensor-core one), the
// general kernel's vector bytes W, the tensor-core kernel's warps a tile
// chain CW and the general kernel's most lanes a thread LT (0 where they
// do not apply), and the column slices a row is cut into (1 but for the
// general kernel's rows wider than 32 x 64 lanes; the grid's z is B x
// slices). Returns a CUDA error code (cudaErrorInvalidValue for G < 1 or
// D < 1).
extern "C" int coded_kv_decode_occupancy(int value_dt, int H, int Hkv, int D,
                                         int* info) {
  if (!is_dt(value_dt) || H <= 0 || Hkv <= 0 || H % Hkv != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Split k = pick_split(value_dt, H / Hkv, D, 0);
  if (k.fn == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  info[1] = static_cast<int>(k.smem);
  info[2] = k.kind;
  info[3] = k.groups;
  info[4] = k.gb;
  info[5] = k.gm;
  info[6] = k.nv;
  info[7] = k.vec;
  info[8] = k.cw;
  info[9] = k.lt;
  info[10] = k.slices;
  const int err = allow_smem(k);
  if (err != 0) return err;
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &info[0], k.fn, kThreads, k.smem));
}

extern "C" const char* coded_kv_decode_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
