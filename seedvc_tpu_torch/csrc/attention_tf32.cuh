// f32 DiT attention on Hopper's tensor cores as 3xTF32, shared by
// attention.cu (K1 and K3 in f32: the forward core) and attention_bwd.cu (K1b:
// the same core computes its row statistics, and the fragment helpers build
// its dK/dV/dQ kernel).
//
// 3xTF32. An f32 operand x is split into two TF32 values, hi = rna(x) and
// lo = rna(x - hi) (cvt.rna.tf32.f32: 10-bit mantissa, to nearest), and a
// product is accumulated in f32 as hi.hi + (lo.hi + hi.lo) on
// mma.sync.m16n8k8.tf32. Only lo.lo is dropped, about 2^-22 of each term (the
// memory-efficient SDPA of PyTorch does the same, cutlass's
// OpMultiplyAddFastF32). An operand that is already a TF32 value (a bf16
// input, EXACT below) has lo = 0, and the terms with its lo are not issued.
// What bounds the work: 3 TF32 products for each f32 one at the card's
// 495 TFLOP/s dense TF32 peak, i.e. f32 work at 165 TFLOP/s.
//
// Accumulation. The tensor cores add into their f32 accumulator with
// truncation, not to nearest: the error drifts one way with every mma that
// adds into the same registers, and with all three terms and every key tile
// in one accumulator K1b's gradients missed the f32 limit (relative L2 2e-6)
// by several times, more at larger T. So the small terms (lo.hi + hi.lo) go
// to an accumulator of their own, which is added to the hi.hi one when a
// 64-wide product is done, and a sum over many tiles (O over the key tiles,
// dK and dV over the query tiles) takes each tile's product from fresh
// accumulators and adds it to the running sum in registers, rounded to
// nearest: no accumulator sees more than 8 truncating adds.
//
// Why mma.sync and not wgmma. wgmma reads B (and, here, A) from shared
// memory, K-major only for TF32 (no transpose flag), and takes no split: the
// hi and lo planes of every operand would have to be written to shared
// memory in each orientation a product needs (S = Q.K^T, P.V, dP = dO.V^T,
// dV = P^T.dO, dK = dS^T.Q, dQ = dS.K). mma.sync takes its fragments from
// registers: each warp gathers them from one padded f32 tile in whichever
// orientation the product needs and splits them as it goes, and an
// accumulator (S, P, dS) feeds the next product as its A operand without
// leaving registers (the k index taken in pair order, see acc_as_a).
//
// Layout. Tiles of 64 rows x 64 f32 features lie in shared memory with a row
// stride of 68 floats: the fragment gathers of every orientation used here
// are free of bank conflicts. cp.async copies 16 bytes a thread and fills the
// rows past T with zeros.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace tf32 {

constexpr int D = 64;               // head width
constexpr int BT = 64;              // rows of a query or key tile
constexpr int WARPS = 4;            // warps of a block, 16 rows each
constexpr int THREADS = 32 * WARPS;
constexpr int LDT = D + 4;          // row stride (floats) of a tile in shared memory
constexpr int TILE = BT * LDT;      // floats of one tile
constexpr float NEG = -1e30f;       // the masked-key bias of the TPU kernels
constexpr float LOG2E = 1.4426950408889634f;

// ---------------------------------------------------------------------------
// Asynchronous copies

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, uint32_t src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, uint32_t src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Rows [r0, r0 + 64) of a (T, 64) f32 slab into a shared tile of stride LDT;
// rows >= T are zero-filled and nothing is read for them.
__device__ __forceinline__ void load_tile(float* dst, const float* __restrict__ src, int r0,
                                          int T_len) {
#pragma unroll
  for (int j = 0; j < BT * (D / 4) / THREADS; ++j) {
    const int i = threadIdx.x + j * THREADS;
    const int r = i >> 4, col = (i & 15) * 4, t = r0 + r;
    const bool in = t < T_len;
    cp_async16(dst + r * LDT + col, src + (size_t)(in ? t : 0) * D + col, in ? 16u : 0u);
  }
}

// Entries [r0, r0 + 64) of a length-T row vector; entries >= T read as zeros.
__device__ __forceinline__ void load_vec(float* dst, const float* __restrict__ src, int r0,
                                         int T_len) {
  if (threadIdx.x < BT) {
    const int t = r0 + threadIdx.x;
    const bool in = t < T_len;
    cp_async4(dst + threadIdx.x, src + (in ? t : 0), in ? 4u : 0u);
  }
}

// ---------------------------------------------------------------------------
// 3xTF32 fragments and products (m16n8k8; g = lane / 4, c = lane % 4)

// The rounding of cvt.rna.tf32.f32 (to nearest, ties away from zero) in two
// integer operations; cvt.rna itself compiles to a longer sequence on sm_90
// that also handles NaN and infinity, which no operand here is.
__device__ __forceinline__ uint32_t rna_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

template <bool EXACT>
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  if constexpr (EXACT) {
    hi = __float_as_uint(x);
    lo = 0u;
  } else {
    hi = rna_tf32(x);
    lo = rna_tf32(x - __uint_as_float(hi));
  }
}

struct FragA {  // 16 x 8: a0 (g, c), a1 (g + 8, c), a2 (g, c + 4), a3 (g + 8, c + 4)
  uint32_t hi[4], lo[4];
};
struct FragB {  // 8 x 8: b0 (k = c, n = g), b1 (k = c + 4, n = g)
  uint32_t hi[2], lo[2];
};

__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// a.b in 3xTF32: hi.hi into big, lo.hi + hi.lo into small (see
// "Accumulation"); AX / BX: that operand is EXACT (lo = 0), so the term with
// its lo is not issued.
template <bool AX, bool BX>
__device__ __forceinline__ void mma3(float (&big)[4], float (&small)[4], const FragA& a,
                                     const FragB& b) {
  if constexpr (!AX) mma(small, a.lo, b.hi[0], b.hi[1]);
  if constexpr (!BX) mma(small, a.hi, b.lo[0], b.lo[1]);
  mma(big, a.hi, b.hi[0], b.hi[1]);
}

// A from a row-major tile X: rows r0 + g and r0 + g + 8, k columns k0 + c and
// k0 + c + 4.
template <bool EXACT>
__device__ __forceinline__ void load_a(FragA& f, const float* X, int ld, int r0, int k0, int g,
                                       int c) {
  const float* p = X + (r0 + g) * ld + k0 + c;
  split<EXACT>(p[0], f.hi[0], f.lo[0]);
  split<EXACT>(p[8 * ld], f.hi[1], f.lo[1]);
  split<EXACT>(p[4], f.hi[2], f.lo[2]);
  split<EXACT>(p[8 * ld + 4], f.hi[3], f.lo[3]);
}

// "Pair order": the fragment's k index c stands for column k0 + 2c and c + 4
// for k0 + 2c + 1. A product sums over k, so any order serves as long as A
// and B take the same one; this one is the accumulator layout (a lane holds
// columns 2c and 2c + 1 of each 8-wide block), so S, P and dS feed the next
// product from registers, and B rows k0 + 2c, k0 + 2c + 1 gather without bank
// conflicts.
__device__ __forceinline__ void acc_as_a(FragA& f, const float (&acc)[4]) {
  split<false>(acc[0], f.hi[0], f.lo[0]);  // row g, column 2c
  split<false>(acc[2], f.hi[1], f.lo[1]);  // row g + 8, column 2c
  split<false>(acc[1], f.hi[2], f.lo[2]);  // row g, column 2c + 1
  split<false>(acc[3], f.hi[3], f.lo[3]);  // row g + 8, column 2c + 1
}

// A from a row-major tile in pair order (8-byte loads).
__device__ __forceinline__ void load_a_pairs(FragA& f, const float* X, int ld, int r0, int k0,
                                             int g, int c) {
  const float2 u = *reinterpret_cast<const float2*>(X + (r0 + g) * ld + k0 + 2 * c);
  const float2 w = *reinterpret_cast<const float2*>(X + (r0 + g + 8) * ld + k0 + 2 * c);
  split<false>(u.x, f.hi[0], f.lo[0]);
  split<false>(w.x, f.hi[1], f.lo[1]);
  split<false>(u.y, f.hi[2], f.lo[2]);
  split<false>(w.y, f.hi[3], f.lo[3]);
}

// B[k][n] = X[n0 + n][k0 + k]: the tile holds n as rows (K for S = Q.K^T).
template <bool EXACT>
__device__ __forceinline__ void load_b_rows_n(FragB& f, const float* X, int ld, int n0, int k0,
                                              int g, int c) {
  const float* p = X + (n0 + g) * ld + k0 + c;
  split<EXACT>(p[0], f.hi[0], f.lo[0]);
  split<EXACT>(p[4], f.hi[1], f.lo[1]);
}

// B[k][n] = X[k0 + k][n0 + n] in pair order: the tile holds k as rows (V for
// P.V), rows k0 + 2c and k0 + 2c + 1.
template <bool EXACT>
__device__ __forceinline__ void load_b_rows_k(FragB& f, const float* X, int ld, int k0, int n0,
                                              int g, int c) {
  const float* p = X + (k0 + 2 * c) * ld + n0 + g;
  split<EXACT>(p[0], f.hi[0], f.lo[0]);
  split<EXACT>(p[ld], f.hi[1], f.lo[1]);
}

__device__ __forceinline__ void zero(float (&a)[8][4]) {
#pragma unroll
  for (int i = 0; i < 8; ++i) a[i][0] = a[i][1] = a[i][2] = a[i][3] = 0.f;
}

// big += small, rounded to nearest (a product's two accumulators joined)
__device__ __forceinline__ void join(float (&big)[8][4], const float (&small)[8][4]) {
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) big[i][e] = __fadd_rn(big[i][e], small[i][e]);
}

// ---------------------------------------------------------------------------
// The forward core

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Online softmax over one 64-key tile for this lane's rows g (r = 0) and
// g + 8 (r = 1). s holds the tile's raw logits in the accumulator layout
// (s[nt][e]: key 8 nt + 2c + (e & 1) of row e >> 1); on return it holds
// exp(x - m) with x = s * scale, plus -1e30 for a key >= n_valid (the TPU
// kernels' bias: a row with no valid key gets uniform weights), and -inf for
// a key >= T. m is the running max of x, l this lane's share of the running
// sum, alpha the factor that rescales the running output. Every operation
// rounds on its own (no contraction), so the statistics are the same bits in
// every instantiation.
__device__ __forceinline__ void softmax_tile(float (&s)[8][4], float (&m)[2], float (&l)[2],
                                             float (&alpha)[2], int k0, int n_valid, int T_len,
                                             float scale, int c) {
  const bool edge = k0 + BT > n_valid || k0 + BT > T_len;
  float mx[2] = {NEG, NEG};
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float x = __fmul_rn(s[nt][e], scale);
      if (edge) {
        const int key = k0 + 8 * nt + 2 * c + (e & 1);
        if (key >= n_valid) x = __fadd_rn(x, NEG);
        if (key >= T_len) x = __int_as_float(0xff800000);  // -inf
      }
      s[nt][e] = x;
      mx[e >> 1] = fmaxf(mx[e >> 1], x);
    }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float mn = fmaxf(m[r], mx[r]);
    alpha[r] = ex2(__fmul_rn(__fsub_rn(m[r], mn), LOG2E));
    m[r] = mn;
  }
  float ps[2] = {0.f, 0.f};
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p = ex2(__fmul_rn(__fsub_rn(s[nt][e], m[e >> 1]), LOG2E));
      s[nt][e] = p;
      ps[e >> 1] = __fadd_rn(ps[e >> 1], p);
    }
  l[0] = __fmaf_rn(l[0], alpha[0], ps[0]);
  l[1] = __fmaf_rn(l[1], alpha[1], ps[1]);
}

// One block a (64-query tile, batch*head): softmax(q.k^T * scale) v over the
// keys < lens[b] (-1e30 bias past them; every key, uniformly, where
// lens[b] <= 0), 4 warps of 16 query rows. Q's fragments are split once from
// device memory; K (and V) tiles of 64 keys stream through a 2-stage cp.async
// ring, the next tile in flight while the current one's products run. Key
// tiles that hold only masked keys are skipped (exact: each adds exp(-1e30)
// = 0), unless no key is valid. PV = false computes the row statistics alone
// (K1b's, when the forward's were not kept). lse (B*H, Tq), if not null,
// receives the row log-sum-exp of the masked logits, m + log(l). q and out
// are (B*H, Tq, 64), k and v (B*H, T_len, 64): Tq < T_len is a rank's query
// slab against keys gathered over ranks.
template <bool PV, bool EXACT>
__global__ void __launch_bounds__(THREADS, PV ? 2 : 3)
attn_fwd_tf32(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, const int* __restrict__ lens,
              float* __restrict__ out, float* __restrict__ lse, int H, int Tq, int T_len,
              float scale) {
  extern __shared__ __align__(16) float smem[];
  float* Ks = smem;             // 2 stages of the key tile
  float* Vs = smem + 2 * TILE;  // 2 stages of the value tile (PV)
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, c = lane & 3;
  const int bh = blockIdx.y, q0 = blockIdx.x * BT;
  const size_t slab = (size_t)bh * T_len * D, qslab = (size_t)bh * Tq * D;
  const int n_valid = lens ? lens[bh / H] : T_len;
  const int all_tiles = (T_len + BT - 1) / BT;
  const int n_tiles = n_valid >= 1 ? min(all_tiles, (n_valid + BT - 1) / BT) : all_tiles;

  load_tile(Ks, k + slab, 0, T_len);
  if constexpr (PV) load_tile(Vs, v + slab, 0, T_len);
  cp_async_commit();

  // this warp's 16 query rows, split once
  const int r0 = q0 + 16 * warp + g, r1 = r0 + 8;
  FragA qf[8];
  {
    const float* p0 = q + qslab + (size_t)min(r0, Tq - 1) * D + c;
    const float* p1 = q + qslab + (size_t)min(r1, Tq - 1) * D + c;
    const bool in0 = r0 < Tq, in1 = r1 < Tq;
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      split<EXACT>(in0 ? p0[8 * kk] : 0.f, qf[kk].hi[0], qf[kk].lo[0]);
      split<EXACT>(in1 ? p1[8 * kk] : 0.f, qf[kk].hi[1], qf[kk].lo[1]);
      split<EXACT>(in0 ? p0[8 * kk + 4] : 0.f, qf[kk].hi[2], qf[kk].lo[2]);
      split<EXACT>(in1 ? p1[8 * kk + 4] : 0.f, qf[kk].hi[3], qf[kk].lo[3]);
    }
  }

  float o[8][4];
  if constexpr (PV) zero(o);
  float m[2] = {NEG, NEG}, l[2] = {0.f, 0.f}, alpha[2];
  for (int it = 0; it < n_tiles; ++it) {
    const int st = it & 1;
    if (it + 1 < n_tiles) {
      load_tile(Ks + (st ^ 1) * TILE, k + slab, (it + 1) * BT, T_len);
      if constexpr (PV) load_tile(Vs + (st ^ 1) * TILE, v + slab, (it + 1) * BT, T_len);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* Kt = Ks + st * TILE;
    float s[8][4], s_small[8][4];
    zero(s);
    zero(s_small);
#pragma unroll
    for (int kk = 0; kk < 8; ++kk)
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        FragB b;
        load_b_rows_n<EXACT>(b, Kt, LDT, 8 * nt, 8 * kk, g, c);
        mma3<EXACT, EXACT>(s[nt], s_small[nt], qf[kk], b);
      }
    if constexpr (!EXACT) join(s, s_small);
    softmax_tile(s, m, l, alpha, it * BT, n_valid, T_len, scale, c);
    if constexpr (PV) {
      // this tile's P.V in fresh accumulators, then O = O alpha + P.V
      const float* Vt = Vs + st * TILE;
      float t[8][4], t_small[8][4];
      zero(t);
      zero(t_small);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        FragA pa;
        acc_as_a(pa, s[j]);
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          FragB b;
          load_b_rows_k<EXACT>(b, Vt, LDT, 8 * j, 8 * nt, g, c);
          mma3<false, EXACT>(t[nt], t_small[nt], pa, b);
        }
      }
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          o[nt][e] = __fmaf_rn(o[nt][e], alpha[e >> 1], __fadd_rn(t[nt][e], t_small[nt][e]));
    }
    __syncthreads();  // the stage is free for the load two tiles on
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] = __fadd_rn(l[r], __shfl_xor_sync(0xffffffffu, l[r], 1));
    l[r] = __fadd_rn(l[r], __shfl_xor_sync(0xffffffffu, l[r], 2));
  }
  if constexpr (PV) {
    const float i0 = 1.f / l[0], i1 = 1.f / l[1];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const int col = 8 * nt + 2 * c;
      if (r0 < Tq)
        *reinterpret_cast<float2*>(out + qslab + (size_t)r0 * D + col) =
            make_float2(o[nt][0] * i0, o[nt][1] * i0);
      if (r1 < Tq)
        *reinterpret_cast<float2*>(out + qslab + (size_t)r1 * D + col) =
            make_float2(o[nt][2] * i1, o[nt][3] * i1);
    }
  }
  if (lse != nullptr && c == 0) {
    const size_t row = (size_t)bh * Tq;
    if (r0 < Tq) lse[row + r0] = __fadd_rn(m[0], logf(l[0]));
    if (r1 < Tq) lse[row + r1] = __fadd_rn(m[1], logf(l[1]));
  }
}

// dynamic shared memory of the forward core
constexpr int fwd_smem_bytes(bool pv) { return (int)sizeof(float) * (pv ? 4 : 2) * TILE; }

}  // namespace tf32
