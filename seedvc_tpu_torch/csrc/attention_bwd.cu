// DiT attention backward for Hopper (sm_90a): K1b, the gradients of K1 and K3.
//
// What it replaces. The JAX package differentiates its attention kernels with
// a custom_vjp whose bwd is an XLA vjp of the jnp reference
// (seedvc_tpu/ops/pallas/attention.py:315-367, the bwd of _fused_diff and
// _plain_diff); no Pallas kernel. This file computes the same gradients, those
// of the plain twins dit_attention_fused_reference (K1: q and k roped in fp32
// from the (T, d) cos / signed-sin caches and rounded to the input type) and
// dit_attention_reference (K3: q and k arrive roped): softmax(q.k^T / 8) v over
// the keys < lens[b], with a masked logit set to -1e30 (a where, so a masked
// key passes no gradient to q or k). No gradient goes to cos, sin or lens.
//
// What bounds it on an H100: operations. The least work is five T x T x d
// products a (batch, head) (S, dP, dQ, dK, dV: 10*B*H*T^2*d operations)
// against about 11*B*H*T*d elements moved. In f32 each product is three TF32
// products on the tensor cores (3xTF32, attention_tf32.cuh), so the bound is
// 3 * 10*B*H*T^2*d operations at the 495 TFLOP/s TF32 peak: 0.0498 ms at the
// fine-tuning path's (2, 8, 896, 64), 0.407 ms at T = 2560.
//
// Design: the flash backward, five products, on 3xTF32 mma.sync; nothing of
// size (T, T) touches device memory. Kernels, in order, on the caller's stream:
// 1. bwd_prep_kernel: one warp a row, a lane a RoPE pair. q and k are roped
//    (K1) with each product and the sum rounded on their own, as the twin's
//    tensor ops round, then rounded to the input type; q is scaled by 2^-3.
//    f32 copies of q and k (and of v and dO for bf16 inputs) go to scratch,
//    D = rowsum(dO * o) to a row vector, and the dQ accumulator is zeroed.
// 2. Only when the caller has no row statistics (the forward's log-sum-exp):
//    tf32::attn_fwd_tf32 in its statistics mode computes them from the same
//    f32 copies.
// 3. bwd_dkdv_kernel: one block a (64-key tile, batch*head), 4 warps of 16
//    keys; K and V stay in shared memory while the query tiles stream through
//    a cp.async stage (the next tile loads while this one's dQ product runs).
//    Per query tile: S^T = K.Q^T and dP^T = V.dO^T; P^T = exp(S^T - lse) and
//    dS^T = P^T (dP^T - D) in registers; dV += P^T.dO and dK += dS^T.Q with P
//    and dS fed from the accumulators; dS goes to shared memory once, and
//    dQ = dS.K for the tile's rows is added to an f32 accumulator in device
//    memory (float2 atomics: the five-product design; dQ's bits vary with
//    the order of the adds from run to run, about 1e-7 of its size). Key
//    tiles past the valid keys write zeros and read nothing. A batch row
//    with at most one valid key is a case of its own, exact as the twin's
//    autograd gives it: dQ = dK = 0; dV is, with no valid key (uniform P over
//    all T keys), the mean of dO at every key, with one, the sum of dO at
//    key 0 (P = (1, 0, ...): P (dP - D) is 0 in the twin, but a tensor-core
//    dP would leave rounding noise there).
// 4. bwd_finish_kernel: the gradients leave fp32: dq (times 2^-3) and dk are
//    rounded to the input type (where the twin's autograd rounds them), then
//    K1 applies RoPE's transpose, dx = g*cos + pair_swap(g*sin), and rounds
//    again; dv is rounded.
// For bf16 inputs q, k, v and dO are TF32 values already, so the products
// skip the terms of their (zero) lo parts.
// Host side: one C entry point for K1 and K3, f32 and bf16. The wrapper
// allocates the fp32 scratch (5 B*H*T*64 + 2 B*H*T floats in f32, 7 B*H*T*64
// + 2 B*H*T for bf16).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "attention_tf32.cuh"

namespace {

using bf16 = __nv_bfloat16;
using namespace tf32;

constexpr float SCALE = 0.125f;  // 1/sqrt(64)
constexpr int LD_DS = 72;        // row stride of the dS tile: conflict-free 8-byte A loads
constexpr int DKDV_SMEM = (int)sizeof(float) * (4 * TILE + BT * LD_DS + 2 * BT);

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float x) { return __float2bfloat16_rn(x); }

template <typename T>
__device__ __forceinline__ float round_to(float x) { return to_f(from_f<T>(x)); }

// x*cos + pair_swap(x)*sin for the pair (x0, x1) at features (f, f+1), each
// product and the sum rounded on their own.
__device__ __forceinline__ void rope_pair(float& x0, float& x1, float c0, float c1, float s0,
                                          float s1) {
  const float y0 = __fadd_rn(__fmul_rn(x0, c0), __fmul_rn(x1, s0));
  const float y1 = __fadd_rn(__fmul_rn(x1, c1), __fmul_rn(x0, s1));
  x0 = y0;
  x1 = y1;
}

template <typename T, bool ROPE>
__global__ void __launch_bounds__(256)
bwd_prep_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                const T* __restrict__ o, const T* __restrict__ dout,
                const float* __restrict__ cosb, const float* __restrict__ sinb,
                float* __restrict__ qs, float* __restrict__ ks, float* __restrict__ vs,
                float* __restrict__ dos, float* __restrict__ dsum, float* __restrict__ dqf,
                int T_len, long long rows) {
  const int lane = threadIdx.x & 31;
  const long long first = (blockIdx.x * (long long)blockDim.x + threadIdx.x) >> 5;
  const long long stride = ((long long)gridDim.x * blockDim.x) >> 5;
  for (long long r = first; r < rows; r += stride) {
    const size_t e = (size_t)r * D + 2 * lane;
    float q0 = to_f(q[e]), q1 = to_f(q[e + 1]);
    float k0 = to_f(k[e]), k1 = to_f(k[e + 1]);
    if constexpr (ROPE) {
      const size_t c = (size_t)(r % T_len) * D + 2 * lane;
      const float c0 = cosb[c], c1 = cosb[c + 1], s0 = sinb[c], s1 = sinb[c + 1];
      rope_pair(q0, q1, c0, c1, s0, s1);
      rope_pair(k0, k1, c0, c1, s0, s1);
      q0 = round_to<T>(q0);
      q1 = round_to<T>(q1);
      k0 = round_to<T>(k0);
      k1 = round_to<T>(k1);
    }
    *reinterpret_cast<float2*>(qs + e) = make_float2(q0 * SCALE, q1 * SCALE);
    *reinterpret_cast<float2*>(ks + e) = make_float2(k0, k1);
    const float g0 = to_f(dout[e]), g1 = to_f(dout[e + 1]);
    if constexpr (!std::is_same<T, float>::value) {
      *reinterpret_cast<float2*>(vs + e) = make_float2(to_f(v[e]), to_f(v[e + 1]));
      *reinterpret_cast<float2*>(dos + e) = make_float2(g0, g1);
    }
    *reinterpret_cast<float2*>(dqf + e) = make_float2(0.f, 0.f);
    float d = fmaf(g1, to_f(o[e + 1]), g0 * to_f(o[e]));
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) d += __shfl_xor_sync(0xffffffffu, d, off);
    if (lane == 0) dsum[r] = d;
  }
}

__device__ __forceinline__ int valid_keys(const int* lens, int b, int T_len) {
  const int n = lens ? lens[b] : T_len;
  return n > T_len ? T_len : n;
}

// Rows [k0, k0 + 64) (< T) of dK and dV for a batch row with n_valid <= 1:
// dK = 0; dV is the mean of dO over the T queries at every key (n_valid <= 0)
// or the sum of dO at key 0 (n_valid = 1), 0 elsewhere. sh: 128 floats.
__device__ void few_keys(const float* __restrict__ dO, float* __restrict__ dk,
                         float* __restrict__ dv, int k0, int n_valid, int T_len, float* sh) {
  const bool need = n_valid <= 0 || k0 == 0;
  if (need) {
    // column sums of dO: thread t sums column t % 64 over every other row
    const int col = threadIdx.x & 63;
    float acc = 0.f;
    for (int t = threadIdx.x >> 6; t < T_len; t += 2) acc += dO[(size_t)t * D + col];
    sh[threadIdx.x] = acc;
  }
  __syncthreads();
  const int rows = min(BT, T_len - k0);
  const float inv_t = 1.f / (float)T_len;
  for (int i = threadIdx.x; i < rows * D; i += THREADS) {
    const int r = i / D, col = i % D, key = k0 + r;
    float val = 0.f;
    if (need) {
      const float sum = sh[col] + sh[col + 64];
      val = n_valid <= 0 ? sum * inv_t : (key == 0 ? sum : 0.f);
    }
    dv[(size_t)key * D + col] = val;
    dk[(size_t)key * D + col] = 0.f;
  }
}

template <bool EXACT>
__global__ void __launch_bounds__(THREADS, 2)
bwd_dkdv_kernel(const float* __restrict__ qs, const float* __restrict__ ks,
                const float* __restrict__ vs, const float* __restrict__ dos,
                const float* __restrict__ dsum, const float* __restrict__ lse,
                const int* __restrict__ lens, float* __restrict__ dqf, float* __restrict__ dkf,
                float* __restrict__ dvf, int H, int T_len) {
  extern __shared__ __align__(16) float smem[];
  float* Ks = smem;                 // the key tile
  float* Vs = Ks + TILE;            // the value tile
  float* Qs = Vs + TILE;            // q * 2^-3 of the query tile
  float* dOs = Qs + TILE;           // dO of the query tile
  float* dSs = dOs + TILE;          // dS of the (query, key) tile pair: [query][key]
  float* Ls = dSs + BT * LD_DS;     // lse of the query tile
  float* Ds = Ls + BT;              // D of the query tile

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, c = lane & 3;
  const int bh = blockIdx.y, k0 = blockIdx.x * BT;
  const size_t slab = (size_t)bh * T_len * D;
  const size_t row0 = (size_t)bh * T_len;
  const int n_valid = valid_keys(lens, bh / H, T_len);
  if (n_valid <= 1) {
    few_keys(dos + slab, dkf + slab, dvf + slab, k0, n_valid, T_len, smem);
    return;
  }
  if (k0 >= n_valid) {  // only masked keys: no gradient
    for (int i = threadIdx.x; i < min(BT, T_len - k0) * D; i += THREADS) {
      dkf[slab + (size_t)k0 * D + i] = 0.f;
      dvf[slab + (size_t)k0 * D + i] = 0.f;
    }
    return;
  }

  load_tile(Ks, ks + slab, k0, T_len);
  load_tile(Vs, vs + slab, k0, T_len);
  load_tile(Qs, qs + slab, 0, T_len);
  load_tile(dOs, dos + slab, 0, T_len);
  load_vec(Ls, lse + row0, 0, T_len);
  load_vec(Ds, dsum + row0, 0, T_len);
  cp_async_commit();

  const int kr = 16 * warp;  // this warp's keys in the tile: rows kr + g and kr + g + 8
  const bool kv0 = k0 + kr + g < n_valid, kv1 = k0 + kr + g + 8 < n_valid;
  float dk[8][4], dv[8][4];
  zero(dk);
  zero(dv);
  const int n_qt = (T_len + BT - 1) / BT;
  for (int it = 0; it < n_qt; ++it) {
    const int qt0 = it * BT;
    cp_async_wait<0>();
    __syncthreads();
    // Per stage, for this warp's 16 keys and the 64 queries, each product in a
    // hi.hi and a small-terms accumulator (see "Accumulation" in
    // attention_tf32.cuh); the order S, P, dV, dP, dS, dK keeps at most four
    // accumulator sets besides dK and dV alive. Unrolled by 2: the k loops
    // whose A fragments come from shared memory (S, dP, dQ) are unrolled by
    // 2, not 8; in full they held every fragment's loads at once (255
    // registers and spills), and by 2 K1b took 0.2326 ms instead of 0.2707
    // at (2, 8, 896, 64) and 1.5505 instead of 1.6792 at T = 2560
    // (chip_smoke.py, H100 80GB HBM3 at 700 W).
    float sp[8][4], t[8][4], small[8][4];  // S^T then P^T; dV, dP^T, dK partials
    // S^T = K.Q^T
    zero(sp);
    zero(small);
#pragma unroll 2  // see "Unrolled by 2" above
    for (int kk = 0; kk < 8; ++kk) {
      FragA ka;
      load_a<EXACT>(ka, Ks, LDT, kr, 8 * kk, g, c);
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        FragB b;
        load_b_rows_n<EXACT>(b, Qs, LDT, 8 * nt, 8 * kk, g, c);
        mma3<EXACT, EXACT>(sp[nt], small[nt], ka, b);
      }
    }
    if constexpr (!EXACT) join(sp, small);
    // P^T = exp(S^T - lse) over valid keys and queries < T
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qc = 8 * nt + 2 * c + (e & 1);
        const bool in = (e < 2 ? kv0 : kv1) && qt0 + qc < T_len;
        sp[nt][e] = in ? expf(sp[nt][e] - Ls[qc]) : 0.f;
      }
    // dV += P^T.dO: this tile's product in fresh accumulators (P from the
    // registers), added to the running sum
    zero(t);
    zero(small);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      FragA pa;
      acc_as_a(pa, sp[j]);
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        FragB b;
        load_b_rows_k<EXACT>(b, dOs, LDT, 8 * j, 8 * nt, g, c);
        mma3<false, EXACT>(t[nt], small[nt], pa, b);
      }
    }
    join(t, small);
    join(dv, t);
    // dP^T = V.dO^T, then dS^T = P^T (dP^T - D) in sp
    zero(t);
    zero(small);
#pragma unroll 2
    for (int kk = 0; kk < 8; ++kk) {
      FragA va;
      load_a<EXACT>(va, Vs, LDT, kr, 8 * kk, g, c);
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        FragB b;
        load_b_rows_n<EXACT>(b, dOs, LDT, 8 * nt, 8 * kk, g, c);
        mma3<EXACT, EXACT>(t[nt], small[nt], va, b);
      }
    }
    if constexpr (!EXACT) join(t, small);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) sp[nt][e] *= t[nt][e] - Ds[8 * nt + 2 * c + (e & 1)];
    // dK += dS^T.(q 2^-3), as dV
    zero(t);
    zero(small);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      FragA sa;
      acc_as_a(sa, sp[j]);
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        FragB b;
        load_b_rows_k<EXACT>(b, Qs, LDT, 8 * j, 8 * nt, g, c);
        mma3<false, EXACT>(t[nt], small[nt], sa, b);
      }
    }
    join(t, small);
    join(dk, t);
    // dS^T to shared memory as dS[query][key]
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        dSs[(8 * nt + 2 * c + (e & 1)) * LD_DS + kr + g + 8 * (e >> 1)] = sp[nt][e];
    __syncthreads();  // this query tile's Q, dO, lse and D are read; dS is whole
    if (it + 1 < n_qt) {
      const int next = qt0 + BT;
      load_tile(Qs, qs + slab, next, T_len);
      load_tile(dOs, dos + slab, next, T_len);
      load_vec(Ls, lse + row0, next, T_len);
      load_vec(Ds, dsum + row0, next, T_len);
      cp_async_commit();
    }
    // dQ of the tile's rows 16 warp .. 16 warp + 15 += dS.K, into device memory
    float (&dq)[8][4] = t;
    zero(dq);
    zero(small);
#pragma unroll 2
    for (int j = 0; j < 8; ++j) {
      FragA da;
      load_a_pairs(da, dSs, LD_DS, 16 * warp, 8 * j, g, c);
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        FragB b;
        load_b_rows_k<EXACT>(b, Ks, LDT, 8 * j, 8 * nt, g, c);
        mma3<false, EXACT>(dq[nt], small[nt], da, b);
      }
    }
    join(dq, small);
    const int q_r0 = qt0 + 16 * warp + g, q_r1 = q_r0 + 8;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const int col = 8 * nt + 2 * c;
      if (q_r0 < T_len)
        atomicAdd(reinterpret_cast<float2*>(dqf + slab + (size_t)q_r0 * D + col),
                  make_float2(dq[nt][0], dq[nt][1]));
      if (q_r1 < T_len)
        atomicAdd(reinterpret_cast<float2*>(dqf + slab + (size_t)q_r1 * D + col),
                  make_float2(dq[nt][2], dq[nt][3]));
    }
  }
  const int key0 = k0 + kr + g, key1 = key0 + 8;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    const int col = 8 * nt + 2 * c;
    if (key0 < T_len) {
      *reinterpret_cast<float2*>(dkf + slab + (size_t)key0 * D + col) =
          make_float2(dk[nt][0], dk[nt][1]);
      *reinterpret_cast<float2*>(dvf + slab + (size_t)key0 * D + col) =
          make_float2(dv[nt][0], dv[nt][1]);
    }
    if (key1 < T_len) {
      *reinterpret_cast<float2*>(dkf + slab + (size_t)key1 * D + col) =
          make_float2(dk[nt][2], dk[nt][3]);
      *reinterpret_cast<float2*>(dvf + slab + (size_t)key1 * D + col) =
          make_float2(dv[nt][2], dv[nt][3]);
    }
  }
}

template <typename T, bool ROPE>
__global__ void __launch_bounds__(256)
bwd_finish_kernel(const float* __restrict__ dqf, const float* __restrict__ dkf,
                  const float* __restrict__ dvf, const float* __restrict__ cosb,
                  const float* __restrict__ sinb, T* __restrict__ dq, T* __restrict__ dk,
                  T* __restrict__ dv, int T_len, long long pairs) {
  for (long long p = blockIdx.x * (long long)blockDim.x + threadIdx.x; p < pairs;
       p += (long long)gridDim.x * blockDim.x) {
    const size_t e = (size_t)p * 2;
    float q0 = round_to<T>(dqf[e] * SCALE), q1 = round_to<T>(dqf[e + 1] * SCALE);
    float k0 = round_to<T>(dkf[e]), k1 = round_to<T>(dkf[e + 1]);
    if constexpr (ROPE) {
      // y_a = x_a cos_a + x_(a^1) sin_a, so dx_a = g_a cos_a + g_(a^1) sin_(a^1)
      const size_t c = (size_t)((p / (D / 2)) % T_len) * D + (size_t)(p % (D / 2)) * 2;
      const float c0 = cosb[c], c1 = cosb[c + 1], s0 = sinb[c], s1 = sinb[c + 1];
      rope_pair(q0, q1, c0, c1, s1, s0);
      rope_pair(k0, k1, c0, c1, s1, s0);
    }
    dq[e] = from_f<T>(q0);
    dq[e + 1] = from_f<T>(q1);
    dk[e] = from_f<T>(k0);
    dk[e + 1] = from_f<T>(k1);
    dv[e] = from_f<T>(dvf[e]);
    dv[e + 1] = from_f<T>(dvf[e + 1]);
  }
}

// Sets a kernel's dynamic shared-memory limit once per device (the attribute
// belongs to the current device).
constexpr int MAX_DEVICES = 64;
bool dkdv_smem_set[2][MAX_DEVICES];

template <typename Kernel>
int set_smem_once(Kernel kernel, int bytes, bool (&done)[MAX_DEVICES]) {
  int dev = 0;
  int err = (int)cudaGetDevice(&dev);
  if (err) return err;
  const bool tracked = dev < MAX_DEVICES;
  if (tracked && done[dev]) return 0;
  err = (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (!err && tracked) done[dev] = true;
  return err;
}

int grid_for(long long threads) {
  const long long blocks = (threads + 255) / 256;
  return (int)(blocks < 8192 ? blocks : 8192);
}

template <typename T, bool ROPE>
int launch(const void* q, const void* k, const void* v, const float* cosb, const float* sinb,
           const int* lens, const void* o, const void* dout, const float* lse_in, void* dq,
           void* dk, void* dv, float* scratch, int B, int H, int T_len, cudaStream_t stream) {
  constexpr bool EXACT = !std::is_same<T, float>::value;  // bf16 inputs are TF32 values
  int err = set_smem_once(bwd_dkdv_kernel<EXACT>, DKDV_SMEM, dkdv_smem_set[EXACT]);
  if (err) return err;
  const long long rows = (long long)B * H * T_len;
  const size_t n = (size_t)rows * D;
  float* qs = scratch;
  float* ks = qs + n;
  float* rest = ks + n;
  float *vcopy = nullptr, *docopy = nullptr;
  if (EXACT) {  // f32 copies of v and dO; f32 inputs are read as they are
    vcopy = rest;
    docopy = rest + n;
    rest += 2 * n;
  }
  const float* vs = EXACT ? vcopy : (const float*)v;
  const float* dos = EXACT ? docopy : (const float*)dout;
  float* dqf = rest;
  float* dkf = dqf + n;
  float* dvf = dkf + n;
  float* dsum = dvf + n;
  float* lse = lse_in ? const_cast<float*>(lse_in) : dsum + rows;

  bwd_prep_kernel<T, ROPE><<<grid_for(rows * 32), 256, 0, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)o, (const T*)dout, cosb, sinb, qs, ks,
      vcopy, docopy, dsum, dqf, T_len, rows);
  err = (int)cudaGetLastError();
  if (err) return err;
  const dim3 grid((T_len + BT - 1) / BT, B * H);
  if (lse_in == nullptr) {
    attn_fwd_tf32<false, EXACT><<<grid, THREADS, fwd_smem_bytes(false), stream>>>(
        qs, ks, nullptr, lens, nullptr, lse, H, T_len, T_len, 1.f);
    err = (int)cudaGetLastError();
    if (err) return err;
  }
  bwd_dkdv_kernel<EXACT><<<grid, THREADS, DKDV_SMEM, stream>>>(qs, ks, vs, dos, dsum, lse, lens,
                                                               dqf, dkf, dvf, H, T_len);
  err = (int)cudaGetLastError();
  if (err) return err;
  const long long pairs = rows * (D / 2);
  bwd_finish_kernel<T, ROPE><<<grid_for(pairs), 256, 0, stream>>>(
      dqf, dkf, dvf, cosb, sinb, (T*)dq, (T*)dk, (T*)dv, T_len, pairs);
  return (int)cudaGetLastError();
}

}  // namespace

// dq, dk, dv (B, H, T, 64) of K1 (rope = 1: q/k before RoPE, cos/sin (T, 64)
// f32) or K3 (rope = 0: q/k roped, cos/sin unused), in the inputs' type
// (is_bf16 = 1: bfloat16, else float32). o is the forward's output and dout its
// upstream gradient, both in the inputs' type; lens is (B,) int32 or null; lse
// is the forward's (B*H, T) f32 row log-sum-exp or null (then computed here).
// scratch holds 5*B*H*T*64 + 2*B*H*T floats (f32) or 7*B*H*T*64 + 2*B*H*T
// (bf16).
extern "C" int dit_attention_bwd(const void* q, const void* k, const void* v, const float* cosb,
                                 const float* sinb, const int* lens, const void* o,
                                 const void* dout, const float* lse, void* dq, void* dk, void* dv,
                                 float* scratch, int B, int H, int T_len, int is_bf16, int rope,
                                 void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16) {
    return rope ? launch<bf16, true>(q, k, v, cosb, sinb, lens, o, dout, lse, dq, dk, dv, scratch,
                                     B, H, T_len, s)
                : launch<bf16, false>(q, k, v, cosb, sinb, lens, o, dout, lse, dq, dk, dv,
                                      scratch, B, H, T_len, s);
  }
  return rope ? launch<float, true>(q, k, v, cosb, sinb, lens, o, dout, lse, dq, dk, dv, scratch,
                                    B, H, T_len, s)
              : launch<float, false>(q, k, v, cosb, sinb, lens, o, dout, lse, dq, dk, dv, scratch,
                                     B, H, T_len, s);
}
