// The v2 AR's decode step (seedvc_tpu_torch/models/ar.py::ARTransformer.decode_step)
// as five kernels a transformer layer and one for the head, for Hopper (sm_90a).
//
// Replaces no Pallas kernel: the JAX package leaves the decode step
// (seedvc_tpu/models/ar.py::ARTransformer.decode_step) to XLA. It was added
// because the port's step, about forty PyTorch and cuBLAS launches a layer, ran
// launch-paced inside its CUDA graph, and cuBLAS's 64x8 output tiles put each
// product with M <= 3 rows on a tenth of the SMs.
//
// What bounds it on the H100: bytes. A step reads every weight once (163 MB of
// bf16 at ARConfig(), 49 us at 3.35 TB/s) and the K/V slots each row attends
// (256 bytes a slot and KV head); it does 2 operations per weight and batch row.
// What the design does about it:
//  - each product is a GEMV spread over every SM: a warp owns one or two rows of
//    an nn.Linear weight (or one row of two weights) and loads its share of them
//    into registers, 16 bytes a lane, before it waits for the kernel launched
//    before it (programmatic dependent launch), so a kernel's weight loads
//    overlap the tail of the one before; the batch rows, up to BG a pass, share
//    the loaded weights, and more rows loop over passes;
//  - the elementwise work around each product runs in its prologue or epilogue
//    (RMSNorm of the input into shared memory, one read of it; RoPE, the write
//    of q and of the cache slot; SwiGLU; the residual add), so between two
//    products only the product's input and output vectors go through device
//    memory;
//  - attention reads only the valid slots [min_key[b], min(kv_pos, S - 1)], in
//    runs of TK keys, a block each, which load their keys and values before the
//    wait (all but the slot this step writes); a block runs the KV head's query
//    heads together with an f32 softmax and writes its partial output and
//    statistics; the last block of a (row, KV head) to finish (an atomic counter
//    it resets) combines the runs in a fixed order, so the result does not
//    depend on the order the blocks ran in;
//  - positions (kv_pos, input_pos, min_key) are read from device memory, so one
//    CUDA graph capture serves every step.
// Rounding follows the plain step: q, k, v, the attention output, the products'
// outputs and the FFN's hidden state are rounded to the weights' type where it
// rounds them; logits and softmax are f32, and the head's logits stay f32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int BG = 4;            // batch rows a pass over the loaded weights serves
constexpr int WARPS = 4;         // warps of a GEMV block
constexpr int NT = WARPS * 32;
constexpr int HD = 64;           // head size
constexpr int R = 6;             // query heads a KV head (ARConfig(): 12 over 2)
constexpr int TK = 128;          // attention: keys a block (a run)
constexpr int ATT_WARPS = 8;
constexpr int ATT_NT = ATT_WARPS * 32;
constexpr int MAX_RUNS = 64;
constexpr int REC = R * (HD + 2);  // floats of one split's record: o[R][HD], m, l

constexpr int ERR_SHAPE = 20001;

template <typename T> struct Pack { static constexpr int N = 16 / sizeof(T); };

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float v) { return __float2bfloat16_rn(v); }
// v rounded to T, back as a float
template <typename T> __device__ __forceinline__ float rnd(float v) { return to_f(from_f<T>(v)); }

// an activation written by an earlier kernel: read through L2
__device__ __forceinline__ float ld_act(const float* p) { return __ldcg(p); }
__device__ __forceinline__ float ld_act(const bf16* p) {
  return __uint_as_float(static_cast<uint32_t>(__ldcg(reinterpret_cast<const unsigned short*>(p))) << 16);
}

// 16 bytes of weights, read once a step: not kept in L1
__device__ __forceinline__ uint4 ld_weights(const void* p) {
  uint4 r;
  asm volatile("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];"
      : "=r"(r.x), "=r"(r.y), "=r"(r.z), "=r"(r.w) : "l"(p));
  return r;
}

template <typename T> __device__ __forceinline__ void unpack(const uint4& u, float* f);
template <> __device__ __forceinline__ void unpack<float>(const uint4& u, float* f) {
  f[0] = __uint_as_float(u.x), f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z), f[3] = __uint_as_float(u.w);
}
template <> __device__ __forceinline__ void unpack<bf16>(const uint4& u, float* f) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// two consecutive elements of a cache row, as floats
__device__ __forceinline__ float2 ld_pair(const float* p) { return __ldcg(reinterpret_cast<const float2*>(p)); }
__device__ __forceinline__ float2 ld_pair(const bf16* p) {
  const uint32_t w = __ldcg(reinterpret_cast<const unsigned int*>(p));
  return make_float2(__uint_as_float(w << 16), __uint_as_float(w & 0xffff0000u));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}
__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Programmatic dependent launch: a kernel may start while the one launched just
// before it runs, and waits for it in wait_prior(); it releases the next one
// right after. So before wait_prior() a kernel reads only what no kernel of the
// chain writes: the weights, the positions (kv_pos, input_pos, min_key) and the
// RoPE table, and cache slots other than the one the step writes. Every kernel
// before the one just before it has completed by then (that one waited for it).
__device__ __forceinline__ void wait_prior() { asm volatile("griddepcontrol.wait;" ::: "memory"); }
__device__ __forceinline__ void release_next() { asm volatile("griddepcontrol.launch_dependents;" :::); }

// 16-byte chunks of a normed row a thread holds: D <= SC * NT * 16 bytes
template <typename T> struct Rows { static constexpr int SC = sizeof(T) == 4 ? 2 : 1; };

template <typename T> __device__ __forceinline__ uint4 pack(const float* f);
template <> __device__ __forceinline__ uint4 pack<float>(const float* f) {
  return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]), __float_as_uint(f[2]),
                    __float_as_uint(f[3]));
}
template <> __device__ __forceinline__ uint4 pack<bf16>(const float* f) {
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    w[i] = (uint32_t)__bfloat16_as_ushort(from_f<bf16>(f[2 * i])) |
           ((uint32_t)__bfloat16_as_ushort(from_f<bf16>(f[2 * i + 1])) << 16);
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// This thread's chunks of the norm weight (loaded before the wait).
template <typename T, int SC = Rows<T>::SC>
__device__ __forceinline__ void load_norm_weight(const T* w, int D, uint4 (&wn)[SC]) {
  const int nch = D / Pack<T>::N;
#pragma unroll
  for (int j = 0; j < SC; ++j) {
    const int c = threadIdx.x + j * NT;
    wn[j] = c < nch ? ld_weights(w + (size_t)c * Pack<T>::N) : make_uint4(0u, 0u, 0u, 0u);
  }
}

// xs[b][i] = T(T(x[b][i] * rsqrt(mean(x[b]^2) + eps)) * w[i]), b < nb: RMSNorm as
// nn/layers.py rounds it; x read once, 16 bytes a thread. Ends synchronised.
template <typename T, int SC = Rows<T>::SC>
__device__ void stage_rmsnorm(const T* x, const uint4 (&wn)[SC], T* xs, int nb, int D,
                              float eps) {
  constexpr int P = Pack<T>::N;
  __shared__ float red[BG][WARPS];
  __shared__ float inv[BG];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nch = D / P;
  uint4 xr[BG][SC];
  float ss[BG];
#pragma unroll
  for (int b = 0; b < BG; ++b) {
    ss[b] = 0.f;
#pragma unroll
    for (int j = 0; j < SC; ++j) {
      const int c = threadIdx.x + j * NT;
      xr[b][j] = make_uint4(0u, 0u, 0u, 0u);
      if (b < nb && c < nch)
        xr[b][j] = __ldcg(reinterpret_cast<const uint4*>(x + (size_t)b * D + (size_t)c * P));
    }
  }
#pragma unroll
  for (int b = 0; b < BG; ++b)
    if (b < nb) {
#pragma unroll
      for (int j = 0; j < SC; ++j) {
        float f[P];
        unpack<T>(xr[b][j], f);
#pragma unroll
        for (int i = 0; i < P; ++i) ss[b] = fmaf(f[i], f[i], ss[b]);
      }
      ss[b] = warp_sum(ss[b]);
      if (lane == 0) red[b][warp] = ss[b];
    }
  __syncthreads();
  if (threadIdx.x < nb) {
    float s = 0.f;
#pragma unroll
    for (int k = 0; k < WARPS; ++k) s += red[threadIdx.x][k];
    inv[threadIdx.x] = rsqrtf(s / (float)D + eps);
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < SC; ++j) {
    const int c = threadIdx.x + j * NT;
    if (c < nch) {
      float w[P];
      unpack<T>(wn[j], w);
#pragma unroll
      for (int b = 0; b < BG; ++b)
        if (b < nb) {
          float f[P];
          unpack<T>(xr[b][j], f);
#pragma unroll
          for (int i = 0; i < P; ++i) f[i] = rnd<T>(f[i] * inv[b]) * w[i];
          *reinterpret_cast<uint4*>(xs + (size_t)b * D + (size_t)c * P) = pack<T>(f);
        }
    }
  }
  __syncthreads();
}

// xs = src[0 : n), n a multiple of 16 bytes' elements. Ends synchronised.
template <typename T>
__device__ void stage_copy(const T* src, T* xs, int n) {
  const uint4* s = reinterpret_cast<const uint4*>(src);
  uint4* d = reinterpret_cast<uint4*>(xs);
  for (int i = threadIdx.x; i < n / Pack<T>::N; i += NT) d[i] = __ldcg(s + i);
  __syncthreads();
}

// One warp's NR weight rows of K elements, its lane's 16-byte chunks c = lane + 32 j
// held in registers.
template <typename T, int NR, int CPL>
struct WarpRows {
  uint4 w[NR][CPL];

  __device__ __forceinline__ void load(const T* const (&rows)[NR], int nch, bool active) {
    const int lane = threadIdx.x & 31;
#pragma unroll
    for (int j = 0; j < CPL; ++j) {
      const int c = lane + 32 * j;
#pragma unroll
      for (int r = 0; r < NR; ++r)
        w[r][j] = (active && c < nch) ? ld_weights(rows[r] + (size_t)c * Pack<T>::N)
                                      : make_uint4(0u, 0u, 0u, 0u);
    }
  }

  // acc[r][b] = sum_k w_r[k] xs[b][k] over the whole row (every lane gets it), b < nb
  __device__ __forceinline__ void dot(const T* xs, int K, int nb, int nch,
                                      float (&acc)[NR][BG]) const {
    constexpr int P = Pack<T>::N;
    const int lane = threadIdx.x & 31;
#pragma unroll
    for (int r = 0; r < NR; ++r)
#pragma unroll
      for (int b = 0; b < BG; ++b) acc[r][b] = 0.f;
#pragma unroll
    for (int j = 0; j < CPL; ++j) {
      const int c = lane + 32 * j;
      if (c < nch) {
        float wf[NR][P];
#pragma unroll
        for (int r = 0; r < NR; ++r) unpack<T>(w[r][j], wf[r]);
#pragma unroll
        for (int b = 0; b < BG; ++b)
          if (b < nb) {
            float xf[P];
            unpack<T>(*reinterpret_cast<const uint4*>(xs + (size_t)b * K + (size_t)c * P), xf);
#pragma unroll
            for (int r = 0; r < NR; ++r)
#pragma unroll
              for (int i = 0; i < P; ++i) acc[r][b] = fmaf(wf[r][i], xf[i], acc[r][b]);
          }
      }
    }
#pragma unroll
    for (int b = 0; b < BG; ++b)
      if (b < nb)
#pragma unroll
        for (int r = 0; r < NR; ++r) acc[r][b] = warp_sum(acc[r][b]);
  }
};

// Epilogues: prefetch(row, n) runs right after the wait, so its loads overlap the
// input's staging; operator() gets the row, the warp's first output row n, the NR
// sums and what prefetch read.

// wqkv rows n, n + 1 (an interleaved RoPE pair): RoPE of q and k at the row's
// position, clamped to the table; q to q, k and v to the cache slot
// min(kv_pos, S - 1).
template <typename T>
struct QkvEpi {
  T* q;
  T* kc;
  T* vc;
  const float* rope;  // (S, HD / 2, 2) cos, sin
  const int64_t* input_pos;
  const int64_t* kv_pos;
  int pos_stride, H, G, S;

  struct Pre {
    float2 cs;
    int slot;
  };

  __device__ __forceinline__ Pre prefetch(int row, int n) const {
    const int64_t kvp = *kv_pos;
    int64_t p = input_pos[(size_t)row * pos_stride];
    p = p < 0 ? 0 : (p > (int64_t)(S - 1) ? (int64_t)(S - 1) : p);
    const int d = n % HD;
    Pre pre;
    pre.cs = *reinterpret_cast<const float2*>(rope + ((size_t)p * (HD / 2) + d / 2) * 2);
    pre.slot = kvp < (int64_t)(S - 1) ? (int)kvp : S - 1;
    return pre;
  }

  __device__ __forceinline__ void operator()(int row, int n, float a0, float a1,
                                             const Pre& pre) const {
    const float y0 = rnd<T>(a0), y1 = rnd<T>(a1);
    const int sec = n / HD, d = n % HD;
    if (sec < H + G) {
      // x0 cos - x1 sin, x1 cos + x0 sin, each product and the sum rounded (no FMA)
      const float o0 = __fadd_rn(__fmul_rn(y0, pre.cs.x), __fmul_rn(y1, -pre.cs.y));
      const float o1 = __fadd_rn(__fmul_rn(y1, pre.cs.x), __fmul_rn(y0, pre.cs.y));
      T* dst = sec < H ? q + ((size_t)row * H + sec) * HD + d
                       : kc + (((size_t)row * G + (sec - H)) * S + pre.slot) * HD + d;
      dst[0] = from_f<T>(o0);
      dst[1] = from_f<T>(o1);
    } else {
      T* dst = vc + (((size_t)row * G + (sec - H - G)) * S + pre.slot) * HD + d;
      dst[0] = from_f<T>(y0);
      dst[1] = from_f<T>(y1);
    }
  }
};

struct NoPre {};

// w1 and w3 row n: hidden = silu(a) * b, each rounded as the plain FFN rounds
template <typename T>
struct SwigluEpi {
  T* hidden;
  int I;
  using Pre = NoPre;

  __device__ __forceinline__ Pre prefetch(int, int) const { return {}; }
  __device__ __forceinline__ void operator()(int row, int n, float a0, float a1,
                                             const Pre&) const {
    const float a = rnd<T>(a0), b = rnd<T>(a1);
    const float s = rnd<T>(a / (1.f + expf(-a)));
    hidden[(size_t)row * I + n] = from_f<T>(s * b);
  }
};

// x_out = x_in + T(product); x_in may be x_out
template <typename T>
struct ResidualEpi {
  const T* x_in;
  T* x_out;
  int D;
  using Pre = float;

  __device__ __forceinline__ Pre prefetch(int row, int n) const {
    return ld_act(x_in + (size_t)row * D + n);
  }
  __device__ __forceinline__ void operator()(int row, int n, float a0, float,
                                             const Pre& x) const {
    x_out[(size_t)row * D + n] = from_f<T>(x + rnd<T>(a0));
  }
};

struct LogitsEpi {
  float* logits;
  int V;
  using Pre = NoPre;

  __device__ __forceinline__ Pre prefetch(int, int) const { return {}; }
  __device__ __forceinline__ void operator()(int row, int n, float a0, float,
                                             const Pre&) const {
    logits[(size_t)row * V + n] = a0;
  }
};

// out[b][n..] = epi(W rows . staged input): warp j of the grid owns output rows
// n = j * row_step (w0 + n K, and w1 + n K when NR = 2). The input is RMSNorm(x)
// when norm_w is given, else x itself (B rows of K elements).
template <typename T, int NR, int CPL, class Epi>
__global__ void __launch_bounds__(NT) gemv_kernel(const T* x, const T* __restrict__ norm_w,
                                                  const T* __restrict__ w0,
                                                  const T* __restrict__ w1, int row_step,
                                                  int B, int K, int N, float eps, Epi epi) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* xs = reinterpret_cast<T*>(smem_raw);
  const int lane = threadIdx.x & 31;
  const int n = (blockIdx.x * WARPS + (threadIdx.x >> 5)) * row_step;
  const bool active = n < N;
  const int nch = K / Pack<T>::N;
  WarpRows<T, NR, CPL> W;
  const T* rows[NR];
  rows[0] = w0 + (size_t)n * K;
  if constexpr (NR == 2) rows[1] = w1 + (size_t)n * K;
  W.load(rows, nch, active);
  uint4 wn[Rows<T>::SC];
  if (norm_w != nullptr) load_norm_weight<T>(norm_w, K, wn);
  wait_prior();
  release_next();
  for (int b0 = 0; b0 < B; b0 += BG) {
    const int nb = B - b0 < BG ? B - b0 : BG;
    typename Epi::Pre pre{};
    if (active && lane < nb) pre = epi.prefetch(b0 + lane, n);
    if (norm_w != nullptr)
      stage_rmsnorm<T>(x + (size_t)b0 * K, wn, xs, nb, K, eps);
    else
      stage_copy<T>(x + (size_t)b0 * K, xs, nb * K);
    if (active) {
      float acc[NR][BG];
      W.dot(xs, K, nb, nch, acc);
#pragma unroll
      for (int b = 0; b < BG; ++b)
        if (b < nb && lane == b) epi(b0 + b, n, acc[0][b], acc[NR - 1][b], pre);
    }
    __syncthreads();  // xs is staged anew for the next pass
  }
}

// Single-query grouped attention of one (run s, KV head g, row b): keys
// [lo + s TK, lo + (s + 1) TK) of the valid [lo, last], two threads a key for the
// logits, ATT_WARPS warps over the keys for p . V, the KV head's R query heads. q (B,
// H, HD) after RoPE; caches (B, G, S, HD); out (B, H * HD). part: (B, G, MAX_RUNS,
// REC) floats; counters: (B, G), zero between calls. A run past the valid keys
// exits at once.
template <typename T>
__global__ void __launch_bounds__(ATT_NT) attention_kernel(
    const T* __restrict__ q, const T* __restrict__ kc, const T* __restrict__ vc,
    const int64_t* __restrict__ kv_pos, const int64_t* __restrict__ min_key, int mk_stride,
    float* __restrict__ part, unsigned* __restrict__ counters, T* __restrict__ out, int G,
    int S) {
  constexpr int P = Pack<T>::N, KC = HD / 2 / P, VJ = TK / ATT_WARPS;
  __shared__ __align__(16) float qs[R][HD + 4];  // + 4: the two halves on other banks
  __shared__ float lg[R][TK];
  __shared__ float red[ATT_WARPS][R][HD];
  __shared__ float ws[MAX_RUNS][R];
  __shared__ int is_last;
  const int s = blockIdx.x, g = blockIdx.y, b = blockIdx.z, H = G * R;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // the positions, and this run's keys, before the wait: only slot `last` is the
  // kernel before's to write, and it is read again after the wait
  const int64_t kvp = *kv_pos;
  const int last = kvp < (int64_t)(S - 1) ? (int)kvp : S - 1;
  int lo = 0;
  if (min_key != nullptr) {
    const int64_t m = min_key[(size_t)b * mk_stride];
    lo = m < 0 ? 0 : (m > (int64_t)S ? S : (int)m);
  }
  const int n_keys = last >= lo ? last - lo + 1 : 0;
  const int runs = (n_keys + TK - 1) / TK;
  if (s >= runs) return;
  const int k0 = lo + s * TK;
  const int nt = last + 1 - k0 < TK ? last + 1 - k0 : TK;
  const size_t head = ((size_t)b * G + g) * S;
  const int key = tid >> 1, half = tid & 1;  // logits: half the dims of key k0 + key
  const uint4* krow = reinterpret_cast<const uint4*>(kc + (head + k0 + key) * HD + half * (HD / 2));
  uint4 kr[KC];
#pragma unroll
  for (int c = 0; c < KC; ++c) kr[c] = key < nt ? __ldcg(krow + c) : make_uint4(0u, 0u, 0u, 0u);
  float2 vr[VJ];  // p . V: keys k0 + warp + ATT_WARPS j, dims 2 lane and 2 lane + 1
#pragma unroll
  for (int j = 0; j < VJ; ++j) {
    const int i = warp + ATT_WARPS * j;
    vr[j] = i < nt ? ld_pair(vc + (head + k0 + i) * HD + 2 * lane) : make_float2(0.f, 0.f);
  }
  wait_prior();
  release_next();
  if (k0 + key == last) {
#pragma unroll
    for (int c = 0; c < KC; ++c) kr[c] = __ldcg(krow + c);
  }
  if ((last - k0 - warp) % ATT_WARPS == 0 && last - k0 < nt) {
    const int j = (last - k0 - warp) / ATT_WARPS;
#pragma unroll
    for (int jj = 0; jj < VJ; ++jj)
      if (jj == j) vr[jj] = ld_pair(vc + (head + last) * HD + 2 * lane);
  }
  // q scaled by 1/8 = hd^-0.5: exact, so the logits are (q . k) hd^-0.5 as the plain step's
  for (int i = tid; i < R * HD; i += ATT_NT)
    qs[i / HD][i % HD] = to_f(q[((size_t)b * H + g * R) * HD + i]) * 0.125f;
  __syncthreads();
  {
    float dot[R];
#pragma unroll
    for (int r = 0; r < R; ++r) dot[r] = 0.f;
#pragma unroll
    for (int c = 0; c < KC; ++c) {
      float kf[P];
      unpack<T>(kr[c], kf);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float* qr = &qs[r][half * (HD / 2) + c * P];
#pragma unroll
        for (int i = 0; i < P; ++i) dot[r] = fmaf(qr[i], kf[i], dot[r]);
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) dot[r] += __shfl_xor_sync(0xffffffffu, dot[r], 1);
    if (half == 0 && key < nt) {
#pragma unroll
      for (int r = 0; r < R; ++r) lg[r][key] = dot[r];
    }
  }
  __syncthreads();
  float m_r = 0.f, l_r = 0.f;  // warp r's head: max logit and sum of e^(logit - max)
  if (warp < R) {
    const int r = warp;
    float mx = -CUDART_INF_F;
    for (int i = lane; i < nt; i += 32) mx = fmaxf(mx, lg[r][i]);
    mx = warp_max(mx);
    float sum = 0.f;
    for (int i = lane; i < nt; i += 32) {
      const float p = expf(lg[r][i] - mx);
      lg[r][i] = p;
      sum += p;
    }
    m_r = mx, l_r = warp_sum(sum);
  }
  __syncthreads();
  float acc[R][2];
#pragma unroll
  for (int r = 0; r < R; ++r) acc[r][0] = acc[r][1] = 0.f;
#pragma unroll
  for (int j = 0; j < VJ; ++j) {
    const int i = warp + ATT_WARPS * j;
    if (i < nt) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float p = lg[r][i];
        acc[r][0] = fmaf(p, vr[j].x, acc[r][0]);
        acc[r][1] = fmaf(p, vr[j].y, acc[r][1]);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < R; ++r)
    *reinterpret_cast<float2*>(&red[warp][r][2 * lane]) = make_float2(acc[r][0], acc[r][1]);
  __syncthreads();
  float* rec = part + (((size_t)b * G + g) * MAX_RUNS + s) * REC;
  for (int i = tid; i < R * HD; i += ATT_NT) {
    float o = 0.f;
#pragma unroll
    for (int w = 0; w < ATT_WARPS; ++w) o += red[w][i / HD][i % HD];
    rec[i] = o;
  }
  if (warp < R && lane == 0) rec[R * HD + warp] = m_r, rec[R * HD + R + warp] = l_r;
  __threadfence();
  __syncthreads();
  unsigned* counter = counters + (size_t)b * G + g;
  if (tid == 0) is_last = atomicAdd(counter, 1u) == (unsigned)(runs - 1);
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  // the last run to finish, a warp a head: out = sum_s o_s e^(m_s - M) / sum_s l_s
  // e^(m_s - M), the runs in order
  const float* recs = part + ((size_t)b * G + g) * MAX_RUNS * REC;
  if (warp < R) {
    const int r = warp;
    float m[MAX_RUNS / 32], l[MAX_RUNS / 32], M = -CUDART_INF_F;
#pragma unroll
    for (int k = 0; k < MAX_RUNS / 32; ++k) {
      const int sp = lane + 32 * k;
      m[k] = sp < runs ? __ldcg(recs + (size_t)sp * REC + R * HD + r) : -CUDART_INF_F;
      l[k] = sp < runs ? __ldcg(recs + (size_t)sp * REC + R * HD + R + r) : 0.f;
      M = fmaxf(M, m[k]);
    }
    M = warp_max(M);
    float L = 0.f;
#pragma unroll
    for (int k = 0; k < MAX_RUNS / 32; ++k) {
      m[k] = lane + 32 * k < runs ? expf(m[k] - M) : 0.f;
      L += l[k] * m[k];
    }
    L = warp_sum(L);
#pragma unroll
    for (int k = 0; k < MAX_RUNS / 32; ++k)
      if (lane + 32 * k < runs) ws[lane + 32 * k][r] = m[k] / L;
    __syncwarp();
    float2 o = make_float2(0.f, 0.f);
    for (int sp0 = 0; sp0 < runs; sp0 += 8) {
      float2 v[8];
#pragma unroll
      for (int u = 0; u < 8; ++u)
        v[u] = sp0 + u < runs
                   ? __ldcg(reinterpret_cast<const float2*>(recs + (size_t)(sp0 + u) * REC + r * HD) + lane)
                   : make_float2(0.f, 0.f);
#pragma unroll
      for (int u = 0; u < 8; ++u)
        if (sp0 + u < runs) {
          const float w = ws[sp0 + u][r];
          o.x = fmaf(v[u].x, w, o.x);
          o.y = fmaf(v[u].y, w, o.y);
        }
    }
    T* dst = out + (size_t)b * H * HD + (size_t)(g * R + r) * HD + 2 * lane;
    dst[0] = from_f<T>(o.x);
    dst[1] = from_f<T>(o.y);
  }
  if (tid == 0) *counter = 0u;
}

template <typename... P, typename... A>
int launch(void (*kernel)(P...), dim3 grid, dim3 block, size_t smem, void* stream, A... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = block;
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// the registers a lane keeps for a row of K elements: 3, 6, 9 or 18 chunks
inline int chunks_per_lane(int K, int elem) {
  const int need = (K * elem / 16 + 31) / 32;
  return need <= 3 ? 3 : need <= 6 ? 6 : need <= 9 ? 9 : need <= 18 ? 18 : 0;
}

template <typename T, int NR, class Epi>
int gemv(const void* x, const void* norm_w, const void* w0, const void* w1, int row_step, int B,
         int K, int N, float eps, Epi epi, void* stream) {
  if (K % 8 != 0 || (size_t)BG * K * sizeof(T) > 48 * 1024) return ERR_SHAPE;
  if (norm_w != nullptr && K * (int)sizeof(T) > Rows<T>::SC * NT * 16) return ERR_SHAPE;
  const int warps = (N + row_step - 1) / row_step;
  const dim3 grid((warps + WARPS - 1) / WARPS);
  const size_t smem = (size_t)BG * K * sizeof(T);
  const T *xp = (const T*)x, *nw = (const T*)norm_w, *a = (const T*)w0, *c = (const T*)w1;
  switch (chunks_per_lane(K, (int)sizeof(T))) {
    case 3: return launch(gemv_kernel<T, NR, 3, Epi>, grid, NT, smem, stream, xp, nw, a, c, row_step, B, K, N, eps, epi);
    case 6: return launch(gemv_kernel<T, NR, 6, Epi>, grid, NT, smem, stream, xp, nw, a, c, row_step, B, K, N, eps, epi);
    case 9: return launch(gemv_kernel<T, NR, 9, Epi>, grid, NT, smem, stream, xp, nw, a, c, row_step, B, K, N, eps, epi);
    case 18:
      if constexpr (NR == 1)
        return launch(gemv_kernel<T, 1, 18, Epi>, grid, NT, smem, stream, xp, nw, a, c, row_step, B, K, N, eps, epi);
      return ERR_SHAPE;
    default: return ERR_SHAPE;
  }
}

}  // namespace

// Each entry point launches one kernel on `stream` and returns cudaGetLastError()
// after it (ERR_SHAPE for a shape it does not take). bf16: the tensors are bf16,
// else f32.

// RMSNorm(x) @ wqkv^T, RoPE, q and the cache slot. x (B, D); wqkv ((H + 2G) HD, D);
// rope (S, HD / 2, 2) f32; input_pos (B,) int64 at stride pos_stride; kv_pos () int64;
// q (B, H, HD); kc, vc (B, G, S, HD).
extern "C" int ar_attn_in(int bf16_, const void* x, const void* norm_w, const void* wqkv,
                          const float* rope, const int64_t* input_pos, int pos_stride,
                          const int64_t* kv_pos, void* q, void* kc, void* vc, int B, int D, int H,
                          int G, int S, float eps, void* stream) {
  const int N = (H + 2 * G) * HD;
  if (bf16_) {
    QkvEpi<bf16> e{(bf16*)q, (bf16*)kc, (bf16*)vc, rope, input_pos, kv_pos, pos_stride, H, G, S};
    return gemv<bf16, 2>(x, norm_w, wqkv, (const bf16*)wqkv + D, 2, B, D, N, eps, e, stream);
  }
  QkvEpi<float> e{(float*)q, (float*)kc, (float*)vc, rope, input_pos, kv_pos, pos_stride, H, G, S};
  return gemv<float, 2>(x, norm_w, wqkv, (const float*)wqkv + D, 2, B, D, N, eps, e, stream);
}

// Attention of q (B, H, HD) over the valid slots of kc, vc (B, G, S, HD); min_key
// (B,) int64 at stride mk_stride, or null (from slot 0). out (B, H HD); part (B, G,
// MAX_RUNS, REC) f32 scratch; counters (B, G) uint32, zero (and left zero).
extern "C" int ar_attention(int bf16_, const void* q, const void* kc, const void* vc,
                            const int64_t* kv_pos, const int64_t* min_key, int mk_stride,
                            float* part, unsigned* counters, void* out, int B, int H, int G, int S,
                            void* stream) {
  const int runs = (S + TK - 1) / TK;
  if (G < 1 || H != G * R || runs > MAX_RUNS) return ERR_SHAPE;
  const dim3 grid(runs, G, B);
  if (bf16_)
    return launch(attention_kernel<bf16>, grid, ATT_NT, 0, stream, (const bf16*)q, (const bf16*)kc,
                  (const bf16*)vc, kv_pos, min_key, mk_stride, part, counters, (bf16*)out, G, S);
  return launch(attention_kernel<float>, grid, ATT_NT, 0, stream, (const float*)q,
                (const float*)kc, (const float*)vc, kv_pos, min_key, mk_stride, part, counters,
                (float*)out, G, S);
}

// x_out = x_in + a @ w^T. a (B, K); w (D, K); x_in, x_out (B, D), may be one tensor.
extern "C" int ar_residual(int bf16_, const void* a, const void* w, const void* x_in, void* x_out,
                           int B, int K, int D, void* stream) {
  if (bf16_)
    return gemv<bf16, 1>(a, nullptr, w, nullptr, 1, B, K, D, 0.f,
                         ResidualEpi<bf16>{(const bf16*)x_in, (bf16*)x_out, D}, stream);
  return gemv<float, 1>(a, nullptr, w, nullptr, 1, B, K, D, 0.f,
                        ResidualEpi<float>{(const float*)x_in, (float*)x_out, D}, stream);
}

// hidden = silu(h @ w1^T) * (h @ w3^T), h = RMSNorm(x). x (B, D); w1, w3 (I, D);
// hidden (B, I).
extern "C" int ar_ffn_in(int bf16_, const void* x, const void* norm_w, const void* w1,
                         const void* w3, void* hidden, int B, int D, int I, float eps,
                         void* stream) {
  if (bf16_)
    return gemv<bf16, 2>(x, norm_w, w1, w3, 1, B, D, I, eps, SwigluEpi<bf16>{(bf16*)hidden, I},
                         stream);
  return gemv<float, 2>(x, norm_w, w1, w3, 1, B, D, I, eps, SwigluEpi<float>{(float*)hidden, I},
                        stream);
}

// logits = RMSNorm(x) @ w^T in f32. x (B, D); w (V, D); logits (B, V) f32.
extern "C" int ar_head(int bf16_, const void* x, const void* norm_w, const void* w, float* logits,
                       int B, int D, int V, float eps, void* stream) {
  if (bf16_)
    return gemv<bf16, 1>(x, norm_w, w, nullptr, 1, B, D, V, eps, LogitsEpi{logits, V}, stream);
  return gemv<float, 1>(x, norm_w, w, nullptr, 1, B, D, V, eps, LogitsEpi{logits, V}, stream);
}
