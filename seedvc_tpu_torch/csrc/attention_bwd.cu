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
// key passes no gradient to q or k). A batch row with lens <= 0 has every key
// masked: its probabilities are uniform over all T keys, so dV gets the mean
// of dO there while dQ and dK get nothing. No gradient goes to cos, sin or lens.
//
// What bounds it on an H100: operations. The least work is five T x T x d
// products a (batch, head) (S, dP, dQ, dK, dV: 10*B*H*T^2*d operations)
// against about 11*B*H*T*d elements moved (q, k, v, o, dO in; dq, dk, dv out).
//
// Design: simple and correct, the flash pattern with fp32 scalar FMAs (as the
// forward's f32 kernel); wgmma and TMA are later work. Nothing of size (T, T)
// touches device memory. Four kernels run in order on the caller's stream:
// 1. bwd_prep_kernel: one warp a row, a lane a RoPE pair. q and k are roped
//    (K1) with each product and the sum rounded on their own, as the twin's
//    tensor ops round, then rounded to the input type; q is scaled by 2^-3
//    (the bf16 forward's pre-pass scale; a power of two, so scaling q or the
//    logits gives the same bits). q, k, v and dO go to fp32 scratch, and
//    D = rowsum(dO * o) to a row vector, summed as one FMA chain in the order
//    the other kernels sum dP = dO.v (so D = dP exactly where o is one v).
// 2. bwd_dq_kernel: one block a (batch*head, 64-query tile), 256 threads each
//    owning a 4x4 patch. Pass 1 over the key tiles that hold a valid key
//    recomputes the row statistics (running max m, sum l); pass 2 recomputes
//    P = exp(S - m) / l, dP = dO.V^T, dS = P (dP - D) in shared memory, and
//    accumulates dQ = dS.K * 2^-3. m and l go to scratch for kernel 3.
// 3. bwd_dkdv_kernel: one block a (batch*head, 64-key tile); walks every
//    query tile, recomputes P^T and dS^T for its keys and accumulates
//    dV = P^T.dO and dK = dS^T.(q * 2^-3). A key tile past the valid keys
//    writes zeros without reading anything.
// 4. bwd_finish_kernel: the gradients leave fp32: dq and dk are rounded to the
//    input type (where the twin's autograd rounds them), then K1 applies
//    RoPE's transpose, dx = g*cos + pair_swap(g*sin), and rounds again; dv is
//    rounded.
// Host side: one C entry point for K1 and K3, f32 and bf16. The wrapper
// allocates the fp32 scratch (7 B*H*T*64 + 3 B*H*T floats).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int D = 64;
constexpr int BT = 64;     // rows of a query or key tile
constexpr int NT = 256;    // threads of kernels 2 and 3: a 16 x 16 grid of 4x4 patches
constexpr int LD = D + 1;  // padded row stride of the shared tiles
constexpr float NEG = -1e30f;
constexpr float SCALE = 0.125f;  // 1/sqrt(64)
constexpr int TILE = BT * LD;
constexpr size_t DQ_SMEM = sizeof(float) * 5 * TILE;
constexpr size_t DKDV_SMEM = sizeof(float) * 6 * TILE;

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
                float* __restrict__ dos, float* __restrict__ dsum, int T_len, long long rows) {
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
    qs[e] = q0 * SCALE;
    qs[e + 1] = q1 * SCALE;
    ks[e] = k0;
    ks[e + 1] = k1;
    vs[e] = to_f(v[e]);
    vs[e + 1] = to_f(v[e + 1]);
    dos[e] = to_f(dout[e]);
    dos[e + 1] = to_f(dout[e + 1]);
    if (lane == 0) {
      // D as one FMA chain over the features in order, the order in which the
      // dQ and dK/dV kernels sum dP = dO.v: where o equals one v (a row with
      // one valid key), D equals that dP bit for bit and dS is exactly 0
      const size_t row = (size_t)r * D;
      float d = 0.f;
      for (int f = 0; f < D; ++f) d = fmaf(to_f(dout[row + f]), to_f(o[row + f]), d);
      dsum[r] = d;
    }
  }
}

// Rows [r0, r0 + BT) of a (T, 64) fp32 slab into a padded shared tile; rows
// >= T read as zeros.
__device__ __forceinline__ void load_tile(float* dst, const float* __restrict__ src, int r0,
                                          int T_len, int tid) {
  for (int idx = tid; idx < BT * D; idx += NT) {
    const int r = idx / D, dd = idx % D, t = r0 + r;
    dst[r * LD + dd] = t < T_len ? src[(size_t)t * D + dd] : 0.f;
  }
}

// s[i][j] = A[ra + 16 i] . B[rb + 16 j] over the 64 features of two shared tiles.
__device__ __forceinline__ void tile_dot(const float* A, const float* B, int ra, int rb,
                                         float (&s)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
  for (int dd = 0; dd < D; ++dd) {
    float a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = A[(ra + 16 * i) * LD + dd];
#pragma unroll
    for (int j = 0; j < 4; ++j) b[j] = B[(rb + 16 * j) * LD + dd];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], b[j], s[i][j]);
  }
}

__device__ __forceinline__ int valid_keys(const int* lens, int b, int T_len) {
  const int n = lens ? lens[b] : T_len;
  return n > T_len ? T_len : n;
}

__global__ void __launch_bounds__(NT)
bwd_dq_kernel(const float* __restrict__ qs, const float* __restrict__ ks,
              const float* __restrict__ vs, const float* __restrict__ dos,
              const float* __restrict__ dsum, const int* __restrict__ lens,
              float* __restrict__ dq, float* __restrict__ stat_m, float* __restrict__ stat_l,
              int H, int T_len) {
  extern __shared__ float smem[];
  float* Qs = smem;         // q * 2^-3 of this query tile
  float* dOs = Qs + TILE;   // dO of this query tile
  float* Ks = dOs + TILE;   // the key tile
  float* Vs = Ks + TILE;    // the value tile
  float* Ss = Vs + TILE;    // dS of this (query, key) tile pair

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * BT;
  const size_t slab = (size_t)bh * T_len * D;
  const size_t row0 = (size_t)bh * T_len;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int n_valid = valid_keys(lens, bh / H, T_len);

  float m[4], l[4], dd_[4], acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = q0 + ty + 16 * i;
    m[i] = NEG;
    l[i] = 0.f;
    dd_[i] = t < T_len ? dsum[row0 + t] : 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  }

  // n_valid <= 0: every key masked, no gradient reaches q (acc stays 0)
  const int n_tiles = n_valid > 0 ? (n_valid + BT - 1) / BT : 0;
  if (n_tiles > 0) {
    load_tile(Qs, qs + slab, q0, T_len, tid);
    load_tile(dOs, dos + slab, q0, T_len, tid);
  }
  // pass 1: row max and sum over the valid keys
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * BT;
    __syncthreads();
    load_tile(Ks, ks + slab, k0, T_len, tid);
    __syncthreads();
    float s[4][4];
    tile_dot(Qs, Ks, ty, tx, s);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float tmax = NEG;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (k0 + tx + 16 * j < n_valid) tmax = fmaxf(tmax, s[i][j]);
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, off));
      const float m_new = fmaxf(m[i], tmax);
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (k0 + tx + 16 * j < n_valid) psum += expf(s[i][j] - m_new);
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) psum += __shfl_xor_sync(0xffffffffu, psum, off);
      l[i] = l[i] * expf(m[i] - m_new) + psum;
      m[i] = m_new;
    }
  }
  // pass 2: dS = P (dP - D), dQ += dS . K
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * BT;
    __syncthreads();
    load_tile(Ks, ks + slab, k0, T_len, tid);
    load_tile(Vs, vs + slab, k0, T_len, tid);
    __syncthreads();
    float s[4][4], dp[4][4];
    tile_dot(Qs, Ks, ty, tx, s);
    tile_dot(dOs, Vs, ty, tx, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = k0 + tx + 16 * j < n_valid ? expf(s[i][j] - m[i]) / l[i] : 0.f;
        Ss[(ty + 16 * i) * LD + tx + 16 * j] = p * (dp[i][j] - dd_[i]);
      }
    __syncthreads();
#pragma unroll 8
    for (int c = 0; c < BT; ++c) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = Ss[(ty + 16 * i) * LD + c];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Ks[c * LD + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = q0 + ty + 16 * i;
    if (t >= T_len) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) dq[slab + (size_t)t * D + tx + 16 * j] = acc[i][j] * SCALE;
    if (tx == 0) {
      stat_m[row0 + t] = m[i];
      stat_l[row0 + t] = l[i];
    }
  }
}

__global__ void __launch_bounds__(NT)
bwd_dkdv_kernel(const float* __restrict__ qs, const float* __restrict__ ks,
                const float* __restrict__ vs, const float* __restrict__ dos,
                const float* __restrict__ dsum, const float* __restrict__ stat_m,
                const float* __restrict__ stat_l, const int* __restrict__ lens,
                float* __restrict__ dk, float* __restrict__ dv, int H, int T_len) {
  extern __shared__ float smem[];
  float* Ks = smem;         // the key tile
  float* Vs = Ks + TILE;    // the value tile
  float* Qs = Vs + TILE;    // q * 2^-3 of the query tile
  float* dOs = Qs + TILE;   // dO of the query tile
  float* Ps = dOs + TILE;   // P^T: [key][query]
  float* Ss = Ps + TILE;    // dS^T: [key][query]

  const int bh = blockIdx.y;
  const int k0 = blockIdx.x * BT;
  const size_t slab = (size_t)bh * T_len * D;
  const size_t row0 = (size_t)bh * T_len;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int n_valid = valid_keys(lens, bh / H, T_len);
  const bool none = n_valid <= 0;  // every key masked: P uniform over all T keys
  const float uniform = 1.f / (float)T_len;

  float acc_k[4][4], acc_v[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc_k[i][j] = acc_v[i][j] = 0.f;

  if (none || k0 < n_valid) {
    if (!none) {
      load_tile(Ks, ks + slab, k0, T_len, tid);
      load_tile(Vs, vs + slab, k0, T_len, tid);
    }
    const int q_tiles = (T_len + BT - 1) / BT;
    for (int qt = 0; qt < q_tiles; ++qt) {
      const int r0 = qt * BT;
      __syncthreads();
      load_tile(Qs, qs + slab, r0, T_len, tid);
      load_tile(dOs, dos + slab, r0, T_len, tid);
      __syncthreads();
      if (none) {
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const bool in = k0 + ty + 16 * i < T_len && r0 + tx + 16 * j < T_len;
            Ps[(ty + 16 * i) * LD + tx + 16 * j] = in ? uniform : 0.f;
            Ss[(ty + 16 * i) * LD + tx + 16 * j] = 0.f;
          }
      } else {
        float st[4][4], dpt[4][4];
        tile_dot(Ks, Qs, ty, tx, st);
        tile_dot(Vs, dOs, ty, tx, dpt);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int r = r0 + tx + 16 * j;
          const bool row_in = r < T_len;
          const float mr = row_in ? stat_m[row0 + r] : 0.f;
          const float lr = row_in ? stat_l[row0 + r] : 1.f;
          const float dr = row_in ? dsum[row0 + r] : 0.f;
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float p =
                row_in && k0 + ty + 16 * i < n_valid ? expf(st[i][j] - mr) / lr : 0.f;
            Ps[(ty + 16 * i) * LD + tx + 16 * j] = p;
            Ss[(ty + 16 * i) * LD + tx + 16 * j] = p * (dpt[i][j] - dr);
          }
        }
      }
      __syncthreads();
#pragma unroll 4
      for (int c = 0; c < BT; ++c) {
        float pa[4], sa[4], gb[4], qb[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          pa[i] = Ps[(ty + 16 * i) * LD + c];
          sa[i] = Ss[(ty + 16 * i) * LD + c];
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          gb[j] = dOs[c * LD + tx + 16 * j];
          qb[j] = Qs[c * LD + tx + 16 * j];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            acc_v[i][j] = fmaf(pa[i], gb[j], acc_v[i][j]);
            acc_k[i][j] = fmaf(sa[i], qb[j], acc_k[i][j]);
          }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = k0 + ty + 16 * i;
    if (t >= T_len) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      dk[slab + (size_t)t * D + tx + 16 * j] = acc_k[i][j];
      dv[slab + (size_t)t * D + tx + 16 * j] = acc_v[i][j];
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
    float q0 = round_to<T>(dqf[e]), q1 = round_to<T>(dqf[e + 1]);
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
bool dq_smem_set[MAX_DEVICES];
bool dkdv_smem_set[MAX_DEVICES];

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
           const int* lens, const void* o, const void* dout, void* dq, void* dk, void* dv,
           float* scratch, int B, int H, int T_len, cudaStream_t stream) {
  int err = set_smem_once(bwd_dq_kernel, (int)DQ_SMEM, dq_smem_set);
  if (!err) err = set_smem_once(bwd_dkdv_kernel, (int)DKDV_SMEM, dkdv_smem_set);
  if (err) return err;
  const long long rows = (long long)B * H * T_len;
  const size_t n = (size_t)rows * D;
  float* qs = scratch;
  float* ks = qs + n;
  float* vs = ks + n;
  float* dos = vs + n;
  float* dqf = dos + n;
  float* dkf = dqf + n;
  float* dvf = dkf + n;
  float* dsum = dvf + n;
  float* stat_m = dsum + rows;
  float* stat_l = stat_m + rows;

  bwd_prep_kernel<T, ROPE><<<grid_for(rows * 32), 256, 0, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)o, (const T*)dout, cosb, sinb, qs, ks,
      vs, dos, dsum, T_len, rows);
  err = (int)cudaGetLastError();
  if (err) return err;
  const dim3 grid((T_len + BT - 1) / BT, B * H);
  bwd_dq_kernel<<<grid, NT, DQ_SMEM, stream>>>(qs, ks, vs, dos, dsum, lens, dqf, stat_m, stat_l,
                                               H, T_len);
  err = (int)cudaGetLastError();
  if (err) return err;
  bwd_dkdv_kernel<<<grid, NT, DKDV_SMEM, stream>>>(qs, ks, vs, dos, dsum, stat_m, stat_l, lens,
                                                   dkf, dvf, H, T_len);
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
// upstream gradient, both in the inputs' type; lens is (B,) int32 or null.
// scratch holds 7*B*H*T*64 + 3*B*H*T floats.
extern "C" int dit_attention_bwd(const void* q, const void* k, const void* v, const float* cosb,
                                 const float* sinb, const int* lens, const void* o,
                                 const void* dout, void* dq, void* dk, void* dv, float* scratch,
                                 int B, int H, int T_len, int is_bf16, int rope, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  if (is_bf16) {
    return rope ? launch<__nv_bfloat16, true>(q, k, v, cosb, sinb, lens, o, dout, dq, dk, dv,
                                              scratch, B, H, T_len, s)
                : launch<__nv_bfloat16, false>(q, k, v, cosb, sinb, lens, o, dout, dq, dk, dv,
                                               scratch, B, H, T_len, s);
  }
  return rope ? launch<float, true>(q, k, v, cosb, sinb, lens, o, dout, dq, dk, dv, scratch, B,
                                    H, T_len, s)
              : launch<float, false>(q, k, v, cosb, sinb, lens, o, dout, dq, dk, dv, scratch, B,
                                     H, T_len, s);
}
