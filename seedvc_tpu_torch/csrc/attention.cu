// DiT attention for Hopper (sm_90a), with or without in-kernel
// interleaved-pair RoPE (a compile-time ROPE flag on both kernels).
//
// ROPE on replaces the TPU kernel seedvc_tpu/ops/pallas/attention.py::
// dit_attention_fused (body _attn_kernel_v2): q and k are roped in fp32 from the
// (T, d) cos / signed-sin caches, q is scaled by 1/sqrt(d) and rounded to the
// input type. ROPE off replaces seedvc_tpu/ops/pallas/attention.py::
// dit_attention (body _attn_kernel): q/k arrive roped, the Q and K tiles are
// plain 16-byte copies, no cos/sin pointer is read, and q is scaled by
// 1/sqrt(d) = 2^-3 as it is copied. The TPU kernel scales the fp32 logits
// instead; at head_dim 64 the scale is a power of two, so folding it into q
// is exact and the two agree bit for bit. In both modes logits are fp32, keys
// >= lens[b] get a -1e30 bias, the softmax is fp32 with its normalisation
// deferred to the output, and P is rounded to the input type before the P.V
// product, which sums in fp32. The rounding order is therefore not the TPU
// K3's: _attn_kernel divides P by the full row sum and then rounds it to bf16,
// while this kernel rounds the unnormalised exp(s - m_running) and divides the
// fp32 output at the end (the TPU K1 defers it too, after a global max).
//
// Design. The TPU kernels keep one head's whole K and V resident in VMEM; at
// T = 2560, d = 64 that is 320 KB of bf16 for K alone, more than the 227 KB of
// shared memory a Hopper block may use. So this kernel streams K/V: one block
// per (batch*head, 64-row query tile) loops over 64-key tiles with an online
// softmax (running max and sum in fp32, started at -1e30 so exp(m_old - m_new)
// never sees inf - inf). With ROPE on, each key tile is roped as it enters
// shared memory.
//
// Bound: 4*B*H*T^2*d operations (17.2 GFLOP at (2, 8, 2048, 64)) against 8.4 MB
// of q/k/v/o, so the work is compute-bound and belongs on the tensor cores.
// The bf16 kernel (the main path's) runs both products on the tensor cores
// with mma.sync m16n8k16 (bf16 in, fp32 accumulate): 4 warps per block, each
// owning 16 query rows; S, P and the running output stay in registers (the S
// accumulator re-packs into P's A fragment), so the online-softmax rescale is
// a per-register multiply. K is loaded (and roped) and V transposed into
// shared memory once per key tile for all four warps. The fp32 kernel (used by
// tests and parity runs) keeps scalar fp32 FMAs: 256 threads, each owning a
// 4x4 patch of the 64x64 logit and output tiles (rows ty + 16*i, columns
// tx + 16*j), so shared-memory reads are broadcasts along one index and
// conflict-free along the other. wgmma/TMA pipelining is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int D = 64;
constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int NT = 256;
constexpr int LD = D + 1;  // padded row stride of the shared tiles
constexpr float NEG = -1e30f;
constexpr size_t SMEM_BYTES = sizeof(float) * (BQ * LD + BK * LD + BK * D + BQ * LD);

template <bool ROPE>
__global__ void __launch_bounds__(NT)
attn_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ cosb,
                const float* __restrict__ sinb, const int* __restrict__ lens,
                float* __restrict__ out, int H, int T_len, float scale) {
  extern __shared__ float smem[];
  float* Qs = smem;            // [BQ][LD] (roped,) scaled q
  float* Ks = Qs + BQ * LD;    // [BK][LD] (roped) k
  float* Vs = Ks + BK * LD;    // [BK][D]
  float* Ps = Vs + BK * D;     // [BQ][LD] probabilities of this key tile

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int q0 = blockIdx.x * BQ;
  const size_t base = (size_t)bh * T_len * D;
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int n_valid = lens ? lens[b] : T_len;

  for (int idx = tid; idx < BQ * D; idx += NT) {
    const int r = idx / D, dd = idx % D, t = q0 + r;
    float val = 0.f;
    if (t < T_len) {
      const float* row = q + base + (size_t)t * D;
      if constexpr (ROPE)
        val = (row[dd] * cosb[t * D + dd] + row[dd ^ 1] * sinb[t * D + dd]) * scale;
      else
        val = row[dd] * scale;
    }
    Qs[r * LD + dd] = val;
  }

  float m_i[4], l_i[4], o[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_i[i] = NEG;
    l_i[i] = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) o[i][j] = 0.f;
  }

  const int n_tiles = (T_len + BK - 1) / BK;
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the previous tile's Ks/Vs/Ps are no longer read
    for (int idx = tid; idx < BK * D; idx += NT) {
      const int c = idx / D, dd = idx % D, t = k0 + c;
      float kval = 0.f, vval = 0.f;
      if (t < T_len) {
        const float* row = k + base + (size_t)t * D;
        if constexpr (ROPE)
          kval = row[dd] * cosb[t * D + dd] + row[dd ^ 1] * sinb[t * D + dd];
        else
          kval = row[dd];
        vval = v[base + (size_t)t * D + dd];
      }
      Ks[c * LD + dd] = kval;
      Vs[c * D + dd] = vval;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int dd = 0; dd < D; ++dd) {
      float qa[4], kb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qa[i] = Qs[(ty + 16 * i) * LD + dd];
#pragma unroll
      for (int j = 0; j < 4; ++j) kb[j] = Ks[(tx + 16 * j) * LD + dd];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qa[i], kb[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float tmax = NEG;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = k0 + tx + 16 * j;
        if (c >= n_valid) s[i][j] += NEG;  // key-padding bias, as the TPU kernel adds it
        if (c < T_len) tmax = fmaxf(tmax, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, off));
      const float m_new = fmaxf(m_i[i], tmax);
      const float alpha = expf(m_i[i] - m_new);
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = k0 + tx + 16 * j;
        const float p = c < T_len ? expf(s[i][j] - m_new) : 0.f;
        Ps[(ty + 16 * i) * LD + tx + 16 * j] = p;
        psum += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        psum += __shfl_xor_sync(0xffffffffu, psum, off);
      l_i[i] = l_i[i] * alpha + psum;
      m_i[i] = m_new;
#pragma unroll
      for (int j = 0; j < 4; ++j) o[i][j] *= alpha;
    }
    __syncthreads();

#pragma unroll 8
    for (int c = 0; c < BK; ++c) {
      float pa[4], vb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pa[i] = Ps[(ty + 16 * i) * LD + c];
#pragma unroll
      for (int j = 0; j < 4; ++j) vb[j] = Vs[c * D + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) o[i][j] = fmaf(pa[i], vb[j], o[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = q0 + ty + 16 * i;
    if (t >= T_len) continue;
    const float inv = 1.f / l_i[i];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      out[base + (size_t)t * D + tx + 16 * j] = o[i][j] * inv;
  }
}

// ---------------------------------------------------------------------------
// bf16 path on tensor cores: mma.sync m16n8k16 (bf16 in, fp32 accumulate).
//
// Fragment layouts of m16n8k16 (g = lane / 4, c = lane % 4):
//   A (16x16, row-major): a0 = (g, 2c..2c+1), a1 = (g+8, 2c..), a2 = (g, 2c+8..),
//                         a3 = (g+8, 2c+8..)
//   B (16x8, "col"):      b0 = (k 2c..2c+1, n g), b1 = (k 2c+8.., n g)
//   C (16x8, fp32):       c0,c1 = (g, 2c..2c+1), c2,c3 = (g+8, 2c..2c+1)
// so an S accumulator tile re-packs in registers into the A fragment of P.V,
// and a row's values sit on the 4 lanes of one quad.
constexpr int MNT = 128;    // 4 warps x 16 query rows
constexpr int LDK = D + 8;  // bf16 row stride (36 words): conflict-free fragment loads

using bf16 = __nv_bfloat16;

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Rope 8 consecutive features d0..d0+7 of row t in fp32 (x*cos + pair_swap(x)*sin),
// scale, round to bf16 and store 16 bytes; zeros for rows past the end.
__device__ __forceinline__ void rope8(const bf16* row, const float* cosb, const float* sinb,
                                      int t, int d0, float scale, bool valid, bf16* dst) {
  uint4 res = make_uint4(0, 0, 0, 0);
  if (valid) {
    const uint4 raw = *reinterpret_cast<const uint4*>(row + d0);
    const bf16* x = reinterpret_cast<const bf16*>(&raw);
    const float4* c4 = reinterpret_cast<const float4*>(cosb + t * D + d0);
    const float4* s4 = reinterpret_cast<const float4*>(sinb + t * D + d0);
    const float4 ca = c4[0], cb = c4[1], sa = s4[0], sb = s4[1];
    const float cs[8] = {ca.x, ca.y, ca.z, ca.w, cb.x, cb.y, cb.z, cb.w};
    const float sn[8] = {sa.x, sa.y, sa.z, sa.w, sb.x, sb.y, sb.z, sb.w};
    uint32_t* o = reinterpret_cast<uint32_t*>(&res);
#pragma unroll
    for (int i = 0; i < 8; i += 2) {
      const float x0 = __bfloat162float(x[i]), x1 = __bfloat162float(x[i + 1]);
      o[i / 2] = pack_bf16((x0 * cs[i] + x1 * sn[i]) * scale,
                           (x1 * cs[i + 1] + x0 * sn[i + 1]) * scale);
    }
  }
  *reinterpret_cast<uint4*>(dst) = res;
}

// Features d0..d0+7 of row t into shared memory: roped (ROPE) or a plain
// 16-byte copy; times scale (exact for a power of two); zeros past the end.
template <bool ROPE>
__device__ __forceinline__ void load8(const bf16* row, const float* cosb, const float* sinb,
                                      int t, int d0, float scale, bool valid, bf16* dst) {
  if constexpr (ROPE) {
    rope8(row, cosb, sinb, t, d0, scale, valid, dst);
  } else {
    uint4 res = make_uint4(0, 0, 0, 0);
    if (valid) {
      res = *reinterpret_cast<const uint4*>(row + d0);
      if (scale != 1.f) {
        const bf16* x = reinterpret_cast<const bf16*>(&res);
        uint32_t o[4];
#pragma unroll
        for (int i = 0; i < 8; i += 2)
          o[i / 2] = pack_bf16(__bfloat162float(x[i]) * scale, __bfloat162float(x[i + 1]) * scale);
        res = make_uint4(o[0], o[1], o[2], o[3]);
      }
    }
    *reinterpret_cast<uint4*>(dst) = res;
  }
}

template <bool ROPE>
__global__ void __launch_bounds__(MNT)
attn_fwd_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const float* __restrict__ cosb,
                    const float* __restrict__ sinb, const int* __restrict__ lens,
                    bf16* __restrict__ out, int H, int T_len, float scale) {
  __shared__ __align__(16) bf16 Qs[BQ * LDK];  // (roped,) scaled q
  __shared__ __align__(16) bf16 Ks[BK * LDK];  // (roped) k, [key][d]
  __shared__ __align__(16) bf16 Vt[D * LDK];   // v transposed, [d][key]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, c = lane & 3;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int q0 = blockIdx.x * BQ;
  const size_t base = (size_t)bh * T_len * D;
  const int n_valid = lens ? lens[b] : T_len;

  for (int idx = tid; idx < BQ * 8; idx += MNT) {
    const int r = idx >> 3, d0 = (idx & 7) * 8, t = q0 + r;
    load8<ROPE>(q + base + (size_t)t * D, cosb, sinb, t, d0, scale, t < T_len,
                Qs + r * LDK + d0);
  }
  __syncthreads();

  uint32_t qf[4][4];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const bf16* p = Qs + (warp * 16 + g) * LDK + kk * 16 + 2 * c;
    qf[kk][0] = ld32(p);
    qf[kk][1] = ld32(p + 8 * LDK);
    qf[kk][2] = ld32(p + 8);
    qf[kk][3] = ld32(p + 8 * LDK + 8);
  }

  float o[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m0 = NEG, m1 = NEG, l0 = 0.f, l1 = 0.f;  // rows g and g+8 of this warp

  const int n_tiles = (T_len + BK - 1) / BK;
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // every warp is done with the previous K/V tile
    for (int idx = tid; idx < BK * 8; idx += MNT) {
      const int key = idx >> 3, d0 = (idx & 7) * 8, t = k0 + key;
      load8<ROPE>(k + base + (size_t)t * D, cosb, sinb, t, d0, 1.f, t < T_len,
                  Ks + key * LDK + d0);
    }
    for (int idx = tid; idx < BK * 8; idx += MNT) {
      const int key = idx & (BK - 1), d0 = (idx / BK) * 8, t = k0 + key;
      uint4 raw = make_uint4(0, 0, 0, 0);
      if (t < T_len) raw = *reinterpret_cast<const uint4*>(v + base + (size_t)t * D + d0);
      const bf16* x = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
      for (int i = 0; i < 8; ++i) Vt[(d0 + i) * LDK + key] = x[i];
    }
    __syncthreads();

    float s[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const bf16* p = Ks + (n * 8 + g) * LDK + kk * 16 + 2 * c;
        mma_bf16(s[n], qf[kk], ld32(p), ld32(p + 8));
      }
    }

    float mx0 = NEG, mx1 = NEG;
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int key = k0 + n * 8 + 2 * c + e;
        if (key >= n_valid) {  // key-padding bias, as the TPU kernel adds it
          s[n][e] += NEG;
          s[n][2 + e] += NEG;
        }
        if (key < T_len) {
          mx0 = fmaxf(mx0, s[n][e]);
          mx1 = fmaxf(mx1, s[n][2 + e]);
        }
      }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float a0 = expf(m0 - mn0), a1 = expf(m1 - mn1);

    uint32_t pf[4][4];
    float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      float p[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + n * 8 + 2 * c + (e & 1);
        // P is rounded to bf16 before both the sum and the P.V product
        p[e] = key < T_len
                   ? __bfloat162float(__float2bfloat16_rn(expf(s[n][e] - (e < 2 ? mn0 : mn1))))
                   : 0.f;
      }
      ps0 += p[0] + p[1];
      ps1 += p[2] + p[3];
      pf[n >> 1][(n & 1) * 2] = pack_bf16(p[0], p[1]);
      pf[n >> 1][(n & 1) * 2 + 1] = pack_bf16(p[2], p[3]);
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      ps0 += __shfl_xor_sync(0xffffffffu, ps0, off);
      ps1 += __shfl_xor_sync(0xffffffffu, ps1, off);
    }
    l0 = l0 * a0 + ps0;
    l1 = l1 * a1 + ps1;
    m0 = mn0;
    m1 = mn1;

#pragma unroll
    for (int n = 0; n < 8; ++n) {
      o[n][0] *= a0;
      o[n][1] *= a0;
      o[n][2] *= a1;
      o[n][3] *= a1;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const bf16* p = Vt + (n * 8 + g) * LDK + kk * 16 + 2 * c;
        mma_bf16(o[n], pf[kk], ld32(p), ld32(p + 8));
      }
    }
  }

  const int r0 = q0 + warp * 16 + g, r1 = r0 + 8;
  const float i0 = 1.f / l0, i1 = 1.f / l1;
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    const int col = n * 8 + 2 * c;
    if (r0 < T_len)
      *reinterpret_cast<uint32_t*>(out + base + (size_t)r0 * D + col) =
          pack_bf16(o[n][0] * i0, o[n][1] * i0);
    if (r1 < T_len)
      *reinterpret_cast<uint32_t*>(out + base + (size_t)r1 * D + col) =
          pack_bf16(o[n][2] * i1, o[n][3] * i1);
  }
}

template <bool ROPE>
int launch_mma(const void* q, const void* k, const void* v, const float* cosb,
               const float* sinb, const int* lens, void* out, int B, int H, int T_len,
               void* stream) {
  dim3 grid((T_len + BQ - 1) / BQ, B * H);
  attn_fwd_mma_kernel<ROPE><<<grid, MNT, 0, (cudaStream_t)stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, cosb, sinb, lens, (bf16*)out, H, T_len,
      0.125f /* 1/sqrt(64) */);
  return (int)cudaGetLastError();
}

template <bool ROPE>
int launch_f32(const void* q, const void* k, const void* v, const float* cosb,
               const float* sinb, const int* lens, void* out, int B, int H, int T_len,
               void* stream) {
  cudaError_t err = cudaFuncSetAttribute(attn_fwd_kernel<ROPE>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((T_len + BQ - 1) / BQ, B * H);
  attn_fwd_kernel<ROPE><<<grid, NT, SMEM_BYTES, (cudaStream_t)stream>>>(
      (const float*)q, (const float*)k, (const float*)v, cosb, sinb, lens, (float*)out, H, T_len,
      0.125f /* 1/sqrt(64) */);
  return (int)cudaGetLastError();
}

}  // namespace

// K1: q/k before RoPE, roped in the kernel from the (T, 64) cos / signed-sin caches.
extern "C" int dit_attention_fused_bf16(const void* q, const void* k, const void* v,
                                        const float* cosb, const float* sinb, const int* lens,
                                        void* out, int B, int H, int T_len, void* stream) {
  return launch_mma<true>(q, k, v, cosb, sinb, lens, out, B, H, T_len, stream);
}

extern "C" int dit_attention_fused_f32(const void* q, const void* k, const void* v,
                                       const float* cosb, const float* sinb, const int* lens,
                                       void* out, int B, int H, int T_len, void* stream) {
  return launch_f32<true>(q, k, v, cosb, sinb, lens, out, B, H, T_len, stream);
}

// K3: q/k already roped; no cos/sin.
extern "C" int dit_attention_bf16(const void* q, const void* k, const void* v, const int* lens,
                                  void* out, int B, int H, int T_len, void* stream) {
  return launch_mma<false>(q, k, v, nullptr, nullptr, lens, out, B, H, T_len, stream);
}

extern "C" int dit_attention_f32(const void* q, const void* k, const void* v, const int* lens,
                                 void* out, int B, int H, int T_len, void* stream) {
  return launch_f32<false>(q, k, v, nullptr, nullptr, lens, out, B, H, T_len, stream);
}
