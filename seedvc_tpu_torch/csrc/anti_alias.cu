// Fused anti-aliased SnakeBeta activation for Hopper (sm_90a).
//
// Replaces the TPU kernels seedvc_tpu/ops/pallas/anti_alias.py::anti_alias_snake
// (pallas_call at :303, body _make_kernel_clean, C > 64) and ::_anti_alias_grouped
// (pallas_call at :242, body _make_kernel_grouped, C <= 64). Both compute one
// function: a 2x kaiser-sinc upsample (12 taps, replicate pad), SnakeBeta
// u + inv_beta * sin^2(alpha * u), and a 2x kaiser-sinc low-pass downsample, all
// in fp32. The lane packing of the grouped TPU kernel is a TPU layout trick; here
// one kernel serves every C.
//
// Polyphase form (see the TPU module's docstring): with f the 12-tap filter,
//   u0[m] = 2 sum_j f[2j]   x[clamp(m + j - 3)],  u1[m] = 2 sum_j f[2j+1] x[clamp(m + j - 2)]
//   s0 = snake(u0), s1 = snake(u1)
//   out[t] = sum_j f[2j+1] s0c[t + j - 2] + f[2j] s1c[t + j - 3]
// where the clamps of s0c/s1c are in u-index space: left of 0 both phases read
// s0[0], right of T-1 both phases read s1[T-1].
//
// What bounds it on the H100: bytes. Each element is read once and written once
// (8 bytes; 22.5 us at (1, 24, 393216) and 3.35 TB/s; a plain device copy of
// the same bytes is the practical floor, timed beside the kernel by
// chip_smoke.py). The arithmetic, 12 up-FIR and 12
// down-FIR FMAs per output and two sin^2 at 14 FP32 instructions each (98
// flops, 13.8 us at 67 TFLOP/s), now issues in the shadow of the bytes. The
// first port of this kernel was bound by issue instead, at about 200
// thread-instructions per output (SASS): two accurate sinf (a range reduction,
// a polynomial and a guarded slow path each), 25 scalar shared-memory accesses
// and two compares and two selects on every down-FIR tap for the u-space
// clamps; its wrapper added four small PyTorch kernels for exp(alpha) and
// 1/(exp(beta) + 1e-9), and its loads and stores moved 4 bytes a thread. What
// this design does about each (about 79 thread-instructions per output remain,
// 52 of them the arithmetic above; counts in PERF.md):
//  - sin^2(y) as the TPU kernel computes it, on the FMA pipe: n = round(y/pi)
//    (an FFMA and an FADD with the 1.5*2^23 rounding constant), z = y - n*pi with
//    a two-constant (Cody-Waite) pi, and a degree-7 polynomial in z^2 whose
//    coefficients fold the TPU kernel's 1/2 - cos(2z)/2 in (|err| <= 2e-7 over
//    |y| <= 300 in fp32; one constant gives 8e-6 there);
//  - each thread owns R = 4 consecutive u-positions and outputs and moves them
//    as float4: one 16-byte global load and store, three 16-byte shared loads
//    of x for both up-FIR phases, two 16-byte shared stores of s0/s1 and six
//    16-byte shared loads for the down-FIR;
//  - a tile computes the u-positions [t0 - 4, t0 + TT + 4), a halo of 4 on each
//    side, so the FIR loops need no clamp; only a row's first and last tiles
//    patch the three s positions the clamps touch, behind a branch uniform
//    across the block (the x halo is clamped where it is loaded);
//  - the wrapper makes no device call but the output's allocation: the kernel
//    takes the raw alpha/beta and a logscale flag and forms exp(alpha) and
//    1/(exp(beta) + 1e-9) once per row a block visits; the taps and the sin^2
//    constants arrive by value as a kernel parameter (constant-bank operands).
// Keeping the bytes in flight: the grid is BPS blocks an SM, each walking a
// contiguous run of (row, tile) items, with the next item's x loaded into
// registers while the current item computes. With one tile a block and no
// prefetch the same arithmetic ran far slower, and a cp.async ring two items
// deep was slower than the register prefetch (PERF.md lists what was tried).

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int NT = 256;        // threads a block
constexpr int BPS = 8;         // resident blocks an SM (32 registers a thread)
constexpr int R = 4;           // u-positions, and outputs, a thread: one float4
constexpr int NU = NT * R;     // u-positions a tile: [t0 - 4, t0 + TT + 4)
constexpr int TT = NU - 8;     // outputs a tile
constexpr int NX = NU + 8;     // x samples a tile: [t0 - 8, t0 + NU)
constexpr int NX2 = (NX - 4 * NT) / 4;  // threads that load a second float4 of x
constexpr float ROUND = 12582912.f;  // 1.5 * 2^23: v + ROUND - ROUND rounds v to an integer

// Filled by the wrapper (ops/anti_alias.py::kernel_constants), in this order.
struct Consts {
  float up[12];    // 2 f[k]: the up-FIR taps with the ratio folded in
  float down[12];  // f[k]: the down-FIR taps
  float sin2[8];   // sin^2(z) = sum_k sin2[k] (z^2)^k for |z| <= pi/2
  float inv_pi, pi_hi, pi_lo;
};
static_assert(sizeof(Consts) == 35 * sizeof(float), "Consts must match the wrapper");

// u + ib * sin^2(a * u), |a * u| < 2^22
__device__ __forceinline__ float snake(float u, float a, float ib, const Consts& k) {
  const float y = u * a;
  const float n = fmaf(y, k.inv_pi, ROUND) - ROUND;
  float z = fmaf(-n, k.pi_hi, y);
  z = fmaf(-n, k.pi_lo, z);
  const float t = z * z;
  float p = k.sin2[7];
#pragma unroll
  for (int i = 6; i >= 0; --i) p = fmaf(p, t, k.sin2[i]);
  return fmaf(ib, p, u);
}

__device__ __forceinline__ float4 load4(const float* __restrict__ xr, int p, int T, bool vec) {
  if (vec && p >= 0 && p + 4 <= T) return *reinterpret_cast<const float4*>(xr + p);
  return make_float4(xr[min(max(p, 0), T - 1)], xr[min(max(p + 1, 0), T - 1)],
                     xr[min(max(p + 2, 0), T - 1)], xr[min(max(p + 3, 0), T - 1)]);
}

// One block walks a contiguous run [begin, end) of the B*C*n_tiles items
// (row, tile), row-major, so a block's items are consecutive tiles of a row.
// The x window of the next item is loaded into registers before the current
// item computes, which keeps the loads in flight behind the arithmetic.
__global__ void __launch_bounds__(NT, BPS)
anti_alias_snake_kernel(const float* __restrict__ x, const float* __restrict__ alpha,
                        const float* __restrict__ beta, float* __restrict__ out, int C, int T,
                        int n_tiles, int n_work, int logscale, const Consts k) {
  __shared__ __align__(16) float xs[NX];   // xs[i] = x[clamp(t0 - 8 + i)]
  __shared__ __align__(16) float s0s[NU];  // s?s[l] = s?[m], m = t0 - 4 + l
  __shared__ __align__(16) float s1s[NU];

  const int tid = threadIdx.x;
  const bool vec = (T & 3) == 0 &&
                   ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(out)) & 15) == 0;
  const int begin = (int)((long long)blockIdx.x * n_work / gridDim.x);
  const int end = (int)((long long)(blockIdx.x + 1) * n_work / gridDim.x);
  int rw = begin / n_tiles, tile = begin - rw * n_tiles;  // the current item
  float4 v0 = load4(x + (size_t)rw * T, tile * TT - 8 + 4 * tid, T, vec), v1;
  if (tid < NX2) v1 = load4(x + (size_t)rw * T, tile * TT - 8 + 4 * NT + 4 * tid, T, vec);
  int r_ab = -1;  // the row whose a and ib are held
  float a = 0.f, ib = 0.f;
  for (int item = begin; item < end; ++item) {
    if (rw != r_ab) {
      const int c = rw % C;
      r_ab = rw;
      if (logscale) {
        a = expf(alpha[c]);
        ib = 1.f / (expf(beta[c]) + 1e-9f);
      } else {
        a = alpha[c];
        ib = 1.f / (beta[c] + 1e-9f);
      }
    }
    const int t0 = tile * TT;
    float* __restrict__ yr = out + (size_t)rw * T;
    // Every thread has passed the previous item's second barrier, so no one
    // still reads xs; the next item's x goes to registers.
    *reinterpret_cast<float4*>(xs + 4 * tid) = v0;
    if (tid < NX2) *reinterpret_cast<float4*>(xs + 4 * NT + 4 * tid) = v1;
    int rn = rw, tn = tile + 1;
    if (tn == n_tiles) tn = 0, ++rn;
    if (item + 1 < end) {
      v0 = load4(x + (size_t)rn * T, tn * TT - 8 + 4 * tid, T, vec);
      if (tid < NX2) v1 = load4(x + (size_t)rn * T, tn * TT - 8 + 4 * NT + 4 * tid, T, vec);
    }
    __syncthreads();

    // This thread's u-positions m0 + r, m0 = t0 - 4 + R tid; w[i] = x[m0 - 4 + i].
    // A group wholly right of T + 2 feeds no stored output and is skipped.
    const int m0 = t0 - 4 + R * tid;
    if (m0 <= T + 2) {
      float w[R + 8];
#pragma unroll
      for (int q = 0; q < 3; ++q) {
        const float4 v = *reinterpret_cast<const float4*>(xs + R * tid + 4 * q);
        w[4 * q] = v.x, w[4 * q + 1] = v.y, w[4 * q + 2] = v.z, w[4 * q + 3] = v.w;
      }
      float s0[R], s1[R];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        float u0 = k.up[0] * w[r + 1], u1 = k.up[1] * w[r + 2];
#pragma unroll
        for (int j = 1; j < 6; ++j) {
          u0 = fmaf(k.up[2 * j], w[r + j + 1], u0);
          u1 = fmaf(k.up[2 * j + 1], w[r + j + 2], u1);
        }
        s0[r] = snake(u0, a, ib, k);
        s1[r] = snake(u1, a, ib, k);
      }
      *reinterpret_cast<float4*>(s0s + R * tid) = make_float4(s0[0], s0[1], s0[2], s0[3]);
      *reinterpret_cast<float4*>(s1s + R * tid) = make_float4(s1[0], s1[1], s1[2], s1[3]);
    }

    // u-space clamps: stored outputs read m in [-3, T + 2]. Left of 0 both
    // phases take s0[0] (l = 4); right of T - 1 both take s1[T - 1] (l = lT).
    const bool first = t0 == 0;
    const int lT = T - 1 - (t0 - 4);
    const bool last = lT < NU - 1;
    if (first || last) {  // uniform across the block
      __syncthreads();
      const float e0 = s0s[4];
      const float e1 = s1s[min(lT, NU - 1)];
      if (first && tid < 3) s0s[1 + tid] = s1s[1 + tid] = e0;
      if (last && tid < 3 && lT + 1 + tid < NU) s0s[lT + 1 + tid] = s1s[lT + 1 + tid] = e1;
    }
    __syncthreads();

    // Outputs t0 + R tid + r read s0 at l = R tid + r + j + 2 and s1 at
    // l = R tid + r + j + 1, j = 0..5: the float4s at R tid, R tid + 4, R tid + 8.
    const int t = t0 + R * tid;
    if (tid < TT / R && t < T) {
      float p0[R + 8], p1[R + 8];
#pragma unroll
      for (int q = 0; q < 3; ++q) {
        const float4 u = *reinterpret_cast<const float4*>(s0s + R * tid + 4 * q);
        const float4 v = *reinterpret_cast<const float4*>(s1s + R * tid + 4 * q);
        p0[4 * q] = u.x, p0[4 * q + 1] = u.y, p0[4 * q + 2] = u.z, p0[4 * q + 3] = u.w;
        p1[4 * q] = v.x, p1[4 * q + 1] = v.y, p1[4 * q + 2] = v.z, p1[4 * q + 3] = v.w;
      }
      float acc[R];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        float v = k.down[1] * p0[r + 2];
        v = fmaf(k.down[0], p1[r + 1], v);
#pragma unroll
        for (int j = 1; j < 6; ++j) {
          v = fmaf(k.down[2 * j + 1], p0[r + j + 2], v);
          v = fmaf(k.down[2 * j], p1[r + j + 1], v);
        }
        acc[r] = v;
      }
      if (vec) {  // T % 4 == 0, so t + 4 <= T
        *reinterpret_cast<float4*>(yr + t) = make_float4(acc[0], acc[1], acc[2], acc[3]);
      } else {
#pragma unroll
        for (int r = 0; r < R; ++r)
          if (t + r < T) yr[t + r] = acc[r];
      }
    }
    rw = rn, tile = tn;
  }
}

}  // namespace

// consts: 35 floats in host memory, laid out as Consts; logscale: alpha and beta
// are logs (SnakeBeta's default). One launch: min(B*C*n_tiles, BPS * SMs) blocks.
extern "C" int anti_alias_snake_f32(const float* x, const float* alpha, const float* beta,
                                    const float* consts, float* out, int B, int C, int T,
                                    int logscale, void* stream) {
  Consts k;
  memcpy(&k, consts, sizeof(k));
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int n_tiles = (T + TT - 1) / TT, n_work = n_tiles * C * B;
  const int grid = n_work < BPS * sms ? n_work : BPS * sms;
  anti_alias_snake_kernel<<<grid, NT, 0, (cudaStream_t)stream>>>(x, alpha, beta, out, C, T,
                                                                 n_tiles, n_work, logscale, k);
  return (int)cudaGetLastError();
}
