// Fused anti-aliased SnakeBeta activation for Hopper (sm_90a).
//
// Replaces the TPU kernels seedvc_tpu/ops/pallas/anti_alias.py::anti_alias_snake
// (body _make_kernel_clean, C > 64) and ::_anti_alias_grouped (body
// _make_kernel_grouped, C <= 64). Both compute one function: a 2x kaiser-sinc
// upsample (12 taps, replicate pad), SnakeBeta x + inv_beta * sin^2(alpha * x),
// and a 2x kaiser-sinc low-pass downsample, all in fp32. The lane packing of
// the grouped TPU kernel is a TPU layout trick; here one kernel serves every C.
//
// Polyphase form (see the TPU module's docstring): with f the 12-tap filter,
//   u0[m] = 2 sum_j f[2j]   x[clamp(m + j - 3)],  u1[m] = 2 sum_j f[2j+1] x[clamp(m + j - 2)]
//   s0 = snake(u0), s1 = snake(u1)
//   out[t] = sum_j f[2j+1] s0c[t + j - 2] + f[2j] s1c[t + j - 3]
// where the clamps of s0c/s1c are in u-index space: left of 0 both phases read
// s0[0], right of T-1 both phases read s1[T-1].
//
// Layout (B, C, T) fp32, time contiguous. One block per (time tile of TT
// outputs, channel, batch): it loads TT + 16 samples (an 8-sample halo each
// side, replicate-clamped) into shared memory, computes both phases of the
// snake'd upsampled signal for TT + 6 u-positions, then the down filter.
//
// Bound: memory. Each element is read once and written once (8 bytes); the
// 2x intermediate never leaves shared memory. Per output the kernel does two
// sinf and 36 FMAs, which stays below the byte time at H100 rates.

#include <cuda_runtime.h>

namespace {

constexpr int TT = 1024;
constexpr int HALO = 8;
constexpr int NT = 256;
constexpr int K = 12;

__global__ void __launch_bounds__(NT)
anti_alias_snake_kernel(const float* __restrict__ x, const float* __restrict__ alpha,
                        const float* __restrict__ inv_beta, const float* __restrict__ filt,
                        float* __restrict__ out, int C, int T) {
  __shared__ float xs[TT + 2 * HALO];
  __shared__ float s0s[TT + 6];
  __shared__ float s1s[TT + 6];
  __shared__ float f[K];

  const int t0 = blockIdx.x * TT;
  const int c = blockIdx.y;
  const size_t row = ((size_t)blockIdx.z * C + c) * T;

  if (threadIdx.x < K) f[threadIdx.x] = filt[threadIdx.x];
  for (int i = threadIdx.x; i < TT + 2 * HALO; i += NT) {
    const int t = min(max(t0 - HALO + i, 0), T - 1);
    xs[i] = x[row + t];
  }
  __syncthreads();

  const float a = alpha[c];
  const float ib = inv_beta[c];
  // Local u index l holds u-position m = t0 - 3 + l; x[m + j - 3] is xs[l + j + 2].
  for (int l = threadIdx.x; l < TT + 6; l += NT) {
    float u0 = 0.f, u1 = 0.f;
#pragma unroll
    for (int j = 0; j < 6; ++j) {
      u0 += (2.f * f[2 * j]) * xs[l + j + 2];
      u1 += (2.f * f[2 * j + 1]) * xs[l + j + 3];
    }
    const float sa = sinf(u0 * a);
    const float sb = sinf(u1 * a);
    s0s[l] = u0 + ib * (sa * sa);
    s1s[l] = u1 + ib * (sb * sb);
  }
  __syncthreads();

  const int l_first = 3 - t0;       // local index of m = 0 (used only when t0 == 0)
  const int l_last = T - 1 - t0 + 3;  // local index of m = T - 1
  for (int tl = threadIdx.x; tl < TT; tl += NT) {
    const int t = t0 + tl;
    if (t >= T) break;
    float acc = 0.f;
#pragma unroll
    for (int j = 0; j < 6; ++j) {
      const int la = tl + j + 1;  // s0 at m = t + j - 2
      const int lb = tl + j;      // s1 at m = t + j - 3
      const float va = la < l_first ? s0s[l_first] : (la > l_last ? s1s[l_last] : s0s[la]);
      const float vb = lb < l_first ? s0s[l_first] : (lb > l_last ? s1s[l_last] : s1s[lb]);
      acc += f[2 * j + 1] * va;
      acc += f[2 * j] * vb;
    }
    out[row + t] = acc;
  }
}

}  // namespace

extern "C" int anti_alias_snake_f32(const float* x, const float* alpha, const float* inv_beta,
                                    const float* filt, float* out, int B, int C, int T,
                                    void* stream) {
  dim3 grid((T + TT - 1) / TT, C, B);
  anti_alias_snake_kernel<<<grid, NT, 0, (cudaStream_t)stream>>>(x, alpha, inv_beta, filt,
                                                                 out, C, T);
  return (int)cudaGetLastError();
}
