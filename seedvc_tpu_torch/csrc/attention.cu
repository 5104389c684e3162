// DiT attention for Hopper (sm_90a): K1 (RoPE in the call) and K3 (q/k
// arrive roped) share one bf16 attention core (every serving path) and one
// f32 core on 3xTF32 tensor-core products (the fine-tuning path).
//
// What it replaces. K1, dit_attention_fused_bf16, replaces the TPU kernel
// seedvc_tpu/ops/pallas/attention.py::dit_attention_fused (body
// _attn_kernel_v2): q and k are roped in fp32 from the (T, d) cos / signed-sin
// caches, q is scaled by 1/sqrt(d) = 2^-3 and both are rounded to bf16. K3,
// dit_attention_bf16, replaces ::dit_attention (body _attn_kernel), whose q/k
// arrive roped and whose fp32 logits are scaled by 2^-3; a power of two, so
// scaling q or the logits gives the same bits. In both, keys >= lens[b] get a
// -1e30 bias, the softmax is fp32, P is rounded to bf16 before the row sum and
// the P.V product (which sums in fp32), and the division by the row sum is
// deferred to the output, as the TPU K1 does (the TPU K3 divides P first).
//
// What bounds them on an H100: operations. 4*B*H*T*n*d products (n the keys
// that count) against 8*B*H*T*d bytes of q/k/v/o: 17.2 GFLOP against 8.4 MB at
// the main path's (2, 8, 2048, 64), far above the card's 295 operations per
// byte, so the bf16 core belongs on wgmma, the only route to the 989 TFLOP/s.
// In f32 each product is three TF32 products (3xTF32, attention_tf32.cuh):
// the bound is 3x the operations at the 495 TFLOP/s TF32 peak (0.0199 ms at
// the fine-tuning path's (2, 8, 896, 64), 0.163 ms at T = 2560).
//
// Design of the bf16 path.
// 1. RoPE once per call (K1 only): rope_prepass_kernel reads pre-RoPE q/k and
//    the f32 cos/sin and writes roped, 2^-3-scaled q and roped k as bf16 into
//    scratch the wrapper allocates: the TPU design's "rope K once per head",
//    for a machine whose blocks run in parallel (about 18 MB moved at the main
//    shape). Each product and the sum round separately (no FMA contraction), so
//    the output equals the plain twin bit for bit.
// 2. The core, attn_core_kernel, warp-specialised. One block per (batch*head,
//    64-query tile), 160 threads: one consumer warpgroup and one producer warp.
//    The producer issues TMA loads (cp.async.bulk.tensor, 3-D maps over
//    (B*H, T, 64), 128-byte swizzle: a bf16 row of 64 features is exactly 128
//    bytes): the Q tile once, then K and V tiles of 64 keys through a ring of
//    4 slots guarded by full/empty mbarriers. Rows >= T are zero-filled by the
//    TMA unit, never read from the next head, and still masked as keys >= T.
//    The consumers run S = Q.K^T as wgmma m64n64k16 with both operands in
//    shared memory, the online softmax in registers (running max from -1e30,
//    ex2.approx with scale*log2(e) folded into its argument by one FFMA on
//    tiles without masked keys), and O += P.V as wgmma
//    with P from registers (the S accumulator repacks into the A fragment) and
//    V read as it lies, an MN-major B (transpose flag): V is never transposed
//    by hand. S of tile j and P.V of tile j-1 are issued back to back, and the
//    softmax of tile j runs while P.V does. Three blocks share an SM (73 KB of
//    shared memory, at most 136 registers a thread each); blocks drift out of
//    phase, so one block's softmax overlaps another's wgmma. On the H100 this
//    beat two or three consumer warpgroups a block (warpgroups that share a
//    ring stay in step), a producer warpgroup handing registers over with
//    setmaxnreg, and rings of 2 or 3 slots. setmaxnreg works only for a whole
//    producer warpgroup (with a lone producer warp the consumers' increase
//    never completed), and with two blocks an SM the compiler then caps a
//    thread at 80 registers and serialises the wgmmas, so it is not used.
//    A wait on an mbarrier that lasts 10 s traps: a deadlock fails the
//    launch instead of hanging the card.
// 3. Fully masked key tiles are skipped: with n_valid >= 1 the loop stops
//    after ceil(n_valid / 64) tiles, which is exact (a skipped key adds
//    exp(-1e30 + s - m) = 0 in fp32). With n_valid = 0 every key is masked
//    and the loop runs in full, so the output is the mean of V over all T
//    keys, as both JAX references give.
// 4. Host side: the C entry points encode the tensor maps on every call,
//    reaching cuTensorMapEncodeTiled through cudaGetDriverEntryPoint, so the
//    library needs no -lcuda.
// 5. A query slab (the sequence-sharded sampler: a rank's Tq query rows
//    against all Tk keys and values, gathered over the ranks): the q map and
//    the query-tile grid run over Tq, the k/v maps, the key tiles and the
//    mask over Tk, and the pre-pass ropes q with q's own (Tq, 64) tables, the
//    rows at the slab's global positions. Each query row is computed alone,
//    so a slab's rows equal the whole sequence's bit for bit, and Tq = Tk with
//    one table is the single-sequence kernel unchanged.
//
// The f32 path (K1 and K3 in f32; the fine-tuning path, whose DiT trunk
// attention runs in f32 as the JAX step's type promotion gives it):
// 1. K1's RoPE once per call: rope_prepass_f32_kernel writes roped q times
//    2^-3 and roped k in f32 into scratch the wrapper allocates, each product
//    and the sum rounded on their own, as the plain twin rounds them.
// 2. The core, tf32::attn_fwd_tf32 (attention_tf32.cuh): 4 warps of 16 query
//    rows a block; Q's fragments split into TF32 hi/lo once; K and V tiles of
//    64 keys through a 2-stage cp.async ring; S = Q.K^T and O += P.V as
//    3xTF32 mma.sync.m16n8k8 with P fed from the S accumulators; an online
//    softmax in f32; key tiles past the valid keys skipped as in the bf16
//    core. It writes the row log-sum-exp when the caller passes a buffer
//    (the autograd Functions keep it for K1b).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "attention_tf32.cuh"

namespace {

constexpr int D = 64;
constexpr float NEG = -1e30f;

// ---------------------------------------------------------------------------
// bf16 path: RoPE pre-pass, then the warp-specialised wgmma/TMA core.

using bf16 = __nv_bfloat16;

constexpr int TQ = 64;                         // query rows per block: one consumer warpgroup
constexpr int TK = 64;                         // keys per tile
constexpr int STAGES = 4;                      // K/V ring slots
constexpr int CONSUMER_WARPS = 4;
constexpr int THREADS = 32 * (CONSUMER_WARPS + 1);  // the consumer warpgroup and a producer warp
constexpr int MIN_BLOCKS = 3;                  // blocks an SM: caps a thread at 136 registers
constexpr int ROW_BYTES = D * 2;               // one bf16 row: one 128-byte swizzle span
constexpr int Q_BYTES = TQ * ROW_BYTES;
constexpr int KV_BYTES = TK * ROW_BYTES;
constexpr int BARRIERS = 1 + 2 * STAGES;       // Q full, K/V full and empty per slot
constexpr int CORE_SMEM = 1024 + Q_BYTES + 2 * STAGES * KV_BYTES + 8 * BARRIERS;
constexpr float LOG2E = 1.4426950408889634f;
// A healthy wait lasts microseconds; one that outlasts this many nanoseconds
// of the global timer is a deadlock, and traps rather than hangs the card.
constexpr uint64_t WAIT_LIMIT_NS = 10ull * 1000 * 1000 * 1000;

// Errors of the host side, beyond cudaError_t's range.
constexpr int ERR_NO_ENCODER = 10001;  // cuTensorMapEncodeTiled not found
constexpr int ERR_TENSOR_MAP = 10002;    // cuTensorMapEncodeTiled refused the map

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Rope 8 consecutive features d0..d0+7 of row t in fp32,
// (x*cos + pair_swap(x)*sin) * scale with each product, the sum and the scale
// rounded on their own (as the plain twin's separate tensor ops round), then
// round to bf16 and store 16 bytes.
__device__ __forceinline__ void rope8(const bf16* row, const float* cosb, const float* sinb,
                                      int t, int d0, float scale, bf16* dst) {
  const uint4 raw = *reinterpret_cast<const uint4*>(row + d0);
  const bf16* x = reinterpret_cast<const bf16*>(&raw);
  const float4* c4 = reinterpret_cast<const float4*>(cosb + (size_t)t * D + d0);
  const float4* s4 = reinterpret_cast<const float4*>(sinb + (size_t)t * D + d0);
  const float4 ca = c4[0], cb = c4[1], sa = s4[0], sb = s4[1];
  const float cs[8] = {ca.x, ca.y, ca.z, ca.w, cb.x, cb.y, cb.z, cb.w};
  const float sn[8] = {sa.x, sa.y, sa.z, sa.w, sb.x, sb.y, sb.z, sb.w};
  uint4 res;
  uint32_t* o = reinterpret_cast<uint32_t*>(&res);
#pragma unroll
  for (int i = 0; i < 8; i += 2) {
    const float x0 = __bfloat162float(x[i]), x1 = __bfloat162float(x[i + 1]);
    const float y0 = __fadd_rn(__fmul_rn(x0, cs[i]), __fmul_rn(x1, sn[i]));
    const float y1 = __fadd_rn(__fmul_rn(x1, cs[i + 1]), __fmul_rn(x0, sn[i + 1]));
    o[i / 2] = pack_bf16(__fmul_rn(y0, scale), __fmul_rn(y1, scale));
  }
  *reinterpret_cast<uint4*>(dst) = res;
}

// One thread per 8 features of one row: the first nq_chunks items are q's
// rows (B*H, Tq), roped with q's tables times 2^-3 to qo; the rest are k's
// rows (B*H, Tk), roped with k's tables to ko. A row's table row is its
// index within its (batch*head); q's tables hold the rows at the queries'
// global positions (a slab of a sequence split over ranks).
__global__ void __launch_bounds__(256)
rope_prepass_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const float* __restrict__ cosk, const float* __restrict__ sink,
                    const float* __restrict__ cosq, const float* __restrict__ sinq,
                    bf16* __restrict__ qo, bf16* __restrict__ ko, int Tq, int Tk,
                    long long nq_chunks, long long n_chunks) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n_chunks;
       i += (long long)gridDim.x * blockDim.x) {
    const bool is_q = i < nq_chunks;
    const long long j = is_q ? i : i - nq_chunks;
    const long long row = j >> 3;
    const int d0 = (int)(j & 7) * 8;
    if (is_q)
      rope8(q + row * D, cosq, sinq, (int)(row % Tq), d0, 0.125f /* 1/sqrt(64) */,
            qo + row * D + d0);
    else
      rope8(k + row * D, cosk, sink, (int)(row % Tk), d0, 1.f, ko + row * D + d0);
  }
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

// Wait until the phase of the given parity has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint64_t start = 0;
  for (;;) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    const uint64_t now = global_ns();
    if (start == 0)
      start = now;
    else if (now - start > WAIT_LIMIT_NS)
      __trap();
  }
}

// TMA: one box of a 3-D tensor map at (feature c0, row c1, batch*head c2) into
// shared memory; completion counts bytes on the barrier.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar, int c0,
                                         int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// wgmma shared-memory descriptor of a tile laid out with the 128-byte swizzle
// (the TMA's SWIZZLE_128B), split in its two words: the low word holds the
// start address and the leading byte offset (16-byte units), the high word
// the stride byte offset of 1024 bytes (8 rows of 128 bytes) and layout type
// 1. Tile bases are 1024-byte aligned, so the base offset is 0, and a k-step
// adds to the low word only.
constexpr uint32_t DESC_HI = (1024 >> 4) | (1u << 30);

__device__ __forceinline__ uint32_t desc_lo(const void* tile, uint32_t lbo) {
  return ((smem_u32(tile) & 0x3FFFF) >> 4) | ((lbo >> 4) << 16);
}

__device__ __forceinline__ uint64_t desc(uint32_t lo) {
  return (static_cast<uint64_t>(DESC_HI) << 32) | lo;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keeps the compiler from moving reads or writes of the accumulators across
// the asynchronous wgmma.
__device__ __forceinline__ void fence_regs(float (&r)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
__device__ __forceinline__ void fence_regs(uint32_t (&r)[4][4]) {
#pragma unroll
  for (int i = 0; i < 16; ++i) asm volatile("" : "+r"(r[i / 4][i % 4])::"memory");
}

#define ACC32(d)                                                                              \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),          \
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), \
      "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),           \
      "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),           \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
#define ACC32_LIST                                                                        \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, " \
  "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"

// D(64x64, f32) (+)= A(64x16) . B(16x64), A and B K-major in shared memory;
// ACC false ignores D's old value.
template <bool ACC>
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " ACC32_LIST
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : ACC32(d)
      : "l"(a), "l"(b), "n"(ACC ? 1 : 0));
}

// D(64x64, f32) += A(64x16, registers) . B(16x64), B MN-major in shared memory.
__device__ __forceinline__ void wgmma_rs_mn(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " ACC32_LIST
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : ACC32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "n"(1));
}

// S(64x64) = Q.K^T over the 64 features: four k-steps of 16 features (32
// bytes, 2 descriptor units) along both K-major tiles; the first overwrites
// S. The caller fences: no register a wgmma reads may be written between its
// issue and its wait, or ptxas serialises the wgmmas (C7513).
__device__ __forceinline__ void issue_qk(float (&s)[32], uint32_t qlo, uint32_t klo) {
  wgmma_ss<false>(s, desc(qlo), desc(klo));
#pragma unroll
  for (int kk = 1; kk < D / 16; ++kk) wgmma_ss<true>(s, desc(qlo + 2 * kk), desc(klo + 2 * kk));
}

// O(64x64) += P.V over the tile's 64 keys: four k-steps of 16 keys (2048
// bytes, 128 descriptor units) down the MN-major V tile.
__device__ __forceinline__ void issue_pv(float (&o)[32], const uint32_t (&p)[4][4], uint32_t vlo) {
#pragma unroll
  for (int kk = 0; kk < TK / 16; ++kk) wgmma_rs_mn(o, p[kk], desc(vlo + 128 * kk));
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Online softmax over one 64-key tile for this lane's rows g and g+8. s holds
// the fp32 logits (the wgmma accumulator layout: s[4j+e] is key 8j+2c+(e&1)
// of row g for e < 2, of row g+8 otherwise). On return p holds
// P = 2^(s*sl2 + bias - m_new) rounded to bf16, packed as the A fragment of
// P.V (keys 16kk..16kk+15 in p[kk]); m is the new running max, l this lane's
// share of the running row sum of the rounded P, and alpha the factor that
// rescales the running output.
__device__ __forceinline__ void softmax_tile(float (&s)[32], uint32_t (&p)[4][4], float (&m)[2],
                                             float (&l)[2], float (&alpha)[2], int k0, int n_valid,
                                             int T_len, float sl2, int c) {
  // A tile with masked keys or keys past T is scaled and masked here (k = 1
  // below); a full tile keeps the raw logits and folds the scale into the
  // exponent, 2^(s*sl2 - m), one FFMA.
  const bool edge = k0 + TK > n_valid || k0 + TK > T_len;
  float mx[2] = {NEG, NEG};
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    if (edge) {
      const int key = k0 + 8 * (i >> 2) + 2 * c + (i & 1);
      float x = s[i] * sl2;
      if (key >= n_valid) x += NEG;  // key-padding bias, as the TPU kernel adds it
      if (key >= T_len) x = -INFINITY;
      s[i] = x;
    }
    mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
  }
  const float k = edge ? 1.f : sl2;
  float nm[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
#pragma unroll
    for (int off = 1; off < 4; off <<= 1)
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], off));
    const float mn = fmaxf(m[r], mx[r] * k);
    alpha[r] = ex2(m[r] - mn);
    m[r] = mn;
    nm[r] = -mn;
  }
  float ps[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      // P rounded to bf16 before both the row sum and P.V
      const uint32_t u = pack_bf16(ex2(fmaf(s[4 * j + 2 * r], k, nm[r])),
                                   ex2(fmaf(s[4 * j + 2 * r + 1], k, nm[r])));
      ps[r] += __uint_as_float(u << 16) + __uint_as_float(u & 0xffff0000u);
      p[j >> 1][(j & 1) * 2 + r] = u;
    }
  l[0] = l[0] * alpha[0] + ps[0];
  l[1] = l[1] * alpha[1] + ps[1];
}

// One block per (64-query tile of the Tq rows, batch*head), against the Tk
// keys. q is roped; sl2 = scale * log2(e) with scale 1 for K1 (q arrives
// scaled by 2^-3) and 2^-3 for K3.
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
attn_core_kernel(const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
                 const __grid_constant__ CUtensorMap vmap, const int* __restrict__ lens,
                 bf16* __restrict__ out, int H, int Tq, int Tk, float sl2) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint8_t* Qs = base;                                 // [TQ][64], swizzled
  uint8_t* Ks = Qs + Q_BYTES;                         // STAGES x [TK][64], swizzled
  uint8_t* Vs = Ks + STAGES * KV_BYTES;               // STAGES x [TK][64], swizzled
  uint64_t* q_full = reinterpret_cast<uint64_t*>(Vs + STAGES * KV_BYTES);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + STAGES;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int bh = blockIdx.y, q0 = blockIdx.x * TQ;
  const int n_valid = lens ? lens[bh / H] : Tk;
  const int all_tiles = (Tk + TK - 1) / TK;
  // skip key tiles that hold only masked keys; with no valid key, visit all
  const int n_tiles = n_valid >= 1 ? min(all_tiles, (n_valid + TK - 1) / TK) : all_tiles;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMER_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == CONSUMER_WARPS) {
    // producer: one lane keeps the ring full
    if (lane == 0) {
      mbar_expect_tx(q_full, Q_BYTES);
      tma_load(Qs, &qmap, q_full, 0, q0, bh);
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % STAGES;
        if (it >= STAGES) mbar_wait(&empty[s], ((it / STAGES) & 1) ^ 1);
        mbar_expect_tx(&full[s], 2 * KV_BYTES);
        tma_load(Ks + s * KV_BYTES, &kmap, &full[s], 0, it * TK, bh);
        tma_load(Vs + s * KV_BYTES, &vmap, &full[s], 0, it * TK, bh);
      }
    }
  } else {
    const int g = lane >> 2, c = lane & 3;
    // Q and K tiles: K-major, 8-row groups 1024 bytes apart. V tiles: keys as
    // rows, MN-major (d contiguous), 8-key groups 1024 bytes apart (LBO and
    // SBO: there is one 64-wide column block).
    const uint32_t qlo = desc_lo(Qs, 16);
    const uint32_t klo0 = desc_lo(Ks, 16);
    const uint32_t vlo0 = desc_lo(Vs, 1024);
    constexpr uint32_t SLOT = KV_BYTES >> 4;  // one ring slot in descriptor units

    float o[32], sacc[32];  // S needs no zeros: its first k-step overwrites it
#pragma unroll
    for (int i = 0; i < 32; ++i) o[i] = 0.f;
    float m[2] = {NEG, NEG}, l[2] = {0.f, 0.f}, alpha[2];  // rows g and g+8 of this warp
    uint32_t pf[4][4];

    // S = Q.K^T of tile 0, then its softmax
    mbar_wait(q_full, 0);
    mbar_wait(&full[0], 0);
    fence_regs(sacc);
    wgmma_fence();
    issue_qk(sacc, qlo, klo0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sacc);
    softmax_tile(sacc, pf, m, l, alpha, 0, n_valid, Tk, sl2, c);

    // Tile it: S = Q.K_it and O += P_{it-1}.V_{it-1} go to the tensor cores
    // back to back; the softmax of S runs while P.V does; then O is rescaled.
    // P alternates between two register sets, pc (read by the P.V in
    // flight) and pn (written by the softmax): a copy from one to the other
    // would make ptxas serialise the wgmmas (C7513).
    auto step = [&](int it, uint32_t(&pc)[4][4], uint32_t(&pn)[4][4]) {
      const int s = it % STAGES, sp = (it - 1) % STAGES;
      mbar_wait(&full[s], (it / STAGES) & 1);
      fence_regs(sacc);
      fence_regs(o);
      fence_regs(pc);
      wgmma_fence();
      issue_qk(sacc, qlo, klo0 + s * SLOT);
      wgmma_commit();
      issue_pv(o, pc, vlo0 + sp * SLOT);
      wgmma_commit();
      wgmma_wait<1>();
      fence_regs(sacc);
      softmax_tile(sacc, pn, m, l, alpha, it * TK, n_valid, Tk, sl2, c);
      wgmma_wait<0>();
      fence_regs(o);
      fence_regs(pc);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[sp]);
      if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) {
#pragma unroll
        for (int i = 0; i < 32; ++i) o[i] *= alpha[(i >> 1) & 1];
      }
    };
    uint32_t pf2[4][4];  // P of odd tiles; pf holds the even ones
    for (int it = 1; it < n_tiles; it += 2) {
      step(it, pf, pf2);
      if (it + 1 < n_tiles) step(it + 1, pf2, pf);
    }
    const uint32_t vlast = vlo0 + ((n_tiles - 1) % STAGES) * SLOT;
    fence_regs(o);
    if ((n_tiles - 1) & 1) {
      fence_regs(pf2);
      wgmma_fence();
      issue_pv(o, pf2, vlast);
    } else {
      fence_regs(pf);
      wgmma_fence();
      issue_pv(o, pf, vlast);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(o);

    // row sums: each lane holds a quarter of its rows' keys
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      l[0] += __shfl_xor_sync(0xffffffffu, l[0], off);
      l[1] += __shfl_xor_sync(0xffffffffu, l[1], off);
    }
    const float i0 = 1.f / l[0], i1 = 1.f / l[1];
    const int r0 = q0 + warp * 16 + g, r1 = r0 + 8;
    bf16* o0 = out + ((size_t)bh * Tq + r0) * D;
    bf16* o1 = out + ((size_t)bh * Tq + r1) * D;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = 8 * j + 2 * c;
      if (r0 < Tq)
        *reinterpret_cast<uint32_t*>(o0 + col) = pack_bf16(o[4 * j] * i0, o[4 * j + 1] * i0);
      if (r1 < Tq)
        *reinterpret_cast<uint32_t*>(o1 + col) = pack_bf16(o[4 * j + 2] * i1, o[4 * j + 3] * i1);
    }
  }
}

#undef ACC32
#undef ACC32_LIST

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled, looked up through the runtime: no -lcuda.
EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                       cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                              &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// A 3-D map over a (B*H, T, 64) bf16 tensor, boxes of `rows` rows, 128-byte
// swizzle; rows past T read as zeros.
int make_map(CUtensorMap* map, const void* ptr, int BH, int T_len, int rows) {
  EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return ERR_NO_ENCODER;
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)T_len, (cuuint64_t)BH};
  const cuuint64_t strides[2] = {(cuuint64_t)ROW_BYTES, (cuuint64_t)T_len * ROW_BYTES};
  const cuuint32_t box[3] = {(cuuint32_t)D, (cuuint32_t)rows, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims,
                            strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : ERR_TENSOR_MAP;
}

// Sets a kernel's dynamic shared-memory limit once per device (the attribute
// belongs to the current device). Once, not every call: the launches may be
// captured into a CUDA graph, and a capture records launches only.
constexpr int MAX_DEVICES = 64;

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

bool core_smem_set[MAX_DEVICES];

int launch_core(const void* q, const void* k, const void* v, const int* lens, void* out, int B,
                int H, int Tq, int Tk, float scale, void* stream) {
  int err = set_smem_once(attn_core_kernel, CORE_SMEM, core_smem_set);
  if (err) return err;
  const int BH = B * H;
  CUtensorMap qm, km, vm;
  err = make_map(&qm, q, BH, Tq, TQ);
  if (!err) err = make_map(&km, k, BH, Tk, TK);
  if (!err) err = make_map(&vm, v, BH, Tk, TK);
  if (err) return err;
  dim3 grid((Tq + TQ - 1) / TQ, BH);
  attn_core_kernel<<<grid, THREADS, CORE_SMEM, (cudaStream_t)stream>>>(
      qm, km, vm, lens, (bf16*)out, H, Tq, Tk, scale * LOG2E);
  return (int)cudaGetLastError();
}

int grid_blocks(long long n_chunks) {
  return (int)((n_chunks + 255) / 256 < 8192 ? (n_chunks + 255) / 256 : 8192);
}

int launch_prepass(const void* q, const void* k, const float* cosk, const float* sink,
                   const float* cosq, const float* sinq, void* qo, void* ko, int BH, int Tq,
                   int Tk, void* stream) {
  const long long nq_chunks = (long long)BH * Tq * (D / 8);
  const long long n_chunks = nq_chunks + (long long)BH * Tk * (D / 8);
  rope_prepass_kernel<<<grid_blocks(n_chunks), 256, 0, (cudaStream_t)stream>>>(
      (const bf16*)q, (const bf16*)k, cosk, sink, cosq, sinq, (bf16*)qo, (bf16*)ko, Tq, Tk,
      nq_chunks, n_chunks);
  return (int)cudaGetLastError();
}

// f32 RoPE pre-pass: one thread per 4 features of one row, q's rows first
// (with q's tables, times 2^-3, to qo), then k's (to ko), as the bf16 one;
// each product and the sum rounded on their own (the plain twin's separate
// tensor ops), so the f32 core reads the twin's roped q (times 2^-3, exact)
// and k bit for bit.
__global__ void __launch_bounds__(256)
rope_prepass_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ cosk, const float* __restrict__ sink,
                        const float* __restrict__ cosq, const float* __restrict__ sinq,
                        float* __restrict__ qo, float* __restrict__ ko, int Tq, int Tk,
                        long long nq_chunks, long long n_chunks) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n_chunks;
       i += (long long)gridDim.x * blockDim.x) {
    const bool is_q = i < nq_chunks;
    const long long j = is_q ? i : i - nq_chunks;
    const long long row = j >> 4;
    const int d0 = (int)(j & 15) * 4;
    const size_t cs = (size_t)(row % (is_q ? Tq : Tk)) * D + d0;
    const float4 c4 = *reinterpret_cast<const float4*>((is_q ? cosq : cosk) + cs);
    const float4 s4 = *reinterpret_cast<const float4*>((is_q ? sinq : sink) + cs);
    const float cv[4] = {c4.x, c4.y, c4.z, c4.w}, sv[4] = {s4.x, s4.y, s4.z, s4.w};
    const float4 x4 = *reinterpret_cast<const float4*>((is_q ? q : k) + row * D + d0);
    const float x[4] = {x4.x, x4.y, x4.z, x4.w};
    const float scale = is_q ? 0.125f /* 1/sqrt(64) */ : 1.f;
    float y[4];
#pragma unroll
    for (int e = 0; e < 4; ++e)
      y[e] = __fmul_rn(__fadd_rn(__fmul_rn(x[e], cv[e]), __fmul_rn(x[e ^ 1], sv[e])), scale);
    *reinterpret_cast<float4*>((is_q ? qo : ko) + row * D + d0) =
        make_float4(y[0], y[1], y[2], y[3]);
  }
}

bool f32_smem_set[MAX_DEVICES];

int launch_f32(const float* q, const float* k, const float* v, const int* lens, float* out,
               float* lse, int B, int H, int Tq, int Tk, float scale, void* stream) {
  const int bytes = tf32::fwd_smem_bytes(true);
  const int err = set_smem_once(tf32::attn_fwd_tf32<true, false>, bytes, f32_smem_set);
  if (err) return err;
  dim3 grid((Tq + tf32::BT - 1) / tf32::BT, B * H);
  tf32::attn_fwd_tf32<true, false><<<grid, tf32::THREADS, bytes, (cudaStream_t)stream>>>(
      q, k, v, lens, out, lse, H, Tq, Tk, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// The C entry points take q as (B*H, Tq, 64) and k, v as (B*H, Tk, 64), Tq <=
// Tk: Tq < Tk is a rank's query slab of a sequence split over ranks, whose
// keys and values were gathered. K1's cosk / sink are k's (Tk, 64) tables and
// cosq / sinq q's (Tq, 64) ones (the same pointers when Tq = Tk).

// K1's first stage alone: qo = rope(q) * 2^-3 and ko = rope(k), bf16.
// dit_attention_fused_bf16 runs it before the core.
extern "C" int rope_prepass_bf16(const void* q, const void* k, const float* cosk,
                                 const float* sink, const float* cosq, const float* sinq,
                                 void* qo, void* ko, int BH, int Tq, int Tk, void* stream) {
  return launch_prepass(q, k, cosk, sink, cosq, sinq, qo, ko, BH, Tq, Tk, stream);
}

// K1: q/k before RoPE; scratch holds B*H*(Tq + Tk)*64 bf16 for the roped q
// and k.
extern "C" int dit_attention_fused_bf16(const void* q, const void* k, const void* v,
                                        const float* cosk, const float* sink, const float* cosq,
                                        const float* sinq, const int* lens, void* out,
                                        void* scratch, int B, int H, int Tq, int Tk,
                                        void* stream) {
  bf16* qr = (bf16*)scratch;
  bf16* kr = qr + (size_t)B * H * Tq * D;
  int err = launch_prepass(q, k, cosk, sink, cosq, sinq, qr, kr, B * H, Tq, Tk, stream);
  if (err) return err;
  return launch_core(qr, kr, v, lens, out, B, H, Tq, Tk, 1.f, stream);
}

// K1 in f32: scratch holds B*H*(Tq + Tk)*64 floats for the roped q (times
// 2^-3) and k; lse, if not null, receives the (B*H, Tq) row log-sum-exp.
extern "C" int dit_attention_fused_f32(const void* q, const void* k, const void* v,
                                       const float* cosk, const float* sink, const float* cosq,
                                       const float* sinq, const int* lens, void* out, void* lse,
                                       void* scratch, int B, int H, int Tq, int Tk,
                                       void* stream) {
  float* qr = (float*)scratch;
  float* kr = qr + (size_t)B * H * Tq * D;
  const long long nq_chunks = (long long)B * H * Tq * (D / 4);
  const long long n_chunks = nq_chunks + (long long)B * H * Tk * (D / 4);
  rope_prepass_f32_kernel<<<grid_blocks(n_chunks), 256, 0, (cudaStream_t)stream>>>(
      (const float*)q, (const float*)k, cosk, sink, cosq, sinq, qr, kr, Tq, Tk, nq_chunks,
      n_chunks);
  const int err = (int)cudaGetLastError();
  if (err) return err;
  return launch_f32(qr, kr, (const float*)v, lens, (float*)out, (float*)lse, B, H, Tq, Tk, 1.f,
                    stream);
}

// K3: q/k already roped; no cos/sin.
extern "C" int dit_attention_bf16(const void* q, const void* k, const void* v, const int* lens,
                                  void* out, int B, int H, int Tq, int Tk, void* stream) {
  return launch_core(q, k, v, lens, out, B, H, Tq, Tk, 0.125f /* 1/sqrt(64) */, stream);
}

extern "C" int dit_attention_f32(const void* q, const void* k, const void* v, const int* lens,
                                 void* out, void* lse, int B, int H, int Tq, int Tk,
                                 void* stream) {
  return launch_f32((const float*)q, (const float*)k, (const float*)v, lens, (float*)out,
                    (float*)lse, B, H, Tq, Tk, 0.125f /* 1/sqrt(64) */, stream);
}
