// K3a and K3b: the flash-attention backward for Hopper (sm_90a), head dim 64,
// in bf16 or fp16.
//
// K3a replaces the TPU kernel dove_tpu/ops/pallas/flash_attention.py:
// _bwd_dq_kernel and K3b its _bwd_dkv_kernel (the two pallas_calls in
// _flash_bwd): the FlashAttention-2 backward of the non-causal attention
// out = softmax(scale Q K^T) V, from the per-row logsumexp that K1 writes in
// its training form and delta = rowsum(dO * O), which the wrapper computes.
// With p = exp(scale q.k - lse) recomputed from the logits,
//
//   K3a: dQ  = sum over keys of  ds k,         ds = p (dO.v - delta) scale
//   K3b: dV  = sum over queries of  p dO,      dK = sum over queries of  ds q
//
// as the TPU kernels compute them: fp32 logits and accumulators, p and ds
// rounded to the model type T (bf16 or fp16) before the products that take
// them, outputs in T. The TPU kernels are generic in the type (they cast dS
// to k's dtype, p^T and dS^T to dO's and q's); here each type is one
// instantiation of the two templates, fp16 differing in the wgmma's type
// suffix, the pair packing, the TMA data type and the stores.
//
// What bounds them on the H100. At the training shape (CogVideoX1.5-5B
// stage 1, batch 2 of 25x320x640: B*H = 96, S = 3426, D = 64) K3a does three
// S x S x D products a head, 4.3e11 bf16 FLOPs (0.438 ms at 989 TFLOP/s
// dense), and K3b four, 5.8e11 (0.583 ms). Each moves under 0.3 GB (~0.08
// ms). Each takes one exponential a logit, 1.1e9, ~0.3 ms on the SFU at 16 a
// clock per SM. So both are bound by tensor-core operations, where K1 has
// the exponentials as a co-bound.
//
// Design (carried over from K1, csrc/flash_fwd_sm90.cu). Each CTA owns its
// output tile and loops over the other axis itself, as the TPU kernels'
// sequential grid axis does: no atomics, and dQ is deterministic.
// - Warp specialisation. Warpgroup 0 is the producer: it gives up registers
//   (setmaxnreg, 24 a thread) and one thread issues every TMA load. The
//   consumer warpgroups own 64 rows each and keep their accumulators in
//   registers for the whole loop.
//     K3a: one CTA per (b*h, 192 queries), three consumers at 160
//          registers. Q and dO of those rows are loaded once; 64-key tiles
//          of K and V stream through a four-stage ring.
//     K3b: one CTA per (b*h, 128 keys), two consumers at 240 registers (it
//          holds two accumulators and the K and V fragments). 64-query
//          tiles of Q and dO stream through a four-stage ring, each with
//          its 64 lse and delta values.
// - TMA and an mbarrier ring, as in K1: one full barrier a stage (the
//   transaction bytes of its tiles) and one empty barrier (an arrival per
//   consumer warp); no __syncthreads in the loop. The maps are 3-D over
//   [b*h, S, 64], 128B-swizzled, so a tile past the end of a head reads
//   zeros, never the next head's rows. K3b's lse and delta values have no
//   TMA map: their rows are S * 4 bytes apart, which TMA takes only when S %
//   4 == 0, and a 1-D map over [b*h*S] faulted (illegal instruction) at the
//   training shape. The producer warpgroup's second warp copies them, each
//   lane two of each, and its 32 lanes arrive on the stage's full barrier
//   beside the TMA transaction.
// - The products, as wgmma with fp32 accumulators in registers:
//     K3a: S = Q K^T and dP = dO V^T with both operands in shared memory,
//          K-major as stored (K1's Q K^T, at n = 64); dQ += dS K with dS
//          from registers (the S accumulator's fragment packs to bf16 in the
//          A-register layout, as K1 packs P) and K read MN-major (K1's P V).
//     K3b: s^T = K Q^T and dP^T = V dO^T with K and V as register A
//          operands (each thread's fragments of its rows, loaded once from
//          global memory) and Q, dO K-major in shared memory; dV += p^T dO
//          and dK += ds^T Q with p^T and ds^T from registers and dO, Q read
//          MN-major. Computing s^T directly (as the TPU kernel does) makes
//          p^T and ds^T come out in the accumulator layout, so they never
//          pass through shared memory. lse and delta are read per
//          accumulator column from the staged values.
//   Each operand tile is read from shared memory once per 64-row warpgroup,
//   where the mma.sync schedule read it once per 16-row warp. Register A
//   operands made K3b's logit products faster; for K3a (Q and dO) they
//   spilled at 160 registers, which serialised every wgmma, and two
//   consumers at 240 registers were slower than three at 160.
// - Overlap. A consumer issues the next tile's two logit products together
//   with the previous tile's accumulating products, waits, then runs the
//   elementwise step. Named barriers pass the issue turn round the
//   consumers (ping-pong, as in K1), so their products take the tensor
//   cores in turn while the others run their elementwise step; both
//   kernels ran faster with it.
// - Tails. The ragged last tile (keys past Skv in K3a, queries past Sq in
//   K3b) is masked in a separately inlined copy of the elementwise step, so
//   the other tiles carry no per-element test. Rows past the end of the
//   owned tile are computed on zeros and not stored. No wgmma sits inside a
//   data-dependent branch: ptxas would then serialise every wgmma of the
//   kernel.

#include <cuda.h>  // CUtensorMap and its enums; the encoder comes through the runtime
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

template <typename T>
constexpr bool kHalf = std::is_same<T, __half>::value;

constexpr int kD = 64;  // head dim: one 128-byte row
constexpr int kRowBytes = kD * 2;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kStages = 4;  // ring depth of both kernels
constexpr int kProducerRegs = 24;

// K3a: queries owned, keys streamed
constexpr int kAConsumers = 3;
constexpr int kABM = 64 * kAConsumers;  // query rows per CTA
constexpr int kABN = 64;                // keys per streamed tile
constexpr int kAThreads = 128 * (1 + kAConsumers);
constexpr int kAConsumerRegs = 160;
constexpr int kAQBytes = kABM * kRowBytes;     // Q (and dO) of the CTA
constexpr int kATileBytes = kABN * kRowBytes;  // a K or a V tile
constexpr int kASmemBytes = 1024 + 2 * kAQBytes + 2 * kStages * kATileBytes;

// K3b: keys owned, queries streamed
constexpr int kBConsumers = 2;
constexpr int kBBN = 64 * kBConsumers;  // key rows per CTA
constexpr int kBBM = 64;                // queries per streamed tile
constexpr int kBThreads = 128 * (1 + kBConsumers);
constexpr int kBConsumerRegs = 240;
constexpr int kBTileBytes = kBBM * kRowBytes;  // a Q or a dO tile
constexpr int kBSliceBytes = kBBM * 4;         // a tile's lse or delta values
constexpr int kBSmemBytes = 1024 + kStages * (2 * kBTileBytes + 2 * kBSliceBytes);

static_assert(128 * kProducerRegs + 128 * kAConsumers * kAConsumerRegs <= 65536,
              "K3a's register split exceeds the SM's file");
static_assert(128 * kProducerRegs + 128 * kBConsumers * kBConsumerRegs <= 65536,
              "K3b's register split exceeds the SM's file");

struct Ring {
  uint64_t full[kStages];
  uint64_t empty[kStages];
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}

// Returns once the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// One box of a 3-D map at (0, row, bh), completing on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint64_t* bar, int row, int bh) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(0),
      "r"(row), "r"(bh)
      : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Waits for every committed wgmma group of this warpgroup.
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keep the compiler from moving register reads or writes across an async
// wgmma's issue or completion (its operands are read and written later than
// the asm statement says).
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// Shared-memory matrix descriptor, 128B swizzle: start address, leading and
// stride byte offsets, all in 16-byte units. Tiles start 1024-aligned.
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

// K-major (the operands of a logit product, rows of d): a k16 step is 32 bytes
// into each swizzled 128-byte row; 8-row groups are 1024 bytes apart; the
// leading offset is unused.
__device__ __forceinline__ uint64_t desc_kmajor(uint32_t addr) {
  return make_desc(addr, 16, 1024);
}

// MN-major (the B operand of an accumulating product, d contiguous): the 64
// d values of a row are one swizzle atom, so the offset between atoms along
// d is never used; 8-row groups along k are 1024 bytes apart. Both offsets
// are set to 1024, right whichever of the two the unit reads for k.
__device__ __forceinline__ uint64_t desc_mnmajor(uint32_t addr) {
  return make_desc(addr, 1024, 1024);
}

#define DOVE_ACC(C, n) C(d[n])
#define DOVE_ACC8(C, n)                                                      \
  DOVE_ACC(C, n), DOVE_ACC(C, n + 1), DOVE_ACC(C, n + 2), DOVE_ACC(C, n + 3), \
      DOVE_ACC(C, n + 4), DOVE_ACC(C, n + 5), DOVE_ACC(C, n + 6),            \
      DOVE_ACC(C, n + 7)
#define DOVE_ACC32(C)                                                        \
  DOVE_ACC8(C, 0), DOVE_ACC8(C, 8), DOVE_ACC8(C, 16), DOVE_ACC8(C, 24)
#define DOVE_REGS32                                                          \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31}"
#define DOVE_RW_F32(x) "+f"(x)
#define DOVE_WGMMA_SS(TY)                                                    \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"                  \
               "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " "    \
               DOVE_REGS32 ", %32, %33, p, 1, 1, 0, 0;\n}\n"                 \
               : DOVE_ACC32(DOVE_RW_F32)                                    \
               : "l"(desc_a), "l"(desc_b), "r"(scale_d))
#define DOVE_WGMMA_RS(TY)                                                    \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"                  \
               "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " "    \
               DOVE_REGS32 ", {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"  \
               : DOVE_ACC32(DOVE_RW_F32)                                    \
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),    \
                 "r"(scale_d), "n"(kTransB))

// d[64 x 64] (+)= A[64 x 16] B[16 x 64] in T (bf16 or fp16), fp32 sums; A
// and B from shared memory, K-major.
template <typename T>
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t desc_a,
                                         uint64_t desc_b, int scale_d) {
  if constexpr (kHalf<T>) {
    DOVE_WGMMA_SS("f16");
  } else {
    DOVE_WGMMA_SS("bf16");
  }
}

// d[64 x 64] (+)= A[64 x 16] B[16 x 64] in T; A from registers (four pairs
// of T, a[0..3]), B from shared memory, K-major (kTransB = 0) or MN-major
// (1).
template <typename T, int kTransB>
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t* a,
                                         uint64_t desc_b, int scale_d) {
  if constexpr (kHalf<T>) {
    DOVE_WGMMA_RS("f16");
  } else {
    DOVE_WGMMA_RS("bf16");
  }
}

// The A fragments over d (4 k16 steps) of rows r0 and r0 + 8 of a T
// [n, 64] matrix, from global memory; rows past n are zero.
template <typename T>
__device__ __forceinline__ void load_a_frags(uint32_t (&f)[16], const T* base,
                                             int r0, int n, int tig) {
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = r0 + 8 * (e & 1);
      const int col = kk * 16 + tig * 2 + 8 * (e >> 1);
      f[4 * kk + e] = row < n ? *reinterpret_cast<const uint32_t*>(
                                    base + static_cast<size_t>(row) * kD + col)
                              : 0u;
    }
  }
}

// Named barriers 1..kConsumers order the consumers' issue sections
// (ping-pong): each is met by the warpgroup that waits for its turn and the
// one before it.
__device__ __forceinline__ void bar_sync(int id) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(id) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(id) : "memory");
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Two fp32 values rounded to a pair of T, as one register.
template <typename T>
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  if constexpr (kHalf<T>) {
    __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  } else {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
}

// A [64 x 64] fp32 accumulator fragment to rows r0 and r1 = r0 + 8 of a
// T [n, 64] matrix, as pairs of T; rows at or past n are not stored.
// Element i of the fragment is row r0 + 8 * ((i >> 1) & 1), column
// 8 * (i >> 2) + 2 * tig + (i & 1).
template <typename T>
__device__ __forceinline__ void store_rows(T* base, const float (&acc)[32],
                                           int r0, int n, int tig) {
  const int r1 = r0 + 8;
#pragma unroll
  for (int j = 0; j < kD / 8; ++j) {
    const int col = j * 8 + tig * 2;
    if (r0 < n) {
      *reinterpret_cast<uint32_t*>(base + static_cast<size_t>(r0) * kD + col) =
          pack2<T>(acc[4 * j], acc[4 * j + 1]);
    }
    if (r1 < n) {
      *reinterpret_cast<uint32_t*>(base + static_cast<size_t>(r1) * kD + col) =
          pack2<T>(acc[4 * j + 2], acc[4 * j + 3]);
    }
  }
}

__device__ __forceinline__ uint32_t aligned_base(uint8_t* smem_raw) {
  return (smem_u32(smem_raw) + 1023u) & ~1023u;
}

// The ping-pong turn of consumer c of n: turn() waits on barrier 1 + c;
// pass(last) hands the turn to the next consumer, except after the last
// consumer's last section, which balances start()'s arrival.
struct PingPong {
  int c, n;
  __device__ __forceinline__ void start() const {
    if (c == n - 1) bar_arrive(1);  // the first consumer goes first
  }
  __device__ __forceinline__ void turn() const { bar_sync(1 + c); }
  __device__ __forceinline__ void pass(bool last) const {
    if (!last || c != n - 1) bar_arrive(1 + (c + 1) % n);
  }
};

// ---------------------------------------------------------------------------
// K3a: dQ for one (b*h, 192-query tile)
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kAThreads, 1)
    flash_bwd_dq_sm90_kernel(const __grid_constant__ CUtensorMap map_q,
                             const __grid_constant__ CUtensorMap map_do,
                             const __grid_constant__ CUtensorMap map_k,
                             const __grid_constant__ CUtensorMap map_v,
                             const float* __restrict__ lse,
                             const float* __restrict__ delta,
                             T* __restrict__ dq, int sq, int skv,
                             float scale) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ Ring ring;
  __shared__ uint64_t full_q;  // Q and dO
  const uint32_t base = aligned_base(smem_raw);
  const uint32_t q_tile = base;
  const uint32_t do_tile = base + kAQBytes;
  const uint32_t k_tiles = base + 2 * kAQBytes;
  const uint32_t v_tiles = k_tiles + kStages * kATileBytes;
  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * kABM;
  const int ntiles = (skv + kABN - 1) / kABN;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(&full_q, 1);
#pragma unroll
    for (int st = 0; st < kStages; ++st) {
      mbar_init(&ring.full[st], 1);
      mbar_init(&ring.empty[st], 4 * kAConsumers);  // one arrival per warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // ---------------- producer: one thread issues every load ----------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x == 0) {
      mbar_expect_tx(&full_q, 2 * kAQBytes);
      tma_load(q_tile, &map_q, &full_q, q0, bh);
      tma_load(do_tile, &map_do, &full_q, q0, bh);
      for (int j = 0; j < ntiles; ++j) {
        const int st = j % kStages;
        mbar_wait(&ring.empty[st], ((j / kStages) & 1) ^ 1);
        mbar_expect_tx(&ring.full[st], 2 * kATileBytes);
        tma_load(k_tiles + st * kATileBytes, &map_k, &ring.full[st], j * kABN, bh);
        tma_load(v_tiles + st * kATileBytes, &map_v, &ring.full[st], j * kABN, bh);
      }
    }
  } else {
    // ---------------- consumers: 64 query rows each ----------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kAConsumerRegs));
    const int c = wg - 1;
    const int tid = threadIdx.x - 128 * wg;
    const int warp = tid >> 5;
    const int lane = tid & 31;
    const int g = lane >> 2;   // fragment row within the warp's 8-row group
    const int tig = lane & 3;  // fragment column pair
    const PingPong pp{c, kAConsumers};
    const float scale_log2 = scale * kLog2e;
    const uint32_t q_rows = q_tile + c * 64 * kRowBytes;
    const uint32_t do_rows = do_tile + c * 64 * kRowBytes;
    const int r0 = q0 + c * 64 + warp * 16 + g;
    const size_t row0 = static_cast<size_t>(bh) * sq;
    // lse in log2 units and delta of this thread's two rows; rows past the
    // end are zeros in Q and dO, computed and never stored
    float lse2[2], dlt[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = r0 + 8 * r;
      lse2[r] = row < sq ? lse[row0 + row] * kLog2e : 0.f;
      dlt[r] = row < sq ? delta[row0 + row] : 0.f;
    }

    // Accumulator fragments: element i of s, dp (and acc) is row g + 8 * ((i
    // >> 1) & 1) of the warp's 16, column 8 * (i >> 2) + 2 * tig + (i & 1).
    float acc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = 0.f;
    float s[32];
    float dp[32];
    // dS as pairs of T in the A-register layout: pair k holds elements 2k
    // and 2k + 1, of row (k & 1)
    uint32_t ds[16];

    // S = Q K_st^T and dP = dO V_st^T (4 k16 steps over d each).
    auto issue_sdp = [&](int st) {
      const uint32_t kt = k_tiles + st * kATileBytes;
      const uint32_t vt = v_tiles + st * kATileBytes;
#pragma unroll
      for (int kk = 0; kk < kD / 16; ++kk) {
        wgmma_ss<T>(s, desc_kmajor(q_rows + kk * 32), desc_kmajor(kt + kk * 32),
                    kk > 0);
      }
#pragma unroll
      for (int kk = 0; kk < kD / 16; ++kk) {
        wgmma_ss<T>(dp, desc_kmajor(do_rows + kk * 32), desc_kmajor(vt + kk * 32),
                    kk > 0);
      }
    };
    // dQ += dS K_st (4 k16 steps over the tile's keys).
    auto issue_dq = [&](int st) {
      const uint32_t kt = k_tiles + st * kATileBytes;
#pragma unroll
      for (int kk = 0; kk < kABN / 16; ++kk) {
        wgmma_rs<T, 1>(acc, ds + 4 * kk, desc_mnmajor(kt + kk * 16 * kRowBytes), 1);
      }
    };
    auto release = [&](int st) {
      if (lane == 0) mbar_arrive(&ring.empty[st]);
    };
    // p = exp2(s scale log2 e - lse log2 e), ds = p (dp - delta) scale, into
    // pairs of T; `masked` on the ragged last tile, whose keys past the end
    // get ds = 0 (a separate inlined copy: the other tiles carry no test).
    auto grads = [&](int j, bool masked) {
#pragma unroll
      for (int k = 0; k < 16; ++k) {
        const int r = k & 1;
        float d0 = ex2(fmaf(s[2 * k], scale_log2, -lse2[r])) *
                   (dp[2 * k] - dlt[r]) * scale;
        float d1 = ex2(fmaf(s[2 * k + 1], scale_log2, -lse2[r])) *
                   (dp[2 * k + 1] - dlt[r]) * scale;
        if (masked) {
          const int kv = j * kABN + (k >> 1) * 8 + tig * 2;
          if (kv >= skv) d0 = 0.f;
          if (kv + 1 >= skv) d1 = 0.f;
        }
        ds[k] = pack2<T>(d0, d1);
      }
    };
    auto grads_tile = [&](int j) {
      if ((j + 1) * kABN > skv) {
        grads(j, true);
      } else {
        grads(j, false);
      }
    };

    pp.start();
    mbar_wait(&full_q, 0);

    // tile 0: its logit products alone
    mbar_wait(&ring.full[0], 0);
    pp.turn();
    wgmma_fence();
    issue_sdp(0);
    wgmma_commit();
    pp.pass(false);
    wgmma_wait();
    fence_regs(s);
    fence_regs(dp);
    grads_tile(0);

    // tile j: S_j and dP_j issued with dQ += dS_{j-1} K_{j-1}; the
    // elementwise step of tile j runs once they are in, while the other
    // consumers' products hold the tensor cores.
    for (int j = 1; j < ntiles; ++j) {
      const int st = j % kStages;
      const int pst = (j - 1) % kStages;
      mbar_wait(&ring.full[st], (j / kStages) & 1);
      pp.turn();
      wgmma_fence();
      issue_sdp(st);
      issue_dq(pst);
      wgmma_commit();
      pp.pass(false);
      wgmma_wait();
      fence_regs(s);
      fence_regs(dp);
      fence_regs(acc);
      fence_regs(ds);
      release(pst);
      grads_tile(j);
    }

    // the last dQ product
    const int lst = (ntiles - 1) % kStages;
    pp.turn();
    wgmma_fence();
    issue_dq(lst);
    wgmma_commit();
    pp.pass(true);
    wgmma_wait();
    fence_regs(acc);
    fence_regs(ds);
    release(lst);

    store_rows(dq + row0 * kD, acc, r0, sq, tig);
  }
}

// ---------------------------------------------------------------------------
// K3b: dK and dV for one (b*h, 128-key tile)
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kBThreads, 1)
    flash_bwd_dkv_sm90_kernel(const __grid_constant__ CUtensorMap map_q,
                              const __grid_constant__ CUtensorMap map_do,
                              const T* __restrict__ k, const T* __restrict__ v,
                              const float* __restrict__ lse,
                              const float* __restrict__ delta,
                              T* __restrict__ dk, T* __restrict__ dv, int sq, int skv,
                              float scale) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ Ring ring;
  const uint32_t base = aligned_base(smem_raw);
  const uint32_t q_tiles = base;
  const uint32_t do_tiles = q_tiles + kStages * kBTileBytes;
  // kStages slices of lse values, then kStages of delta values
  const uint32_t slices = do_tiles + kStages * kBTileBytes;
  float* slices_p = reinterpret_cast<float*>(smem_raw + (slices - smem_u32(smem_raw)));
  const int bh = blockIdx.y;
  const int k0 = blockIdx.x * kBBN;
  const int ntiles = (sq + kBBM - 1) / kBBM;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int st = 0; st < kStages; ++st) {
      // the TMA issue and the 32 lanes that copy lse and delta
      mbar_init(&ring.full[st], 1 + 32);
      mbar_init(&ring.empty[st], 4 * kBConsumers);  // one arrival per warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // ---------------- producer: one thread issues the TMA loads -------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x == 0) {
      for (int j = 0; j < ntiles; ++j) {
        const int st = j % kStages;
        mbar_wait(&ring.empty[st], ((j / kStages) & 1) ^ 1);
        mbar_expect_tx(&ring.full[st], 2 * kBTileBytes);
        tma_load(q_tiles + st * kBTileBytes, &map_q, &ring.full[st], j * kBBM, bh);
        tma_load(do_tiles + st * kBTileBytes, &map_do, &ring.full[st], j * kBBM, bh);
      }
    } else if (threadIdx.x / 32 == 1) {
      // the second warp: lse and delta of the tile's queries, 0 past the end
      const int lane = threadIdx.x & 31;
      const size_t row0 = static_cast<size_t>(bh) * sq;
      for (int j = 0; j < ntiles; ++j) {
        const int st = j % kStages;
        mbar_wait(&ring.empty[st], ((j / kStages) & 1) ^ 1);
#pragma unroll
        for (int i = lane; i < kBBM; i += 32) {
          const int qi = j * kBBM + i;
          slices_p[st * kBBM + i] = qi < sq ? lse[row0 + qi] : 0.f;
          slices_p[(kStages + st) * kBBM + i] = qi < sq ? delta[row0 + qi] : 0.f;
        }
        mbar_arrive(&ring.full[st]);
      }
    }
  } else {
    // ---------------- consumers: 64 key rows each ----------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kBConsumerRegs));
    const int c = wg - 1;
    const int tid = threadIdx.x - 128 * wg;
    const int warp = tid >> 5;
    const int lane = tid & 31;
    const int tig = lane & 3;
    const PingPong pp{c, kBConsumers};
    const float scale_log2 = scale * kLog2e;
    const int kr0 = k0 + c * 64 + warp * 16 + (lane >> 2);
    const size_t kv_off = static_cast<size_t>(bh) * skv * kD;
    // K and V as register A operands of the logit products: this thread's
    // fragments of its rows kr0 and kr0 + 8, zero past the end
    uint32_t kf[16], vf[16];
    load_a_frags(kf, k + kv_off, kr0, skv, tig);
    load_a_frags(vf, v + kv_off, kr0, skv, tig);

    // Fragments of [64 keys x 64]: element i is key row g + 8 * ((i >> 1) &
    // 1) of the warp's 16, column (query, or d for the accumulators)
    // 8 * (i >> 2) + 2 * tig + (i & 1).
    float acc_dk[32], acc_dv[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) acc_dk[i] = acc_dv[i] = 0.f;
    float s[32];
    float dp[32];
    // p^T and ds^T as pairs of T in the A-register layout
    uint32_t pt[16], dst[16];

    // s^T = K Q_st^T and dP^T = V dO_st^T (4 k16 steps over d each).
    auto issue_sdp = [&](int st) {
      const uint32_t qt = q_tiles + st * kBTileBytes;
      const uint32_t dot = do_tiles + st * kBTileBytes;
#pragma unroll
      for (int kk = 0; kk < kD / 16; ++kk) {
        wgmma_rs<T, 0>(s, kf + 4 * kk, desc_kmajor(qt + kk * 32), kk > 0);
      }
#pragma unroll
      for (int kk = 0; kk < kD / 16; ++kk) {
        wgmma_rs<T, 0>(dp, vf + 4 * kk, desc_kmajor(dot + kk * 32), kk > 0);
      }
    };
    // dV += p^T dO_st and dK += ds^T Q_st (4 k16 steps over the queries).
    auto issue_dkv = [&](int st) {
      const uint32_t qt = q_tiles + st * kBTileBytes;
      const uint32_t dot = do_tiles + st * kBTileBytes;
#pragma unroll
      for (int kk = 0; kk < kBBM / 16; ++kk) {
        wgmma_rs<T, 1>(acc_dv, pt + 4 * kk, desc_mnmajor(dot + kk * 16 * kRowBytes), 1);
      }
#pragma unroll
      for (int kk = 0; kk < kBBM / 16; ++kk) {
        wgmma_rs<T, 1>(acc_dk, dst + 4 * kk, desc_mnmajor(qt + kk * 16 * kRowBytes), 1);
      }
    };
    auto release = [&](int st) {
      if (lane == 0) mbar_arrive(&ring.empty[st]);
    };
    // p^T = exp2(s^T scale log2 e - lse log2 e) and ds^T = p^T (dp^T -
    // delta) scale, lse and delta per column (query) from the staged
    // values, into pairs of T; `masked` on the ragged last tile, whose
    // queries past the end get p = ds = 0.
    auto grads = [&](int j, int st, bool masked) {
      const float* ls = slices_p + st * kBBM;
      const float* dl = slices_p + (kStages + st) * kBBM;
#pragma unroll
      for (int n = 0; n < kBBM / 8; ++n) {
        const int col = n * 8 + tig * 2;
        const float2 lv = *reinterpret_cast<const float2*>(ls + col);
        const float2 dv2 = *reinterpret_cast<const float2*>(dl + col);
        const float l0 = lv.x * kLog2e, l1 = lv.y * kLog2e;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int i = 4 * n + 2 * h;
          float p0 = ex2(fmaf(s[i], scale_log2, -l0));
          float p1 = ex2(fmaf(s[i + 1], scale_log2, -l1));
          float d0 = p0 * (dp[i] - dv2.x) * scale;
          float d1 = p1 * (dp[i + 1] - dv2.y) * scale;
          if (masked) {
            const int qi = j * kBBM + col;
            if (qi >= sq) p0 = d0 = 0.f;
            if (qi + 1 >= sq) p1 = d1 = 0.f;
          }
          pt[2 * n + h] = pack2<T>(p0, p1);
          dst[2 * n + h] = pack2<T>(d0, d1);
        }
      }
    };
    auto grads_tile = [&](int j, int st) {
      if ((j + 1) * kBBM > sq) {
        grads(j, st, true);
      } else {
        grads(j, st, false);
      }
    };

    pp.start();

    // tile 0: its logit products alone
    mbar_wait(&ring.full[0], 0);
    pp.turn();
    wgmma_fence();
    issue_sdp(0);
    wgmma_commit();
    pp.pass(false);
    wgmma_wait();
    fence_regs(s);
    fence_regs(dp);
    grads_tile(0, 0);

    // tile j: s^T_j and dP^T_j issued with dV, dK += tile j-1's products
    for (int j = 1; j < ntiles; ++j) {
      const int st = j % kStages;
      const int pst = (j - 1) % kStages;
      mbar_wait(&ring.full[st], (j / kStages) & 1);
      pp.turn();
      wgmma_fence();
      issue_sdp(st);
      issue_dkv(pst);
      wgmma_commit();
      pp.pass(false);
      wgmma_wait();
      fence_regs(s);
      fence_regs(dp);
      fence_regs(acc_dk);
      fence_regs(acc_dv);
      fence_regs(pt);
      fence_regs(dst);
      release(pst);
      grads_tile(j, st);
    }

    // the last dV and dK products
    const int lst = (ntiles - 1) % kStages;
    pp.turn();
    wgmma_fence();
    issue_dkv(lst);
    wgmma_commit();
    pp.pass(true);
    wgmma_wait();
    fence_regs(acc_dk);
    fence_regs(acc_dv);
    fence_regs(pt);
    fence_regs(dst);
    release(lst);

    store_rows(dk + kv_off, acc_dk, kr0, skv, tig);
    store_rows(dv + kv_off, acc_dv, kr0, skv, tig);
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled is a driver-API function: fetched once through the
// runtime, so the library links against nothing but cudart.
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult status;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault,
                                &status) == cudaSuccess &&
        status == cudaDriverEntryPointSuccess) {
      fn = reinterpret_cast<EncodeTiled>(ptr);
    }
  }
  return fn;
}

// A 3-D map over a contiguous T [bh, s, 64] (bf16 or fp16): boxes of `rows`
// rows of one head, 128B-swizzled; rows past s read as zeros.
template <typename T>
bool make_map(CUtensorMap* map, const void* ptr, int bh, int s, int rows) {
  EncodeTiled encode = encoder();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {kD, static_cast<cuuint64_t>(s),
                              static_cast<cuuint64_t>(bh)};
  const cuuint64_t strides[2] = {kRowBytes, static_cast<cuuint64_t>(s) * kRowBytes};
  const cuuint32_t box[3] = {kD, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t elem_strides[3] = {1, 1, 1};
  return encode(map,
                kHalf<T> ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                3, const_cast<void*>(ptr),
                dims, strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

bool misaligned(const void* p, uintptr_t bytes) {
  return (reinterpret_cast<uintptr_t>(p) & (bytes - 1)) != 0;
}

bool bad_shape(int bh, int sq, int skv, int head_dim) {
  return head_dim != kD || bh <= 0 || sq <= 0 || skv <= 0 || bh > 65535 ||
         static_cast<long long>(bh) * sq >= (1ll << 31);
}

// K3a in the model type T.
template <typename T>
int bwd_dq(const void* q, const void* k, const void* v, const void* dout,
           const void* lse, const void* delta, void* dq, int bh, int sq, int skv,
           int head_dim, float scale, void* stream) {
  if (bad_shape(bh, sq, skv, head_dim) || misaligned(q, 16) || misaligned(k, 16) ||
      misaligned(v, 16) || misaligned(dout, 16) || misaligned(dq, 4)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  CUtensorMap mq, mdo, mk, mv;
  if (!make_map<T>(&mq, q, bh, sq, kABM) || !make_map<T>(&mdo, dout, bh, sq, kABM) ||
      !make_map<T>(&mk, k, bh, skv, kABN) || !make_map<T>(&mv, v, bh, skv, kABN)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_sm90_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kASmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((sq + kABM - 1) / kABM, bh);
  flash_bwd_dq_sm90_kernel<T><<<grid, kAThreads, kASmemBytes,
                                static_cast<cudaStream_t>(stream)>>>(
      mq, mdo, mk, mv, static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<T*>(dq), sq, skv, scale);
  return static_cast<int>(cudaGetLastError());
}

// K3b in the model type T.
template <typename T>
int bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
            const void* lse, const void* delta, void* dk, void* dv, int bh, int sq,
            int skv, int head_dim, float scale, void* stream) {
  if (bad_shape(bh, sq, skv, head_dim) || misaligned(q, 16) || misaligned(k, 4) ||
      misaligned(v, 4) || misaligned(dout, 16) || misaligned(dk, 4) ||
      misaligned(dv, 4)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  CUtensorMap mq, mdo;
  if (!make_map<T>(&mq, q, bh, sq, kBBM) || !make_map<T>(&mdo, dout, bh, sq, kBBM)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_sm90_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kBSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((skv + kBBN - 1) / kBBN, bh);
  flash_bwd_dkv_sm90_kernel<T><<<grid, kBThreads, kBSmemBytes,
                                 static_cast<cudaStream_t>(stream)>>>(
      mq, mdo, static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dk), static_cast<T*>(dv), sq, skv, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The dynamic shared memory a launch asks for: K3a's (Q, dO, the K/V ring)
// with dkv = 0, K3b's (the Q/dO ring with its lse and delta values) with
// dkv = 1; each with slack to align the tiles to 1024 bytes; the same in
// bf16 and fp16.
extern "C" int dove_flash_bwd_sm90_smem_bytes(int dkv) {
  return dkv ? kBSmemBytes : kASmemBytes;
}

// K3a. q, dout: bf16 [bh, sq, 64]; k, v: bf16 [bh, skv, 64]; lse, delta:
// fp32 [bh, sq] (lse in natural-log units, delta = rowsum(dout * out));
// dq: bf16 [bh, sq, 64]. All contiguous on the device; q, k, v and dout
// 16-byte aligned (TMA). Launches on `stream`, returns the cudaError_t of
// the launch (0 on success), does not synchronise.
extern "C" int dove_flash_bwd_dq(const void* q, const void* k, const void* v,
                                 const void* dout, const void* lse,
                                 const void* delta, void* dq, int bh, int sq,
                                 int skv, int head_dim, float scale,
                                 void* stream) {
  return bwd_dq<__nv_bfloat16>(q, k, v, dout, lse, delta, dq, bh, sq, skv, head_dim,
                               scale, stream);
}

// K3a in fp16: dove_flash_bwd_dq's arguments with fp16 q, k, v, dout and dq.
extern "C" int dove_flash_bwd_dq_f16(const void* q, const void* k, const void* v,
                                     const void* dout, const void* lse,
                                     const void* delta, void* dq, int bh, int sq,
                                     int skv, int head_dim, float scale,
                                     void* stream) {
  return bwd_dq<__half>(q, k, v, dout, lse, delta, dq, bh, sq, skv, head_dim, scale,
                        stream);
}

// K3b. The inputs of K3a; dk, dv: bf16 [bh, skv, 64]. All contiguous on the
// device; q and dout 16-byte aligned (TMA), k and v 4-byte. Launches on
// `stream`, returns the cudaError_t of the launch, does not synchronise.
extern "C" int dove_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                  const void* dout, const void* lse,
                                  const void* delta, void* dk, void* dv,
                                  int bh, int sq, int skv, int head_dim,
                                  float scale, void* stream) {
  return bwd_dkv<__nv_bfloat16>(q, k, v, dout, lse, delta, dk, dv, bh, sq, skv,
                                head_dim, scale, stream);
}

// K3b in fp16: dove_flash_bwd_dkv's arguments with fp16 tensors.
extern "C" int dove_flash_bwd_dkv_f16(const void* q, const void* k, const void* v,
                                      const void* dout, const void* lse,
                                      const void* delta, void* dk, void* dv,
                                      int bh, int sq, int skv, int head_dim,
                                      float scale, void* stream) {
  return bwd_dkv<__half>(q, k, v, dout, lse, delta, dk, dv, bh, sq, skv, head_dim,
                         scale, stream);
}
