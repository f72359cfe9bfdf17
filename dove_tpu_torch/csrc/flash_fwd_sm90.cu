// K1 and K2: the flash-attention forward for Hopper (sm_90a), head dim 64.
//
// K1 replaces the TPU kernel dove_tpu/ops/pallas/flash_attention.py:_fwd_kernel
// (pallas_call in _flash_fwd) in its four forms: the bounded-logits form
// (no running max, p = exp2(s * scale * log2 e)) that every inference call
// takes, the online-softmax form (a running max in log2 units), and each of
// them with or without the per-row logsumexp that the backward (K3a, K3b)
// reads, in natural-log units: ln 2 * (m + log2 l) online, ln l bounded.
// Non-causal softmax(scale Q K^T) V with fp32 logits, fp32 row sums, P
// rounded to the model type before P V, an fp32 accumulator and an output in
// the model type. The model type T is bf16 or fp16 (the TPU kernel is
// generic in it: it casts P to v.dtype and writes v.dtype); every form of
// both types is one instantiation of the template. fp16 changes the wgmma
// (.f16.f16 in place of .bf16.bf16, the same dense rate on the H100), the
// pair packing, the TMA data type and the stores, nothing else. Like the TPU
// kernel, the bounded form rounds p to T with no max: an fp16 P is inf for a
// scaled logit above ln 65504 (about 11.09) where a bf16 P is not, and the
// output is then not finite, as JAX's is. The online form's test on the
// packed P (no p above 2^8) sees such an inf and takes the exact row maxima,
// as it does for a bf16 P.
//
// K2 is the same kernel with int8 Q and K: the qk8 branch of _fwd_kernel
// (flash_attention.py:107-114), the int8-dit serving mode's attention.
// q and k arrive as per-tensor symmetric int8 codes (the wrapper quantizes
// them, as the TPU wrapper does outside its pallas_call), Q K^T is exact in
// int32, and the logits are float(q8 . k8) * factor, factor = (s_q s_k) *
// fp32(scale log2 e) one fp32 value the kernel reads from device memory (the
// TPU kernel reads it from SMEM), so the host never waits for it. Bounded
// form only, V and O in the model type (bf16 or fp16), as on the TPU.
// Where it differs from K1:
// - Q and K come through 3-D TMA maps of int8 (64-byte rows, 64B swizzle):
//   Q is 12 KB, a K tile 8 KB, V stays K1's 16 KB bf16 tile.
// - S = Q K^T is wgmma m64n128k32 .s32.s8.s8, two k32 steps of 32 bytes into
//   each 64-byte row, both operands K-major from shared memory (the only
//   layout wgmma takes for 8-bit operands); the s32 accumulator has the fp32
//   one's fragment layout, so K1's softmax and P packing apply.
// - int32 -> fp32 by a preset instead of a conversion: |q8 . k8| <=
//   127^2 * 64 = 1,032,256 < 2^22, so an accumulator preset to 0x4B400000
//   (the bits of 1.5 * 2^23) holds, read as fp32, exactly 12582912 + x. One
//   FFMA with factor and -12582912 * factor gives the log2 logit. The
//   factor is first rounded to 22 significant bits (a relative change of at
//   most 2^-22), which makes -12582912 * factor exact, so the FFMA yields
//   x * factor rounded once. With the factor as it is, the rounding of
//   -12582912 * factor would shift every logit alike; that does not cancel
//   in p / l, because P is rounded to T before P V and l sums the
//   unrounded p, and at one key (out = T(p) / p * v) it showed as one-ulp
//   flips of the bf16 output. The argument does not depend on T: with an
//   fp16 P the logit is the same x * factor rounded once, so T(p) / p is
//   the plain version's at every key. Subtracting 12582912 first and multiplying
//   (JAX's float(x) * factor bit for bit) costs one more FADD an element
//   and measured slower in this three-stage ring; so did cvt.rn.f32.s32
//   with no preset (it lowers to I2FP.F32.S32 here, an ALU op, not the
//   quarter-rate I2F).
//
// What bounds them on the H100. At the main-path shape [1, 48, 19426, 64] one
// K1 launch does 4 S^2 D H = 4.64 TFLOP of bf16 tensor-core work (4.69 ms at
// 989 TFLOP/s), one K2 launch half that in int8 at twice the rate and half
// in bf16 (3.52 ms); both take S^2 H = 1.81e10 exponentials, which the SFU
// retires at 16 ex2 a clock per SM, 4.3-4.9 ms at the clocks the card runs.
// At D = 64 the two are co-bounds of about the same size, so the kernel
// reaches either only if the exponentials run while the tensor cores work.
// The bytes (0.48 GB for K1, 0.36 GB for K2) are ~0.15 ms.
//
// Design (one CTA per (192-query tile, b*h), 512 threads):
// - Warp specialisation. Warpgroup 0 is the producer: it gives up registers
//   (setmaxnreg, 24 a thread) and one thread issues every TMA load.
//   Warpgroups 1-3 are consumers (160 registers), each owning 64 query rows;
//   their S, P and O live in registers for the whole key loop. Three
//   consumers of 64 rows beat two (a 128-row tile) on both shapes: one more
//   warpgroup to fill the tensor cores while the others exponentiate, and
//   K and V read once for 192 queries.
// - TMA and an mbarrier ring. Q (192 x 64) is loaded once; K and V tiles of
//   128 keys x 64 (16 KB of bf16 in 128-byte rows, 128B swizzle) stream
//   through a three-stage ring (two stages starve the consumers) with full
//   barriers (K and V apart, so Q K^T starts before V lands) and one empty
//   barrier per stage. No __syncthreads in the loop. The maps are 3-D over
//   [b*h, S, 64], so a tile past the end of a head reads zeros, never the
//   next head's keys.
// - S = Q K^T is wgmma m64n128k16 (K2: m64n128k32 s8) with both operands in
//   shared memory, K K-major as stored. O += P V is wgmma m64n64k16 with A =
//   P from registers (the S accumulator's fragment packs to bf16 in the
//   A-register layout) and B = V read MN-major (the transpose bit).
// - Overlap. A consumer issues Q K_j^T together with P_{j-1} V_{j-1}, then
//   exponentiates S_j. Named barriers pass the issue turn round the three
//   consumers (ping-pong), so their GEMMs take the tensor cores in turn
//   while the other two run their softmax. (Issuing Q K_{j+1}^T before the
//   softmax of S_j within a warpgroup needs a second P buffer, which does
//   not fit in 160 registers; with two consumers it was slower than this.)
// - The softmax is where the time goes: 64 ex2 a thread a tile, each with a
//   multiply and an add, and a pack per pair. Nothing else may sit beside
//   them: the kv tail's -inf mask is a separate inlined copy for the ragged
//   last tile only, and the online form does not wait for the tile's max.
//   It exponentiates against the running max as it stands and checks, on
//   the packed bf16 P (one max per pair), that no p exceeds 2^8; only then
//   (the first tile, and rarely after) does it take the exact row maxima
//   from S, which is kept, move them, and redo those rows. l and O carry
//   the same offset, so the result is the same softmax. K2 needs the mask
//   as much as K1: a key past the end reads as zero codes, x = 0, p = 1.
//   The bounded form keeps per-thread partial row sums and reduces them
//   once at the end. A share of the exponentials as a polynomial on the FMA
//   pipes ran slower: the loop is bound by instruction issue and latency,
//   not by the SFU. K2's preset adds a move a logit, placed by ptxas between
//   the wait for K and the issue turn; moving it beside the ex2 was slower.
// - Query rows past the end are computed on zeros and not stored: the
//   epilogue writes O / l as bf16 pairs straight from registers, guarded
//   per row, and the lse per row in the kLse forms only.

// K1 at head dim 128 (flash_fwd_sm90_kernel_d128, bf16, the online form
// without the logsumexp: the serving forward of Wan2.1, whose q and k RMS
// norms span all heads, so one head's logit can pass 400 and the bounded
// form would overflow). A kernel of its own beside the one above, whose
// head-64 instantiations it leaves as they are; it shares the barriers, the
// TMA load, the wgmma wrappers and the softmax's lazy rescale. FA3's layout
// for head dim 128:
// - 128 query rows a CTA as two consumer warpgroups of 64 (240 registers),
//   one producer warpgroup (24); 384 threads.
// - 128 keys a tile. A row of 128 values is 256 bytes, twice what one
//   128B-swizzled TMA box holds, so Q and each K and V tile are two halves
//   of [rows x 64], each loaded as one box at d = 0 and d = 64: Q 32 KB and
//   K and V 32 KB a tile. Three stages: 32 + 3 x 64 = 224 KB of shared
//   memory. FA3's two stages (160 KB) ran at 45.1 ms at the shape below,
//   three at 36.7 (phase 36): with two consumers the ring must hide a whole
//   tile's loads behind one consumer's softmax.
// - S = Q K^T: eight k16 steps of m64n128k16, four in each half of d.
//   O += P V: one m64n128k16 a k16 step of keys, V read MN-major across both
//   halves (atoms of 64 d values 16 KB apart: the descriptor's leading
//   offset; 8-key groups 1024 bytes apart: its stride offset). O is two
//   accumulators of 32 registers, columns 0-63 and 64-127 (two m64n64k16
//   per step, one a half, measured the same).
// - The ping-pong, the ragged-tail mask and the online softmax are the head-64
//   kernel's. The bound at [1, 40, 34560, 128]: 2.45e13 ops, 24.7 ms at
//   989 TFLOP/s, against 4.78e10 exponentials, about 13.7 ms of SFU: at
//   head dim 128 the MMAs bound it, where at 64 the two are co-bounds.

#include <cuda.h>  // CUtensorMap and its enums; the encoder comes through the runtime
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <initializer_list>
#include <type_traits>

namespace {

constexpr int kD = 64;                   // head dim
constexpr int kBM = 192;                 // query rows per CTA
constexpr int kBN = 128;                 // keys per tile
constexpr int kStages = 3;               // K/V ring depth
constexpr int kConsumers = kBM / 64;     // consumer warpgroups, 64 rows each
constexpr int kThreads = 128 * (1 + kConsumers);
constexpr int kVTileBytes = kBN * kD * 2;  // 16 KB, a bf16 or fp16 V tile
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 160;
// The online form lets p reach 2^kLazyLog2 before a row moves its running
// max (log2 units).
constexpr int kLazyLog2 = 8;
constexpr float kLazyMax = 1 << kLazyLog2;

static_assert(128 * kProducerRegs + 128 * kConsumers * kConsumerRegs <= 65536,
              "register split exceeds the SM's file");

// K2's int32 -> fp32 route: an accumulator preset to these bits holds, read
// as fp32, exactly kMagic + x for |x| < 2^22 (|q8 . k8| <= 127^2 * 64).
constexpr uint32_t kMagicBits = 0x4B400000u;
constexpr float kMagic = 12582912.f;  // 1.5 * 2^23
static_assert(127 * 127 * kD < (1 << 22), "int8 logits leave the exact range");

// Shared-memory geometry by the element type of Q and K: bf16 or fp16 (K1)
// or int8 codes (K2). A row of 64 values is 128 or 64 bytes, TMA's swizzle as
// wide.
template <typename QK>
struct Geometry {
  static constexpr bool kInt8 = std::is_same<QK, int8_t>::value;
  static constexpr int kRowBytes = kD * static_cast<int>(sizeof(QK));
  static constexpr int kQBytes = kBM * kRowBytes;      // 24 or 12 KB
  static constexpr int kKTileBytes = kBN * kRowBytes;  // 16 or 8 KB
  // + slack to align the tiles to 1024 bytes
  static constexpr int kSmemBytes =
      1024 + kQBytes + kStages * (kKTileBytes + kVTileBytes);
  // the S accumulator: fp32, or s32 read back as fp32 bits
  using Acc = typename std::conditional<kInt8, uint32_t, float>::type;
};

// The model type's pair of values in one register, and its rounding.
template <typename T>
struct Pair;
template <>
struct Pair<__nv_bfloat16> {
  using type = __nv_bfloat162;
  static __device__ __forceinline__ type round(float lo, float hi) {
    return __floats2bfloat162_rn(lo, hi);
  }
};
template <>
struct Pair<__half> {
  using type = __half2;
  static __device__ __forceinline__ type round(float lo, float hi) {
    return __floats2half2_rn(lo, hi);
  }
};

template <typename T>
constexpr bool kHalf = std::is_same<T, __half>::value;

struct Barriers {
  uint64_t full_q;
  uint64_t full_k[kStages];
  uint64_t full_v[kStages];
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

// Named barriers 1..kConsumers order the consumers' issue sections: each
// is met by the warpgroup that waits for its turn and the one before it.
__device__ __forceinline__ void bar_sync(int id) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(id) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(id) : "memory");
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

// Shared-memory matrix descriptor: start address, leading and stride byte
// offsets, all in 16-byte units, and the swizzle mode (1: 128B, 2: 64B).
// Tiles start 1024-aligned.
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo, uint64_t mode = 1) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (mode << 62);
}

// K-major (Q, K): a k step (16 bf16 or 32 int8 values) is 32 bytes into each
// swizzled row; 8-row groups are 8 rows apart, 1024 bytes in bf16's 128B
// swizzle and 512 in int8's 64B one; the leading offset is unused.
template <typename QK>
__device__ __forceinline__ uint64_t desc_kmajor(uint32_t addr) {
  if constexpr (Geometry<QK>::kInt8) return make_desc(addr, 16, 512, 2);
  return make_desc(addr, 16, 1024);
}

// MN-major (V as B of P V, d contiguous): the 64 d values of a key are one
// swizzle atom, so the offset between atoms along d is never used; the
// 8-key groups are 1024 bytes apart. Both offsets are set to 1024, which is
// right whichever of the two the unit reads for the k direction.
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
#define DOVE_ACC64(C)                                                        \
  DOVE_ACC32(C), DOVE_ACC8(C, 32), DOVE_ACC8(C, 40), DOVE_ACC8(C, 48),       \
      DOVE_ACC8(C, 56)
#define DOVE_REGS32                                                          \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31}"
#define DOVE_REGS64                                                          \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "  \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "  \
  "%58, %59, %60, %61, %62, %63}"
#define DOVE_RW_F32(x) "+f"(x)
#define DOVE_RW_S32(x) "+r"(x)
// d[64 x 128] (+)= A[64 x 16] B[16 x 128] in T (bf16 or fp16), fp32 sums;
// the instruction differs only in its type suffix
#define DOVE_WGMMA_QK(TY)                                                    \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"                  \
               "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " "   \
               DOVE_REGS64 ", %64, %65, p, 1, 1, 0, 0;\n}\n"                 \
               : DOVE_ACC64(DOVE_RW_F32)                                    \
               : "l"(desc_a), "l"(desc_b), "r"(scale_d))

// d[64 x 128] (+)= A[64 x 16] B[16 x 128]; A, B from shared memory, K-major.
template <typename T>
__device__ __forceinline__ void wgmma_qk(float (&d)[64], uint64_t desc_a,
                                         uint64_t desc_b, int scale_d) {
  if constexpr (kHalf<T>) {
    DOVE_WGMMA_QK("f16");
  } else {
    DOVE_WGMMA_QK("bf16");
  }
}

// d[64 x 128] += A[64 x 32] B[32 x 128], int8 codes, int32 sums (exact); A,
// B from shared memory, K-major (8-bit operands have no transpose bit).
__device__ __forceinline__ void wgmma_qk(uint32_t (&d)[64], uint64_t desc_a,
                                         uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 " DOVE_REGS64
      ", %64, %65, p;\n}\n"
      : DOVE_ACC64(DOVE_RW_S32)
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

#define DOVE_WGMMA_PV(TY)                                                    \
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"                  \
               "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " "    \
               DOVE_REGS32 ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"    \
               : DOVE_ACC32(DOVE_RW_F32)                                    \
               : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(desc_b), "r"(1))

// d[64 x 64] += A[64 x 16] B[16 x 64] in T; A from registers (pairs of T),
// B from shared memory MN-major (transpose bit set).
template <typename T>
__device__ __forceinline__ void wgmma_pv(float (&d)[32], uint32_t a0,
                                         uint32_t a1, uint32_t a2, uint32_t a3,
                                         uint64_t desc_b) {
  if constexpr (kHalf<T>) {
    DOVE_WGMMA_PV("f16");
  } else {
    DOVE_WGMMA_PV("bf16");
  }
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Two fp32 values rounded to a pair of T, as one register.
template <typename T>
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  typename Pair<T>::type v = Pair<T>::round(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// T: the model type (bf16 or fp16) of V, P and O. QK = T: K1, scale_log2 =
// scale * log2 e, factor unused. QK = int8_t: K2 (kBounded, no lse), the
// logits scaled by *factor with one FFMA (the header).
template <typename T, typename QK, bool kBounded, bool kLse>
__global__ void __launch_bounds__(kThreads, 1)
    flash_fwd_sm90_kernel(const __grid_constant__ CUtensorMap map_q,
                          const __grid_constant__ CUtensorMap map_k,
                          const __grid_constant__ CUtensorMap map_v,
                          T* __restrict__ o, float* __restrict__ lse,
                          int sq, int skv, float scale_log2,
                          const float* __restrict__ factor_ptr) {
  static_assert(std::is_same<QK, T>::value || std::is_same<QK, int8_t>::value,
                "Q and K are the model type (K1) or int8 codes (K2)");
  using G = Geometry<QK>;
  static_assert(!G::kInt8 || (kBounded && !kLse), "K2 is the bounded form only");
  extern __shared__ uint8_t smem_raw[];
  __shared__ Barriers bars;
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_tile = base;
  const uint32_t k_tiles = base + G::kQBytes;
  const uint32_t v_tiles = k_tiles + kStages * G::kKTileBytes;
  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * kBM;
  const int ntiles = (skv + kBN - 1) / kBN;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(&bars.full_q, 1);
#pragma unroll
    for (int st = 0; st < kStages; ++st) {
      mbar_init(&bars.full_k[st], 1);
      mbar_init(&bars.full_v[st], 1);
      mbar_init(&bars.empty[st], 4 * kConsumers);  // one arrival per warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // ---------------- producer: one thread issues every load ----------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x == 0) {
      mbar_expect_tx(&bars.full_q, G::kQBytes);
      tma_load(q_tile, &map_q, &bars.full_q, q0, bh);
      for (int j = 0; j < ntiles; ++j) {
        const int st = j % kStages;
        mbar_wait(&bars.empty[st], ((j / kStages) & 1) ^ 1);
        mbar_expect_tx(&bars.full_k[st], G::kKTileBytes);
        tma_load(k_tiles + st * G::kKTileBytes, &map_k, &bars.full_k[st], j * kBN, bh);
        mbar_expect_tx(&bars.full_v[st], kVTileBytes);
        tma_load(v_tiles + st * kVTileBytes, &map_v, &bars.full_v[st], j * kBN, bh);
      }
    }
  } else {
    // ---------------- consumers: 64 query rows each ----------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    const int c = wg - 1;
    const int tid = threadIdx.x - 128 * wg;
    const int warp = tid >> 5;
    const int lane = tid & 31;
    const int g = lane >> 2;   // fragment row within the warp's 8-row group
    const int tig = lane & 3;  // fragment column pair
    // ping-pong: this warpgroup waits on barrier 1 + c for its turn, then
    // passes the turn on to the next one
    const int my_bar = 1 + c;
    const int next_bar = 1 + (c + 1) % kConsumers;
    const uint32_t q_rows = q_tile + c * 64 * G::kRowBytes;
    // K2: the factor on the int32 logits, and the offset that the preset's
    // kMagic contributes; read once, no host sync. The factor is rounded to
    // 22 significant bits, which makes kMagic * factor (3 * 2^22 * factor)
    // exact, so that the FFMA gives x * factor rounded once.
    float factor = 0.f, offset = 0.f;
    if constexpr (G::kInt8) {
      factor = *factor_ptr;
      factor = __uint_as_float((__float_as_uint(factor) + 2u) & ~3u);
      offset = -kMagic * factor;
    }

    // Accumulator fragments: element i of s (and of acc) is row g + 8 * ((i
    // >> 1) & 1) of the warp's 16, column 8 * (i >> 2) + 2 * tig + (i & 1).
    float acc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = 0.f;
    typename G::Acc s[64];
    // P as pairs of T in the A-register layout: pair k holds s[2k], s[2k + 1],
    // of row (k & 1).
    uint32_t p[32];
    float lsum[2] = {0.f, 0.f};              // this thread's partial row sums
    float mrow[2] = {-INFINITY, -INFINITY};  // online form: running max (log2)

    // Q K_j^T into s: 32 bytes of each row a step, 4 k16 steps over d in
    // bf16 (the first overwrites s), 2 k32 steps in int8 (accumulating onto
    // the preset).
    auto issue_qk = [&](int st) {
      const uint32_t kt = k_tiles + st * G::kKTileBytes;
#pragma unroll
      for (int kk = 0; kk < G::kRowBytes / 32; ++kk) {
        const uint64_t da = desc_kmajor<QK>(q_rows + kk * 32);
        const uint64_t db = desc_kmajor<QK>(kt + kk * 32);
        if constexpr (G::kInt8) {
          wgmma_qk(s, da, db);
        } else {
          wgmma_qk<T>(s, da, db, kk > 0);
        }
      }
    };
    // K2: s = kMagicBits before Q K^T, so that it comes out as kMagic + x.
    auto preset = [&]() {
      if constexpr (G::kInt8) {
#pragma unroll
        for (int i = 0; i < 64; ++i) s[i] = kMagicBits;
      }
    };
    // acc += P V_st (8 k16 steps over the tile's keys).
    auto issue_pv = [&](int st) {
      const uint32_t vt = v_tiles + st * kVTileBytes;
#pragma unroll
      for (int kk = 0; kk < kBN / 16; ++kk) {
        wgmma_pv<T>(acc, p[4 * kk], p[4 * kk + 1], p[4 * kk + 2], p[4 * kk + 3],
                 desc_mnmajor(vt + kk * 16 * kD * 2));
      }
    };
    auto release = [&](int st) {
      if (lane == 0) mbar_arrive(&bars.empty[st]);
    };
    // The second half of an issue section: pass the turn on. The last
    // consumer does not after its last section, which balances its arrival
    // before the first.
    auto pass_turn = [&](bool last) {
      if (!last || c != kConsumers - 1) bar_arrive(next_bar);
    };
    // The softmax of tile j from s into p; `masked` on the ragged last tile,
    // whose keys past the end get p = 0 (a separate inlined copy, so that
    // the other tiles carry no per-element test).
    //
    // Bounded: p = exp2(s * scale_log2). Online: p = exp2(s * scale_log2 -
    // m) against the running max m as it stands; the tile's max is not
    // waited for. A row moves m only when some p of the warp exceeds
    // 2^kLazyLog2 (on the first tile m = -inf): then the exact row maxima
    // are taken from s, which is kept, and each row whose max rose above m
    // by more than kLazyLog2 redoes its exponentials. l and O carry the same
    // offset, so the softmax is the same. Returns whether acc must be scaled
    // by alpha.
    auto softmax = [&](int j, float (&alpha)[2], bool masked) -> bool {
      if (masked) {
        const int kv0 = j * kBN;
#pragma unroll
        for (int i = 0; i < 64; ++i) {
          if (kv0 + (i >> 2) * 8 + tig * 2 + (i & 1) >= skv) {
            if constexpr (G::kInt8) {
              s[i] = __float_as_uint(-INFINITY);
            } else {
              s[i] = -INFINITY;
            }
          }
        }
      }
      // the bounded form's logit in log2 units
      auto logit2 = [&](int i) -> float {
        if constexpr (!G::kInt8) {
          return s[i] * scale_log2;
        } else {
          return fmaf(__uint_as_float(s[i]), factor, offset);
        }
      };
      if constexpr (kBounded) {
#pragma unroll
        for (int k = 0; k < 32; ++k) {
          const float e0 = ex2(logit2(2 * k));
          const float e1 = ex2(logit2(2 * k + 1));
          lsum[k & 1] += e0;
          lsum[k & 1] += e1;
          p[k] = pack2<T>(e0, e1);
        }
        return false;
      } else {
        float sum[2] = {0.f, 0.f};
        using P2 = typename Pair<T>::type;
        P2 pmax = Pair<T>::round(0.f, 0.f);
#pragma unroll
        for (int k = 0; k < 32; ++k) {
          const int r = k & 1;
          const float e0 = ex2(fmaf(s[2 * k], scale_log2, -mrow[r]));
          const float e1 = ex2(fmaf(s[2 * k + 1], scale_log2, -mrow[r]));
          sum[r] += e0;
          sum[r] += e1;
          const P2 pk = Pair<T>::round(e0, e1);
          pmax = __hmax2(pmax, pk);
          p[k] = *reinterpret_cast<const uint32_t*>(&pk);
        }
        const float big = fmaxf(__low2float(pmax), __high2float(pmax));
        const bool rescale = __any_sync(0xffffffffu, !(big <= kLazyMax));
        if (rescale) {  // rare after the first tile
          bool grow[2];
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            float mx = s[2 * r];
#pragma unroll
            for (int i = 2 * r; i < 64; i += 4) mx = fmaxf(mx, fmaxf(s[i], s[i + 1]));
            mx *= scale_log2;
            mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
            mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
            grow[r] = mx > mrow[r] + kLazyLog2;
            alpha[r] = 1.f;
            if (grow[r]) {
              alpha[r] = ex2(mrow[r] - mx);
              mrow[r] = mx;
              lsum[r] *= alpha[r];
              sum[r] = 0.f;
            }
          }
#pragma unroll
          for (int k = 0; k < 32; ++k) {
            const int r = k & 1;
            if (grow[r]) {
              const float e0 = ex2(fmaf(s[2 * k], scale_log2, -mrow[r]));
              const float e1 = ex2(fmaf(s[2 * k + 1], scale_log2, -mrow[r]));
              sum[r] += e0;
              sum[r] += e1;
              p[k] = pack2<T>(e0, e1);
            }
          }
        }
        lsum[0] += sum[0];
        lsum[1] += sum[1];
        return rescale;
      }
    };
    auto softmax_tile = [&](int j, float (&alpha)[2]) -> bool {
      return (j + 1) * kBN > skv ? softmax(j, alpha, true) : softmax(j, alpha, false);
    };

    if (c == kConsumers - 1) bar_arrive(next_bar);  // the first consumer goes first
    mbar_wait(&bars.full_q, 0);

    // tile 0: Q K_0^T alone
    preset();
    mbar_wait(&bars.full_k[0], 0);
    bar_sync(my_bar);
    wgmma_fence();
    issue_qk(0);
    wgmma_commit();
    pass_turn(false);
    wgmma_wait();
    fence_regs(s);
    float alpha[2];
    softmax_tile(0, alpha);  // acc is still 0: nothing to rescale

    // tile j: S_j = Q K_j^T and O += P_{j-1} V_{j-1} issued together; the
    // softmax of S_j runs once both are in, while the other consumers' GEMMs
    // hold the tensor cores.
    for (int j = 1; j < ntiles; ++j) {
      const int st = j % kStages;
      const int pst = (j - 1) % kStages;
      preset();
      mbar_wait(&bars.full_k[st], (j / kStages) & 1);
      mbar_wait(&bars.full_v[pst], ((j - 1) / kStages) & 1);
      bar_sync(my_bar);
      wgmma_fence();
      issue_qk(st);
      issue_pv(pst);
      wgmma_commit();
      pass_turn(false);
      wgmma_wait();
      fence_regs(s);
      fence_regs(acc);
      fence_regs(p);
      release(pst);
      if (softmax_tile(j, alpha)) {
#pragma unroll
        for (int i = 0; i < 32; ++i) acc[i] *= alpha[(i >> 1) & 1];
      }
    }

    // the last P V
    const int lst = (ntiles - 1) % kStages;
    mbar_wait(&bars.full_v[lst], ((ntiles - 1) / kStages) & 1);
    bar_sync(my_bar);
    wgmma_fence();
    issue_pv(lst);
    wgmma_commit();
    pass_turn(true);
    wgmma_wait();
    fence_regs(acc);
    fence_regs(p);
    release(lst);

    // epilogue: row sums across the quad, O / l to T, the lse
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      lsum[r] += __shfl_xor_sync(0xffffffffu, lsum[r], 1);
      lsum[r] += __shfl_xor_sync(0xffffffffu, lsum[r], 2);
    }
    const float inv0 = 1.f / lsum[0];
    const float inv1 = 1.f / lsum[1];
    const int r0 = q0 + c * 64 + warp * 16 + g;
    const int r1 = r0 + 8;
    T* ob = o + static_cast<size_t>(bh) * sq * kD;
    if constexpr (kLse) {
      if (tig == 0) {
        constexpr float kLn2 = 0.6931471805599453f;
        float* lb = lse + static_cast<size_t>(bh) * sq;
        const float m0 = kBounded ? 0.f : mrow[0];
        const float m1 = kBounded ? 0.f : mrow[1];
        if (r0 < sq) lb[r0] = (m0 + log2f(lsum[0])) * kLn2;
        if (r1 < sq) lb[r1] = (m1 + log2f(lsum[1])) * kLn2;
      }
    }
#pragma unroll
    for (int n = 0; n < kD / 8; ++n) {
      const int col = n * 8 + tig * 2;
      if (r0 < sq) {
        *reinterpret_cast<uint32_t*>(ob + static_cast<size_t>(r0) * kD + col) =
            pack2<T>(acc[4 * n] * inv0, acc[4 * n + 1] * inv0);
      }
      if (r1 < sq) {
        *reinterpret_cast<uint32_t*>(ob + static_cast<size_t>(r1) * kD + col) =
            pack2<T>(acc[4 * n + 2] * inv1, acc[4 * n + 3] * inv1);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// K1 at head dim 128
// ---------------------------------------------------------------------------

constexpr int kD128 = 128;
constexpr int kBM128 = 128;                    // query rows per CTA
constexpr int kStages128 = 3;                  // K/V ring depth
constexpr int kConsumers128 = kBM128 / 64;     // 2 consumer warpgroups
constexpr int kThreads128 = 128 * (1 + kConsumers128);
constexpr int kHalfRows = 64;                  // d values in one swizzled half
constexpr int kQHalfBytes = kBM128 * kHalfRows * 2;  // 16 KB
constexpr int kKVHalfBytes = kBN * kHalfRows * 2;    // 16 KB
constexpr int kQBytes128 = 2 * kQHalfBytes;          // 32 KB
constexpr int kKVTileBytes128 = 2 * kKVHalfBytes;    // 32 KB
constexpr int kSmemBytes128 = 1024 + kQBytes128 + kStages128 * 2 * kKVTileBytes128;
constexpr int kConsumerRegs128 = 240;
// V as B of P V across both halves, MN-major: 64-value atoms kKVHalfBytes
// apart (leading offset), 8-key groups 1024 bytes apart (stride offset)
constexpr uint32_t kPvLbo128 = kKVHalfBytes, kPvSbo128 = 1024;

#define DOVE_A(C, arr, n) C(arr[n])
#define DOVE_A8(C, arr, n)                                                      \
  DOVE_A(C, arr, n), DOVE_A(C, arr, n + 1), DOVE_A(C, arr, n + 2),              \
      DOVE_A(C, arr, n + 3), DOVE_A(C, arr, n + 4), DOVE_A(C, arr, n + 5),      \
      DOVE_A(C, arr, n + 6), DOVE_A(C, arr, n + 7)
#define DOVE_A32(C, arr) \
  DOVE_A8(C, arr, 0), DOVE_A8(C, arr, 8), DOVE_A8(C, arr, 16), DOVE_A8(C, arr, 24)

// [d0 | d1][64 x 128] += A[64 x 16] B[16 x 128] in bf16; A from registers, B
// from shared memory MN-major; d0 holds columns 0-63, d1 64-127.
__device__ __forceinline__ void wgmma_pv128(float (&d0)[32], float (&d1)[32], uint32_t a0,
                                            uint32_t a1, uint32_t a2, uint32_t a3,
                                            uint64_t desc_b) {
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
               "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " DOVE_REGS64
               ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
               : DOVE_A32(DOVE_RW_F32, d0), DOVE_A32(DOVE_RW_F32, d1)
               : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(desc_b), "r"(1));
}

static_assert(128 * kProducerRegs + 128 * kConsumers128 * kConsumerRegs128 <= 65536,
              "register split exceeds the SM's file");

struct Barriers128 {
  uint64_t full_q;
  uint64_t full_k[kStages128];
  uint64_t full_v[kStages128];
  uint64_t empty[kStages128];
};

// One box of a 3-D map at (d0, row, bh), completing on `bar`.
__device__ __forceinline__ void tma_load_at(uint32_t dst, const CUtensorMap* map,
                                            uint64_t* bar, int d0, int row, int bh) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(d0),
      "r"(row), "r"(bh)
      : "memory");
}

// A tile of `rows` x 128 as two halves of rows x 64, `half_bytes` apart.
__device__ __forceinline__ void tma_load_tile(uint32_t dst, const CUtensorMap* map,
                                              uint64_t* bar, int row, int bh,
                                              int half_bytes) {
  tma_load_at(dst, map, bar, 0, row, bh);
  tma_load_at(dst + half_bytes, map, bar, kHalfRows, row, bh);
}

template <typename T>
__global__ void __launch_bounds__(kThreads128, 1)
    flash_fwd_sm90_kernel_d128(const __grid_constant__ CUtensorMap map_q,
                               const __grid_constant__ CUtensorMap map_k,
                               const __grid_constant__ CUtensorMap map_v,
                               T* __restrict__ o, int sq, int skv, float scale_log2) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ Barriers128 bars;
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_tile = base;
  const uint32_t k_tiles = base + kQBytes128;
  const uint32_t v_tiles = k_tiles + kStages128 * kKVTileBytes128;
  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * kBM128;
  const int ntiles = (skv + kBN - 1) / kBN;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(&bars.full_q, 1);
#pragma unroll
    for (int st = 0; st < kStages128; ++st) {
      mbar_init(&bars.full_k[st], 1);
      mbar_init(&bars.full_v[st], 1);
      mbar_init(&bars.empty[st], 4 * kConsumers128);  // one arrival per warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // ---------------- producer: one thread issues every load ----------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x == 0) {
      mbar_expect_tx(&bars.full_q, kQBytes128);
      tma_load_tile(q_tile, &map_q, &bars.full_q, q0, bh, kQHalfBytes);
      for (int j = 0; j < ntiles; ++j) {
        const int st = j % kStages128;
        mbar_wait(&bars.empty[st], ((j / kStages128) & 1) ^ 1);
        mbar_expect_tx(&bars.full_k[st], kKVTileBytes128);
        tma_load_tile(k_tiles + st * kKVTileBytes128, &map_k, &bars.full_k[st], j * kBN,
                      bh, kKVHalfBytes);
        mbar_expect_tx(&bars.full_v[st], kKVTileBytes128);
        tma_load_tile(v_tiles + st * kKVTileBytes128, &map_v, &bars.full_v[st], j * kBN,
                      bh, kKVHalfBytes);
      }
    }
  } else {
    // ---------------- consumers: 64 query rows each ----------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs128));
    const int c = wg - 1;
    const int tid = threadIdx.x - 128 * wg;
    const int warp = tid >> 5;
    const int lane = tid & 31;
    const int g = lane >> 2;
    const int tig = lane & 3;
    const int my_bar = 1 + c;
    const int next_bar = 1 + (c + 1) % kConsumers128;
    // this consumer's 64 rows in each half of Q (128 bytes a row)
    const uint32_t q_rows = q_tile + c * 64 * 128;

    float acc[2][32];  // O, by half of d
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[h][i] = 0.f;
    }
    float s[64];
    uint32_t p[32];
    float lsum[2] = {0.f, 0.f};
    float mrow[2] = {-INFINITY, -INFINITY};

    auto issue_qk = [&](int st) {
      const uint32_t kt = k_tiles + st * kKVTileBytes128;
#pragma unroll
      for (int kk = 0; kk < kD128 / 16; ++kk) {
        const uint32_t off = (kk / 4) * kQHalfBytes + (kk % 4) * 32;
        const uint32_t koff = (kk / 4) * kKVHalfBytes + (kk % 4) * 32;
        wgmma_qk<T>(s, desc_kmajor<T>(q_rows + off), desc_kmajor<T>(kt + koff), kk > 0);
      }
    };
    auto issue_pv = [&](int st) {
      const uint32_t vt = v_tiles + st * kKVTileBytes128;
#pragma unroll
      for (int kk = 0; kk < kBN / 16; ++kk) {
        wgmma_pv128(acc[0], acc[1], p[4 * kk], p[4 * kk + 1], p[4 * kk + 2], p[4 * kk + 3],
                    make_desc(vt + kk * 16 * kHalfRows * 2, kPvLbo128, kPvSbo128));
      }
    };
    auto release = [&](int st) {
      if (lane == 0) mbar_arrive(&bars.empty[st]);
    };
    auto pass_turn = [&](bool last) {
      if (!last || c != kConsumers128 - 1) bar_arrive(next_bar);
    };
    // The head-64 kernel's online softmax (its comment), on this tile's s.
    auto softmax = [&](int j, float (&alpha)[2], bool masked) -> bool {
      if (masked) {
        const int kv0 = j * kBN;
#pragma unroll
        for (int i = 0; i < 64; ++i) {
          if (kv0 + (i >> 2) * 8 + tig * 2 + (i & 1) >= skv) s[i] = -INFINITY;
        }
      }
      float sum[2] = {0.f, 0.f};
      using P2 = typename Pair<T>::type;
      P2 pmax = Pair<T>::round(0.f, 0.f);
#pragma unroll
      for (int k = 0; k < 32; ++k) {
        const int r = k & 1;
        const float e0 = ex2(fmaf(s[2 * k], scale_log2, -mrow[r]));
        const float e1 = ex2(fmaf(s[2 * k + 1], scale_log2, -mrow[r]));
        sum[r] += e0;
        sum[r] += e1;
        const P2 pk = Pair<T>::round(e0, e1);
        pmax = __hmax2(pmax, pk);
        p[k] = *reinterpret_cast<const uint32_t*>(&pk);
      }
      const float big = fmaxf(__low2float(pmax), __high2float(pmax));
      const bool rescale = __any_sync(0xffffffffu, !(big <= kLazyMax));
      if (rescale) {
        bool grow[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float mx = s[2 * r];
#pragma unroll
          for (int i = 2 * r; i < 64; i += 4) mx = fmaxf(mx, fmaxf(s[i], s[i + 1]));
          mx *= scale_log2;
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
          grow[r] = mx > mrow[r] + kLazyLog2;
          alpha[r] = 1.f;
          if (grow[r]) {
            alpha[r] = ex2(mrow[r] - mx);
            mrow[r] = mx;
            lsum[r] *= alpha[r];
            sum[r] = 0.f;
          }
        }
#pragma unroll
        for (int k = 0; k < 32; ++k) {
          const int r = k & 1;
          if (grow[r]) {
            const float e0 = ex2(fmaf(s[2 * k], scale_log2, -mrow[r]));
            const float e1 = ex2(fmaf(s[2 * k + 1], scale_log2, -mrow[r]));
            sum[r] += e0;
            sum[r] += e1;
            p[k] = pack2<T>(e0, e1);
          }
        }
      }
      lsum[0] += sum[0];
      lsum[1] += sum[1];
      return rescale;
    };
    auto softmax_tile = [&](int j, float (&alpha)[2]) -> bool {
      return (j + 1) * kBN > skv ? softmax(j, alpha, true) : softmax(j, alpha, false);
    };

    if (c == kConsumers128 - 1) bar_arrive(next_bar);  // the first consumer goes first
    mbar_wait(&bars.full_q, 0);

    mbar_wait(&bars.full_k[0], 0);
    bar_sync(my_bar);
    wgmma_fence();
    issue_qk(0);
    wgmma_commit();
    pass_turn(false);
    wgmma_wait();
    fence_regs(s);
    float alpha[2];
    softmax_tile(0, alpha);

    for (int j = 1; j < ntiles; ++j) {
      const int st = j % kStages128;
      const int pst = (j - 1) % kStages128;
      mbar_wait(&bars.full_k[st], (j / kStages128) & 1);
      mbar_wait(&bars.full_v[pst], ((j - 1) / kStages128) & 1);
      bar_sync(my_bar);
      wgmma_fence();
      issue_qk(st);
      issue_pv(pst);
      wgmma_commit();
      pass_turn(false);
      wgmma_wait();
      fence_regs(s);
      fence_regs(acc[0]);
      fence_regs(acc[1]);
      fence_regs(p);
      release(pst);
      if (softmax_tile(j, alpha)) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
#pragma unroll
          for (int i = 0; i < 32; ++i) acc[h][i] *= alpha[(i >> 1) & 1];
        }
      }
    }

    const int lst = (ntiles - 1) % kStages128;
    mbar_wait(&bars.full_v[lst], ((ntiles - 1) / kStages128) & 1);
    bar_sync(my_bar);
    wgmma_fence();
    issue_pv(lst);
    wgmma_commit();
    pass_turn(true);
    wgmma_wait();
    fence_regs(acc[0]);
    fence_regs(acc[1]);
    fence_regs(p);
    release(lst);

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      lsum[r] += __shfl_xor_sync(0xffffffffu, lsum[r], 1);
      lsum[r] += __shfl_xor_sync(0xffffffffu, lsum[r], 2);
    }
    const float inv0 = 1.f / lsum[0];
    const float inv1 = 1.f / lsum[1];
    const int r0 = q0 + c * 64 + warp * 16 + g;
    const int r1 = r0 + 8;
    T* ob = o + static_cast<size_t>(bh) * sq * kD128;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int n = 0; n < kHalfRows / 8; ++n) {
        const int col = h * kHalfRows + n * 8 + tig * 2;
        if (r0 < sq) {
          *reinterpret_cast<uint32_t*>(ob + static_cast<size_t>(r0) * kD128 + col) =
              pack2<T>(acc[h][4 * n] * inv0, acc[h][4 * n + 1] * inv0);
        }
        if (r1 < sq) {
          *reinterpret_cast<uint32_t*>(ob + static_cast<size_t>(r1) * kD128 + col) =
              pack2<T>(acc[h][4 * n + 2] * inv1, acc[h][4 * n + 3] * inv1);
        }
      }
    }
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

// A 3-D map over a contiguous [bh, s, 64] of bf16 or fp16 (128-byte rows,
// 128B swizzle) or int8 codes (64-byte rows, 64B swizzle): boxes of `rows`
// rows of one head; rows past s read as zeros.
template <typename E>
bool make_map(CUtensorMap* map, const void* ptr, int bh, int s, int rows) {
  EncodeTiled encode = encoder();
  if (encode == nullptr) return false;
  constexpr bool int8 = std::is_same<E, int8_t>::value;
  constexpr CUtensorMapDataType type =
      int8 ? CU_TENSOR_MAP_DATA_TYPE_UINT8
           : (kHalf<E> ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16);
  const cuuint64_t row_bytes = int8 ? kD : kD * 2;
  const cuuint64_t dims[3] = {kD, static_cast<cuuint64_t>(s),
                              static_cast<cuuint64_t>(bh)};
  const cuuint64_t strides[2] = {row_bytes, static_cast<cuuint64_t>(s) * row_bytes};
  const cuuint32_t box[3] = {kD, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t elem_strides[3] = {1, 1, 1};
  return encode(map, type, 3, const_cast<void*>(ptr), dims, strides, box, elem_strides,
                CU_TENSOR_MAP_INTERLEAVE_NONE,
                int8 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename T, typename QK, bool kBounded, bool kLse>
cudaError_t launch(const CUtensorMap& mq, const CUtensorMap& mk,
                   const CUtensorMap& mv, void* o, void* lse, int bh, int sq,
                   int skv, float scale_log2, const void* factor,
                   cudaStream_t stream) {
  auto kernel = flash_fwd_sm90_kernel<T, QK, kBounded, kLse>;
  constexpr int kSmemBytes = Geometry<QK>::kSmemBytes;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((sq + kBM - 1) / kBM, bh);
  kernel<<<grid, kThreads, kSmemBytes, stream>>>(
      mq, mk, mv, static_cast<T*>(o), static_cast<float*>(lse), sq,
      skv, scale_log2, static_cast<const float*>(factor));
  return cudaGetLastError();
}

bool bad_args(int head_dim, int bh, int sq, int skv,
              std::initializer_list<const void*> ptrs) {
  bool bad = head_dim != kD || bh <= 0 || sq <= 0 || skv <= 0 || bh > 65535;
  for (const void* p : ptrs) bad = bad || (reinterpret_cast<uintptr_t>(p) & 15) != 0;
  return bad;
}

// K1 in the model type T: the four forms by lse (null or not) and bounded.
template <typename T>
int fwd(const void* q, const void* k, const void* v, void* o, void* lse, int bh,
        int sq, int skv, int head_dim, float scale, int bounded, void* stream) {
  if (bad_args(head_dim, bh, sq, skv, {q, k, v, o})) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  CUtensorMap mq, mk, mv;
  if (!make_map<T>(&mq, q, bh, sq, kBM) || !make_map<T>(&mk, k, bh, skv, kBN) ||
      !make_map<T>(&mv, v, bh, skv, kBN)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const float scale_log2 = scale * 1.4426950408889634f;
  auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (lse != nullptr && bounded) {
    err = launch<T, T, true, true>(mq, mk, mv, o, lse, bh, sq, skv, scale_log2, nullptr, s);
  } else if (lse != nullptr) {
    err = launch<T, T, false, true>(mq, mk, mv, o, lse, bh, sq, skv, scale_log2, nullptr, s);
  } else if (bounded) {
    err = launch<T, T, true, false>(mq, mk, mv, o, lse, bh, sq, skv, scale_log2, nullptr, s);
  } else {
    err = launch<T, T, false, false>(mq, mk, mv, o, lse, bh, sq, skv, scale_log2, nullptr, s);
  }
  return static_cast<int>(err);
}

// K2 with V and O in the model type T.
template <typename T>
int fwd_qk8(const void* q8, const void* k8, const void* v, void* o, int bh, int sq,
            int skv, int head_dim, const void* factor, void* stream) {
  if (bad_args(head_dim, bh, sq, skv, {q8, k8, v, o}) || factor == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  CUtensorMap mq, mk, mv;
  if (!make_map<int8_t>(&mq, q8, bh, sq, kBM) ||
      !make_map<int8_t>(&mk, k8, bh, skv, kBN) || !make_map<T>(&mv, v, bh, skv, kBN)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      launch<T, int8_t, true, false>(mq, mk, mv, o, nullptr, bh, sq, skv, 0.f, factor, s);
  return static_cast<int>(err);
}

// A 3-D map over a contiguous [bh, s, 128] of bf16 or fp16 (256-byte rows):
// boxes of `rows` x 64 values of one head (one 128B-swizzled half of a row);
// rows past s read as zeros.
template <typename E>
bool make_map_d128(CUtensorMap* map, const void* ptr, int bh, int s, int rows) {
  EncodeTiled encode = encoder();
  if (encode == nullptr) return false;
  constexpr CUtensorMapDataType type =
      kHalf<E> ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  const cuuint64_t row_bytes = kD128 * 2;
  const cuuint64_t dims[3] = {kD128, static_cast<cuuint64_t>(s),
                              static_cast<cuuint64_t>(bh)};
  const cuuint64_t strides[2] = {row_bytes, static_cast<cuuint64_t>(s) * row_bytes};
  const cuuint32_t box[3] = {kHalfRows, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t elem_strides[3] = {1, 1, 1};
  return encode(map, type, 3, const_cast<void*>(ptr), dims, strides, box, elem_strides,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// K1 at head dim 128, online, no lse.
template <typename T>
int fwd_d128(const void* q, const void* k, const void* v, void* o, int bh, int sq,
             int skv, int head_dim, float scale, void* stream) {
  bool bad = head_dim != kD128 || bh <= 0 || sq <= 0 || skv <= 0 || bh > 65535;
  for (const void* ptr : {q, k, v, static_cast<const void*>(o)}) {
    bad = bad || (reinterpret_cast<uintptr_t>(ptr) & 15) != 0;
  }
  if (bad) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap mq, mk, mv;
  if (!make_map_d128<T>(&mq, q, bh, sq, kBM128) ||
      !make_map_d128<T>(&mk, k, bh, skv, kBN) || !make_map_d128<T>(&mv, v, bh, skv, kBN)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto kernel = flash_fwd_sm90_kernel_d128<T>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes128);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((sq + kBM128 - 1) / kBM128, bh);
  kernel<<<grid, kThreads128, kSmemBytes128, static_cast<cudaStream_t>(stream)>>>(
      mq, mk, mv, static_cast<T*>(o), sq, skv, scale * 1.4426950408889634f);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K1 at head dim 128, bf16, the online form without the logsumexp. q, k, v:
// [bh, sq|skv, 128], o: [bh, sq, 128], contiguous on the device and 16-byte
// aligned. Launches on `stream` and returns the launch's cudaError_t; it
// does not synchronise.
extern "C" int dove_flash_fwd_d128_bf16(const void* q, const void* k, const void* v,
                                        void* o, int bh, int sq, int skv, int head_dim,
                                        float scale, void* stream) {
  return fwd_d128<__nv_bfloat16>(q, k, v, o, bh, sq, skv, head_dim, scale, stream);
}

// The dynamic shared memory a K1 at head dim 128 asks for.
extern "C" int dove_flash_fwd_d128_smem_bytes() { return kSmemBytes128; }

// The dynamic shared memory a K1 (qk8 = 0) or K2 (qk8 = 1) launch asks for
// (Q, the K/V ring, and slack to align the tiles to 1024 bytes); the same in
// bf16 and fp16.
extern "C" int dove_flash_fwd_sm90_smem_bytes(int qk8) {
  return qk8 ? Geometry<int8_t>::kSmemBytes : Geometry<__nv_bfloat16>::kSmemBytes;
}

// K1. q, k, v: bf16 [bh, sq|skv, 64], o: bf16 [bh, sq, 64]; lse: fp32
// [bh, sq], or null for the inference forms that write none. All contiguous
// on the device and 16-byte aligned. Launches on `stream` and returns the
// cudaError_t of the launch (0 on success); it does not synchronise.
extern "C" int dove_flash_fwd_bf16(const void* q, const void* k, const void* v,
                                   void* o, void* lse, int bh, int sq, int skv,
                                   int head_dim, float scale, int bounded,
                                   void* stream) {
  return fwd<__nv_bfloat16>(q, k, v, o, lse, bh, sq, skv, head_dim, scale, bounded,
                            stream);
}

// K1 in fp16: dove_flash_fwd_bf16's arguments with fp16 q, k, v and o.
extern "C" int dove_flash_fwd_f16(const void* q, const void* k, const void* v,
                                  void* o, void* lse, int bh, int sq, int skv,
                                  int head_dim, float scale, int bounded,
                                  void* stream) {
  return fwd<__half>(q, k, v, o, lse, bh, sq, skv, head_dim, scale, bounded, stream);
}

// K2. q8, k8: int8 codes [bh, sq|skv, 64]; v: bf16 [bh, skv, 64]; o: bf16
// [bh, sq, 64]; factor: one fp32 on the device, (s_q * s_k) * fp32(scale *
// log2 e). All contiguous on the device and 16-byte aligned. Launches on
// `stream`, returns the cudaError_t of the launch, does not synchronise.
extern "C" int dove_flash_fwd_qk8(const void* q8, const void* k8, const void* v,
                                  void* o, int bh, int sq, int skv, int head_dim,
                                  const void* factor, void* stream) {
  return fwd_qk8<__nv_bfloat16>(q8, k8, v, o, bh, sq, skv, head_dim, factor, stream);
}

// K2 with fp16 v and o: dove_flash_fwd_qk8's arguments otherwise.
extern "C" int dove_flash_fwd_qk8_f16(const void* q8, const void* k8, const void* v,
                                      void* o, int bh, int sq, int skv, int head_dim,
                                      const void* factor, void* stream) {
  return fwd_qk8<__half>(q8, k8, v, o, bh, sq, skv, head_dim, factor, stream);
}
