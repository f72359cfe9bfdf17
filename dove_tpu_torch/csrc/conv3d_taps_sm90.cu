// K4 and K5: the 3x3 (x k_t) tap convolution for Hopper (sm_90a).
//
// K4 replaces the TPU kernel dove_tpu/ops/pallas/conv3d_int8.py:_kernel as
// conv3d_w8a8 calls it (pallas_call at :244): a VALID 3x3x3 convolution of a
// pre-padded channels-last input x [B, Fo + 2, Ho + 2, Wo + 2, Cin] of int8
// codes against int8 weights, int32 accumulation over all 27 taps (exact),
// then out = float(acc) * scale[cout] in fp32 and one rounding to the output
// type: bf16, fp16 (a VAE in fp16, as the TPU kernel's out_dtype) or fp32. K5 replaces the same body as conv3d_bf16 calls it (pallas_call at
// :337): bf16 operands, fp32 accumulation, no scale. Both are instantiations
// of one template; KT = 1 is the same schedule over the nine spatial taps of
// one frame, for the VAE's per-frame 3x3 convs (the upsamplers).
//
// What bounds them on the H100. At the largest decode window of the int8 plan
// (x [35, 274, 338, 128] -> [33, 272, 336, 128]) one conv is 2 * 27 * 128 *
// 128 * 3.02e6 = 2.67e12 operations: 1.35 ms at the data sheet's 1,979 TOP/s
// int8 dense, 2.70 ms at 989 TFLOP/s bf16, against 1.2 GB (K4, bf16 out) of
// device-memory traffic, 0.35 ms at 3.35 TB/s. Operations bound them, as
// long as the operands reach the tensor cores: at Cout = 128 a staged weight
// byte serves only the pixels of its CTA, so the bytes staged per operation,
// and the number of TMA requests that stage them, set the pace first. What
// is left (PERF.md): the loop's wgmmas alone run below the tensor
// rate, the loads slow K5's loop more than K4's, and the epilogue, which no
// mainloop overlaps (one CTA per SM), costs K4 most.
//
// Design (one CTA per 384 output positions x 128 couts of one window, 384
// threads: one producer warpgroup, two consumer warpgroups):
// - Flat positions. Output positions are numbered over the padded frame,
//   q = f * Hp * Wp + h * Wp + w, so that every tap (dt, dh, dw) of a tile of
//   384 consecutive q is the same run of input rows shifted by dt * Hp * Wp +
//   dh * Wp + dw. Positions with h >= Ho or w >= Wo (1.3% at the main shape)
//   are computed and never stored; what they read across a row, a frame or
//   the window's end is never stored either.
// - The halo is loaded once per (k_t, 32-byte channel slab) and read by all
//   nine (dh, dw) taps: for each dh, the 384 + 2 input rows from q0 + dt * Hp
//   * Wp + dh * Wp on (two TMA boxes of 200 rows), in TMA's 32-byte swizzle:
//   rows of 32 bytes (one k step of either kernel) whose two 16-byte halves
//   trade places in rows 4-7 of every 8. The hardware takes that pattern
//   from the shared-memory address, in TMA's writes and in wgmma's reads
//   alike, so tap (dh, dw) of a 64-row block is a wgmma A descriptor that
//   starts dw rows into piece dh: no copy per tap.
// - Weights by one bulk copy a stage. The wrapper lays the weights out once
//   per launch as the kernel's shared-memory image ([cout block][k_t][slab]
//   [tap][128 cout][32 bytes], swizzled as TMA would), so the nine [128 cout,
//   32 B] tiles of a stage are 36,864 contiguous bytes and one
//   cp.async.bulk. TMA walks a box row by row, and at 32-byte rows that
//   request rate, not bytes, set the pace; the bulk copy takes the weights
//   off it. A stage is 38,400 + 36,864 bytes; three ride an mbarrier ring.
// - wgmma with both operands in shared memory: m64n128k32 s8 -> s32 for K4
//   (exact, so K4 stays bit for bit its plain version), m64n128k16 bf16 ->
//   f32 for K5. Each consumer owns three 64-row blocks x 128 couts (192
//   accumulator registers) and issues the 27 wgmmas of a stage as one group,
//   then releases the stage as soon as the group completes (keeping a group
//   in flight held two stages and measured slower). No wgmma sits in a
//   data-dependent branch. The two consumers share every stage (one ring),
//   so there is no issue turn to pass: with one tile per CTA there is no
//   epilogue for a ping-pong partner to hide. The producer warpgroup gives its registers to the consumers
//   (setmaxnreg: 40 and 232); one thread issues every load, and three of
//   its warps fill the epilogue's per-cout table while the loop runs.
// - Epilogue through shared memory, as the TPU kernel and the plain version
//   take it: float(acc) * scale, + addend[border class], + bias, each a
//   rounded fp32 step (__fmul_rn / __fadd_rn keep the compiler from fusing
//   them), one rounding. The accumulators go to a cout-major tile in the
//   (now idle) ring, so that the stores of a warp run along 32 neighbouring
//   outputs of the output's layout (along W for the VAE's NCDHW); each
//   batch of shared reads comes before its global stores.
// - Measured and not kept: the no-swizzle layout (16-byte TMA rows, twice the
//   requests of 32-byte ones); weight tiles as TMA boxes, multicast over a
//   cluster of 2 or 4 CTAs or not (the clusters were slower than none, as
//   they tie the CTAs' rings together; the bulk copy is faster than
//   either); 256 positions a CTA (more weight bytes per operation); an
//   epilogue tile of 8-byte cout pairs, and the weights as the A operand
//   with positions as B (m64n192), neither faster.

#include <cuda.h>  // CUtensorMap and its enums; the encoder comes through the runtime
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kConsumers = 2;
constexpr int kThreads = 128 * (1 + kConsumers);
constexpr int kBlocks = 3;               // 64-row blocks per consumer
constexpr int kM = 64 * kBlocks * kConsumers;  // output positions per CTA
constexpr int kBN = 128;                 // output channels per CTA
// out_type: the output's element type (the model type, or fp32)
constexpr int kOutBF16 = 0;
constexpr int kOutF32 = 1;
constexpr int kOutF16 = 2;
constexpr int kSlab = 32;                // bytes of input channels per stage
constexpr int kBoxRows = kM / 2 + 8;     // rows per halo TMA box
constexpr int kPieceRows = 2 * kBoxRows;  // rows per dh piece: >= kM + 2
constexpr int kHaloBytes = 3 * kPieceRows * kSlab;
constexpr int kWTapBytes = kBN * kSlab;  // one tap's [128 cout][32 B] tile
constexpr int kWBytes = 9 * kWTapBytes;
constexpr int kStageBytes = kHaloBytes + kWBytes;
constexpr int kStages = 3;
constexpr int kConstBytes = 11 * (kBN + 1) * 4;  // the epilogue's per-cout table
// 256 bytes of alignment slack: the 32-byte swizzle repeats every 256
constexpr int kSmemBytes = 256 + kStages * kStageBytes + kConstBytes;
// words per cout row of the epilogue's tile: 4 mod 32, so that the 32 lanes
// of an accumulator fragment store (8 rows x 4 cout pairs) hit 32 banks
constexpr int kTileStride = kM + 4;
constexpr int kConstStride = kBN + 1;  // words per row of the constants' table
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;

static_assert(kPieceRows >= kM + 2, "a dh piece must hold a tile and its dw shift");
static_assert(kStageBytes % 256 == 0 && kHaloBytes % 256 == 0 &&
                  (kBoxRows * kSlab) % 256 == 0 && kWTapBytes % 256 == 0,
              "TMA destinations start on the 256-byte swizzle pattern");
static_assert(kBN * kTileStride * 4 <= kStages * kStageBytes,
              "the epilogue's tile must fit in the ring");
static_assert(kConstBytes == 11 * kConstStride * 4, "the table's size");
static_assert(128 * kProducerRegs + 128 * kConsumers * kConsumerRegs <= 65536,
              "register split exceeds the SM's file");

struct Barriers {
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

// One box of a 3-D map at (x, y, z), completing on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint64_t* bar, int x, int y, int z) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(x), "r"(y),
      "r"(z)
      : "memory");
}

// `bytes` contiguous bytes from device memory, completing on `bar`.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], "
      "[%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
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

// Keep the compiler from moving accumulator reads or writes across an async
// wgmma's issue or completion.
__device__ __forceinline__ void fence_acc(float (&r)[kBlocks][64]) {
#pragma unroll
  for (int j = 0; j < kBlocks; ++j) {
#pragma unroll
    for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(r[j][i])::"memory");
  }
}

__device__ __forceinline__ void fence_acc(int32_t (&r)[kBlocks][64]) {
#pragma unroll
  for (int j = 0; j < kBlocks; ++j) {
#pragma unroll
    for (int i = 0; i < 64; ++i) asm volatile("" : "+r"(r[j][i])::"memory");
  }
}

// Named barrier 1 over the two consumer warpgroups.
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(128 * kConsumers) : "memory");
}

// Named barrier 2: producer warps 1-3 arrive once the epilogue's table is
// written; the consumers wait on it before they read the table.
__device__ __forceinline__ void table_ready_arrive() {
  asm volatile("bar.arrive 2, %0;\n" ::"n"(96 + 128 * kConsumers) : "memory");
}

__device__ __forceinline__ void table_ready_sync() {
  asm volatile("bar.sync 2, %0;\n" ::"n"(96 + 128 * kConsumers) : "memory");
}

__device__ __forceinline__ uint32_t to_bits(int32_t v) { return static_cast<uint32_t>(v); }
__device__ __forceinline__ uint32_t to_bits(float v) { return __float_as_uint(v); }

// An accumulator's bits back as fp32: an int32 sum converts (round to
// nearest), an fp32 sum is itself.
template <typename Acc>
__device__ __forceinline__ float from_bits(uint32_t v) {
  if (std::is_same<Acc, int32_t>::value) return static_cast<float>(static_cast<int32_t>(v));
  return __uint_as_float(v);
}

// Shared-memory matrix descriptor of a K-major tile in the 32-byte swizzle
// (layout type 3): rows of 32 bytes (one k step), whose two 16-byte halves
// trade places in rows 4-7 of every 8; core matrices of 8 rows 256 bytes
// apart (stride byte offset); the leading byte offset is unused, a k step
// being the whole row. The hardware takes the pattern from the address, as
// TMA writes it, so a tile may start on any row: a tap's shift by dw rows is
// only a start address.
__device__ __forceinline__ uint64_t make_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) |
         (static_cast<uint64_t>(256 >> 4) << 32) | (3ull << 62);
}

#define DOVE_ACC64(C)                                                         \
  C(d[0]), C(d[1]), C(d[2]), C(d[3]), C(d[4]), C(d[5]), C(d[6]), C(d[7]),     \
      C(d[8]), C(d[9]), C(d[10]), C(d[11]), C(d[12]), C(d[13]), C(d[14]),     \
      C(d[15]), C(d[16]), C(d[17]), C(d[18]), C(d[19]), C(d[20]), C(d[21]),   \
      C(d[22]), C(d[23]), C(d[24]), C(d[25]), C(d[26]), C(d[27]), C(d[28]),   \
      C(d[29]), C(d[30]), C(d[31]), C(d[32]), C(d[33]), C(d[34]), C(d[35]),   \
      C(d[36]), C(d[37]), C(d[38]), C(d[39]), C(d[40]), C(d[41]), C(d[42]),   \
      C(d[43]), C(d[44]), C(d[45]), C(d[46]), C(d[47]), C(d[48]), C(d[49]),   \
      C(d[50]), C(d[51]), C(d[52]), C(d[53]), C(d[54]), C(d[55]), C(d[56]),   \
      C(d[57]), C(d[58]), C(d[59]), C(d[60]), C(d[61]), C(d[62]), C(d[63])
#define DOVE_REGS64                                                           \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "  \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "   \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "   \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "   \
  "%58, %59, %60, %61, %62, %63}"
#define DOVE_RW_S32(x) "+r"(x)
#define DOVE_RW_F32(x) "+f"(x)

// d[64 x 128] += A[64 x 32] B[32 x 128], int8 codes, int32 sums (exact).
__device__ __forceinline__ void wgmma(int32_t (&d)[64], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 " DOVE_REGS64
      ", %64, %65, p;\n}\n"
      : DOVE_ACC64(DOVE_RW_S32)
      : "l"(a), "l"(b), "r"(1));
}

// d[64 x 128] += A[64 x 16] B[16 x 128], bf16, fp32 sums; both K-major.
__device__ __forceinline__ void wgmma(float (&d)[64], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " DOVE_REGS64
      ", %64, %65, p, 1, 1, 0, 0;\n}\n"
      : DOVE_ACC64(DOVE_RW_F32)
      : "l"(a), "l"(b), "r"(1));
}

// x (map_x): bytes [B][F * Hp * Wp rows][Cin * sizeof(In)], F = Fo + KT - 1;
// w_img: the weights' shared-memory image (ops/conv3d_int8.py weight_image),
// one kWBytes block per (cout block, k_t, slab); scale: fp32 [Cout]
// or null; addend: fp32 [Cout, add_h, add_w] or null, indexed by the pixel's
// border class (class of row h: add_h - 1 for the last row, else min(h, 1);
// columns alike); bias: fp32 [Cout] or null; out: element (b, f, h, w, c) at
// b*osb + f*osf + h*osh + w*osw + c*osc, in the type out_type names.
// grid = (tiles of kM positions, Cout / 128, B).
template <typename In, typename Acc, int KT>
__global__ void __launch_bounds__(kThreads, 1)
    conv3d_taps_sm90_kernel(const __grid_constant__ CUtensorMap map_x,
                            const uint8_t* __restrict__ w_img,
                            const float* __restrict__ scale,
                            const float* __restrict__ addend,
                            const float* __restrict__ bias, void* __restrict__ out,
                            int Fo, int Ho, int Wo, int slabs, int out_type,
                            int add_h, int add_w, long long osb, long long osf,
                            long long osh, long long osw, long long osc) {
  static_assert(std::is_same<In, int8_t>::value
                    ? std::is_same<Acc, int32_t>::value
                    : std::is_same<Acc, float>::value,
                "int8 accumulates in int32, bf16 in fp32");
  extern __shared__ uint8_t smem_raw[];
  __shared__ Barriers bars;
  const uint32_t base = (smem_u32(smem_raw) + 255u) & ~255u;
  const int Hp = Ho + 2, Wp = Wo + 2;
  const int frame = Hp * Wp;
  const int q0 = blockIdx.x * kM;
  const int n0 = blockIdx.y * kBN;
  const int b = blockIdx.z;
  const int nst = KT * slabs;  // stages: (k_t, slab) pairs
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int st = 0; st < kStages; ++st) {
      mbar_init(&bars.full[st], 1);
      mbar_init(&bars.empty[st], 4 * kConsumers);  // one arrival per warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // ---------------- producer: one thread issues every load ----------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x == 0) {
      for (int s = 0; s < nst; ++s) {
        const int st = s % kStages;
        mbar_wait(&bars.empty[st], ((s / kStages) & 1) ^ 1);
        const int kt = s / slabs;
        const int x0 = (s % slabs) * kSlab;  // byte offset of the slab
        const uint32_t halo = base + st * kStageBytes;
        const uint32_t wts = halo + kHaloBytes;
        mbar_expect_tx(&bars.full[st], kStageBytes);
#pragma unroll
        for (int dh = 0; dh < 3; ++dh) {
#pragma unroll
          for (int k = 0; k < 2; ++k) {
            tma_load(halo + (dh * kPieceRows + k * kBoxRows) * kSlab, &map_x,
                     &bars.full[st], x0, q0 + kt * frame + dh * Wp + k * kBoxRows, b);
          }
        }
        bulk_load(wts, w_img + (static_cast<size_t>(blockIdx.y) * nst + s) * kWBytes,
                  kWBytes, &bars.full[st]);
      }
    }
    // warps 1-3: the epilogue's per-cout table (scale, bias and the addend's
    // 9 border classes, rows of kConstStride words, so that the 9 addend
    // rows of one cout fall into 9 banks), while the loop runs
    if (threadIdx.x >= 32) {
      float* consts = reinterpret_cast<float*>(smem_raw + (base - smem_u32(smem_raw)) +
                                               kStages * kStageBytes);
      for (int k = threadIdx.x - 32; k < kBN * 11; k += 96) {
        const int c = k % kBN, slot = k / kBN;
        float v = 0.f;
        if (slot == 0) {
          v = scale != nullptr ? __ldg(scale + n0 + c) : 1.f;
        } else if (slot == 1) {
          v = bias != nullptr ? __ldg(bias + n0 + c) : 0.f;
        } else if (addend != nullptr && slot - 2 < add_h * add_w) {
          v = __ldg(addend + (n0 + c) * add_h * add_w + slot - 2);
        }
        consts[slot * kConstStride + c] = v;
      }
      table_ready_arrive();
    }
  } else {
    // ---------------- consumers: three 64-row blocks each ----------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    const int cw = wg - 1;
    const int tid = threadIdx.x - 128 * wg;
    const int warp = tid >> 5;
    const int lane = tid & 31;

    Acc acc[kBlocks][64];
#pragma unroll
    for (int j = 0; j < kBlocks; ++j) {
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[j][i] = 0;
    }
    auto release = [&](int st) {
      if (lane == 0) mbar_arrive(&bars.empty[st]);
    };
    for (int s = 0; s < nst; ++s) {
      const int st = s % kStages;
      mbar_wait(&bars.full[st], (s / kStages) & 1);
      const uint32_t halo = base + st * kStageBytes;
      const uint32_t wts = halo + kHaloBytes;
      // 32-byte rows, 8-row core matrices 256 bytes apart
      const uint32_t a0 = halo + cw * kBlocks * 64 * kSlab;
      fence_acc(acc);
      wgmma_fence();
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) {
        const int dh = tap / 3, dw = tap % 3;
        const uint64_t bd = make_desc(wts + tap * kWTapBytes);
#pragma unroll
        for (int j = 0; j < kBlocks; ++j) {
          wgmma(acc[j], make_desc(a0 + (dh * kPieceRows + j * 64 + dw) * kSlab), bd);
        }
      }
      wgmma_commit();
      wgmma_wait();
      fence_acc(acc);
      release(st);
    }

    // Epilogue, through shared memory: the ring is free once both consumers
    // are past their last stage (every load of this tile has landed). The
    // accumulators go to a [128 cout][kTileStride] word tile (the producer
    // has put the per-cout constants beside the ring); then each store
    // instruction of a warp
    // covers 32 neighbouring outputs of the output's layout: positions of
    // one cout for NCDHW, couts of one position for NDHWC.
    uint32_t* tile = reinterpret_cast<uint32_t*>(smem_raw + (base - smem_u32(smem_raw)));
    const float* consts = reinterpret_cast<const float*>(
        smem_raw + (base - smem_u32(smem_raw)) + kStages * kStageBytes);
    const int ctid = threadIdx.x - 128;  // 0 .. 255 over both consumers
    consumers_sync();
    // Element i of a block's accumulator is row warp * 16 + g + 8 * ((i >> 1)
    // & 1) of the block, cout 8 * (i >> 2) + 2 * t + (i & 1).
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int j = 0; j < kBlocks; ++j) {
      const int row0 = (cw * kBlocks + j) * 64 + warp * 16 + g;
#pragma unroll
      for (int i = 0; i < 64; ++i) {
        const int row = row0 + 8 * ((i >> 1) & 1);
        tile[(8 * (i >> 2) + 2 * t + (i & 1)) * kTileStride + row] =
            to_bits(acc[j][i]);
      }
    }
    table_ready_sync();  // the dump is complete, and so is the producer's table
    // The epilogue's arithmetic, each step a rounded fp32 operation in the
    // plain version's order. Every shared-memory read of a batch comes
    // before its global stores: a store through the generic output pointer
    // may not pass a shared read the compiler cannot tell apart from it, so
    // reads after stores would each wait out their full latency.
    auto finish = [&](uint32_t bits, float sc, float add, float bs) -> float {
      float v = from_bits<Acc>(bits);
      if (std::is_same<In, int8_t>::value) v = __fmul_rn(v, sc);
      if (addend != nullptr) v = __fadd_rn(v, add);
      if (bias != nullptr) v = __fadd_rn(v, bs);
      return v;
    };
    auto store = [&](long long at, float v) {
      if (out_type == kOutF32) {
        static_cast<float*>(out)[at] = v;
      } else if (out_type == kOutF16) {
        static_cast<__half*>(out)[at] = __float2half_rn(v);
      } else {
        static_cast<__nv_bfloat16*>(out)[at] = __float2bfloat16_rn(v);
      }
    };
    // where position p of the tile is stored (-1: not stored) and its border
    // class
    auto locate = [&](int p, long long& pix, int& cls) {
      const int q = q0 + p;
      const int f = q / frame;
      const int rem = q - f * frame;
      const int h = rem / Wp;
      const int wv = rem - h * Wp;
      pix = -1;
      cls = 0;
      if (f < Fo && h < Ho && wv < Wo) {
        pix = b * osb + f * osf + h * osh + wv * osw;
        cls = (h == Ho - 1 ? add_h - 1 : min(h, 1)) * add_w +
              (wv == Wo - 1 ? add_w - 1 : min(wv, 1));
      }
    };
    const int ew = ctid >> 5;  // warp of the two consumers, 0 .. 7
    constexpr int kPer = kM / 32;
    if (osc != 1) {
      // positions along the lanes, one cout per batch
      long long pix[kPer];
      int cls[kPer];
#pragma unroll
      for (int m = 0; m < kPer; ++m) locate(m * 32 + lane, pix[m], cls[m]);
      for (int c = ew; c < kBN; c += 8) {
        const float sc = consts[c], bs = consts[kConstStride + c];
        uint32_t v[kPer];
        float add[kPer];
#pragma unroll
        for (int m = 0; m < kPer; ++m) {
          v[m] = tile[c * kTileStride + m * 32 + lane];
          add[m] = addend != nullptr ? consts[(2 + cls[m]) * kConstStride + c] : 0.f;
        }
        const long long coff = static_cast<long long>(n0 + c) * osc;
#pragma unroll
        for (int m = 0; m < kPer; ++m) {
          if (pix[m] >= 0) store(pix[m] + coff, finish(v[m], sc, add[m], bs));
        }
      }
    } else {
      // couts along the lanes, one position per batch
      float sc[kBN / 32], bs[kBN / 32];
#pragma unroll
      for (int k = 0; k < kBN / 32; ++k) {
        sc[k] = consts[k * 32 + lane];
        bs[k] = consts[kConstStride + k * 32 + lane];
      }
      for (int p = ew; p < kM; p += 8) {
        long long pix;
        int cls;
        locate(p, pix, cls);
        if (pix < 0) continue;
        uint32_t v[kBN / 32];
        float add[kBN / 32];
#pragma unroll
        for (int k = 0; k < kBN / 32; ++k) {
          v[k] = tile[(k * 32 + lane) * kTileStride + p];
          add[k] = addend != nullptr ? consts[(2 + cls) * kConstStride + k * 32 + lane] : 0.f;
        }
#pragma unroll
        for (int k = 0; k < kBN / 32; ++k) {
          store(pix + n0 + k * 32 + lane, finish(v[k], sc[k], add[k], bs[k]));
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

// A 3-D byte map over x as [B][rows][row_bytes], boxes of 32 bytes x kBoxRows
// rows, 32-byte swizzle: rows past a window's end read as zeros.
bool make_map(CUtensorMap* map, const void* ptr, long long row_bytes,
              long long rows, int B) {
  EncodeTiled encode = encoder();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(row_bytes),
                              static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(row_bytes),
                                 static_cast<cuuint64_t>(row_bytes * rows)};
  const cuuint32_t box[3] = {kSlab, kBoxRows, 1};
  const cuuint32_t elem_strides[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3, const_cast<void*>(ptr),
                dims, strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_32B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Output positions a window's tiles must cover: up to the last stored one.
long long flat_positions(int Fo, int Ho, int Wo) {
  const long long Hp = Ho + 2, Wp = Wo + 2;
  return (Fo - 1) * Hp * Wp + (Ho - 1) * Wp + Wo;
}

template <typename In, typename Acc, int KT>
int launch(const void* x, const void* w, const void* scale, const void* addend,
           const void* bias, void* out, int B, int Fo, int Ho, int Wo, int Cin,
           int Cout, int out_type, int add_h, int add_w, long long osb,
           long long osf, long long osh, long long osw, long long osc,
           void* stream) {
  const long long row_bytes = static_cast<long long>(Cin) * sizeof(In);
  const long long rows = static_cast<long long>(Fo + KT - 1) * (Ho + 2) * (Wo + 2);
  CUtensorMap map_x;
  if (!make_map(&map_x, x, row_bytes, rows, B)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto kernel = conv3d_taps_sm90_kernel<In, Acc, KT>;
  static bool opted_in = false;  // more than 48 KB of dynamic shared memory
  if (!opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    opted_in = true;
  }
  const long long tiles = (flat_positions(Fo, Ho, Wo) + kM - 1) / kM;
  const dim3 grid(static_cast<unsigned>(tiles), Cout / kBN, B);
  kernel<<<grid, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      map_x, static_cast<const uint8_t*>(w), static_cast<const float*>(scale),
      static_cast<const float*>(addend), static_cast<const float*>(bias), out, Fo,
      Ho, Wo, static_cast<int>(row_bytes / kSlab), out_type, add_h, add_w, osb, osf,
      osh, osw, osc);
  return static_cast<int>(cudaGetLastError());
}

// Cin in whole 64-channel slabs, Cout in whole 128 blocks; every index of a
// window's flat rows and of the grid fits an int.
bool bad_shape(const void* x, const void* w, int B, int Fo, int Ho, int Wo,
               int Cin, int Cout, int kt) {
  const auto misaligned = [](const void* p) {
    return (reinterpret_cast<uintptr_t>(p) & 15) != 0;
  };
  return B <= 0 || Fo <= 0 || Ho <= 0 || Wo <= 0 || Cin <= 0 || Cout <= 0 ||
         Cin % 64 != 0 || Cout % kBN != 0 || (kt != 1 && kt != 3) || B > 65535 ||
         Cout / kBN > 65535 || misaligned(x) || misaligned(w) ||
         static_cast<long long>(Fo + kt - 1) * (Ho + 2) * (Wo + 2) + 2 * kM >
             (1ll << 31) - 1;
}

}  // namespace

// The tile geometry the host's plan (ops/conv3d_int8.py) must agree with:
// {positions per CTA, rows per dh piece, rows per halo box, bytes of a
// stage's weight image}.
extern "C" void dove_conv3d_sm90_geometry(int* out) {
  out[0] = kM;
  out[1] = kPieceRows;
  out[2] = kBoxRows;
  out[3] = kWBytes;
}

// The dynamic shared memory a K4 or K5 launch asks for.
extern "C" int dove_conv3d_sm90_smem_bytes() { return kSmemBytes; }

// K4. x: int8 [B, Fo + kt - 1, Ho + 2, Wo + 2, Cin], contiguous; w: the
// shared-memory image of the int8 weights [kt * 9, Cout, Cin] (ops/
// conv3d_int8.py weight_image); both 16-byte aligned; scale: fp32 [Cout] on the
// device; addend: fp32 [Cout, add_h, add_w] or null; bias: fp32 [Cout] or
// null; out: bf16, fp32 or fp16 (out_type 0, 1 or 2), written through the
// element strides os*.
// kt is 3 or 1. Launches on `stream` and returns the cudaError_t of the
// launch (0 on success); no synchronisation.
extern "C" int dove_conv3d_w8a8(const void* x, const void* w,
                                const void* scale, const void* addend,
                                const void* bias, void* out, int B, int Fo,
                                int Ho, int Wo, int Cin, int Cout, int kt,
                                int out_type, int add_h, int add_w,
                                long long osb, long long osf, long long osh,
                                long long osw, long long osc, void* stream) {
  if (bad_shape(x, w, B, Fo, Ho, Wo, Cin, Cout, kt) || scale == nullptr ||
      out_type < kOutBF16 || out_type > kOutF16 ||
      (addend != nullptr && (add_h < 1 || add_h > 3 || add_w < 1 || add_w > 3))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (kt == 3) {
    return launch<int8_t, int32_t, 3>(x, w, scale, addend, bias, out, B, Fo, Ho,
                                      Wo, Cin, Cout, out_type, add_h, add_w, osb,
                                      osf, osh, osw, osc, stream);
  }
  return launch<int8_t, int32_t, 1>(x, w, scale, addend, bias, out, B, Fo, Ho,
                                    Wo, Cin, Cout, out_type, add_h, add_w, osb,
                                    osf, osh, osw, osc, stream);
}

// K5. As K4 with bf16 x and w, fp32 accumulation, no scale, addend or bias.
extern "C" int dove_conv3d_bf16(const void* x, const void* w, void* out, int B,
                                int Fo, int Ho, int Wo, int Cin, int Cout,
                                int kt, int out_type, long long osb,
                                long long osf, long long osh, long long osw,
                                long long osc, void* stream) {
  if (bad_shape(x, w, B, Fo, Ho, Wo, Cin, Cout, kt) || out_type < kOutBF16 ||
      out_type > kOutF16) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (kt == 3) {
    return launch<__nv_bfloat16, float, 3>(x, w, nullptr, nullptr, nullptr, out,
                                           B, Fo, Ho, Wo, Cin, Cout, out_type, 1,
                                           1, osb, osf, osh, osw, osc, stream);
  }
  return launch<__nv_bfloat16, float, 1>(x, w, nullptr, nullptr, nullptr, out, B,
                                         Fo, Ho, Wo, Cin, Cout, out_type, 1, 1,
                                         osb, osf, osh, osw, osc, stream);
}
