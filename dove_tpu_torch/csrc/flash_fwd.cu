// Flash-attention forward for Hopper (sm_90a), bf16 in and out, head dim 64.
//
// Replaces the TPU kernel dove_tpu/ops/pallas/flash_attention.py:_fwd_kernel
// (pallas_call in _flash_fwd), in both of its forms: the bounded-logits form
// (no running max, p = exp2(s * scale * log2 e)) that every inference call
// takes, and the online-softmax form. Non-causal: out = softmax(scale Q K^T) V
// with fp32 logits, fp32 row sums and an fp32 accumulator; p is rounded to
// bf16 before the P V product, as the TPU kernel does.
//
// What bounds it on the H100. At the main-path shape (CogVideoX1.5-5B, 720p,
// 33 frames: B*H = 48, S = 18226, D = 64) one launch does 4 S^2 D H = 4.08
// TFLOP of tensor-core work, about 4.1 ms at the data sheet's 989 TFLOP/s
// dense bf16, and S^2 H = 1.6e10 exponentials, which the SFUs need about as
// long for. It moves only ~0.45 GB. So the kernel is bound by operations,
// with the exp a co-bound at D = 64; the bounded form exists to avoid adding
// to it (no max, no rescale, one ex2 per logit).
//
// Design. The TPU kernel walks the kv axis as a sequential grid dimension
// carrying its accumulators in scratch between grid steps. Blocks here run in
// any order, so each CTA owns one (b*h, 128-query tile) and loops over the
// keys itself. 8 warps each own 16 query rows; their Q fragments, the
// [16, 64] fp32 accumulator and the row sums live in registers for the whole
// loop. K and V tiles of 64 keys are staged in shared memory through a
// two-stage cp.async ring (zero-filled past the end of the sequence), read
// with ldmatrix (V transposed on the fly), and both products run on tensor
// cores as mma.sync m16n8k16 bf16 with fp32 accumulation. The S fragment of
// Q K^T is reused in registers as the A fragment of P V. The kv tail is
// masked to -inf; query rows past the end are computed on zeros and never
// stored, so the host pads and slices nothing. wgmma and TMA are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kD = 64;             // head dim
constexpr int kBQ = 128;           // query rows per CTA
constexpr int kBK = 64;            // keys per shared-memory tile
constexpr int kWarps = kBQ / 16;   // one warp per 16 query rows
constexpr int kThreads = kWarps * 32;
constexpr int kLds = kD + 8;       // padded row: 144 B, conflict-free ldmatrix

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte async copy; src_bytes = 0 zero-fills the destination.
__device__ __forceinline__ void cp_async_16(uint32_t dst, const void* src,
                                            int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_1() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// c[16x8] += a[16x16] * b[16x8], bf16 operands, fp32 accumulator.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t load_u32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

template <bool kBounded>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     __nv_bfloat16* __restrict__ o, int sq, int skv,
                     float scale_log2) {
  __shared__ __align__(16) __nv_bfloat16 ks[2][kBK][kLds];
  __shared__ __align__(16) __nv_bfloat16 vs[2][kBK][kLds];

  const int bh = blockIdx.y;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;   // fragment row within the warp's 8-row group
  const int tig = lane & 3;  // thread in group: fragment column pair
  const __nv_bfloat16* qb = q + static_cast<size_t>(bh) * sq * kD;
  const __nv_bfloat16* kb = k + static_cast<size_t>(bh) * skv * kD;
  const __nv_bfloat16* vb = v + static_cast<size_t>(bh) * skv * kD;
  __nv_bfloat16* ob = o + static_cast<size_t>(bh) * sq * kD;

  // Rows this thread holds: r0 (c0, c1 of every fragment) and r0 + 8.
  const int r0 = blockIdx.x * kBQ + warp * 16 + g;
  const int r1 = r0 + 8;

  // Q as four m16k16 A fragments over D, read once; tail rows are zero.
  uint32_t qf[4][4];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const int c = kk * 16 + tig * 2;
    qf[kk][0] = r0 < sq ? load_u32(qb + static_cast<size_t>(r0) * kD + c) : 0u;
    qf[kk][1] = r1 < sq ? load_u32(qb + static_cast<size_t>(r1) * kD + c) : 0u;
    qf[kk][2] =
        r0 < sq ? load_u32(qb + static_cast<size_t>(r0) * kD + c + 8) : 0u;
    qf[kk][3] =
        r1 < sq ? load_u32(qb + static_cast<size_t>(r1) * kD + c + 8) : 0u;
  }

  auto load_tile = [&](int stage, int kv0) {
#pragma unroll
    for (int i = threadIdx.x; i < kBK * (kD / 8); i += kThreads) {
      const int row = i / (kD / 8);
      const int col = (i % (kD / 8)) * 8;
      const int key = kv0 + row;
      const bool ok = key < skv;
      const size_t off = static_cast<size_t>(ok ? key : 0) * kD + col;
      cp_async_16(smem_addr(&ks[stage][row][col]), kb + off, ok ? 16 : 0);
      cp_async_16(smem_addr(&vs[stage][row][col]), vb + off, ok ? 16 : 0);
    }
  };

  float acc[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  }
  float lsum[2] = {0.f, 0.f};  // this thread's partial row sums
  float mrow[2] = {-INFINITY, -INFINITY};  // online-softmax running max

  const int ntiles = (skv + kBK - 1) / kBK;
  load_tile(0, 0);
  cp_async_commit();

  for (int t = 0; t < ntiles; ++t) {
    if (t + 1 < ntiles) load_tile((t + 1) & 1, (t + 1) * kBK);
    cp_async_commit();  // possibly empty: keeps the group count uniform
    cp_async_wait_1();
    __syncthreads();
    const int st = t & 1;

    // S = Q K^T for this warp's 16 rows x 64 keys (8 n-tiles of 8 keys).
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        uint32_t b[4];
        ldmatrix_x4(b, smem_addr(&ks[st][j * 8 + (lane & 7)]
                                    [h * 32 + (lane >> 3) * 8]));
        mma_bf16(s[j], qf[2 * h], b[0], b[1]);
        mma_bf16(s[j], qf[2 * h + 1], b[2], b[3]);
      }
    }

    const int kv0 = t * kBK;
    if (kv0 + kBK > skv) {  // ragged last tile: mask the keys past the end
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (kv0 + j * 8 + tig * 2 + (e & 1) >= skv) s[j][e] = -INFINITY;
        }
      }
    }

    if (kBounded) {
      // |s| is bounded by the caller: exp2 straight off the logits.
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = ex2(s[j][e] * scale_log2);
          s[j][e] = p;
          lsum[e >> 1] += p;
        }
      }
    } else {
      float mx[2] = {mrow[0], mrow[1]};
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        mx[0] = fmaxf(mx[0], fmaxf(s[j][0], s[j][1]) * scale_log2);
        mx[1] = fmaxf(mx[1], fmaxf(s[j][2], s[j][3]) * scale_log2);
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      }
      const float alpha[2] = {ex2(mrow[0] - mx[0]), ex2(mrow[1] - mx[1])};
      mrow[0] = mx[0];
      mrow[1] = mx[1];
      lsum[0] *= alpha[0];
      lsum[1] *= alpha[1];
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        acc[n][0] *= alpha[0];
        acc[n][1] *= alpha[0];
        acc[n][2] *= alpha[1];
        acc[n][3] *= alpha[1];
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = ex2(fmaf(s[j][e], scale_log2, -mx[e >> 1]));
          s[j][e] = p;
          lsum[e >> 1] += p;
        }
      }
    }

    // O += P V: the C fragments of two adjacent key n-tiles are exactly the
    // A fragment of one k16 step; V arrives transposed through ldmatrix.
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint32_t a[4] = {
          pack_bf16x2(s[2 * kk][0], s[2 * kk][1]),
          pack_bf16x2(s[2 * kk][2], s[2 * kk][3]),
          pack_bf16x2(s[2 * kk + 1][0], s[2 * kk + 1][1]),
          pack_bf16x2(s[2 * kk + 1][2], s[2 * kk + 1][3]),
      };
#pragma unroll
      for (int dn = 0; dn < 4; ++dn) {
        uint32_t b[4];
        ldmatrix_x4_trans(
            b, smem_addr(&vs[st][kk * 16 + ((lane >> 3) & 1) * 8 + (lane & 7)]
                            [dn * 16 + (lane >> 4) * 8]));
        mma_bf16(acc[2 * dn], a, b[0], b[1]);
        mma_bf16(acc[2 * dn + 1], a, b[2], b[3]);
      }
    }
    __syncthreads();  // every warp is done with stage st before it refills
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    lsum[r] += __shfl_xor_sync(0xffffffffu, lsum[r], 1);
    lsum[r] += __shfl_xor_sync(0xffffffffu, lsum[r], 2);
  }
  const float inv0 = 1.f / lsum[0];
  const float inv1 = 1.f / lsum[1];
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    const int c = n * 8 + tig * 2;
    if (r0 < sq) {
      *reinterpret_cast<uint32_t*>(ob + static_cast<size_t>(r0) * kD + c) =
          pack_bf16x2(acc[n][0] * inv0, acc[n][1] * inv0);
    }
    if (r1 < sq) {
      *reinterpret_cast<uint32_t*>(ob + static_cast<size_t>(r1) * kD + c) =
          pack_bf16x2(acc[n][2] * inv1, acc[n][3] * inv1);
    }
  }
}

}  // namespace

// q: [bh, sq, 64], k and v: [bh, skv, 64], o: [bh, sq, 64]; all contiguous
// bf16 on the device. Launches on `stream` and returns the cudaError_t of the
// launch (0 on success); it does not synchronise.
extern "C" int dove_flash_fwd_bf16(const void* q, const void* k, const void* v,
                                   void* o, int bh, int sq, int skv,
                                   int head_dim, float scale, int bounded,
                                   void* stream) {
  if (head_dim != kD || bh <= 0 || sq <= 0 || skv <= 0 || bh > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid((sq + kBQ - 1) / kBQ, bh);
  const float scale_log2 = scale * 1.4426950408889634f;
  const auto* qp = static_cast<const __nv_bfloat16*>(q);
  const auto* kp = static_cast<const __nv_bfloat16*>(k);
  const auto* vp = static_cast<const __nv_bfloat16*>(v);
  auto* op = static_cast<__nv_bfloat16*>(o);
  auto s = static_cast<cudaStream_t>(stream);
  if (bounded) {
    flash_fwd_kernel<true><<<grid, kThreads, 0, s>>>(qp, kp, vp, op, sq, skv,
                                                     scale_log2);
  } else {
    flash_fwd_kernel<false><<<grid, kThreads, 0, s>>>(qp, kp, vp, op, sq, skv,
                                                      scale_log2);
  }
  return static_cast<int>(cudaGetLastError());
}
