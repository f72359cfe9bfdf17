// Flash-attention backward for Hopper (sm_90a), head dim 64, bf16 in and out.
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
// as the TPU kernels compute them: fp32 logits and accumulators, ds and p
// rounded to bf16 before the products that take them, outputs written in
// the inputs' dtype.
//
// What bounds them on the H100. At the training shape (CogVideoX1.5-5B
// stage 1, batch 2 of 25x320x640: B*H = 96, S = 3426, D = 64) K3a does three
// S x S x D products per head, 4.3e11 bf16 FLOPs (0.44 ms at 989 TFLOP/s
// dense), and K3b four, 5.8e11 (0.58 ms); each moves under 0.3 GB. Both also
// take one exponential per logit (1.1e9), as K1 does.
//
// Design. The TPU kernels carry their accumulators across a sequential grid
// axis. Blocks here run in any order, so each CTA owns its output tile and
// loops over the other axis itself, as JAX's grid order does: no atomics.
//   K3a: one CTA per (b*h, 128 queries); 8 warps of 16 rows keep their Q and
//        dO fragments, the dQ accumulator, lse and delta in registers, and
//        stream 64-key tiles of K and V through a two-stage cp.async ring.
//   K3b: one CTA per (b*h, 128 keys); the warps keep K and V fragments and
//        the dK and dV accumulators, and stream 64-query tiles of Q and dO
//        with their lse and delta.
// K3b computes s^T = K Q^T directly, as the TPU kernel does, so p^T and
// ds^T come out of mma.sync in the accumulator layout and, packed to bf16,
// are the A operands of p^T dO and ds^T Q without a trip through shared
// memory; K1 reuses S for P V the same way. Products run as mma.sync
// m16n8k16 bf16 with fp32 accumulation, 16 keys (K3a) or queries (K3b) at a
// time, so only 16 logits per thread are live. The streamed tiles are read
// row-wise (ldmatrix) where they are the columns of a product over D, and
// transposed (ldmatrix.trans) where a product runs over their rows: K in
// ds K, dO in p^T dO, Q in ds^T Q. Shared rows are padded to 144 B, which
// keeps ldmatrix free of bank conflicts. Ragged tiles: rows past the end
// are zero-filled by cp.async and their p is set to 0 (the TPU kernels mask
// their logits to -inf, and the wrapper pads lse with +inf); rows past the
// end of the owned tile are computed on zeros and never stored, so the host
// pads and slices nothing. wgmma and TMA are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kD = 64;             // head dim
constexpr int kRows = 128;         // rows a CTA owns: queries (K3a), keys (K3b)
constexpr int kBT = 64;            // rows of a streamed tile
constexpr int kWarps = kRows / 16;  // one warp per 16 owned rows
constexpr int kThreads = kWarps * 32;
constexpr int kLds = kD + 8;       // bf16 row padded to 144 B
constexpr float kLog2e = 1.4426950408889634f;

using Tile = __nv_bfloat16[kBT][kLds];

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte async copy; src_bytes = 0 zero-fills the destination.
__device__ __forceinline__ void cp_async_16(uint32_t dst, const void* src,
                                            int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes));
}

// 4-byte async copy; src_bytes = 0 zero-fills the destination.
__device__ __forceinline__ void cp_async_4(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
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

// A fragments over D (four k16 steps) of rows r0 and r1 = r0 + 8 of a
// row-major [n, 64] matrix; rows past n are zero.
__device__ __forceinline__ void load_a_frags(uint32_t (&f)[4][4],
                                             const __nv_bfloat16* base, int r0,
                                             int r1, int n, int tig) {
  const __nv_bfloat16* p0 = base + static_cast<size_t>(r0) * kD;
  const __nv_bfloat16* p1 = base + static_cast<size_t>(r1) * kD;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const int c = kk * 16 + tig * 2;
    f[kk][0] = r0 < n ? load_u32(p0 + c) : 0u;
    f[kk][1] = r1 < n ? load_u32(p1 + c) : 0u;
    f[kk][2] = r0 < n ? load_u32(p0 + c + 8) : 0u;
    f[kk][3] = r1 < n ? load_u32(p1 + c + 8) : 0u;
  }
}

// Rows [row0, row0 + kBT) of a row-major bf16 [n, 64] matrix into a shared
// tile, asynchronously; rows past n are zero-filled.
__device__ __forceinline__ void load_tile(Tile& tile,
                                          const __nv_bfloat16* base, int row0,
                                          int n) {
#pragma unroll
  for (int i = threadIdx.x; i < kBT * (kD / 8); i += kThreads) {
    const int row = i / (kD / 8);
    const int col = (i % (kD / 8)) * 8;
    const int r = row0 + row;
    const bool ok = r < n;
    cp_async_16(smem_addr(&tile[row][col]),
                base + static_cast<size_t>(ok ? r : 0) * kD + col,
                ok ? 16 : 0);
  }
}

// c = A T_j^T: the warp's 16 rows (A fragments over D) against the 8 tile
// rows of n-tile j, contracted over D; the tile is read row-wise.
__device__ __forceinline__ void mma_rows(float (&c)[4],
                                         const uint32_t (&a)[4][4],
                                         const Tile& tile, int j, int lane) {
#pragma unroll
  for (int e = 0; e < 4; ++e) c[e] = 0.f;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    uint32_t b[4];
    ldmatrix_x4(b, smem_addr(&tile[j * 8 + (lane & 7)]
                                  [h * 32 + (lane >> 3) * 8]));
    mma_bf16(c, a[2 * h], b[0], b[1]);
    mma_bf16(c, a[2 * h + 1], b[2], b[3]);
  }
}

// acc[16 x 64] += A T[16 kk .. 16 kk + 16, :]: a 16-deep step of a product
// over the tile's rows; the tile arrives transposed through ldmatrix.
__device__ __forceinline__ void mma_cols(float (&acc)[8][4],
                                         const uint32_t (&a)[4],
                                         const Tile& tile, int kk, int lane) {
#pragma unroll
  for (int dn = 0; dn < 4; ++dn) {
    uint32_t b[4];
    ldmatrix_x4_trans(b, smem_addr(&tile[kk * 16 + ((lane >> 3) & 1) * 8 +
                                         (lane & 7)][dn * 16 + (lane >> 4) * 8]));
    mma_bf16(acc[2 * dn], a, b[0], b[1]);
    mma_bf16(acc[2 * dn + 1], a, b[2], b[3]);
  }
}

// The C fragments of n-tiles 2 kk and 2 kk + 1 are the A fragment of one
// k16 step, rounded to bf16.
__device__ __forceinline__ void pack_a(uint32_t (&a)[4], const float (&c)[2][4]) {
  a[0] = pack_bf16x2(c[0][0], c[0][1]);
  a[1] = pack_bf16x2(c[0][2], c[0][3]);
  a[2] = pack_bf16x2(c[1][0], c[1][1]);
  a[3] = pack_bf16x2(c[1][2], c[1][3]);
}

// Rows r0 and r1 of a [16 x 64] fp32 accumulator to a bf16 [n, 64] matrix.
__device__ __forceinline__ void store_rows(__nv_bfloat16* base,
                                           const float (&acc)[8][4], int r0,
                                           int r1, int n, int tig) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int c = j * 8 + tig * 2;
    if (r0 < n) {
      *reinterpret_cast<uint32_t*>(base + static_cast<size_t>(r0) * kD + c) =
          pack_bf16x2(acc[j][0], acc[j][1]);
    }
    if (r1 < n) {
      *reinterpret_cast<uint32_t*>(base + static_cast<size_t>(r1) * kD + c) =
          pack_bf16x2(acc[j][2], acc[j][3]);
    }
  }
}

// K3a: dQ for one (b*h, 128-query tile).
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_kernel(const __nv_bfloat16* __restrict__ q,
                        const __nv_bfloat16* __restrict__ k,
                        const __nv_bfloat16* __restrict__ v,
                        const __nv_bfloat16* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        __nv_bfloat16* __restrict__ dq, int sq, int skv,
                        float scale) {
  __shared__ __align__(16) Tile ks[2];
  __shared__ __align__(16) Tile vs[2];

  const int bh = blockIdx.y;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int tig = lane & 3;
  const size_t q_off = static_cast<size_t>(bh) * sq;
  const __nv_bfloat16* kb = k + static_cast<size_t>(bh) * skv * kD;
  const __nv_bfloat16* vb = v + static_cast<size_t>(bh) * skv * kD;
  const float scale_log2 = scale * kLog2e;

  const int r0 = blockIdx.x * kRows + warp * 16 + g;
  const int r1 = r0 + 8;
  uint32_t qf[4][4], dof[4][4];
  load_a_frags(qf, q + q_off * kD, r0, r1, sq, tig);
  load_a_frags(dof, dout + q_off * kD, r0, r1, sq, tig);
  // lse in log2 units; +inf on rows past the end makes their p 0
  const float lse2[2] = {r0 < sq ? lse[q_off + r0] * kLog2e : INFINITY,
                         r1 < sq ? lse[q_off + r1] * kLog2e : INFINITY};
  const float dlt[2] = {r0 < sq ? delta[q_off + r0] : 0.f,
                        r1 < sq ? delta[q_off + r1] : 0.f};

  float acc[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  }

  const int ntiles = (skv + kBT - 1) / kBT;
  load_tile(ks[0], kb, 0, skv);
  load_tile(vs[0], vb, 0, skv);
  cp_async_commit();

  for (int t = 0; t < ntiles; ++t) {
    if (t + 1 < ntiles) {
      load_tile(ks[(t + 1) & 1], kb, (t + 1) * kBT, skv);
      load_tile(vs[(t + 1) & 1], vb, (t + 1) * kBT, skv);
    }
    cp_async_commit();  // possibly empty: keeps the group count uniform
    cp_async_wait_1();
    __syncthreads();
    const int st = t & 1;
    const int kv0 = t * kBT;
    const bool ragged = kv0 + kBT > skv;

#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {  // 16 keys at a time
      float ds[2][4];
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const int j = 2 * kk + jj;
        float s[4], dp[4];
        mma_rows(s, qf, ks[st], j, lane);   // Q K^T
        mma_rows(dp, dof, vs[st], j, lane);  // dO V^T
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float p = ex2(fmaf(s[e], scale_log2, -lse2[e >> 1]));
          if (ragged && kv0 + j * 8 + tig * 2 + (e & 1) >= skv) p = 0.f;
          ds[jj][e] = p * (dp[e] - dlt[e >> 1]) * scale;
        }
      }
      uint32_t a[4];
      pack_a(a, ds);
      mma_cols(acc, a, ks[st], kk, lane);  // dQ += ds K
    }
    __syncthreads();  // every warp is done with stage st before it refills
  }
  store_rows(dq + q_off * kD, acc, r0, r1, sq, tig);
}

// K3b: dK and dV for one (b*h, 128-key tile).
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkv_kernel(const __nv_bfloat16* __restrict__ q,
                         const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v,
                         const __nv_bfloat16* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         __nv_bfloat16* __restrict__ dk,
                         __nv_bfloat16* __restrict__ dv, int sq, int skv,
                         float scale) {
  __shared__ __align__(16) Tile qs[2];
  __shared__ __align__(16) Tile dos[2];
  __shared__ __align__(16) float lse_s[2][kBT];
  __shared__ __align__(16) float dlt_s[2][kBT];

  const int bh = blockIdx.y;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int tig = lane & 3;
  const size_t q_off = static_cast<size_t>(bh) * sq;
  const size_t kv_off = static_cast<size_t>(bh) * skv * kD;
  const __nv_bfloat16* qb = q + q_off * kD;
  const __nv_bfloat16* dob = dout + q_off * kD;
  const float* lseb = lse + q_off;
  const float* dltb = delta + q_off;
  const float scale_log2 = scale * kLog2e;

  const int r0 = blockIdx.x * kRows + warp * 16 + g;  // keys
  const int r1 = r0 + 8;
  const bool key_ok[2] = {r0 < skv, r1 < skv};
  uint32_t kf[4][4], vf[4][4];
  load_a_frags(kf, k + kv_off, r0, r1, skv, tig);
  load_a_frags(vf, v + kv_off, r0, r1, skv, tig);

  float acc_dk[8][4], acc_dv[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_dk[j][e] = acc_dv[j][e] = 0.f;
  }

  auto load_stage = [&](int stage, int q0) {
    load_tile(qs[stage], qb, q0, sq);
    load_tile(dos[stage], dob, q0, sq);
    for (int i = threadIdx.x; i < kBT; i += kThreads) {
      const int qi = q0 + i;
      const bool ok = qi < sq;
      cp_async_4(smem_addr(&lse_s[stage][i]), lseb + (ok ? qi : 0), ok ? 4 : 0);
      cp_async_4(smem_addr(&dlt_s[stage][i]), dltb + (ok ? qi : 0), ok ? 4 : 0);
    }
  };

  const int ntiles = (sq + kBT - 1) / kBT;
  load_stage(0, 0);
  cp_async_commit();

  for (int t = 0; t < ntiles; ++t) {
    if (t + 1 < ntiles) load_stage((t + 1) & 1, (t + 1) * kBT);
    cp_async_commit();
    cp_async_wait_1();
    __syncthreads();
    const int st = t & 1;
    const int q0 = t * kBT;
    const bool ragged = q0 + kBT > sq;

#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {  // 16 queries at a time
      float pt[2][4], dst[2][4];
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const int j = 2 * kk + jj;
        float s[4], dp[4];
        mma_rows(s, kf, qs[st], j, lane);    // s^T = K Q^T
        mma_rows(dp, vf, dos[st], j, lane);  // dp^T = V dO^T
        const int col = j * 8 + tig * 2;     // queries col, col + 1
        const float2 l = *reinterpret_cast<const float2*>(&lse_s[st][col]);
        const float2 d = *reinterpret_cast<const float2*>(&dlt_s[st][col]);
        const float l2[2] = {l.x * kLog2e, l.y * kLog2e};
        const float dl[2] = {d.x, d.y};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float p = ex2(fmaf(s[e], scale_log2, -l2[e & 1]));
          if (!key_ok[e >> 1] || (ragged && q0 + col + (e & 1) >= sq)) p = 0.f;
          pt[jj][e] = p;
          dst[jj][e] = p * (dp[e] - dl[e & 1]) * scale;
        }
      }
      uint32_t a[4];
      pack_a(a, pt);
      mma_cols(acc_dv, a, dos[st], kk, lane);  // dV += p^T dO
      pack_a(a, dst);
      mma_cols(acc_dk, a, qs[st], kk, lane);   // dK += ds^T Q
    }
    __syncthreads();
  }
  store_rows(dk + kv_off, acc_dk, r0, r1, skv, tig);
  store_rows(dv + kv_off, acc_dv, r0, r1, skv, tig);
}

bool bad_shape(int bh, int sq, int skv, int head_dim) {
  return head_dim != kD || bh <= 0 || sq <= 0 || skv <= 0 || bh > 65535;
}

}  // namespace

// K3a. q, dout: bf16 [bh, sq, 64]; k, v: bf16 [bh, skv, 64]; lse, delta:
// fp32 [bh, sq] (lse in natural-log units, delta = rowsum(dout * out));
// dq: bf16 [bh, sq, 64]. All contiguous on the device. Launches on `stream`,
// returns the cudaError_t of the launch, does not synchronise.
extern "C" int dove_flash_bwd_dq(const void* q, const void* k, const void* v,
                                 const void* dout, const void* lse,
                                 const void* delta, void* dq, int bh, int sq,
                                 int skv, int head_dim, float scale,
                                 void* stream) {
  if (bad_shape(bh, sq, skv, head_dim)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid((sq + kRows - 1) / kRows, bh);
  flash_bwd_dq_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v),
      static_cast<const __nv_bfloat16*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<__nv_bfloat16*>(dq), sq,
      skv, scale);
  return static_cast<int>(cudaGetLastError());
}

// K3b. The inputs of K3a; dk, dv: bf16 [bh, skv, 64]. All contiguous on the
// device. Launches on `stream`, returns the cudaError_t of the launch, does
// not synchronise.
extern "C" int dove_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                  const void* dout, const void* lse,
                                  const void* delta, void* dk, void* dv,
                                  int bh, int sq, int skv, int head_dim,
                                  float scale, void* stream) {
  if (bad_shape(bh, sq, skv, head_dim)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid((skv + kRows - 1) / kRows, bh);
  flash_bwd_dkv_kernel<<<grid, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v),
      static_cast<const __nv_bfloat16*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), sq, skv, scale);
  return static_cast<int>(cudaGetLastError());
}
