// 3x3 (x k_t) convolution as an implicit GEMM over taps for Hopper (sm_90a).
//
// K4 replaces the TPU kernel dove_tpu/ops/pallas/conv3d_int8.py:_kernel as
// conv3d_w8a8 calls it (pallas_call at :244): a VALID 3x3x3 convolution of a
// pre-padded channels-last input x [B, Fo + 2, Ho + 2, Wo + 2, Cin] of int8
// codes against int8 weights, int32 accumulation over all 27 taps (exact),
// then out = float(acc) * scale[cout] in fp32 (scale = s_x * s_k, made by the
// wrapper and read from device memory) and one rounding to the output type.
// K5 replaces the same body as conv3d_bf16 calls it (pallas_call at :337):
// bf16 operands, fp32 accumulation, no scale. Both are instantiations of one
// template; the KT = 1 instantiation is the same schedule over the nine
// spatial taps of one frame, for the VAE's per-frame 3x3 convs (the
// upsamplers), which the TPU build left to XLA's int8 convolution.
//
// What bounds them on the H100. At the largest decode window of the int8 plan
// (x [35, 274, 338, 128] -> [33, 272, 336, 128]) one conv is 2 * 27 * 128 *
// 128 * 3.02e6 = 2.67e12 operations: 1.35 ms at the data sheet's 1,979 TOP/s
// int8 dense, 2.70 ms at 989 TFLOP/s bf16, against 1.2 GB (K4, bf16 out;
// fp32 out: 2.0 GB) of traffic, 0.35-0.6 ms at 3.35 TB/s. Operations bound it.
//
// Design. The TPU kernel is shaped by Mosaic: one program per 128-cout block
// walks frames through a VMEM ring, keeps one accumulator per width tap and
// aligns them with sublane rolls, and pads the width to the sublane tile.
// None of that carries over. Here one CTA owns 8 rows x 16 columns of one
// output frame by 128 output channels, and loops over (k_t, 64-byte slab of
// input channels): 64 int8 or 32 bf16 channels. Each step stages, through a
// two-stage cp.async ring, the (8+2) x (16+2) input halo of that frame and
// slab once, and the nine [128 cout, slab] weight tiles of that k_t. The nine
// (dh, dw) taps then read shifted views of the same halo: a 16-pixel tile row
// is one m16 A fragment, so a tap's shift is only a different row address for
// ldmatrix. Both tiles keep 64-byte rows with their 16-byte chunks XOR-
// swizzled by the row, so every ldmatrix phase (eight consecutive rows) hits
// eight different bank groups. 8 warps as 2 (rows) x 4 (cout): each holds a
// 64-pixel x 32-cout accumulator in registers for the whole loop (mma.sync
// m16n8k32 s8 -> s32 for K4, m16n8k16 bf16 -> f32 for K5; read as bytes the
// two A and B fragment layouts are the same, so one ldmatrix path serves
// both). Ragged tiles: halo pixels past the input are zero-filled by cp.async,
// and outputs past Ho or Wo are never stored, so the host pads nothing beyond
// the conv's own border. The epilogue stores through strides, so the caller
// picks channels-last (the TPU kernel's layout) or NCDHW (the VAE's), and it
// can finish the VAE's int8 conv in registers: after the scale it adds the
// asymmetric grid's offset term (one fp32 value per output channel and
// border class of the pixel: first, inner or last row and column) and the
// bias, each as its own rounded fp32 operation, in the order the plain
// version takes them, so the result stays bit for bit the plain one and
// three elementwise passes over the fp32 output never happen.
// wgmma, TMA im2col and a persistent schedule are later work.
//
// quant_pack_kernel is the other end of the int8 conv: the activation
// quantizer's last step. The range search (ops/quant.py) has chosen the grid
// on a sample; this reads the NCDHW activation once, takes round(x * mult[c]
// + off) (one fused multiply-add, as XLA compiles the reference's
// expression) or round((x - m) / s), clips to +-127 and writes the codes
// channels-last with the conv's zero border in place. It replaces the fused
// elementwise chain of dove_tpu/ops/quant.py:240-249, which XLA emits as one
// pass on the TPU. Bytes bound it: 2 in and 1 out per element; a 32-pixel by
// 128-channel tile goes through shared memory so that reads run along W and
// writes along C.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kTH = 8;    // output rows per CTA
constexpr int kTW = 16;   // output columns per CTA: one tile row = one m16
constexpr int kBN = 128;  // output channels per CTA
constexpr int kSlab = 64;  // bytes of input channels per stage and pixel
constexpr int kHaloW = kTW + 2;
constexpr int kHaloPix = (kTH + 2) * kHaloW;
constexpr int kThreads = 256;  // 8 warps: 2 over rows x 4 over cout
constexpr int kHaloBytes = kHaloPix * kSlab;
constexpr int kWeightBytes = 9 * kBN * kSlab;
constexpr int kStageBytes = kHaloBytes + kWeightBytes;
constexpr int kSmemBytes = 2 * kStageBytes;  // 170,496 of the SM's 232,448

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

// c[16x8] += a[16x16] * b[16x8], bf16 operands, fp32 accumulator.
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c[16x8] += a[16x32] * b[32x8], int8 operands, int32 accumulator (exact).
__device__ __forceinline__ void mma(int32_t (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Byte offset of 16-byte chunk `chunk` (0..3) of 64-byte row `row`: the chunk
// index is XORed with bits 1-2 of the row, so rows r .. r+7 at one chunk fall
// into eight different 16-byte bank groups.
__device__ __forceinline__ int swz(int row, int chunk) {
  return row * kSlab + ((chunk ^ ((row >> 1) & 3)) << 4);
}

// x: [B, Fo + KT - 1, Ho + 2, Wo + 2, Cin] contiguous; w: [KT * 9, Cout, Cin]
// contiguous (tap-major, the input channel fastest); scale: [Cout] fp32 or
// null; addend: fp32 [Cout, add_h, add_w] or null, indexed by the pixel's
// border class (class of row h: add_h - 1 for the last row, else min(h, 1);
// columns alike); bias: fp32 [Cout] or null; out: element (b, f, h, w, c) at
// b*osb + f*osf + h*osh + w*osw + c*osc, fp32 when out_f32, else bf16.
// grid = (tiles of 8x16 pixels, Cout / 128, B * Fo).
template <typename In, typename Acc, int KT>
__global__ void __launch_bounds__(kThreads)
    conv3d_taps_kernel(const In* __restrict__ x, const In* __restrict__ w,
                       const float* __restrict__ scale,
                       const float* __restrict__ addend,
                       const float* __restrict__ bias, void* __restrict__ out,
                       int Fo, int Ho, int Wo, int Cin, int Cout, int out_f32,
                       int add_h, int add_w, long long osb, long long osf,
                       long long osh, long long osw, long long osc) {
  static_assert(std::is_same<In, int8_t>::value
                    ? std::is_same<Acc, int32_t>::value
                    : std::is_same<Acc, float>::value,
                "int8 accumulates in int32, bf16 in fp32");
  constexpr int kCh = kSlab / sizeof(In);    // input channels per stage
  constexpr int kChunk = 16 / sizeof(In);    // input channels per 16 bytes
  extern __shared__ __align__(128) unsigned char smem[];

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int warp_m = warp >> 2;  // rows 4 * warp_m .. + 3 of the tile
  const int warp_n = warp & 3;   // couts 32 * warp_n .. + 31 of the block
  const int tiles_w = (Wo + kTW - 1) / kTW;
  const int h0 = (blockIdx.x / tiles_w) * kTH;
  const int w0 = (blockIdx.x % tiles_w) * kTW;
  const int n0 = blockIdx.y * kBN;
  const int b = blockIdx.z / Fo;
  const int f = blockIdx.z % Fo;
  const int Hp = Ho + 2, Wp = Wo + 2, F = Fo + KT - 1;
  const int ncb = Cin / kCh;
  const int nstages = KT * ncb;

  auto load_stage = [&](int buf, int s) {
    const int kt = s / ncb;
    const int c0 = (s % ncb) * kCh;
    const uint32_t halo = smem_addr(smem + buf * kStageBytes);
    const uint32_t wts = halo + kHaloBytes;
    const In* xf = x + (static_cast<size_t>(b) * F + f + kt) * Hp * Wp * Cin + c0;
    for (int i = tid; i < kHaloPix * 4; i += kThreads) {
      const int p = i >> 2, chunk = i & 3;
      const int h = h0 + p / kHaloW, wv = w0 + p % kHaloW;
      const bool ok = h < Hp && wv < Wp;
      const size_t off = ok ? (static_cast<size_t>(h) * Wp + wv) * Cin : 0;
      cp_async_16(halo + swz(p, chunk), xf + off + chunk * kChunk, ok ? 16 : 0);
    }
    const In* wk = w + (static_cast<size_t>(kt) * 9 * Cout + n0) * Cin + c0;
    for (int i = tid; i < 9 * kBN * 4; i += kThreads) {
      const int row = i >> 2, chunk = i & 3;  // row = tap * 128 + cout
      const size_t off =
          (static_cast<size_t>(row / kBN) * Cout + row % kBN) * Cin;
      cp_async_16(wts + swz(row, chunk), wk + off + chunk * kChunk, 16);
    }
  };

  Acc acc[4][4][4];
#pragma unroll
  for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0;
    }
  }

  load_stage(0, 0);
  cp_async_commit();
  for (int s = 0; s < nstages; ++s) {
    if (s + 1 < nstages) load_stage((s + 1) & 1, s + 1);
    cp_async_commit();  // possibly empty: keeps the group count uniform
    cp_async_wait_1();
    __syncthreads();
    const uint32_t halo = smem_addr(smem + (s & 1) * kStageBytes);
    const uint32_t wts = halo + kHaloBytes;
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int dh = tap / 3, dw = tap % 3;
#pragma unroll
      for (int ks = 0; ks < 2; ++ks) {  // two 32-byte k steps of the slab
        uint32_t a[4][4], bq[2][4];
#pragma unroll
        for (int mi = 0; mi < 4; ++mi) {
          // the fragment's 16 rows are the 16 pixels of tile row 4*warp_m+mi
          // shifted by (dh, dw); lanes 16-31 address the upper 16 bytes
          const int p = (warp_m * 4 + mi + dh) * kHaloW + (lane & 15) + dw;
          ldmatrix_x4(a[mi], halo + swz(p, ks * 2 + (lane >> 4)));
        }
#pragma unroll
        for (int nj = 0; nj < 2; ++nj) {
          // matrices: (cout 0-7, lo), (cout 0-7, hi), (cout 8-15, lo), (.., hi)
          const int row = tap * kBN + warp_n * 32 + nj * 16 + (lane & 7) +
                          ((lane >> 4) << 3);
          ldmatrix_x4(bq[nj], wts + swz(row, ks * 2 + ((lane >> 3) & 1)));
        }
#pragma unroll
        for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
          for (int nj = 0; nj < 2; ++nj) {
            mma(acc[mi][2 * nj], a[mi], bq[nj][0], bq[nj][1]);
            mma(acc[mi][2 * nj + 1], a[mi], bq[nj][2], bq[nj][3]);
          }
        }
      }
    }
    __syncthreads();  // every warp is done with this stage before it refills
  }

  // Epilogue: c0, c1 of a fragment are pixel column g, couts 2t and 2t + 1;
  // c2, c3 the same couts at column g + 8. __fmul_rn and __fadd_rn keep the
  // compiler from fusing the steps: each rounds as the plain version's does.
  const int g = lane >> 2, t = lane & 3;
  float sc[4][2], bs[4][2];
#pragma unroll
  for (int ni = 0; ni < 4; ++ni) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int c = n0 + warp_n * 32 + ni * 8 + t * 2 + e;
      sc[ni][e] = scale != nullptr ? __ldg(scale + c) : 1.f;
      bs[ni][e] = bias != nullptr ? __ldg(bias + c) : 0.f;
    }
  }
  const long long frame = b * osb + f * osf;
#pragma unroll
  for (int mi = 0; mi < 4; ++mi) {
    const int h = h0 + warp_m * 4 + mi;
    if (h >= Ho) continue;
    const int cls_h = h == Ho - 1 ? add_h - 1 : min(h, 1);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int wv = w0 + g + half * 8;
      if (wv >= Wo) continue;
      const int cls = cls_h * add_w + (wv == Wo - 1 ? add_w - 1 : min(wv, 1));
      const long long pix = frame + h * osh + wv * osw;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int c = n0 + warp_n * 32 + ni * 8 + t * 2;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float v = static_cast<float>(acc[mi][ni][half * 2 + e]);
          if (std::is_same<In, int8_t>::value) v = __fmul_rn(v, sc[ni][e]);
          if (addend != nullptr) {
            v = __fadd_rn(v, __ldg(addend + (c + e) * add_h * add_w + cls));
          }
          if (bias != nullptr) v = __fadd_rn(v, bs[ni][e]);
          const long long at = pix + (c + e) * osc;
          if (out_f32) {
            static_cast<float*>(out)[at] = v;
          } else {
            static_cast<__nv_bfloat16*>(out)[at] = __float2bfloat16_rn(v);
          }
        }
      }
    }
  }
}

template <typename In, typename Acc, int KT>
int launch(const void* x, const void* w, const void* scale, const void* addend,
           const void* bias, void* out, int B, int Fo, int Ho, int Wo, int Cin,
           int Cout, int out_f32, int add_h, int add_w, long long osb,
           long long osf, long long osh, long long osw, long long osc,
           void* stream) {
  auto kernel = conv3d_taps_kernel<In, Acc, KT>;
  static bool opted_in = false;  // more than 48 KB of dynamic shared memory
  if (!opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    opted_in = true;
  }
  const int tiles = ((Ho + kTH - 1) / kTH) * ((Wo + kTW - 1) / kTW);
  const dim3 grid(tiles, Cout / kBN, B * Fo);
  kernel<<<grid, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const In*>(x), static_cast<const In*>(w),
      static_cast<const float*>(scale), static_cast<const float*>(addend),
      static_cast<const float*>(bias), out, Fo, Ho, Wo, Cin, Cout, out_f32,
      add_h, add_w, osb, osf, osh, osw, osc);
  return static_cast<int>(cudaGetLastError());
}

constexpr int kQW = 32;   // pixels of one row per block
constexpr int kQC = 128;  // channels per block

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// x: [B, C, F, H, W] contiguous; out: int8 [B, F, H + 2 pad, W + 2 pad, C]
// contiguous, border included (written as the code 0). mult: fp32 [C] with
// off: fp32 [1], or null with s, m: fp32 [1]. grid = (W tiles x C tiles,
// H + 2 pad, B * F).
template <typename T>
__global__ void __launch_bounds__(256)
    quant_pack_kernel(const T* __restrict__ x, const float* __restrict__ mult,
                      const float* __restrict__ off,
                      const float* __restrict__ s, const float* __restrict__ m,
                      int8_t* __restrict__ out, int C, int F, int H, int W,
                      int pad) {
  // rows of 132 bytes: 33 words, so the 32 lanes of a warp, one pixel each,
  // store their bytes into 32 different banks
  __shared__ __align__(16) int8_t tile[kQW][kQC + 4];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int Hp = H + 2 * pad, Wp = W + 2 * pad;
  const int nct = (C + kQC - 1) / kQC;
  const int w0 = (blockIdx.x / nct) * kQW, c0 = (blockIdx.x % nct) * kQC;
  const int hp = blockIdx.y, b = blockIdx.z / F, f = blockIdx.z % F;
  const int h = hp - pad, wv = w0 + lane - pad;
  const bool inside = h >= 0 && h < H && wv >= 0 && wv < W;
  const float offv = mult != nullptr ? __ldg(off) : 0.f;
  const float sv = mult != nullptr ? 1.f : __ldg(s);
  const float mv = mult != nullptr ? 0.f : __ldg(m);
  for (int ci = warp; ci < kQC; ci += 8) {  // a warp reads 32 pixels of one channel
    const int c = c0 + ci;
    int8_t q = 0;
    if (inside && c < C) {
      const size_t at =
          (((static_cast<size_t>(b) * C + c) * F + f) * H + h) * W + wv;
      const float v = to_float(x[at]);
      float r = mult != nullptr ? fmaf(v, __ldg(mult + c), offv)
                                : __fdiv_rn(__fsub_rn(v, mv), sv);
      r = fminf(fmaxf(rintf(r), -127.f), 127.f);  // halves to even, then the clip
      q = static_cast<int8_t>(static_cast<int>(r));
    }
    tile[lane][ci] = q;
  }
  __syncthreads();
  for (int p = warp; p < kQW; p += 8) {  // a warp writes 128 channels of one pixel
    const int wp = w0 + p, c = c0 + lane * 4;
    if (wp >= Wp || c >= C) continue;
    const size_t at =
        ((static_cast<size_t>(blockIdx.z) * Hp + hp) * Wp + wp) * C + c;
    *reinterpret_cast<uint32_t*>(out + at) =
        *reinterpret_cast<const uint32_t*>(&tile[p][lane * 4]);
  }
}

// Cin in whole 64-channel slabs (two bf16 slabs), Cout in whole 128 blocks.
bool bad_shape(int B, int Fo, int Ho, int Wo, int Cin, int Cout, int kt) {
  return B <= 0 || Fo <= 0 || Ho <= 0 || Wo <= 0 || Cin <= 0 || Cout <= 0 ||
         Cin % 64 != 0 || Cout % kBN != 0 || (kt != 1 && kt != 3) ||
         static_cast<long long>(B) * Fo > 65535 || Cout / kBN > 65535;
}

}  // namespace

// K4. x: int8 [B, Fo + kt - 1, Ho + 2, Wo + 2, Cin]; w: int8 [kt * 9, Cout,
// Cin]; scale: fp32 [Cout] on the device; addend: fp32 [Cout, add_h, add_w]
// or null; bias: fp32 [Cout] or null; out: fp32 (out_f32) or bf16, written
// through the element strides os*. kt is 3 or 1. Launches on `stream` and
// returns the cudaError_t of the launch (0 on success); no synchronisation.
extern "C" int dove_conv3d_w8a8(const void* x, const void* w,
                                const void* scale, const void* addend,
                                const void* bias, void* out, int B, int Fo,
                                int Ho, int Wo, int Cin, int Cout, int kt,
                                int out_f32, int add_h, int add_w,
                                long long osb, long long osf, long long osh,
                                long long osw, long long osc, void* stream) {
  if (bad_shape(B, Fo, Ho, Wo, Cin, Cout, kt) || scale == nullptr ||
      (addend != nullptr && (add_h < 1 || add_h > 3 || add_w < 1 || add_w > 3))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (kt == 3) {
    return launch<int8_t, int32_t, 3>(x, w, scale, addend, bias, out, B, Fo, Ho,
                                      Wo, Cin, Cout, out_f32, add_h, add_w, osb,
                                      osf, osh, osw, osc, stream);
  }
  return launch<int8_t, int32_t, 1>(x, w, scale, addend, bias, out, B, Fo, Ho,
                                    Wo, Cin, Cout, out_f32, add_h, add_w, osb,
                                    osf, osh, osw, osc, stream);
}

// K5. As K4 with bf16 x and w, fp32 accumulation, no scale, addend or bias.
extern "C" int dove_conv3d_bf16(const void* x, const void* w, void* out, int B,
                                int Fo, int Ho, int Wo, int Cin, int Cout,
                                int kt, int out_f32, long long osb,
                                long long osf, long long osh, long long osw,
                                long long osc, void* stream) {
  if (bad_shape(B, Fo, Ho, Wo, Cin, Cout, kt)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (kt == 3) {
    return launch<__nv_bfloat16, float, 3>(x, w, nullptr, nullptr, nullptr, out,
                                           B, Fo, Ho, Wo, Cin, Cout, out_f32, 1,
                                           1, osb, osf, osh, osw, osc, stream);
  }
  return launch<__nv_bfloat16, float, 1>(x, w, nullptr, nullptr, nullptr, out, B,
                                         Fo, Ho, Wo, Cin, Cout, out_f32, 1, 1,
                                         osb, osf, osh, osw, osc, stream);
}

// The activation quantizer's last step. x: bf16 (x_bf16) or fp32 [B, C, F, H,
// W]; with mult (fp32 [C]) the code is round(fma(x, mult[c], off[0])), else
// round((x - m[0]) / s[0]); out: int8 [B, F, H + 2 pad, W + 2 pad, C], its
// border zero. C must be a multiple of 4. Returns the launch's cudaError_t.
extern "C" int dove_quant_pack(const void* x, const void* mult, const void* off,
                               const void* s, const void* m, void* out, int B,
                               int C, int F, int H, int W, int pad, int x_bf16,
                               void* stream) {
  if (B <= 0 || C <= 0 || F <= 0 || H <= 0 || W <= 0 || pad < 0 || C % 4 != 0 ||
      H + 2 * pad > 65535 || static_cast<long long>(B) * F > 65535 ||
      (mult != nullptr ? off == nullptr : (s == nullptr || m == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int wtiles = (W + 2 * pad + kQW - 1) / kQW, ctiles = (C + kQC - 1) / kQC;
  const dim3 grid(wtiles * ctiles, H + 2 * pad, B * F);
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* mu = static_cast<const float*>(mult);
  const auto* of = static_cast<const float*>(off);
  const auto* sp = static_cast<const float*>(s);
  const auto* mp = static_cast<const float*>(m);
  if (x_bf16) {
    quant_pack_kernel<__nv_bfloat16><<<grid, 256, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), mu, of, sp, mp,
        static_cast<int8_t*>(out), C, F, H, W, pad);
  } else {
    quant_pack_kernel<float><<<grid, 256, 0, st>>>(
        static_cast<const float*>(x), mu, of, sp, mp, static_cast<int8_t*>(out),
        C, F, H, W, pad);
  }
  return static_cast<int>(cudaGetLastError());
}
