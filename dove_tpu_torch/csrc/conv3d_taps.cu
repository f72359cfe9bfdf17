// The int8 conv's quantizer pass for Hopper (sm_90a); the convolution itself,
// K4 and K5, is csrc/conv3d_taps_sm90.cu.
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
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kQW = 32;   // pixels of one row per block
constexpr int kQC = 128;  // channels per block

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_float(__half v) { return __half2float(v); }

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

}  // namespace

// The activation quantizer's last step. x: fp32, bf16 or fp16 (x_type 0, 1
// or 2) [B, C, F, H, W]; with mult (fp32 [C]) the code is round(fma(x, mult[c], off[0])), else
// round((x - m[0]) / s[0]); out: int8 [B, F, H + 2 pad, W + 2 pad, C], its
// border zero. C must be a multiple of 4. Returns the launch's cudaError_t.
extern "C" int dove_quant_pack(const void* x, const void* mult, const void* off,
                               const void* s, const void* m, void* out, int B,
                               int C, int F, int H, int W, int pad, int x_type,
                               void* stream) {
  if (x_type < 0 || x_type > 2 || B <= 0 || C <= 0 || F <= 0 || H <= 0 || W <= 0 || pad < 0 || C % 4 != 0 ||
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
  if (x_type == 1) {
    quant_pack_kernel<__nv_bfloat16><<<grid, 256, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), mu, of, sp, mp,
        static_cast<int8_t*>(out), C, F, H, W, pad);
  } else if (x_type == 2) {
    quant_pack_kernel<__half><<<grid, 256, 0, st>>>(
        static_cast<const __half*>(x), mu, of, sp, mp, static_cast<int8_t*>(out), C,
        F, H, W, pad);
  } else {
    quant_pack_kernel<float><<<grid, 256, 0, st>>>(
        static_cast<const float*>(x), mu, of, sp, mp, static_cast<int8_t*>(out),
        C, F, H, W, pad);
  }
  return static_cast<int>(cudaGetLastError());
}
