// The VAE's norm primitive for Hopper (sm_90a): silu(GroupNorm(x)), with the
// norm's affine and, in the decoder, the spatial modulation of SpatialNorm3d,
// in two forms: over NCDHW x (two passes), and over channels-last NDHWC x
// (three passes), the form the VAE's activations take on the card.
//
// It replaces no TPU kernel: the JAX package's GroupNorm is XLA
// (dove_tpu/models/vae.py), which fuses the statistics, the affine, the
// modulation and SiLU on the TPU. On the card the port ran ATen's group_norm
// (whose statistics kernel takes one block per sample and group: 32 blocks
// on 132 SMs for a window at B = 1), then the affine, the full-size
// repeat_interleave of the decoder's 1x1x1 convs, their product and sum, and
// SiLU, each a pass over memory. The work reads and writes memory only, so
// bytes bound it: one read for the statistics, one read to apply them, one
// write.
//
// The NCDHW form.
//
// group_norm_stats_kernel: a (sample, group) is one contiguous span of
// (C / G) F H W elements. Each span is cut into S chunks, S chosen by the
// host from the shape so that the grid covers every SM several times over.
// A block reads its chunk in 16-byte vectors, two in flight a thread, takes
// each vector's mean and M2 in fp32 and merges them into its thread's
// (count, mean, M2) by Chan's formula, then merges the block's threads in a
// fixed order and writes one partial. No atomics: a clip is bit for bit the
// same from run to run.
//
// group_norm_apply_kernel: each block merges its span's S partials in a
// fixed order (every block of a span gets the same bits), then for each
// element y = a x + b with a = rstd gamma_c, b = beta_c - mean a; in the
// decoder y = y cy[c, f', h', w'] + cb[c, f', h', w'], read from the
// latent-resolution conv outputs by nearest index (f' by the causal rule:
// frame 0 alone on latent frame 0 at a clip's start); then SiLU, all in
// fp32, and one rounding to x's type, stored NCDHW in 16-byte vectors. An
// element's coordinates come from one division chain per vector and are
// stepped from there, element by element; the modulation's two values are
// read again only where w' or the row changes (every 8 columns at the
// decoder's finest level). At most 64 registers a thread, four blocks an SM.
//
// The channels-last form. In NDHWC a (sample, group) is no longer one span:
// at each of a sample's P = F H W positions a row of C channels holds every
// group's C / G of them side by side. A 16-byte vector of a row holds kVec
// channels (8 in bf16 and fp16, 4 in fp32), so a group is part of a vector
// (C / G < kVec: K = kVec G / C groups a vector), or one or more whole
// vectors. A row is cols = C / kVec vectors, a power of two up to 256, and a
// block's 256 threads sweep R = 256 / cols rows at a time: thread t always
// reads vector column t % cols, so the channels it touches are fixed for its
// whole life, and a warp reads whole rows, contiguous.
//
// group_norm_stats_cl_kernel: a sample's positions are cut into S chunks of
// whole rows (S from the shape and the SM count, as in the NCDHW form). A
// thread keeps a (count, mean, M2) for each of the K groups its column
// touches and merges each vector's part into them; the block then merges,
// for each group, its threads' moments in a fixed order (rows, then
// columns) and writes one partial a group: [B, S, G, 3].
//
// group_norm_finalize_cl_kernel: one warp a (sample, group) merges the S
// partials in a fixed order, and folds the statistics into each channel's
// a = rstd gamma_c and b = beta_c - mean a: fp32 [B, C, 2].
//
// group_norm_apply_cl_kernel: each thread loads the a and b of its kVec
// channels once, then per row y = a x + b, in the decoder times cy and plus
// cb read as 16-byte vectors of a channels-last [B, Fl, Hl, Wl, C] by the
// nearest-index rule, then SiLU, in fp32 with one rounding, stored NDHWC.
// The output holds lead + F frames a sample, y from frame lead on: the frames
// before it are the next causal conv's left context, so the conv reads its
// input in place and nothing concatenates it. Where a row lies in frame 0 its
// thread also writes those lead frames at the same position: a copy of the
// caller's left frames (the conv's cache from the previous chunk), or at a
// clip's start y itself, frame 0 repeated, as the causal conv pads.
//
// Neither form uses atomics: a clip is bit for bit the same from run to run,
// and a NaN stays in its group.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// n / d for 0 <= n < 2^31, as (umulhi(n, m) + n) >> s (Granlund and
// Montgomery; the host computes m and s)
struct FastDiv {
  uint32_t d, m, s;
};

__device__ __forceinline__ uint32_t fdiv(uint32_t n, const FastDiv& q) {
  return (__umulhi(n, q.m) + n) >> q.s;
}

FastDiv make_div(uint32_t d) {
  uint32_t s = 0;
  while ((uint64_t{1} << s) < d) ++s;
  const uint64_t m = ((uint64_t{1} << 32) * ((uint64_t{1} << s) - d)) / d + 1;
  return {d, static_cast<uint32_t>(m), s};
}

// one span's shape, and the modulation's where there is one
struct Geometry {
  int groups, cg, channels, splits;
  FastDiv w, h, f;      // x's W, H, F
  int lf, lh, lw;       // the modulation's Fl, Hl, Wl
  FastDiv rf, rh, rw;   // x's frames, rows, columns per modulation one
  int causal;           // frame 0 on latent frame 0 alone, the rest from 1
  float eps;
};

struct Moments {
  float n, mean, m2;
};

__device__ __forceinline__ Moments merge(const Moments& a, const Moments& b) {
  if (b.n == 0.f) return a;
  if (a.n == 0.f) return b;
  const float n = a.n + b.n;
  const float d = b.mean - a.mean;
  const float wb = __fdividef(b.n, n);
  return {n, fmaf(d, wb, a.mean), a.m2 + b.m2 + d * d * a.n * wb};
}

// lane 0 ends with the warp's merge, taken in a fixed order
__device__ __forceinline__ Moments warp_merge(Moments m) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const Moments other{__shfl_down_sync(0xffffffffu, m.n, o),
                        __shfl_down_sync(0xffffffffu, m.mean, o),
                        __shfl_down_sync(0xffffffffu, m.m2, o)};
    m = merge(m, other);
  }
  return m;
}

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_float(__half v) { return __half2float(v); }

template <typename T> __device__ __forceinline__ T from_float(float v);
template <> __device__ __forceinline__ float from_float<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
template <> __device__ __forceinline__ __half from_float<__half>(float v) {
  return __float2half_rn(v);
}

// 16 bytes <-> kVec floats
template <typename T> struct Pack {
  static constexpr int kVec = 16 / sizeof(T);
  __device__ __forceinline__ static void unpack(const uint4& r, float* v) {
    const T* e = reinterpret_cast<const T*>(&r);
#pragma unroll
    for (int i = 0; i < kVec; ++i) v[i] = to_float(e[i]);
  }
  __device__ __forceinline__ static uint4 pack(const float* v) {
    uint4 r;
    T* e = reinterpret_cast<T*>(&r);
#pragma unroll
    for (int i = 0; i < kVec; ++i) e[i] = from_float<T>(v[i]);
    return r;
  }
};

// The vectors of a span that lie wholly inside it (x's base is 16-byte
// aligned, so vector k holds elements [k kVec, (k + 1) kVec)), and this
// chunk's share of them: [first, last).
struct Chunk {
  long long span_start, span_end, v0, v1, first, last;
};

template <int kVec>
__device__ __forceinline__ Chunk chunk_of(long long span, long long span_len, int part,
                                          int splits) {
  Chunk c;
  c.span_start = span * span_len;
  c.span_end = c.span_start + span_len;
  c.v0 = (c.span_start + kVec - 1) / kVec;
  c.v1 = c.span_end / kVec;
  if (c.v1 < c.v0) c.v1 = c.v0;
  const long long nv = c.v1 - c.v0;
  c.first = c.v0 + nv * part / splits;
  c.last = c.v0 + nv * (part + 1) / splits;
  return c;
}

// The moments of kVec elements: their mean, and M2 about it.
template <int kVec>
__device__ __forceinline__ Moments vector_moments(const float* v) {
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < kVec; ++i) s += v[i];
  const float mean = s * (1.f / kVec);
  float q = 0.f;
#pragma unroll
  for (int i = 0; i < kVec; ++i) {
    const float d = v[i] - mean;
    q = fmaf(d, d, q);
  }
  return {static_cast<float>(kVec), mean, q};
}

// x: [B, C, F, H, W] contiguous, 16-byte aligned; partials: fp32 [B G, S, 3]
// (count, mean, M2). grid = B G S blocks of kThreads.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    group_norm_stats_kernel(const T* __restrict__ x, float* __restrict__ partials,
                            long long span_len, int splits) {
  using P = Pack<T>;
  constexpr int kVec = P::kVec;
  const long long span = blockIdx.x / splits;
  const int part = blockIdx.x % splits;
  const Chunk c = chunk_of<kVec>(span, span_len, part, splits);
  const uint4* xv = reinterpret_cast<const uint4*>(x) + c.first;
  const uint32_t n = static_cast<uint32_t>(c.last - c.first);
  Moments acc{0.f, 0.f, 0.f};
  uint32_t i = threadIdx.x;
  for (; i + kThreads < n; i += 2 * kThreads) {  // two loads in flight
    const uint4 r0 = __ldg(xv + i), r1 = __ldg(xv + i + kThreads);
    float v[kVec];
    P::unpack(r0, v);
    acc = merge(acc, vector_moments<kVec>(v));
    P::unpack(r1, v);
    acc = merge(acc, vector_moments<kVec>(v));
  }
  if (i < n) {
    float v[kVec];
    P::unpack(__ldg(xv + i), v);
    acc = merge(acc, vector_moments<kVec>(v));
  }
  // the elements outside whole vectors: the head in chunk 0, the tail in the last
  long long lo = 0, hi = 0;
  if (c.v1 == c.v0) {
    if (part == 0) lo = c.span_start, hi = c.span_end;
  } else if (part == 0) {
    lo = c.span_start, hi = c.v0 * kVec;
  }
  for (long long e = lo + threadIdx.x; e < hi; e += kThreads)
    acc = merge(acc, Moments{1.f, to_float(x[e]), 0.f});
  if (part == splits - 1 && c.v1 > c.v0) {
    for (long long e = c.v1 * kVec + threadIdx.x; e < c.span_end; e += kThreads)
      acc = merge(acc, Moments{1.f, to_float(x[e]), 0.f});
  }
  __shared__ Moments warps[kWarps];
  acc = warp_merge(acc);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) warps[warp] = acc;
  __syncthreads();
  if (warp == 0) {
    acc = lane < kWarps ? warps[lane] : Moments{0.f, 0.f, 0.f};
    acc = warp_merge(acc);
    if (lane == 0) {
      float* p = partials + 3 * static_cast<long long>(blockIdx.x);
      p[0] = acc.n;
      p[1] = acc.mean;
      p[2] = acc.m2;
    }
  }
}

// Where an element lies in its span, and what applies to it there.
struct Cursor {
  uint32_t cl, f, h, w;  // channel within the group, frame, row, column
  uint32_t wq, wr;       // w / rw, w % rw
  long long mrow;        // the modulation row's first element
  float a, b;            // the channel's affine, the statistics folded in
  float my, mb;          // the modulation at (f', h', w')
};

template <typename T, bool kMod>
struct Apply {
  const T* gamma;
  const T* beta;
  const T* cy;
  const T* cb;
  Geometry g;
  float mean, rstd;
  int sample, group;

  __device__ __forceinline__ void set_channel(Cursor& c) const {
    const int ch = group * g.cg + static_cast<int>(c.cl);
    c.a = rstd * to_float(gamma[ch]);
    c.b = fmaf(-mean, c.a, to_float(beta[ch]));
  }

  __device__ __forceinline__ void set_row(Cursor& c) const {
    if (!kMod) return;
    const uint32_t fq = g.causal ? (c.f == 0 ? 0u : 1u + fdiv(c.f - 1, g.rf)) : fdiv(c.f, g.rf);
    const long long ch = static_cast<long long>(sample) * g.channels + group * g.cg + c.cl;
    c.mrow = ((ch * g.lf + fq) * g.lh + fdiv(c.h, g.rh)) * g.lw;
  }

  // the modulation's two values where the cursor is: loaded when w' or the
  // row changes, not once an element
  __device__ __forceinline__ void load_mod(Cursor& c) const {
    if (!kMod) return;
    const long long at = c.mrow + c.wq;
    c.my = to_float(__ldg(cy + at));
    c.mb = to_float(__ldg(cb + at));
  }

  // the cursor at element l of the span
  __device__ __forceinline__ Cursor at(uint32_t l) const {
    Cursor c{};
    const uint32_t row = fdiv(l, g.w);
    c.w = l - row * g.w.d;
    const uint32_t t = fdiv(row, g.h);
    c.h = row - t * g.h.d;
    c.cl = fdiv(t, g.f);
    c.f = t - c.cl * g.f.d;
    set_channel(c);
    set_row(c);
    if (kMod) {
      c.wq = fdiv(c.w, g.rw);
      c.wr = c.w - c.wq * g.rw.d;
      load_mod(c);
    }
    return c;
  }

  // the cursor at the next element
  __device__ __forceinline__ void step(Cursor& c) const {
    if (++c.w == g.w.d) {
      c.w = 0;
      if (++c.h == g.h.d) {
        c.h = 0;
        if (++c.f == g.f.d) {
          c.f = 0;
          ++c.cl;
          set_channel(c);
        }
      }
      if (kMod) {
        set_row(c);
        c.wq = c.wr = 0;
        load_mod(c);
      }
    } else if (kMod && ++c.wr == g.rw.d) {
      c.wr = 0;
      ++c.wq;
      load_mod(c);
    }
  }

  __device__ __forceinline__ float value(const Cursor& c, float v) const {
    float y = fmaf(c.a, v, c.b);
    if (kMod) y = fmaf(y, c.my, c.mb);
    // SiLU; the clamp keeps the divisor finite (exp(80) < 2^126), a NaN
    // stays a NaN through the numerator
    return __fdividef(y, 1.f + __expf(fminf(-y, 80.f)));
  }

  __device__ __forceinline__ uint4 vector(uint32_t l, const uint4& r) const {
    using P = Pack<T>;
    float v[P::kVec];
    P::unpack(r, v);
    Cursor c = at(l);
#pragma unroll
    for (int j = 0; j < P::kVec; ++j) {
      v[j] = value(c, v[j]);
      if (j + 1 < P::kVec) step(c);
    }
    return P::pack(v);
  }
};

// out = silu(norm(x)) of the same shape and type; gamma, beta: [C] of x's
// type; with kMod, cy and cb: [B, C, Fl, Hl, Wl] of x's type. grid = B G S
// blocks of kThreads; partials as group_norm_stats_kernel wrote them.
template <typename T, bool kMod>
__global__ void __launch_bounds__(kThreads, 4)
    group_norm_apply_kernel(const T* __restrict__ x, const float* __restrict__ partials,
                            const T* __restrict__ gamma, const T* __restrict__ beta,
                            const T* __restrict__ cy, const T* __restrict__ cb,
                            T* __restrict__ out, long long span_len, Geometry g) {
  using P = Pack<T>;
  constexpr int kVec = P::kVec;
  const long long span = blockIdx.x / g.splits;
  const int part = blockIdx.x % g.splits;
  __shared__ float stats[2];
  if (threadIdx.x < 32) {  // the span's partials, merged in a fixed order
    const float* p = partials + 3 * span * g.splits;
    Moments m{0.f, 0.f, 0.f};
    for (int k = threadIdx.x; k < g.splits; k += 32)
      m = merge(m, Moments{p[3 * k], p[3 * k + 1], p[3 * k + 2]});
    m = warp_merge(m);
    if (threadIdx.x == 0) {
      stats[0] = m.mean;
      stats[1] = rsqrtf(m.m2 / m.n + g.eps);  // the biased variance, as GroupNorm
    }
  }
  __syncthreads();
  Apply<T, kMod> ap{gamma, beta, cy, cb, g, stats[0], stats[1],
                    static_cast<int>(span / g.groups), static_cast<int>(span % g.groups)};
  const Chunk c = chunk_of<kVec>(span, span_len, part, g.splits);
  const uint4* xv = reinterpret_cast<const uint4*>(x) + c.first;
  uint4* ov = reinterpret_cast<uint4*>(out) + c.first;
  const uint32_t n = static_cast<uint32_t>(c.last - c.first);
  const uint32_t l0 = static_cast<uint32_t>(c.first * kVec - c.span_start);
  uint32_t i = threadIdx.x;
  for (; i + kThreads < n; i += 2 * kThreads) {  // two loads in flight
    const uint4 r0 = __ldg(xv + i), r1 = __ldg(xv + i + kThreads);
    ov[i] = ap.vector(l0 + i * kVec, r0);
    ov[i + kThreads] = ap.vector(l0 + (i + kThreads) * kVec, r1);
  }
  if (i < n) ov[i] = ap.vector(l0 + i * kVec, __ldg(xv + i));
  // the elements outside whole vectors, one at a time
  long long lo = 0, hi = 0;
  if (c.v1 == c.v0) {
    if (part == 0) lo = c.span_start, hi = c.span_end;
  } else if (part == 0) {
    lo = c.span_start, hi = c.v0 * kVec;
  }
  for (long long e = lo + threadIdx.x; e < hi; e += kThreads)
    out[e] = from_float<T>(ap.value(ap.at(static_cast<uint32_t>(e - c.span_start)),
                                    to_float(x[e])));
  if (part == g.splits - 1 && c.v1 > c.v0) {
    for (long long e = c.v1 * kVec + threadIdx.x; e < c.span_end; e += kThreads)
      out[e] = from_float<T>(ap.value(ap.at(static_cast<uint32_t>(e - c.span_start)),
                                      to_float(x[e])));
  }
}

template <typename T>
int launch(const void* x, const void* gamma, const void* beta, const void* cy,
           const void* cb, void* out, void* partials, int B, long long span_len,
           const Geometry& g, cudaStream_t st) {
  const unsigned blocks = static_cast<unsigned>(static_cast<long long>(B) * g.groups * g.splits);
  const auto* xt = static_cast<const T*>(x);
  auto* pt = static_cast<float*>(partials);
  group_norm_stats_kernel<T><<<blocks, kThreads, 0, st>>>(xt, pt, span_len, g.splits);
  const auto* gt = static_cast<const T*>(gamma);
  const auto* bt = static_cast<const T*>(beta);
  auto* ot = static_cast<T*>(out);
  if (cy != nullptr) {
    group_norm_apply_kernel<T, true><<<blocks, kThreads, 0, st>>>(
        xt, pt, gt, bt, static_cast<const T*>(cy), static_cast<const T*>(cb), ot, span_len, g);
  } else {
    group_norm_apply_kernel<T, false><<<blocks, kThreads, 0, st>>>(
        xt, pt, gt, bt, nullptr, nullptr, ot, span_len, g);
  }
  return static_cast<int>(cudaGetLastError());
}


// ---------------------------------------------------------------------------
// The channels-last form
// ---------------------------------------------------------------------------

// a sample's shape as the channels-last passes see it
struct ClGeometry {
  long long positions;  // P = F H W
  int channels, groups, cols, col_shift, splits;
  int lead;             // frames in front of y in the output
  uint32_t hw;          // H W: rows of frame 0 are those under it
  FastDiv fhw, w;       // division by H W and by W: a row's frame, row, column
  int lf, lh, lw;       // the modulation's Fl, Hl, Wl
  FastDiv rf, rh, rw;   // x's frames, rows, columns per modulation one
  int causal;
};

// this block's sample and its chunk of whole rows [r0, r1)
struct RowChunk {
  long long sample, r0, r1;
};

__device__ __forceinline__ RowChunk row_chunk(long long positions, int splits) {
  RowChunk c;
  c.sample = blockIdx.x / splits;
  const long long part = blockIdx.x % splits;
  c.r0 = positions * part / splits;
  c.r1 = positions * (part + 1) / splits;
  return c;
}

// K groups a vector: each takes kVec / K of its elements
template <typename T, int K>
__global__ void __launch_bounds__(kThreads)
    group_norm_stats_cl_kernel(const T* __restrict__ x, float* __restrict__ partials,
                               ClGeometry g) {
  using P = Pack<T>;
  constexpr int kVec = P::kVec;
  constexpr int kPer = kVec / K;
  const RowChunk c = row_chunk(g.positions, g.splits);
  const int col = threadIdx.x & (g.cols - 1);
  const int rows = kThreads >> g.col_shift;  // R
  const uint4* xv = reinterpret_cast<const uint4*>(x) + c.sample * g.positions * g.cols + col;
  Moments acc[K];
#pragma unroll
  for (int k = 0; k < K; ++k) acc[k] = Moments{0.f, 0.f, 0.f};
  long long r = c.r0 + (threadIdx.x >> g.col_shift);
  for (; r + rows < c.r1; r += 2 * rows) {  // two loads in flight
    const uint4 r0 = __ldg(xv + r * g.cols), r1 = __ldg(xv + (r + rows) * g.cols);
    float v[kVec];
    P::unpack(r0, v);
#pragma unroll
    for (int k = 0; k < K; ++k) acc[k] = merge(acc[k], vector_moments<kPer>(v + k * kPer));
    P::unpack(r1, v);
#pragma unroll
    for (int k = 0; k < K; ++k) acc[k] = merge(acc[k], vector_moments<kPer>(v + k * kPer));
  }
  if (r < c.r1) {
    float v[kVec];
    P::unpack(__ldg(xv + r * g.cols), v);
#pragma unroll
    for (int k = 0; k < K; ++k) acc[k] = merge(acc[k], vector_moments<kPer>(v + k * kPer));
  }
  __shared__ Moments moments[kThreads * K];
#pragma unroll
  for (int k = 0; k < K; ++k) moments[threadIdx.x * K + k] = acc[k];
  __syncthreads();
  // group q: column q / K, part q % K of it where K > 1, else columns
  // [q cpg, (q + 1) cpg) with cpg = cols / groups; rows, then columns
  const int cpg = K > 1 ? 1 : g.cols / g.groups;
  for (int q = threadIdx.x; q < g.groups; q += kThreads) {
    const int c0 = K > 1 ? q / K : q * cpg;
    const int k = K > 1 ? q % K : 0;
    Moments m{0.f, 0.f, 0.f};
    for (int rr = 0; rr < rows; ++rr)
      for (int cc = c0; cc < c0 + cpg; ++cc) m = merge(m, moments[((rr << g.col_shift) + cc) * K + k]);
    float* p = partials + 3 * (static_cast<long long>(blockIdx.x) * g.groups + q);
    p[0] = m.n;
    p[1] = m.mean;
    p[2] = m.m2;
  }
}

// one warp a (sample, group): ab[sample, c] = (a, b) of each of its channels
template <typename T>
__global__ void __launch_bounds__(kThreads)
    group_norm_finalize_cl_kernel(const float* __restrict__ partials,
                                  const T* __restrict__ gamma, const T* __restrict__ beta,
                                  float* __restrict__ ab, int spans, int groups, int channels,
                                  int splits, float eps) {
  const int span = (blockIdx.x * kThreads + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (span >= spans) return;  // the whole warp
  const int sample = span / groups, q = span % groups;
  Moments m{0.f, 0.f, 0.f};
  for (int k = lane; k < splits; k += 32) {
    const float* p = partials + 3 * ((static_cast<long long>(sample) * splits + k) * groups + q);
    m = merge(m, Moments{p[0], p[1], p[2]});
  }
  m = warp_merge(m);
  const float mean = __shfl_sync(0xffffffffu, m.mean, 0);
  const float rstd = rsqrtf(__shfl_sync(0xffffffffu, m.m2, 0) /
                                __shfl_sync(0xffffffffu, m.n, 0) + eps);
  const int cg = channels / groups;
  for (int i = lane; i < cg; i += 32) {
    const int ch = q * cg + i;
    const float a = rstd * to_float(gamma[ch]);
    float* o = ab + 2 * (static_cast<long long>(sample) * channels + ch);
    o[0] = a;
    o[1] = fmaf(-mean, a, to_float(beta[ch]));
  }
}

// out[sample] = lead frames, then silu(norm(x)) modulated where kMod:
// [B, lead + F, H, W, C]; left: null (frame 0 repeated) or [B, lead, H, W, C]
template <typename T, bool kMod>
__global__ void __launch_bounds__(kThreads, 4)
    group_norm_apply_cl_kernel(const T* __restrict__ x, const float* __restrict__ ab,
                               const T* __restrict__ cy, const T* __restrict__ cb,
                               const T* __restrict__ left, T* __restrict__ out, ClGeometry g) {
  using P = Pack<T>;
  constexpr int kVec = P::kVec;
  const RowChunk c = row_chunk(g.positions, g.splits);
  const int col = threadIdx.x & (g.cols - 1);
  const int rows = kThreads >> g.col_shift;
  float a[kVec], b[kVec];
  {
    const float2* abv =
        reinterpret_cast<const float2*>(ab) + (c.sample * g.channels + col * kVec);
#pragma unroll
    for (int e = 0; e < kVec; ++e) {
      const float2 t = abv[e];
      a[e] = t.x;
      b[e] = t.y;
    }
  }
  const long long frame_rows = g.hw;
  const uint4* xv = reinterpret_cast<const uint4*>(x) + c.sample * g.positions * g.cols + col;
  uint4* ov = reinterpret_cast<uint4*>(out) +
              (c.sample * (g.positions + g.lead * frame_rows)) * g.cols + col;
  const uint4* lv = left == nullptr ? nullptr
                    : reinterpret_cast<const uint4*>(left) +
                          c.sample * g.lead * frame_rows * g.cols + col;

  auto row = [&](long long r, const uint4& raw) {
    float v[kVec];
    P::unpack(raw, v);
    float my[kVec], mb[kVec];
    if (kMod) {
      const uint32_t rr = static_cast<uint32_t>(r);
      const uint32_t f = fdiv(rr, g.fhw);
      const uint32_t rem = rr - f * g.fhw.d;
      const uint32_t h = fdiv(rem, g.w);
      const uint32_t w = rem - h * g.w.d;
      const uint32_t fq = g.causal ? (f == 0 ? 0u : 1u + fdiv(f - 1, g.rf)) : fdiv(f, g.rf);
      const long long at =
          (((c.sample * g.lf + fq) * g.lh + fdiv(h, g.rh)) * g.lw + fdiv(w, g.rw)) * g.cols + col;
      P::unpack(__ldg(reinterpret_cast<const uint4*>(cy) + at), my);
      P::unpack(__ldg(reinterpret_cast<const uint4*>(cb) + at), mb);
    }
#pragma unroll
    for (int e = 0; e < kVec; ++e) {
      float y = fmaf(a[e], v[e], b[e]);
      if (kMod) y = fmaf(y, my[e], mb[e]);
      // SiLU; the clamp keeps the divisor finite, a NaN stays a NaN
      v[e] = __fdividef(y, 1.f + __expf(fminf(-y, 80.f)));
    }
    const uint4 o = P::pack(v);
    ov[(g.lead * frame_rows + r) * g.cols] = o;
    if (r < frame_rows) {  // frame 0: the lead frames at this position too
      for (int l = 0; l < g.lead; ++l)
        ov[(l * frame_rows + r) * g.cols] =
            lv == nullptr ? o : __ldg(lv + (l * frame_rows + r) * g.cols);
    }
  };

  long long r = c.r0 + (threadIdx.x >> g.col_shift);
  for (; r + rows < c.r1; r += 2 * rows) {  // two loads in flight
    const uint4 r0 = __ldg(xv + r * g.cols), r1 = __ldg(xv + (r + rows) * g.cols);
    row(r, r0);
    row(r + rows, r1);
  }
  if (r < c.r1) row(r, __ldg(xv + r * g.cols));
}

template <typename T>
int launch_cl(const void* x, const void* gamma, const void* beta, const void* cy,
              const void* cb, const void* left, void* out, void* partials, void* ab, int B,
              int groups_per_vector, const ClGeometry& g, float eps, cudaStream_t st) {
  const unsigned blocks = static_cast<unsigned>(static_cast<long long>(B) * g.splits);
  const auto* xt = static_cast<const T*>(x);
  auto* pt = static_cast<float*>(partials);
  switch (groups_per_vector) {
    case 1: group_norm_stats_cl_kernel<T, 1><<<blocks, kThreads, 0, st>>>(xt, pt, g); break;
    case 2: group_norm_stats_cl_kernel<T, 2><<<blocks, kThreads, 0, st>>>(xt, pt, g); break;
    case 4: group_norm_stats_cl_kernel<T, 4><<<blocks, kThreads, 0, st>>>(xt, pt, g); break;
    default:
      if constexpr (Pack<T>::kVec == 8) {
        group_norm_stats_cl_kernel<T, 8><<<blocks, kThreads, 0, st>>>(xt, pt, g);
      }
  }
  const int spans = B * g.groups;
  group_norm_finalize_cl_kernel<T><<<(spans * 32 + kThreads - 1) / kThreads, kThreads, 0, st>>>(
      pt, static_cast<const T*>(gamma), static_cast<const T*>(beta), static_cast<float*>(ab),
      spans, g.groups, g.channels, g.splits, eps);
  const auto* abt = static_cast<const float*>(ab);
  const auto* lt = static_cast<const T*>(left);
  auto* ot = static_cast<T*>(out);
  if (cy != nullptr) {
    group_norm_apply_cl_kernel<T, true><<<blocks, kThreads, 0, st>>>(
        xt, abt, static_cast<const T*>(cy), static_cast<const T*>(cb), lt, ot, g);
  } else {
    group_norm_apply_cl_kernel<T, false><<<blocks, kThreads, 0, st>>>(
        xt, abt, nullptr, nullptr, lt, ot, g);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// out = silu(GroupNorm(x) * gamma + beta), times cy and plus cb where cy is
// given. x, out: [B, C, F, H, W] contiguous, 16-byte aligned, of x_type 0
// (fp32), 1 (bf16) or 2 (fp16); gamma, beta: [C] of that type; cy, cb: null,
// or [B, C, Fl, Hl, Wl] of that type, with H = rh Hl, W = rw Wl and F = rf Fl,
// or with causal F - 1 = rf (Fl - 1); partials: fp32 [B groups splits 3],
// scratch. Launches the two kernels on stream; returns cudaGetLastError().
extern "C" int dove_group_norm_silu(const void* x, const void* gamma, const void* beta,
                                    const void* cy, const void* cb, void* out,
                                    void* partials, int B, int C, int F, int H, int W,
                                    int groups, int splits, float eps, int Fl, int Hl,
                                    int Wl, int causal, int x_type, void* stream) {
  const bool mod = cy != nullptr;
  const long long span_len =
      groups > 0 ? static_cast<long long>(C / groups) * F * H * W : 0;
  bool ok = x_type >= 0 && x_type <= 2 && B > 0 && C > 0 && F > 0 && H > 0 && W > 0 &&
            groups > 0 && C % groups == 0 && splits > 0 && span_len < (1LL << 31) &&
            static_cast<long long>(B) * groups * splits < (1LL << 31) &&
            (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(out)) % 16 == 0 &&
            (cb != nullptr) == mod;
  int rf = 1, rh = 1, rw = 1;
  if (ok && mod) {
    ok = Fl > 0 && Hl > 0 && Wl > 0 && H % Hl == 0 && W % Wl == 0 &&
         (causal ? Fl > 1 && (F - 1) % (Fl - 1) == 0 : F % Fl == 0);
    if (ok) {
      rf = causal ? (F - 1) / (Fl - 1) : F / Fl;
      rh = H / Hl;
      rw = W / Wl;
    }
  }
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  Geometry g{groups, C / groups, C, splits, make_div(W), make_div(H), make_div(F),
             Fl, Hl, Wl, make_div(rf), make_div(rh), make_div(rw), mod && causal, eps};
  const auto st = static_cast<cudaStream_t>(stream);
  if (x_type == 1)
    return launch<__nv_bfloat16>(x, gamma, beta, cy, cb, out, partials, B, span_len, g, st);
  if (x_type == 2)
    return launch<__half>(x, gamma, beta, cy, cb, out, partials, B, span_len, g, st);
  return launch<float>(x, gamma, beta, cy, cb, out, partials, B, span_len, g, st);
}

// The channels-last form. x: [B, F, H, W, C] contiguous, of x_type as above,
// C = cols kVec with cols a power of two up to 256 (kVec = 16 / element size),
// and C / groups a multiple or a divisor of kVec; out: [B, lead + F, H, W, C]
// contiguous, y from frame lead on; left: null (frame 0 of y repeated in the
// lead frames) or [B, lead, H, W, C] contiguous; gamma, beta: [C]; cy, cb:
// null, or [B, Fl, Hl, Wl, C] contiguous, under the NCDHW form's ratios;
// x, out, left, cy, cb 16-byte aligned; partials: fp32 [B splits groups 3],
// ab: fp32 [B C 2], scratch. Launches three kernels on stream; returns
// cudaGetLastError().
extern "C" int dove_group_norm_silu_cl(const void* x, const void* gamma, const void* beta,
                                       const void* cy, const void* cb, const void* left,
                                       void* out, void* partials, void* ab, int B, int C,
                                       int F, int H, int W, int groups, int splits, float eps,
                                       int Fl, int Hl, int Wl, int causal, int lead,
                                       int x_type, void* stream) {
  const bool mod = cy != nullptr;
  const int vec = x_type == 0 ? 4 : 8;
  const int cols = C > 0 && C % vec == 0 ? C / vec : 0;
  int shift = 0;
  while (shift < 9 && (1 << shift) < cols) ++shift;
  const int cg = groups > 0 && C % groups == 0 ? C / groups : 0;
  const int per_vector = cg > 0 && cg < vec && vec % cg == 0 ? vec / cg
                         : cg > 0 && cg % vec == 0          ? 1
                                                            : 0;
  const long long positions = static_cast<long long>(F) * H * W;
  const auto aligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  bool ok = x_type >= 0 && x_type <= 2 && B > 0 && F > 0 && H > 0 && W > 0 && cols > 0 &&
            (1 << shift) == cols && cols <= kThreads && per_vector > 0 && splits > 0 &&
            splits <= positions && lead >= 0 &&
            positions + static_cast<long long>(lead) * H * W < (1LL << 31) &&
            static_cast<long long>(B) * splits < (1LL << 31) && aligned(x) && aligned(out) &&
            (left == nullptr || aligned(left)) && (cb != nullptr) == mod &&
            (!mod || (aligned(cy) && aligned(cb)));
  int rf = 1, rh = 1, rw = 1;
  if (ok && mod) {
    ok = Fl > 0 && Hl > 0 && Wl > 0 && H % Hl == 0 && W % Wl == 0 &&
         (causal ? Fl > 1 && (F - 1) % (Fl - 1) == 0 : F % Fl == 0);
    if (ok) {
      rf = causal ? (F - 1) / (Fl - 1) : F / Fl;
      rh = H / Hl;
      rw = W / Wl;
    }
  }
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  ClGeometry g{positions, C, groups, cols, shift, splits, lead,
               static_cast<uint32_t>(H * W), make_div(static_cast<uint32_t>(H * W)),
               make_div(W), Fl, Hl, Wl, make_div(rf), make_div(rh), make_div(rw),
               mod && causal};
  const auto st = static_cast<cudaStream_t>(stream);
  if (x_type == 1)
    return launch_cl<__nv_bfloat16>(x, gamma, beta, cy, cb, left, out, partials, ab, B,
                                    per_vector, g, eps, st);
  if (x_type == 2)
    return launch_cl<__half>(x, gamma, beta, cy, cb, left, out, partials, ab, B, per_vector,
                             g, eps, st);
  return launch_cl<float>(x, gamma, beta, cy, cb, left, out, partials, ab, B, per_vector, g,
                          eps, st);
}
