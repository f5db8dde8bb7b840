// Fused tri-plane render kernels for Hopper (sm_90a), bound with ctypes.
//
// B1 `fused_render_kernel` replaces the Pallas kernel
//    invertavatar_tpu/ops/pallas_fused_render.py:_kernel (fused_render_pallas).
// B2 `merged_march_kernel` replaces
//    invertavatar_tpu/ops/pallas_fused_render.py:_kernel_march (fused_merged_march_pallas).
//
// What they compute (see invertavatar_torch/ops/fused_render.py for the plain
// PyTorch versions they are held against):
//   B1: for every point of the tile-major [T*S, P] coarse grid, the four
//       bilinear taps of each of the three channels-last bf16 planes (zeros
//       outside the plane), summed in fp32, mean over the planes, then the OSG
//       decoder C -> HID, softplus, HID -> 1+C; sigma raw, rgb =
//       sigmoid*1.002-0.001. Writes the raw [T*S, P, 1+C] row (bf16 or fp32).
//   B2: per tile, the merged coarse+fine depth list (d_m, is_fine, src) is
//       shared by all P rays. A fine slot is sampled and decoded as in B1, a
//       coarse slot reads its B1 raw row; then the MipNeRF march (softplus of
//       the mid density - 1, alpha, transmittance with +1e-10, midpoint rgb,
//       depth = sum(w*d_mid)/sum(w), NaN -> inf, clamp to the global range).
//
// What bounds them on an H100 at the flagship shapes (128² rays, 40 coarse +
// 24 fine samples, 256² x 32-channel planes, tile 128x4, decoder 32 -> 64 ->
// 33): bytes, for the least time the work could take. B1 moves ~72 MB (15.7
// MB grid, 12.6 MB planes, 43 MB out: 0.021 ms at 3.35 TB/s) for 5.45 GFLOP
// of MLP (0.011 ms at the 495 TFLOP/s TF32 tensor-core peak) and 0.5 GFLOP of
// taps (0.008 ms at 67 TFLOP/s fp32); B2 moves ~68 MB (43 MB raw rows, 9.4 MB
// fine projections, 12.6 MB planes) for 3.3 GFLOP of MLP and 0.4 GFLOP of
// taps and march. What holds both at ~10x that is the work behind the bytes:
// every point pulls its 12 tap rows (768 bytes) from L2, 0.5 GB for B1, and
// the fp32-accurate decoder issues 216 mma.sync per 16 points; within a warp
// the two run one after the other. chip_smoke.py times both kernels and
// prints their bounds.
//
// The design:
//   * The decoder runs on the tensor cores, 16 points per warp and 64 per
//     tile (`decode16`): mma.sync m16n8k8 TF32 with fp32 accumulation. Each
//     product is split into three (big*big + big*small + small*big, both
//     halves rounded to nearest, ties away, as cvt.rna does) so the result
//     keeps fp32 accuracy: one TF32 pass is off by ~1e-3, beyond B2's
//     tolerance. Weights are split once, when a block stages them in shared
//     memory; activations when they are loaded into fragments. Layer 1 runs
//     k-step outside, so its HID/8 accumulators are independent chains, and
//     its accumulator fragments are layer 2's A fragments in registers: the
//     k order inside each 8-wide step is permuted (k = t -> hidden 2t,
//     k = t + 4 -> hidden 2t + 1) and layer 2 reads its weights in that
//     order. The decoder's softplus and sigmoid use the hardware exp2/log2
//     (within ~5e-7 of libm's, which cost several times the instructions).
//   * The gather gives each point C/8 lanes that own 16 bytes of the bf16
//     channel row, so each tap is one coalesced segment (as B3 does). A
//     point's coordinates are found once, by one lane, and shuffled to the
//     others; its twelve tap rows are requested before any is used, so the
//     gather waits on L2 once, not twelve times. Sums keep the fp32 order of
//     the plain version's taps.
//   * B1 is persistent: each warp walks 16-point row blocks of the flat point
//     list (gather -> shared memory -> decode -> one coalesced run of output),
//     with the next block's coordinates in flight meanwhile, so the staged
//     weights serve many tiles and warps never wait on each other.
//   * B2 runs one block per (tile, 64 rays). The slot loop goes in chunks of
//     kSlotsB2 merged slots: each fine slot is one 64-ray decoder tile (four
//     16-row warp units, gathered as in B1; fine units are dealt out first),
//     each coarse slot a 16-byte-vector copy of B1's raw rows; both land in
//     one shared buffer, then four threads per ray march the chunk, each
//     owning C/4 channels, the scalar march state carried from chunk to chunk.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kRows = 16;     // rows of one warp's slice of a decoder tile (one m16 block)
constexpr int kWarpsB1 = 8;
constexpr int kWarpsB2 = 8;
constexpr int kRaysB2 = 64;   // rays per B2 block: one decoder tile
constexpr int kSlotsB2 = 4;   // merged slots per chunk of B2's slot loop: two blocks fit an SM

__device__ __forceinline__ float softplus_f(float x) {
  // jax.nn.softplus: log1p(exp(-|x|)) + max(x, 0)
  return log1pf(expf(-fabsf(x))) + fmaxf(x, 0.0f);
}

// The decoder's activations on the hardware exp2 / log2 units (MUFU): a few
// instructions each instead of ~40 for the libm versions, within ~5e-7 of
// them, far inside the kernels' tolerances. The march keeps softplus_f.
__device__ __forceinline__ float softplus_fast(float x) {
  return __logf(1.0f + __expf(-fabsf(x))) + fmaxf(x, 0.0f);
}

__device__ __forceinline__ float sigmoid_fast(float x) {
  return __fdividef(1.0f, 1.0f + __expf(-x));
}

// ------------------------------------------------------ TF32 tensor-core MMA

// Round to TF32 (10-bit mantissa), to nearest with ties away from zero: the
// rounding of cvt.rna.tf32.f32, which ptxas expands to four instructions with
// a guard for inf and NaN; adding half of the dropped bits and masking them is
// the same rounding in two (inf stays inf, NaN stays NaN).
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = big + small, both TF32 (round to nearest, ties away)
__device__ __forceinline__ void split_tf32(float x, uint32_t& big, uint32_t& small) {
  big = tf32_rna(x);
  small = tf32_rna(x - __uint_as_float(big));
}

// d += a * b, one m16n8k8 TF32 product (row-major A, column-major B).
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a * b with a = ab + as and b = bb + bs: small*big, big*small, big*big
// (small*small is below fp32's rounding).
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&ab)[4],
                                     const uint32_t (&as)[4], uint32_t bb0, uint32_t bb1,
                                     uint32_t bs0, uint32_t bs1) {
  mma_tf32(d, as, bb0, bb1);
  mma_tf32(d, ab, bs0, bs1);
  mma_tf32(d, ab, bb0, bb1);
}

// ------------------------------------------------------------------ decoder

// The packed decoder from the wrapper: [w1t: HID x C][b1: HID][w2: HID x OP4]
// [b2: OP4], OP4 = 1 + C padded to 4. Staged in shared memory as 32-bit words:
// [w1 big | w1 small: HID x XS][w2 big | w2 small: OP x HS][b1: HID][b2: OP],
// w1 by hidden unit (k contiguous), w2 by output (hidden contiguous). The row
// strides XS = C + 4 and HS = HID + 8 make the fragment loads free of bank
// conflicts.
template <int C, int HID>
struct Dec {
  static constexpr int O = C + 1;
  static constexpr int OP = (C + 1 + 7) / 8 * 8;   // layer 2's width, whole n-tiles of 8
  static constexpr int OP4 = (C + 1 + 3) / 4 * 4;  // w2/b2 stride of the packed buffer
  static constexpr int XS = C + 4;                 // row stride of x tiles and staged w1
  static constexpr int HS = HID + 8;               // row stride of staged w2
  static constexpr int kWords = (2 * HID * XS + 2 * OP * HS + HID + OP + 3) / 4 * 4;
};

template <int C, int HID>
__device__ void stage_decoder(uint32_t* sw, const float* __restrict__ wpack) {
  using D = Dec<C, HID>;
  constexpr int HS = D::HS;
  uint32_t* w1b = sw;
  uint32_t* w1s = w1b + HID * D::XS;
  uint32_t* w2b = w1s + HID * D::XS;
  uint32_t* w2s = w2b + D::OP * HS;
  float* b1 = reinterpret_cast<float*>(w2s + D::OP * HS);
  float* b2 = b1 + HID;
  const float* g_w1t = wpack;
  const float* g_b1 = g_w1t + HID * C;
  const float* g_w2 = g_b1 + HID;
  const float* g_b2 = g_w2 + HID * D::OP4;
  for (int i = threadIdx.x; i < HID * D::XS; i += blockDim.x) {
    const int n = i / D::XS, k = i % D::XS;
    split_tf32(k < C ? g_w1t[n * C + k] : 0.0f, w1b[i], w1s[i]);
  }
  for (int i = threadIdx.x; i < D::OP * HS; i += blockDim.x) {
    const int o = i / HS, j = i % HS;
    split_tf32(o < D::O && j < HID ? g_w2[j * D::OP4 + o] : 0.0f, w2b[i], w2s[i]);
  }
  for (int i = threadIdx.x; i < HID; i += blockDim.x) b1[i] = g_b1[i];
  for (int i = threadIdx.x; i < D::OP; i += blockDim.x) b2[i] = i < D::O ? g_b2[i] : 0.0f;
}

// Decode one warp's 16 rows of a 64-point decoder tile on the tensor cores.
// xs: the rows' plane-mean features [16][XS] fp32 in shared memory. Writes
// the 1+C outputs of row i to dst[i * ds + k] (sigma raw, rgb clamped
// sigmoid); dst may alias xs.
template <int C, int HID>
__device__ __forceinline__ void decode16(const uint32_t* __restrict__ sw, const float* xs,
                                         float* dst, int ds, int lane) {
  using D = Dec<C, HID>;
  constexpr int KT = C / 8, HT = HID / 8, NT = D::OP / 8, XS = D::XS, HS = D::HS;
  const uint32_t* w1b = sw;
  const uint32_t* w1s = w1b + HID * XS;
  const uint32_t* w2b = w1s + HID * XS;
  const uint32_t* w2s = w2b + D::OP * HS;
  const float* b1 = reinterpret_cast<const float*>(w2s + D::OP * HS);
  const float* b2 = b1 + HID;
  const int g = lane >> 2, t = lane & 3;

  // layer 1, k-step outside so the HT accumulators are independent chains;
  // h[ht] holds (row g, hidden 8ht+2t), (g, +1), (g+8, 2t), (g+8, +1)
  float h[HT][4];
#pragma unroll
  for (int ht = 0; ht < HT; ++ht) h[ht][0] = h[ht][1] = h[ht][2] = h[ht][3] = 0.0f;
#pragma unroll
  for (int kt = 0; kt < KT; ++kt) {
    // A fragment of x: rows g, g+8; columns t, t+4 of the k-step
    const int c = kt * 8 + t;
    uint32_t ab[4], as[4];
    split_tf32(xs[g * XS + c], ab[0], as[0]);
    split_tf32(xs[(g + 8) * XS + c], ab[1], as[1]);
    split_tf32(xs[g * XS + c + 4], ab[2], as[2]);
    split_tf32(xs[(g + 8) * XS + c + 4], ab[3], as[3]);
#pragma unroll
    for (int ht = 0; ht < HT; ++ht) {
      const int k = (ht * 8 + g) * XS + c;
      mma3(h[ht], ab, as, w1b[k], w1b[k + 4], w1s[k], w1s[k + 4]);
    }
  }
  // layer 2. With its k order inside each 8-wide step permuted (k = t ->
  // hidden 2t, k = t+4 -> 2t+1), h[ht] after bias and softplus is layer 2's
  // A fragment (a0, a2, a1, a3): no data moves between the layers.
  float o[NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    o[nt][0] = o[nt][2] = b2[nt * 8 + 2 * t];
    o[nt][1] = o[nt][3] = b2[nt * 8 + 2 * t + 1];
  }
#pragma unroll
  for (int ht = 0; ht < HT; ++ht) {
    const float c0 = b1[ht * 8 + 2 * t], c1 = b1[ht * 8 + 2 * t + 1];
    uint32_t ab[4], as[4];
    split_tf32(softplus_fast(h[ht][0] + c0), ab[0], as[0]);
    split_tf32(softplus_fast(h[ht][2] + c0), ab[1], as[1]);
    split_tf32(softplus_fast(h[ht][1] + c1), ab[2], as[2]);
    split_tf32(softplus_fast(h[ht][3] + c1), ab[3], as[3]);
    // b0 / b1: hidden 8ht+2t / 8ht+2t+1 of output 8nt+g
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int k = (nt * 8 + g) * HS + ht * 8 + 2 * t;
      const uint2 bb = *reinterpret_cast<const uint2*>(w2b + k);
      const uint2 bs = *reinterpret_cast<const uint2*>(w2s + k);
      mma3(o[nt], ab, as, bb.x, bb.y, bs.x, bs.y);
    }
  }
  __syncwarp();  // every lane has read xs before dst, which may alias it, is written
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = g + (e >> 1) * 8, col = nt * 8 + 2 * t + (e & 1);
      if (col < D::O) {
        const float v = o[nt][e];
        dst[row * ds + col] = col == 0 ? v : sigmoid_fast(v) * (1.0f + 2.0f * 0.001f) - 0.001f;
      }
    }
  }
}

// ------------------------------------------------------------------- gather

// 16 bytes of bf16 payload -> 8 floats
__device__ __forceinline__ void unpack8(const uint4 q, float (&v)[8]) {
  const uint32_t words[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    v[2 * k] = __uint_as_float(words[k] << 16);
    v[2 * k + 1] = __uint_as_float(words[k] & 0xffff0000u);
  }
}

// Channels [8q, 8q+8) of the mean over the three planes of the bilinear
// samples at pixel coordinates (gx, gy). All twelve tap rows are requested
// before any is used, so the gather waits on one round trip to L2, not twelve:
// a tap outside the plane reads texel 0 and is then zeroed with its weight,
// which keeps the sums and their order those of the zeros-padded samples.
template <int C>
__device__ __forceinline__ void sample_planes(const __nv_bfloat16* __restrict__ planes, int H,
                                              int W, int q, const float (&gx)[3],
                                              const float (&gy)[3], float (&x)[8]) {
  uint4 v[12];
  float w[12];
#pragma unroll
  for (int n = 0; n < 3; ++n) {
    const uint4* plane = reinterpret_cast<const uint4*>(planes + (size_t)n * H * W * C) + q;
    const float x0f = floorf(gx[n]), y0f = floorf(gy[n]);
    const float wx = gx[n] - x0f, wy = gy[n] - y0f;
    // coordinates far outside the plane (or NaN) would overflow int: no taps
    const bool finite = fabsf(x0f) < 1e8f && fabsf(y0f) < 1e8f;
    const int x0 = finite ? (int)x0f : -2, y0 = finite ? (int)y0f : -2;
    const float tap_w[4] = {(1.0f - wx) * (1.0f - wy), wx * (1.0f - wy), (1.0f - wx) * wy,
                            wx * wy};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int y = y0 + (k >> 1), xk = x0 + (k & 1);
      const bool in = y >= 0 && y < H && xk >= 0 && xk < W;  // zeros padding
      const uint4 r = __ldg(plane + (in ? ((size_t)y * W + xk) * (C / 8) : 0));
      v[4 * n + k] = in ? r : make_uint4(0u, 0u, 0u, 0u);
      w[4 * n + k] = in ? tap_w[k] : 0.0f;
    }
  }
#pragma unroll
  for (int c = 0; c < 8; ++c) x[c] = 0.0f;
#pragma unroll
  for (int i = 0; i < 12; ++i) {
    float f[8];
    unpack8(v[i], f);
#pragma unroll
    for (int c = 0; c < 8; ++c) x[c] += w[i] * f[c];
  }
#pragma unroll
  for (int c = 0; c < 8; ++c) x[c] *= (1.0f / 3.0f);
}

// A point's plane-space xy -> pixel coordinates (align_corners=False).
__device__ __forceinline__ void to_pixels(float2 q, int H, int W, float& gx, float& gy) {
  gx = (q.x + 1.0f) * (W * 0.5f) - 0.5f;
  gy = (q.y + 1.0f) * (H * 0.5f) - 0.5f;
}

__device__ __forceinline__ float2 nan2() {
  return make_float2(__int_as_float(0x7fc00000), __int_as_float(0x7fc00000));
}

// Fill the warp's 16 feature rows xs [16][XS]. Lane i < 16 holds row i's
// plane-space coordinates on the three planes, q[n] (NaN for a row past the
// end, which samples zeros), and hands them to the C/8 lanes that gather
// the row.
template <int C, int XS>
__device__ __forceinline__ void gather_rows(const __nv_bfloat16* __restrict__ planes, int H, int W,
                                            const float2 (&q)[3], float* xs, int lane) {
  constexpr int V = C / 8;
  float gx[3], gy[3];
#pragma unroll
  for (int n = 0; n < 3; ++n) to_pixels(q[n], H, W, gx[n], gy[n]);
#pragma unroll
  for (int it = 0; it < kRows * V; it += 32) {
    const int idx = it + lane;
    const int i = idx / V, c8 = idx % V;
    float px[3], py[3];
#pragma unroll
    for (int n = 0; n < 3; ++n) {
      px[n] = __shfl_sync(0xffffffffu, gx[n], i);
      py[n] = __shfl_sync(0xffffffffu, gy[n], i);
    }
    if (idx < kRows * V) {
      float x[8];
      sample_planes<C>(planes, H, W, c8, px, py, x);
      float4* dst = reinterpret_cast<float4*>(xs + i * XS + 8 * c8);
      dst[0] = make_float4(x[0], x[1], x[2], x[3]);
      dst[1] = make_float4(x[4], x[5], x[6], x[7]);
    }
  }
}

// ------------------------------------------------------------------ kernels

// Write rows [0, nv) of xs [.][XS] (O values each) to the contiguous output
// run out[base : base + nv*O], as fp32 or, two values per store, bf16 (base
// is even: row blocks start at multiples of 16 rows). NV = nv when the whole
// block is stored, so the loop unrolls; 1 for a ragged block.
template <int O, int XS, int NV>
__device__ __forceinline__ void store_rows(const float* xs, void* out, size_t base, int out_f32,
                                           int lane, int nv = NV) {
  const int n = nv * O;
  if (out_f32) {
    float* dst = reinterpret_cast<float*>(out) + base;
#pragma unroll
    for (int e = lane; e < NV * O; e += 32)
      if (e < n) dst[e] = xs[(e / O) * XS + e % O];
    for (int e = NV * O + lane; e < n; e += 32) dst[e] = xs[(e / O) * XS + e % O];
  } else {
    __nv_bfloat162* dst = reinterpret_cast<__nv_bfloat162*>(
        reinterpret_cast<__nv_bfloat16*>(out) + base);
    auto pair = [&](int k) {
      const int e = 2 * k;
      const float a = xs[(e / O) * XS + e % O];
      if (e + 1 < n) {
        dst[k] = __floats2bfloat162_rn(a, xs[((e + 1) / O) * XS + (e + 1) % O]);
      } else {
        reinterpret_cast<__nv_bfloat16*>(dst)[e] = __float2bfloat16_rn(a);
      }
    };
#pragma unroll
    for (int k = lane; k < (NV * O + 1) / 2; k += 32)
      if (2 * k < n) pair(k);
    for (int k = (NV * O + 1) / 2 + lane; 2 * k < n; k += 32) pair(k);
  }
}

template <int C, int HID>
__global__ void __launch_bounds__(kWarpsB1 * 32, 2)
fused_render_kernel(const __nv_bfloat16* __restrict__ planes,  // [3, H, W, C]
                    const float* __restrict__ grid,            // [3, R, S, 2]
                    const float* __restrict__ wpack, void* __restrict__ out,  // [T*S, P, 1+C]
                    int H, int W, int res, int th, int tw, int S, int out_f32) {
  using D = Dec<C, HID>;
  extern __shared__ float4 smem4[];
  uint32_t* sw = reinterpret_cast<uint32_t*>(smem4);
  stage_decoder<C, HID>(sw, wpack);
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* xs = reinterpret_cast<float*>(sw + D::kWords) + warp * kRows * D::XS;
  const int P = th * tw;
  const int R = res * res;
  const int tsx = res / tw;
  const int total = (R / P) * S * P;  // < 2^31: the launcher checks
  const int units = (total + kRows - 1) / kRows;
  // lane i < 16 loads the coordinates of row i of a row block; those of the
  // next block are in flight while this one is gathered and decoded
  auto load_coords = [&](int u, float2 (&q)[3]) {
    const int pt = u * kRows + lane;
    if (lane < kRows && pt < total) {
      const int p = pt % P;
      const int ts = pt / P;  // t * S + s
      const int s = ts % S;
      const int t = ts / S;
      const int r = ((t / tsx) * th + p / tw) * res + (t % tsx) * tw + p % tw;
#pragma unroll
      for (int n = 0; n < 3; ++n)
        q[n] = *reinterpret_cast<const float2*>(grid + (((size_t)n * R + r) * S + s) * 2);
    } else {
#pragma unroll
      for (int n = 0; n < 3; ++n) q[n] = nan2();
    }
  };
  const int stride = gridDim.x * kWarpsB1;
  float2 q[3];
  load_coords(blockIdx.x * kWarpsB1 + warp, q);
  for (int u = blockIdx.x * kWarpsB1 + warp; u < units; u += stride) {
    const int row0 = u * kRows;
    const int nv = min(kRows, total - row0);
    float2 cur[3] = {q[0], q[1], q[2]};
    load_coords(u + stride, q);
    gather_rows<C, D::XS>(planes, H, W, cur, xs, lane);
    __syncwarp();
    decode16<C, HID>(sw, xs, xs, D::XS, lane);
    __syncwarp();
    if (nv == kRows)
      store_rows<D::O, D::XS, kRows>(xs, out, (size_t)row0 * D::O, out_f32, lane);
    else
      store_rows<D::O, D::XS, 1>(xs, out, (size_t)row0 * D::O, out_f32, lane, nv);
    __syncwarp();  // before the next row block's gather overwrites xs
  }
}

// B2's coarse slot: n contiguous bf16 values of B1's raw rows -> fp32 in dst
// (16-byte aligned). A whole 16-row block (n = 16 * O, a multiple of 8) from
// an aligned source is read as 16-byte vectors, all requested at once.
template <int O>
__device__ __forceinline__ void copy_raw_rows(const __nv_bfloat16* __restrict__ src, int n,
                                              float* dst, int lane) {
  constexpr int kVecs = kRows * O / 8;
  static_assert(kRows * O % 8 == 0, "a row block must be whole 16-byte vectors");
  if (n == kRows * O && (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    const uint4* s4 = reinterpret_cast<const uint4*>(src);
    uint4 v[(kVecs + 31) / 32];
#pragma unroll
    for (int it = 0; it < (kVecs + 31) / 32; ++it)
      if (it * 32 + lane < kVecs) v[it] = __ldg(s4 + it * 32 + lane);
#pragma unroll
    for (int it = 0; it < (kVecs + 31) / 32; ++it) {
      if (it * 32 + lane < kVecs) {
        float f[8];
        unpack8(v[it], f);
        float4* d4 = reinterpret_cast<float4*>(dst) + 2 * (it * 32 + lane);
        d4[0] = make_float4(f[0], f[1], f[2], f[3]);
        d4[1] = make_float4(f[4], f[5], f[6], f[7]);
      }
    }
  } else {
    for (int e = lane; e < n; e += 32) dst[e] = __bfloat162float(src[e]);
  }
}

template <int C, int HID>
__global__ void __launch_bounds__(kWarpsB2 * 32, 2)
merged_march_kernel(const __nv_bfloat16* __restrict__ planes,  // [3, H, W, C]
                    const float* __restrict__ proj_m,          // [3, T, Sm, P, 2]
                    const int* __restrict__ is_fine,           // [T, Sm]
                    const int* __restrict__ src,               // [T, Sm]
                    const float* __restrict__ d_m,             // [T, Sm]
                    const __nv_bfloat16* __restrict__ coarse,  // [T*S, P, 1+C]
                    const float* __restrict__ wpack,
                    const float* __restrict__ drange,  // [2]: global min/max of d_m
                    float* __restrict__ out,           // [T, P, C+2]
                    int H, int W, int T, int Sm, int S, int P) {
  using D = Dec<C, HID>;
  constexpr int O = D::O;
  // the slot buffer's row stride O is odd: the march reads it free of bank conflicts
  static_assert(O % 2 == 1, "the slot buffer needs an odd row stride");
  constexpr int Q = kWarpsB2 * 32 / kRaysB2;  // march threads per ray
  constexpr int CQ = C / Q;                   // channels each of them owns
  static_assert(C % Q == 0, "channels must split evenly over a ray's march threads");
  extern __shared__ float4 smem4[];
  uint32_t* sw = reinterpret_cast<uint32_t*>(smem4);
  float* buf = reinterpret_cast<float*>(sw + D::kWords);  // [kSlotsB2][kRaysB2][O]
  float* xs_all = buf + (kSlotsB2 * kRaysB2 * O + 3) / 4 * 4;  // [kWarpsB2][16][XS]
  float* sd = xs_all + kWarpsB2 * kRows * D::XS;
  int* sfine = reinterpret_cast<int*>(sd + Sm);
  int* ssrc = sfine + Sm;
  const int t = blockIdx.y;
  const int p0 = blockIdx.x * kRaysB2;
  const int nr = min(kRaysB2, P - p0);
  stage_decoder<C, HID>(sw, wpack);
  for (int k = threadIdx.x; k < Sm; k += blockDim.x) {
    sd[k] = d_m[t * Sm + k];
    sfine[k] = is_fine[t * Sm + k];
    ssrc[k] = src[t * Sm + k];
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* xs = xs_all + warp * kRows * D::XS;
  const int nb = (nr + kRows - 1) / kRows;  // 16-ray row blocks of this block's rays
  // march: ray r, channels [q*CQ, q*CQ + CQ)
  const int r = threadIdx.x % kRaysB2, q = threadIdx.x / kRaysB2;
  const bool live = r < nr;
  float prev_sig = 0.0f, prev[CQ], acc[CQ];
#pragma unroll
  for (int c = 0; c < CQ; ++c) prev[c] = acc[c] = 0.0f;
  float trans = 1.0f, wd = 0.0f, wsum = 0.0f;

  for (int s0 = 0; s0 < Sm; s0 += kSlotsB2) {
    const int ns = min(kSlotsB2, Sm - s0);
    int nf = 0;
    for (int j = 0; j < ns; ++j) nf += sfine[s0 + j] != 0;
    // fill the chunk's slots: work unit (slot, row block), fine slots first so
    // their decodes spread over the warps
    for (int u = warp; u < ns * nb; u += kWarpsB2) {
      const int k = u / nb, rb = u % nb;
      const bool want_fine = k < nf;
      int j = 0;
      for (int left = want_fine ? k : k - nf; j < ns; ++j)
        if ((sfine[s0 + j] != 0) == want_fine && left-- == 0) break;
      const int s = s0 + j, i0 = rb * kRows, nv = min(kRows, nr - i0);
      float* dst = buf + (j * kRaysB2 + i0) * O;
      if (want_fine) {
        float2 q[3];
#pragma unroll
        for (int n = 0; n < 3; ++n)
          q[n] = lane < nv ? *reinterpret_cast<const float2*>(
                                 proj_m + ((((size_t)n * T + t) * Sm + s) * P + p0 + i0 + lane) * 2)
                           : nan2();
        gather_rows<C, D::XS>(planes, H, W, q, xs, lane);
        __syncwarp();
        decode16<C, HID>(sw, xs, dst, O, lane);
      } else {
        copy_raw_rows<O>(coarse + (((size_t)t * S + ssrc[s]) * P + p0 + i0) * O, nv * O, dst,
                         lane);
      }
      __syncwarp();  // before the next unit's gather overwrites xs
    }
    __syncthreads();
    if (live) {
      for (int j = 0; j < ns; ++j) {
        const float* row = buf + (j * kRaysB2 + r) * O;
        const float cur_sig = row[0];
        float cur[CQ];
#pragma unroll
        for (int c = 0; c < CQ; ++c) cur[c] = row[1 + q * CQ + c];
        const int s = s0 + j;
        if (s > 0) {
          const float delta = sd[s] - sd[s - 1];
          const float d_mid = (sd[s] + sd[s - 1]) * 0.5f;
          const float dens = softplus_f((prev_sig + cur_sig) * 0.5f - 1.0f);
          const float alpha = 1.0f - expf(-dens * delta);
          const float w = alpha * trans;
          trans = trans * (1.0f - alpha + 1e-10f);
#pragma unroll
          for (int c = 0; c < CQ; ++c) acc[c] += w * (prev[c] + cur[c]) * 0.5f;
          wd += w * d_mid;
          wsum += w;
        }
        prev_sig = cur_sig;
#pragma unroll
        for (int c = 0; c < CQ; ++c) prev[c] = cur[c];
      }
    }
    __syncthreads();  // the buffer is refilled by the next chunk
  }

  if (!live) return;
  float depth = wd / wsum;
  if (isnan(depth)) depth = __int_as_float(0x7f800000);  // NaN -> +inf
  depth = fminf(fmaxf(depth, drange[0]), drange[1]);
  float* dst = out + ((size_t)t * P + p0 + r) * (C + 2);
#pragma unroll
  for (int c = 0; c < CQ; ++c) dst[q * CQ + c] = acc[c] * 2.0f - 1.0f;
  if (q == 0) {
    dst[C] = depth;
    dst[C + 1] = wsum;
  }
}

template <typename K>
cudaError_t set_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <int C, int HID>
size_t smem_b1() {
  using D = Dec<C, HID>;
  return ((size_t)D::kWords + kWarpsB1 * kRows * D::XS) * 4;
}

template <int C, int HID>
size_t smem_b2(int Sm) {
  using D = Dec<C, HID>;
  return ((size_t)D::kWords + (kSlotsB2 * kRaysB2 * D::O + 3) / 4 * 4 + kWarpsB2 * kRows * D::XS +
          3 * Sm) * 4;
}

template <int C, int HID>
int launch_b1(const void* planes, const void* grid, const void* wpack, void* out, int H, int W,
              int res, int th, int tw, int S, int out_f32, cudaStream_t stream) {
  const long total = (long)(res / th) * (res / tw) * S * th * tw;
  if (total == 0) return 0;
  if (total > (1L << 31) - kRows) return (int)cudaErrorInvalidValue;
  auto kernel = fused_render_kernel<C, HID>;
  const size_t smem = smem_b1<C, HID>();
  cudaError_t err = set_smem(kernel, smem);
  // persistent: as many blocks as fit on the card at once, or fewer
  int dev = 0, sms = 0, per_sm = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kWarpsB1 * 32, smem);
  if (err != cudaSuccess) return (int)err;
  const long units = (total + kRows - 1) / kRows;
  const long needed = (units + kWarpsB1 - 1) / kWarpsB1;
  const long fit = (long)sms * (per_sm > 0 ? per_sm : 1);
  const unsigned blocks = (unsigned)(needed < fit ? needed : fit);
  kernel<<<blocks, kWarpsB1 * 32, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(planes), static_cast<const float*>(grid),
      static_cast<const float*>(wpack), out, H, W, res, th, tw, S, out_f32);
  return (int)cudaGetLastError();
}

template <int C, int HID>
int launch_b2(const void* planes, const void* proj_m, const void* is_fine, const void* src,
              const void* d_m, const void* coarse, const void* wpack, const void* drange,
              void* out, int H, int W, int T, int Sm, int S, int P, cudaStream_t stream) {
  if (T == 0 || P == 0) return 0;
  auto kernel = merged_march_kernel<C, HID>;
  const size_t smem = smem_b2<C, HID>(Sm);
  cudaError_t err = set_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 blocks((P + kRaysB2 - 1) / kRaysB2, T);
  kernel<<<blocks, kWarpsB2 * 32, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(planes), static_cast<const float*>(proj_m),
      static_cast<const int*>(is_fine), static_cast<const int*>(src),
      static_cast<const float*>(d_m), static_cast<const __nv_bfloat16*>(coarse),
      static_cast<const float*>(wpack), static_cast<const float*>(drange),
      static_cast<float*>(out), H, W, T, Sm, S, P);
  return (int)cudaGetLastError();
}

}  // namespace

// The decoders the kernels are built for: (C, HID) = (8, 16), the tests', and
// (32, 64), the flagship's (the wrapper checks).
extern "C" int fused_render_launch(const void* planes, const void* grid, const void* wpack,
                                   void* out, int C, int H, int W, int res, int th, int tw, int S,
                                   int HID, int out_f32, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (C == 8 && HID == 16)
    return launch_b1<8, 16>(planes, grid, wpack, out, H, W, res, th, tw, S, out_f32, st);
  if (C == 32 && HID == 64)
    return launch_b1<32, 64>(planes, grid, wpack, out, H, W, res, th, tw, S, out_f32, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" int merged_march_launch(const void* planes, const void* proj_m, const void* is_fine,
                                   const void* src, const void* d_m, const void* coarse,
                                   const void* wpack, const void* drange, void* out, int C, int H,
                                   int W, int T, int Sm, int S, int P, int HID, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (C == 8 && HID == 16)
    return launch_b2<8, 16>(planes, proj_m, is_fine, src, d_m, coarse, wpack, drange, out, H, W,
                            T, Sm, S, P, st);
  if (C == 32 && HID == 64)
    return launch_b2<32, 64>(planes, proj_m, is_fine, src, d_m, coarse, wpack, drange, out, H, W,
                             T, Sm, S, P, st);
  return (int)cudaErrorInvalidValue;
}
