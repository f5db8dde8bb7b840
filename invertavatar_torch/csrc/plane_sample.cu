// Structured tri-plane sampling (kernel B3) and its transpose for Hopper
// (sm_90a), bound with ctypes.
//
// `sample_kernel` replaces the Pallas kernel
//    invertavatar_tpu/ops/pallas_plane_sample.py:_kernel (sample_planes_windowed_pallas).
// `transpose_kernel` replaces the XLA transpose
//    invertavatar_tpu/ops/plane_sample.py:windowed_sample_transpose (B3's backward).
//
// What they compute (see invertavatar_torch/ops/plane_sample.py for the plain
// PyTorch versions they are held against): planes [N, H, W, C] channels-last,
// points grid [N, M, 2] plane-space xy in [-1, 1] (align_corners=False).
//   forward:  out[n, m, :] = sum over the four bilinear taps of w_tap * plane_n[tap, :],
//             taps outside the plane are zero; float32 sums, output in the
//             payload's dtype (float32 or bfloat16); NaN for a point with a
//             NaN or infinite coordinate, as in the plain version.
//   backward: d_plane[n, tap, :] += w_tap * cot[n, m, :] for every point, as
//             float32 atomics into a zeroed buffer (the sum order is not
//             deterministic); a point with a non-finite coordinate adds nothing.
// The TPU kernel builds tent matrices over a texel window per (ray tile,
// stratum) block and contracts them on the MXU, because TPU gathers are slow;
// it drops taps outside the window. Here each point gathers its own four taps,
// so there is no window and no such drop.
//
// Thread layout: each thread owns 16-byte vectors of payload (4 float32 or 8
// bfloat16), so the threads of one point read a tap's C-channel row as one
// contiguous segment and write it likewise: every load, store and atomic is a
// 16-byte vector, coalesced across the point's threads. The transpose has
// C / 4 threads per point, one vector each. The forward has two consecutive
// vectors of a point per thread, so the point's tap arithmetic serves two
// vectors, and each thread samples 4 points whose coordinates it loads
// together. It takes the points in memory order, so its stores stream
// through device memory in order, and stores with the evict-first hint
// (st.global.cs), so the streamed samples do not push the planes out of the
// L2. One launch covers all N planes of a render pass.
//
// What bounds them on an H100 at the e4e shapes (N = 3 planes of 256² x 32,
// 128² rays, 40 coarse or 24 fine samples): the forward, bytes. It writes
// 252 MB of float32 features and reads 16 MB of grid and 25 MB of planes
// (about 0.087 ms at 3.35 TB/s) for ~0.5 GFLOP. It takes ~0.117 ms (74%),
// the bf16 payload at the Next3D coarse shapes ~0.086 ms against 0.0545
// (63%). A kernel writing the same bytes and nothing else takes ~0.077 ms;
// with every point's taps on one texel patch (L1 hits) the forward takes
// ~0.100 ms, so the taps' L2 traffic costs ~15% and the rest is the
// per-thread chain (coordinates, tap arithmetic, tap loads, store) that the
// occupancy has to hide; bf16 spends more instructions per byte (unpacking).
// One vector per thread took 0.142 ms; taking the points in 8x8-ray tile
// order, or staging a texel window per (ray tile, stratum) block in shared
// memory as the TPU kernel does, was slower (PERF.md, Findings).
// The backward reads the 252 MB cotangent and 16 MB of grid and writes 25 MB
// of d-planes, but its ~63 M atomics (one 16-byte float4 atomicAdd per tap
// and thread, sm_90) land on the few hundred thousand texels of the face
// region, dozens per texel, so it waits on the L2's atomic units rather than
// on device memory. One float4 atomic in place of four scalar ones cut it
// from ~1.3 ms to ~0.35 ms at S=40 on an H100. Summing a block's taps in a
// shared-memory window first, and flushing the window once, was slower on
// the renderer's grids (~0.39 ms) and only won when every point hit one 2x2
// texel patch (PERF.md, Findings).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPoints = 4;  // points a thread of the forward samples

inline int log2_exact(int v) {
  int l = 0;
  while ((1 << l) < v) ++l;
  return (v > 0 && (1 << l) == v) ? l : -1;
}

// The four bilinear taps of a point: flat texel index (-1 outside the plane)
// and weight. The coordinate transform is rounded step by step (no fused
// multiply-add) to match the plain version's float32 arithmetic. A point with
// a NaN or infinite coordinate has NaN weights; with `nan_taps` its taps are
// the plane's first 2x2 texels, so that its samples are NaN, else it has none.
__device__ __forceinline__ void bilinear_taps(float2 p, int H, int W, bool nan_taps,
                                              int (&idx)[4], float (&w)[4]) {
  const float gx = __fsub_rn(__fmul_rn(__fadd_rn(p.x, 1.0f), W * 0.5f), 0.5f);
  const float gy = __fsub_rn(__fmul_rn(__fadd_rn(p.y, 1.0f), H * 0.5f), 0.5f);
  const float x0f = floorf(gx), y0f = floorf(gy);
  const float wx = gx - x0f, wy = gy - y0f;
  w[0] = (1.0f - wx) * (1.0f - wy);
  w[1] = wx * (1.0f - wy);
  w[2] = (1.0f - wx) * wy;
  w[3] = wx * wy;
  // coordinates far outside the plane (or not finite) would overflow int: no taps
  const bool near = fabsf(x0f) < 1e8f && fabsf(y0f) < 1e8f;
  const bool nan_w = nan_taps && !(wx == wx && wy == wy);
  const int x0 = near ? (int)x0f : nan_w ? 0 : -2, y0 = near ? (int)y0f : nan_w ? 0 : -2;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int y = y0 + (k >> 1), x = x0 + (k & 1);
    idx[k] = (y >= 0 && y < H && x >= 0 && x < W) ? y * W + x : -1;
  }
}

// 16 bytes of payload <-> VEC float32 values.
__device__ __forceinline__ void unpack(const uint4 q, float (&v)[4]) {
  v[0] = __uint_as_float(q.x);
  v[1] = __uint_as_float(q.y);
  v[2] = __uint_as_float(q.z);
  v[3] = __uint_as_float(q.w);
}

__device__ __forceinline__ void unpack(const uint4 q, float (&v)[8]) {
  const uint32_t words[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    v[2 * k] = __uint_as_float(words[k] << 16);
    v[2 * k + 1] = __uint_as_float(words[k] & 0xffff0000u);
  }
}

__device__ __forceinline__ uint4 pack(const float (&v)[4]) {
  return make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]), __float_as_uint(v[2]),
                    __float_as_uint(v[3]));
}

__device__ __forceinline__ uint4 pack(const float (&v)[8]) {
  uint32_t words[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const __nv_bfloat162 pair = __floats2bfloat162_rn(v[2 * k], v[2 * k + 1]);  // one cvt
    words[k] = *reinterpret_cast<const uint32_t*>(&pair);
  }
  return make_uint4(words[0], words[1], words[2], words[3]);
}

// VEC = channels per 16-byte vector: 4 for a float32 payload, 8 for
// bfloat16. A task is VPT consecutive vectors of a point; block (b, n)
// covers the kPoints·kThreads tasks of plane n from b·kPoints·kThreads on,
// thread i the ones at i, i + kThreads, ..., so each of its stores is
// coalesced across the warp. It loads the coordinates of its points before
// it samples any.
template <int VEC, int VPT>
__global__ void __launch_bounds__(kThreads)
    sample_kernel(const uint4* __restrict__ planes, const float2* __restrict__ grid,
                  uint4* __restrict__ out, int H, int W, int C, long long M, int tpp_log2) {
  const int vecs = C / VEC;  // 16-byte vectors per texel row
  const int tpp = vecs / VPT;  // threads per point
  const int n = blockIdx.y;
  const long long t0 = (long long)blockIdx.x * (kPoints * kThreads) + threadIdx.x;
  const float2* g = grid + (long long)n * M;
  const uint4* plane = planes + (long long)n * H * W * vecs;
  uint4* o = out + (long long)n * M * vecs;
  long long point[kPoints];
  float2 p[kPoints];
#pragma unroll
  for (int k = 0; k < kPoints; ++k) {
    const long long t = t0 + k * kThreads;
    point[k] = tpp_log2 >= 0 ? t >> tpp_log2 : t / tpp;
    if (point[k] < M) p[k] = g[point[k]];
  }
#pragma unroll
  for (int k = 0; k < kPoints; ++k) {
    if (point[k] >= M) continue;
    const int lane = (int)(t0 + k * kThreads - point[k] * tpp) * VPT;
    int idx[4];
    float w[4];
    bilinear_taps(p[k], H, W, true, idx, w);
    float acc[VPT][VEC];
#pragma unroll
    for (int u = 0; u < VPT; ++u)
#pragma unroll
      for (int c = 0; c < VEC; ++c) acc[u][c] = 0.0f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (idx[j] < 0) continue;  // zeros padding
      const uint4* src = plane + (long long)idx[j] * vecs + lane;
#pragma unroll
      for (int u = 0; u < VPT; ++u) {
        float v[VEC];
        unpack(__ldg(src + u), v);
#pragma unroll
        for (int c = 0; c < VEC; ++c) acc[u][c] += w[j] * v[c];
      }
    }
#pragma unroll
    for (int u = 0; u < VPT; ++u) __stcs(o + point[k] * vecs + lane + u, pack(acc[u]));
  }
}

// Two vectors a thread where the point's vector count is even, else one.
template <int VEC>
int launch_sample(const uint4* p, const float2* g, uint4* o, int N, int H, int W, int C,
                  long long M, cudaStream_t s) {
  const int vecs = C / VEC, vpt = vecs % 2 == 0 ? 2 : 1, tpp = vecs / vpt;
  const long long tasks = M * tpp;  // per plane
  const dim3 blocks((unsigned)((tasks + kPoints * kThreads - 1) / (kPoints * kThreads)),
                    (unsigned)N);
  if (vpt == 2)
    sample_kernel<VEC, 2><<<blocks, kThreads, 0, s>>>(p, g, o, H, W, C, M, log2_exact(tpp));
  else
    sample_kernel<VEC, 1><<<blocks, kThreads, 0, s>>>(p, g, o, H, W, C, M, log2_exact(tpp));
  return (int)cudaGetLastError();
}

__global__ void __launch_bounds__(kThreads)
    transpose_kernel(const float2* __restrict__ grid, const float4* __restrict__ cot,
                     float* __restrict__ d_planes, int H, int W, int C, long long M,
                     long long total) {
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (t >= total) return;
  const int vecs = C / 4;
  const long long point = t / vecs;
  const int lane = (int)(t - point * vecs);
  const long long n = point / M;

  int idx[4];
  float w[4];
  bilinear_taps(grid[point], H, W, false, idx, w);
  const float4 g = cot[point * vecs + lane];
  float* plane = d_planes + n * H * W * C + lane * 4;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    if (idx[k] < 0) continue;
    atomicAdd(reinterpret_cast<float4*>(plane + (long long)idx[k] * C),
              make_float4(w[k] * g.x, w[k] * g.y, w[k] * g.z, w[k] * g.w));
  }
}

unsigned int blocks_for(long long threads) {
  return (unsigned int)((threads + kThreads - 1) / kThreads);
}

}  // namespace

// payload: 0 = float32 planes and output, 1 = bfloat16. C must be a multiple
// of 8; every pointer 16-byte aligned (the wrapper checks both); at most
// 65535 planes. Returns the launch's cudaGetLastError(), or
// cudaErrorInvalidValue for more planes.
extern "C" int plane_sample_launch(const void* planes, const void* grid, void* out, int N,
                                   int H, int W, int C, long long M, int payload,
                                   void* stream) {
  const int vec = payload == 0 ? 4 : 8;
  if ((long long)N * M * (C / vec) == 0) return 0;
  if (N > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* p = static_cast<const uint4*>(planes);
  const auto* g = static_cast<const float2*>(grid);
  auto* o = static_cast<uint4*>(out);
  return payload == 0 ? launch_sample<4>(p, g, o, N, H, W, C, M, s)
                      : launch_sample<8>(p, g, o, N, H, W, C, M, s);
}

// d_planes must be zeroed float32 [N, H, W, C]; cot float32 [N, M, C].
extern "C" int plane_sample_transpose_launch(const void* grid, const void* cot, void* d_planes,
                                             int N, int H, int W, int C, long long M,
                                             void* stream) {
  const long long total = (long long)N * M * (C / 4);
  if (total == 0) return 0;
  transpose_kernel<<<blocks_for(total), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(grid), static_cast<const float4*>(cot),
      static_cast<float*>(d_planes), H, W, C, M, total);
  return (int)cudaGetLastError();
}
