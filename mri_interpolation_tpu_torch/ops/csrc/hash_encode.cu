// Multiresolution hash encoding on Hopper: forward and table gradient.
//
// Replaces two Pallas TPU kernels of mri_interpolation_tpu/ops/pallas/hash_encode.py:
//   hash_encode_forward_kernel    <- _forward_kernel  (called by _forward_call)
//   hash_encode_table_grad_kernel <- _backward_kernel (called by _backward_call,
//                                    the table VJP of pallas_hash_encode)
//
// Semantics (shared with the plain PyTorch version in ops/hash_encode.py and
// with encodings/hashgrid.py): per level, scale x by the level resolution,
// truncate to a cell index (clamped to res-1 on dense levels), enumerate the
// 2^D corners, map each corner to a row of ONE fused (T, F) table (row-major
// vertex index on dense levels, tcnn's uint32 prime-XOR hash modulo the level
// size on hashed levels, plus the level offset), and take the multilinear
// weighted sum of the F-wide rows. Products and sums are rounded one by one
// (__fmul_rn / __fadd_rn) in the reference's order, so no FMA contraction
// moves a weight or the truncation point.
//
// Design: one thread per (point, level); blockIdx.y is the level, so a
// block's per-level constants (a __grid_constant__ kernel parameter, read
// through the constant cache) are uniform across the block. The table is read
// from global memory: it is not limited to what fits on chip (the TPU
// kernel's 8 MB VMEM gate is gone), and the flagship's 625 KB table stays in
// the 50 MB L2. The gradient is a zeroed (T, F) buffer that every
// (point, level, corner, feature) updates with one fp32 atomicAdd; nothing
// rereads a whole accumulator per tile as the TPU kernel did.
//
// What bounds them on this card: both move few bytes per point (D+L*F floats
// in, L*F out for the forward; D+L*F in for the gradient) and do 2^D random
// row accesses per (point, level). At the flagship shapes the random gathers
// (forward) and atomics (gradient) into L2, not DRAM bytes or FLOPs, set the
// time; PERF.md holds the measured times beside the byte bound.
//
// Interface: plain C, raw pointers, the caller's stream; every launcher
// returns cudaGetLastError() so the Python wrapper raises on a refused launch.

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kMaxDim = 4;
constexpr int kMaxFeatures = 8;
constexpr int kMaxLevels = 64;
constexpr int kThreads = 256;
// int32 words per level in the host constant block (encodings/hashgrid.py
// LEVEL_CONST_WIDTH): res[4], vertex strides[4], size, offset, dense, pad.
constexpr int kLevelWords = 12;

struct Level {
  int res[kMaxDim];
  int vstride[kMaxDim];
  uint32_t size;
  int offset;
  int dense;
  int pad;
};
static_assert(sizeof(Level) == kLevelWords * sizeof(int32_t), "Level layout");

struct Levels {
  Level lv[kMaxLevels];
};

__device__ __forceinline__ uint32_t prime(int k) {
  return k == 0 ? 1u : k == 1 ? 2654435761u : k == 2 ? 805459861u : 3674653429u;
}

// Rows and weights of the 2^D corners of point xp on level lv.
template <int D>
__device__ __forceinline__ void corners(const float* __restrict__ xp, const Level& lv,
                                        int* rows, float* w) {
  int xi[D];
  float xf[D];
#pragma unroll
  for (int k = 0; k < D; ++k) {
    const float s = __fmul_rn(__ldg(xp + k), (float)lv.res[k]);
    int c = __float2int_rz(s);  // truncation, as astype(int32)
    if (lv.dense) c = min(max(c, 0), lv.res[k] - 1);
    xi[k] = c;
    xf[k] = __fsub_rn(s, (float)c);
  }
#pragma unroll
  for (int c = 0; c < (1 << D); ++c) {
    float wc = 0.f;
#pragma unroll
    for (int k = 0; k < D; ++k) {
      const float f = ((c >> k) & 1) ? xf[k] : __fsub_rn(1.f, xf[k]);
      wc = (k == 0) ? f : __fmul_rn(wc, f);
    }
    w[c] = wc;
    if (lv.dense) {
      int idx = 0;
#pragma unroll
      for (int k = 0; k < D; ++k) idx += (xi[k] + ((c >> k) & 1)) * lv.vstride[k];
      rows[c] = idx + lv.offset;
    } else {
      uint32_t h = 0;
#pragma unroll
      for (int k = 0; k < D; ++k) h ^= (uint32_t)(xi[k] + ((c >> k) & 1)) * prime(k);
      rows[c] = (int)(h % lv.size) + lv.offset;
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
hash_encode_forward_kernel(const float* __restrict__ x, const float* __restrict__ table,
                           float* __restrict__ out, int64_t n, int n_features, int n_levels,
                           const __grid_constant__ Levels levels) {
  const int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const int l = blockIdx.y;
  int rows[1 << D];
  float w[1 << D];
  corners<D>(x + i * D, levels.lv[l], rows, w);
  float* o = out + i * (int64_t)(n_levels * n_features) + (int64_t)l * n_features;
  for (int f = 0; f < n_features; ++f) {
    float acc = 0.f;
#pragma unroll
    for (int c = 0; c < (1 << D); ++c) {
      const float t = __ldg(table + (int64_t)rows[c] * n_features + f);
      acc = (c == 0) ? __fmul_rn(t, w[c]) : __fadd_rn(acc, __fmul_rn(t, w[c]));
    }
    o[f] = acc;
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
hash_encode_table_grad_kernel(const float* __restrict__ x, const float* __restrict__ g,
                              float* __restrict__ dtable, int64_t n, int n_features,
                              int n_levels, const __grid_constant__ Levels levels) {
  const int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const int l = blockIdx.y;
  int rows[1 << D];
  float w[1 << D];
  corners<D>(x + i * D, levels.lv[l], rows, w);
  const float* gp = g + i * (int64_t)(n_levels * n_features) + (int64_t)l * n_features;
  for (int f = 0; f < n_features; ++f) {
    const float gf = __ldg(gp + f);
#pragma unroll
    for (int c = 0; c < (1 << D); ++c)
      atomicAdd(dtable + (int64_t)rows[c] * n_features + f, __fmul_rn(gf, w[c]));
  }
}

// Validates the sizes and packs the host constant block into the kernel
// parameter. Returns cudaSuccess or cudaErrorInvalidValue.
cudaError_t pack_levels(int d, int n_features, int n_levels, const int32_t* level_consts,
                        Levels* levels) {
  if (d < 1 || d > kMaxDim || n_features < 1 || n_features > kMaxFeatures ||
      n_levels < 1 || n_levels > kMaxLevels || level_consts == nullptr)
    return cudaErrorInvalidValue;
  memset(levels, 0, sizeof(Levels));
  memcpy(levels->lv, level_consts, sizeof(Level) * n_levels);
  return cudaSuccess;
}

template <template <int> class Launch, typename... Args>
cudaError_t dispatch_dim(int d, Args... args) {
  switch (d) {
    case 1: Launch<1>::run(args...); break;
    case 2: Launch<2>::run(args...); break;
    case 3: Launch<3>::run(args...); break;
    case 4: Launch<4>::run(args...); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

template <int D>
struct ForwardLaunch {
  static void run(dim3 grid, cudaStream_t stream, const float* x, const float* table,
                  float* out, int64_t n, int n_features, int n_levels, const Levels& lv) {
    hash_encode_forward_kernel<D><<<grid, kThreads, 0, stream>>>(x, table, out, n, n_features,
                                                                  n_levels, lv);
  }
};

template <int D>
struct TableGradLaunch {
  static void run(dim3 grid, cudaStream_t stream, const float* x, const float* g,
                  float* dtable, int64_t n, int n_features, int n_levels, const Levels& lv) {
    hash_encode_table_grad_kernel<D><<<grid, kThreads, 0, stream>>>(x, g, dtable, n, n_features,
                                                                     n_levels, lv);
  }
};

dim3 grid_for(int64_t n, int n_levels) {
  return dim3((unsigned)((n + kThreads - 1) / kThreads), (unsigned)n_levels);
}

}  // namespace

extern "C" {

// out[n, l*F + f] = sum_c table[row(n, l, c), f] * w(n, l, c).
// x: (n, d) f32, table: (T, F) f32, out: (n, L*F) f32, all device pointers;
// level_consts: host pointer to L * 12 int32 words. n == 0 launches nothing.
int hash_encode_forward(const float* x, const float* table, float* out, int64_t n, int d,
                        int n_features, int n_levels, const int32_t* level_consts,
                        void* stream) {
  Levels levels;
  cudaError_t err = pack_levels(d, n_features, n_levels, level_consts, &levels);
  if (err != cudaSuccess) return (int)err;
  if (n <= 0) return (int)cudaSuccess;
  return (int)dispatch_dim<ForwardLaunch>(d, grid_for(n, n_levels), (cudaStream_t)stream, x,
                                          table, out, n, n_features, n_levels, levels);
}

// dtable[row(n, l, c), f] += g[n, l*F + f] * w(n, l, c), with fp32 atomics.
// dtable must be zeroed by the caller; g: (n, L*F) f32.
int hash_encode_table_grad(const float* x, const float* g, float* dtable, int64_t n, int d,
                           int n_features, int n_levels, const int32_t* level_consts,
                           void* stream) {
  Levels levels;
  cudaError_t err = pack_levels(d, n_features, n_levels, level_consts, &levels);
  if (err != cudaSuccess) return (int)err;
  if (n <= 0) return (int)cudaSuccess;
  return (int)dispatch_dim<TableGradLaunch>(d, grid_for(n, n_levels), (cudaStream_t)stream, x,
                                            g, dtable, n, n_features, n_levels, levels);
}

const char* hash_encode_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
