// Multiresolution hash encoding on Hopper: forward and table gradient, over
// all levels and over the coarse dense levels alone.
//
// Replaces four Pallas TPU kernels of mri_interpolation_tpu/ops/pallas/hash_encode.py:
//   hash_encode_forward_kernel           <- _forward_kernel  (called by _forward_call)
//   hash_encode_table_grad_kernel        <- _backward_kernel (called by _backward_call,
//                                           the table VJP of pallas_hash_encode)
//   hash_encode_coarse_forward_kernel    <- _onehot_forward_kernel  (_onehot_forward_call)
//   hash_encode_coarse_table_grad_kernel <- _onehot_backward_kernel (_onehot_backward_call,
//                                           the table VJP of pallas_hash_encode_coarse)
//
// Semantics (shared with the plain PyTorch version in ops/hash_encode.py and
// with encodings/hashgrid.py): per level, scale x by the level resolution,
// truncate to a cell index (clamped to res-1 on dense levels), enumerate the
// 2^D corners, map each corner to a row of ONE fused (T, F) table (row-major
// vertex index on dense levels, tcnn's uint32 prime-XOR hash modulo the level
// size on hashed levels, plus the level offset), and take the multilinear
// weighted sum of the F-wide rows. Products and sums are rounded one by one
// (__fmul_rn / __fadd_rn) in the reference's order, so no FMA contraction
// moves a weight or the truncation point. All four kernels share corners().
//
// Design of the all-level pair: one thread per (point, level); blockIdx.y is
// the level, so a block's per-level constants (a __grid_constant__ kernel
// parameter, read through the constant cache) are uniform across the block.
// The table is read from global memory: it is not limited to what fits on
// chip (the TPU kernel's 8 MB VMEM gate is gone), and the flagship's 625 KB
// table stays in the 50 MB L2. The gradient is a zeroed (T, F) buffer that
// every (point, level, corner, feature) updates with one fp32 atomicAdd;
// nothing rereads a whole accumulator per tile as the TPU kernel did.
//
// Design of the coarse pair: the TPU kernels turn each row lookup into a
// one-hot(idx) x table matmul over a copy of the coarse levels packed in
// 128-row segments, because Mosaic cannot lower a vector gather; a Hopper
// block gathers, so neither the one-hot nor the padding is carried over.
// A grid of at most two blocks per SM walks the points (grid-stride). Each
// block stages the coarse levels' rows, unpadded and level after level, in
// dynamic shared memory with coalesced loads; the forward then gathers the
// 2^D corners of each point from there. The gradient keeps a shared-memory
// accumulator of the same rows, adds g*w into it with shared-memory atomics,
// and at the end adds each nonzero (row, feature) once into the fused (T, F)
// gradient with one global fp32 atomicAdd: a row takes at most one global
// atomic per block, not one per point as in the all-level kernel. Where the
// coarse levels together exceed the block's shared memory (227 KB opt-in),
// they are staged in groups of whole levels, one group after another; a
// level that alone exceeds it is refused before launch.
//
// What bounds them on this card: all four move few bytes per point (D+L*F
// floats in, L*F out for the forward; D+L*F in for the gradient) and do 2^D
// random row accesses per (point, level). At the main paths' shapes the
// random gathers (forward) and atomics (gradient), into L2 or shared memory,
// not DRAM bytes or FLOPs, set the time; PERF.md holds the measured times
// beside the byte bound.
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
constexpr int kDefaultSharedBytes = 48 * 1024;  // dynamic shared memory without the opt-in
// int32 words per level in the host constant block (encodings/hashgrid.py
// LEVEL_CONST_WIDTH): res[4], vertex strides[4], size, offset, dense, source.
constexpr int kLevelWords = 12;
// Blocks per SM of the coarse kernels' grid-stride grid.
constexpr int kCoarseBlocksPerSM = 2;

struct Level {
  int res[kMaxDim];
  int vstride[kMaxDim];
  uint32_t size;
  int offset;  // first row of the level: in the fused table, or (coarse kernels)
               // in the unpadded packing of the coarse levels
  int dense;
  int source;  // coarse kernels: first row of the level in the fused table
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

// Levels [j0, j1) of the coarse block: the longest run from j0 whose rows fit
// `budget` floats of shared memory (at least level j0: the host refuses a
// level that alone does not fit). Their packed rows are contiguous, from
// levels.lv[j0].offset on.
__device__ __forceinline__ int coarse_group_end(const Levels& levels, int n_levels, int j0,
                                                int n_features, int budget) {
  int j1 = j0, used = 0;
  while (j1 < n_levels && used + (int)levels.lv[j1].size * n_features <= budget) {
    used += (int)levels.lv[j1].size * n_features;
    ++j1;
  }
  return j1;
}

template <int D>
__global__ void __launch_bounds__(kThreads)
hash_encode_coarse_forward_kernel(const float* __restrict__ x, const float* __restrict__ table,
                                  float* __restrict__ out, int64_t n, int n_features, int n_levels,
                                  int budget, const __grid_constant__ Levels levels) {
  extern __shared__ float rows_s[];
  const int width = n_levels * n_features;
  for (int j0 = 0; j0 < n_levels;) {
    const int j1 = coarse_group_end(levels, n_levels, j0, n_features, budget);
    const int base = levels.lv[j0].offset;
    for (int j = j0; j < j1; ++j) {  // stage the group's rows, coalesced
      const Level& lv = levels.lv[j];
      const float* src = table + (int64_t)lv.source * n_features;
      float* dst = rows_s + (lv.offset - base) * n_features;
      for (int k = threadIdx.x; k < (int)lv.size * n_features; k += blockDim.x) dst[k] = __ldg(src + k);
    }
    __syncthreads();
    for (int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x; i < n;
         i += (int64_t)gridDim.x * kThreads) {
      for (int j = j0; j < j1; ++j) {
        int rows[1 << D];
        float w[1 << D];
        corners<D>(x + i * D, levels.lv[j], rows, w);
        float* o = out + i * (int64_t)width + (int64_t)j * n_features;
        for (int f = 0; f < n_features; ++f) {
          float acc = 0.f;
#pragma unroll
          for (int c = 0; c < (1 << D); ++c) {
            const float t = rows_s[(rows[c] - base) * n_features + f];
            acc = (c == 0) ? __fmul_rn(t, w[c]) : __fadd_rn(acc, __fmul_rn(t, w[c]));
          }
          o[f] = acc;
        }
      }
    }
    __syncthreads();  // the next group restages the same shared memory
    j0 = j1;
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
hash_encode_coarse_table_grad_kernel(const float* __restrict__ x, const float* __restrict__ g,
                                     float* __restrict__ dtable, int64_t n, int n_features,
                                     int n_levels, int budget, const __grid_constant__ Levels levels) {
  extern __shared__ float acc_s[];
  const int width = n_levels * n_features;
  for (int j0 = 0; j0 < n_levels;) {
    const int j1 = coarse_group_end(levels, n_levels, j0, n_features, budget);
    const int base = levels.lv[j0].offset;
    const int used = (levels.lv[j1 - 1].offset + (int)levels.lv[j1 - 1].size - base) * n_features;
    for (int k = threadIdx.x; k < used; k += blockDim.x) acc_s[k] = 0.f;
    __syncthreads();
    for (int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x; i < n;
         i += (int64_t)gridDim.x * kThreads) {
      for (int j = j0; j < j1; ++j) {
        int rows[1 << D];
        float w[1 << D];
        corners<D>(x + i * D, levels.lv[j], rows, w);
        const float* gp = g + i * (int64_t)width + (int64_t)j * n_features;
        for (int f = 0; f < n_features; ++f) {
          const float gf = __ldg(gp + f);
#pragma unroll
          for (int c = 0; c < (1 << D); ++c)
            atomicAdd(acc_s + (rows[c] - base) * n_features + f, __fmul_rn(gf, w[c]));
        }
      }
    }
    __syncthreads();
    for (int j = j0; j < j1; ++j) {  // one global atomic per nonzero (row, feature)
      const Level& lv = levels.lv[j];
      const float* src = acc_s + (lv.offset - base) * n_features;
      float* dst = dtable + (int64_t)lv.source * n_features;
      for (int k = threadIdx.x; k < (int)lv.size * n_features; k += blockDim.x) {
        const float v = src[k];
        if (v != 0.f) atomicAdd(dst + k, v);
      }
    }
    __syncthreads();  // the next group rezeroes the same shared memory
    j0 = j1;
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

template <int D>
struct CoarseForwardLaunch {
  static void run(dim3 grid, int smem, cudaStream_t stream, const float* x, const float* table,
                  float* out, int64_t n, int n_features, int n_levels, const Levels& lv) {
    if (smem > kDefaultSharedBytes)
      cudaFuncSetAttribute(hash_encode_coarse_forward_kernel<D>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    hash_encode_coarse_forward_kernel<D><<<grid, kThreads, smem, stream>>>(
        x, table, out, n, n_features, n_levels, smem / (int)sizeof(float), lv);
  }
};

template <int D>
struct CoarseTableGradLaunch {
  static void run(dim3 grid, int smem, cudaStream_t stream, const float* x, const float* g,
                  float* dtable, int64_t n, int n_features, int n_levels, const Levels& lv) {
    if (smem > kDefaultSharedBytes)
      cudaFuncSetAttribute(hash_encode_coarse_table_grad_kernel<D>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    hash_encode_coarse_table_grad_kernel<D><<<grid, kThreads, smem, stream>>>(
        x, g, dtable, n, n_features, n_levels, smem / (int)sizeof(float), lv);
  }
};

// Grid and shared memory of a coarse launch on the current device: at most
// kCoarseBlocksPerSM blocks per SM, and room for every coarse row or, where
// they do not fit the opt-in limit, for the largest group. Refuses a level
// that alone does not fit, and a level that is not dense.
cudaError_t coarse_shape(int64_t n, int n_features, int n_levels, const Levels& levels,
                         dim3* grid, int* smem) {
  int dev = 0, sms = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  int64_t total = 0;
  for (int j = 0; j < n_levels; ++j) {
    const int64_t bytes = (int64_t)levels.lv[j].size * n_features * (int64_t)sizeof(float);
    if (!levels.lv[j].dense || bytes > optin) return cudaErrorInvalidValue;
    total += bytes;
  }
  *smem = (int)(total < optin ? total : optin);
  const int64_t blocks = (n + kThreads - 1) / kThreads;
  const int64_t cap = (int64_t)kCoarseBlocksPerSM * sms;
  *grid = dim3((unsigned)(blocks < cap ? blocks : cap));
  return cudaSuccess;
}

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

// out[n, j*F + f] = sum_c table[row(n, level j, c), f] * w(n, level j, c) over
// the coarse dense levels j < n_levels. level_consts: n_levels * 12 int32
// words as for hash_encode_forward, but word 9 (offset) is the level's first
// row in the unpadded packing of the coarse levels and word 11 (source) its
// first row in the fused table. out: (n, n_levels * F).
int hash_encode_coarse_forward(const float* x, const float* table, float* out, int64_t n, int d,
                               int n_features, int n_levels, const int32_t* level_consts,
                               void* stream) {
  Levels levels;
  cudaError_t err = pack_levels(d, n_features, n_levels, level_consts, &levels);
  if (err != cudaSuccess) return (int)err;
  if (n <= 0) return (int)cudaSuccess;
  dim3 grid;
  int smem = 0;
  err = coarse_shape(n, n_features, n_levels, levels, &grid, &smem);
  if (err != cudaSuccess) return (int)err;
  return (int)dispatch_dim<CoarseForwardLaunch>(d, grid, smem, (cudaStream_t)stream, x, table, out,
                                                n, n_features, n_levels, levels);
}

// dtable[source_j + r, f] += sum over points of g[n, j*F + f] * w(n, level j, c)
// for the corners c that fall on row r of coarse level j: shared-memory
// atomics per block, then one global fp32 atomicAdd per nonzero (row, feature)
// and block. dtable is the fused (T, F) gradient, zeroed by the caller; rows
// outside the coarse levels are not touched. Constants as above.
int hash_encode_coarse_table_grad(const float* x, const float* g, float* dtable, int64_t n, int d,
                                  int n_features, int n_levels, const int32_t* level_consts,
                                  void* stream) {
  Levels levels;
  cudaError_t err = pack_levels(d, n_features, n_levels, level_consts, &levels);
  if (err != cudaSuccess) return (int)err;
  if (n <= 0) return (int)cudaSuccess;
  dim3 grid;
  int smem = 0;
  err = coarse_shape(n, n_features, n_levels, levels, &grid, &smem);
  if (err != cudaSuccess) return (int)err;
  return (int)dispatch_dim<CoarseTableGradLaunch>(d, grid, smem, (cudaStream_t)stream, x, g, dtable,
                                                  n, n_features, n_levels, levels);
}

const char* hash_encode_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
