// Multiresolution hash encoding on Hopper: forward and table gradient, over
// all levels and over the coarse dense levels alone.
//
// Replaces four Pallas TPU kernels of mri_interpolation_tpu/ops/pallas/hash_encode.py:
//   hash_encode_forward_kernel           <- _forward_kernel  (called by _forward_call)
//   hash_encode_table_grad_private_kernel \ <- _backward_kernel (called by _backward_call,
//   hash_encode_table_grad_kernel         /    the table VJP of pallas_hash_encode)
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
// Design of the all-level forward: one thread per (point, level); blockIdx.y
// is the level, so a block's per-level constants (a __grid_constant__ kernel
// parameter, read through the constant cache) are uniform across the block.
// The table is read from global memory: it is not limited to what fits on
// chip (the TPU kernel's 8 MB VMEM gate is gone), and the flagship's 625 KB
// table stays in the 50 MB L2.
//
// Design of the all-level table gradient: a zeroed (T, F) buffer (nothing
// rereads a whole accumulator per tile as the TPU kernel did) that one call
// fills with up to two kernels, after a per-level plan made on the host
// (ops/hash_encode.py:table_grad_plan, passed as a Plan):
//   - privatised levels (hash_encode_table_grad_private_kernel): dense
//     levels whose rows fit a block's accumulator (at most 113.5 KB, so two
//     blocks share an SM) and whose rows take at least 256 updates each on
//     average (N * 2^D / rows): about as many as the kernel has blocks, so
//     its flush adds no more global atomics than it removes. The structure
//     of the coarse gradient below: a grid of at most two blocks per SM walks
//     the points, adds g*w into a shared-memory copy of the levels' rows with
//     shared atomics, then adds each nonzero (row, feature) once into the
//     fused gradient. A coarse level's few hundred rows take thousands of
//     updates each, which global atomics serialise in L2;
//   - every other level (hash_encode_table_grad_kernel): one thread per
//     (point, level, corner group) adds F-wide rows straight into the fused
//     gradient, with Hopper's float4 or float2 atomicAdd where F is a
//     multiple of 4 or 2 (a row of F floats starts on 4F bytes), scalar fp32
//     atomics otherwise; on a dense level with F = 1 the two corners that
//     differ on the last axis are adjacent rows, and one float2 atomic adds
//     both where the first row is even. The plan splits
//     the 2^D corners into up to 2^D groups (corner c in group c mod split)
//     until the grid holds two blocks of 256 threads an SM, so a small
//     batch (the flagship's 10,000 points x 4 levels) still reaches every
//     SM; each group recomputes its point's cell, so no more.
// Every product stays __fmul_rn(g, w); shared partial sums change only the
// order of the additions.
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
constexpr int kMaxSharedBytes = 232448;         // Hopper's opt-in limit per block (227 KB)
// int32 words per level in the host constant block (encodings/hashgrid.py
// LEVEL_CONST_WIDTH): res[4], vertex strides[4], size, offset, dense, source.
constexpr int kLevelWords = 12;
// Blocks per SM of the coarse kernels' and the private table gradient's
// grid-stride grids.
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

// The table gradient's per-level plan (ops/hash_encode.py:table_grad_plan;
// host words: n_private, n_global, corner_split, shared_bytes, the private
// levels, their first rows in the accumulator's packing, the global levels).
struct Plan {
  int n_private;
  int n_global;
  int corner_split;   // threads per (point, global level); each takes 2^D / corner_split corners
  int shared_floats;  // the private kernel's accumulator
  int private_level[kMaxLevels];
  int packed[kMaxLevels];
  int global_level[kMaxLevels];
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

// p[0:V] += v[0:V] with one V-wide atomic (p lies on 4V bytes).
template <int V>
__device__ __forceinline__ void atomic_add_vec(float* p, const float (&v)[V]) {
  if constexpr (V == 4) atomicAdd(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3]));
  else if constexpr (V == 2) atomicAdd(reinterpret_cast<float2*>(p), make_float2(v[0], v[1]));
  else atomicAdd(p, v[0]);
}

// corners() for the corners c with c % split == group alone (split a power
// of two; the other entries of rows and w are left unset): the same
// truncation, clamp, weights and hash, with the modulo of a power-of-two
// level size taken as a mask (the same row).
template <int D>
__device__ __forceinline__ void group_corners(const float* __restrict__ xp, const Level& lv, int group, int split,
                                              int* rows, float* w) {
  int xi[D];
  float xf[D];
#pragma unroll
  for (int k = 0; k < D; ++k) {
    const float s = __fmul_rn(__ldg(xp + k), (float)lv.res[k]);
    int c = __float2int_rz(s);
    if (lv.dense) c = min(max(c, 0), lv.res[k] - 1);
    xi[k] = c;
    xf[k] = __fsub_rn(s, (float)c);
  }
  const bool pow2 = (lv.size & (lv.size - 1)) == 0;
#pragma unroll
  for (int c = 0; c < (1 << D); ++c) {
    if ((c & (split - 1)) != group) continue;
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
      rows[c] = (int)(pow2 ? (h & (lv.size - 1)) : (h % lv.size)) + lv.offset;
    }
  }
}

// The global levels: blockIdx.y is the level (plan.global_level), blockIdx.z
// the corner group (corners c with c % corner_split == group); each thread
// adds its point's rows of that group, V features per atomic (V = 4 or 2
// where F is a multiple of it, else 1). On a dense level with F = 1 the
// corners c and c + 2^(D-1) are adjacent rows (the last axis has vertex
// stride 1): where the first is even, one float2 atomic adds both. (Pairing
// F = 2 rows into float4 atomics was slower on the card.)
template <int D, int V>
__global__ void __launch_bounds__(kThreads)
hash_encode_table_grad_kernel(const float* __restrict__ x, const float* __restrict__ g,
                              float* __restrict__ dtable, int64_t n, int n_features,
                              int n_levels, const __grid_constant__ Levels levels,
                              const __grid_constant__ Plan plan) {
  const int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const int l = plan.global_level[blockIdx.y];
  const Level& lv = levels.lv[l];
  const int split = plan.corner_split, group = (int)blockIdx.z;
  int rows[1 << D];
  float w[1 << D];
  group_corners<D>(x + i * D, lv, group, split, rows, w);
  const float* gp = g + i * (int64_t)(n_levels * n_features) + (int64_t)l * n_features;
  constexpr int top = 1 << (D - 1);
  if (V == 1 && n_features == 1 && lv.dense && lv.vstride[D - 1] == 1 && split <= top) {
    const float gv = __ldg(gp);
#pragma unroll
    for (int c = 0; c < top; ++c) {
      if ((c & (split - 1)) != group) continue;
      const float both[2] = {__fmul_rn(gv, w[c]), __fmul_rn(gv, w[c + top])};  // rows[c], rows[c] + 1
      float* p = dtable + rows[c];
      if ((rows[c] & 1) == 0) {
        atomic_add_vec<2>(p, both);
      } else {
        atomicAdd(p, both[0]);
        atomicAdd(p + 1, both[1]);
      }
    }
    return;
  }
  for (int f = 0; f < n_features; f += V) {
    float gv[V];
#pragma unroll
    for (int q = 0; q < V; ++q) gv[q] = __ldg(gp + f + q);
#pragma unroll
    for (int c = 0; c < (1 << D); ++c) {
      if ((c & (split - 1)) != group) continue;
      float v[V];
#pragma unroll
      for (int q = 0; q < V; ++q) v[q] = __fmul_rn(gv[q], w[c]);
      atomic_add_vec<V>(dtable + (int64_t)rows[c] * n_features + f, v);
    }
  }
}

// The privatised levels, in groups that fit the accumulator (at least one
// level each: the host plans no level past it), one group after another.
template <int D>
__global__ void __launch_bounds__(kThreads)
hash_encode_table_grad_private_kernel(const float* __restrict__ x, const float* __restrict__ g,
                                      float* __restrict__ dtable, int64_t n, int n_features,
                                      int n_levels, const __grid_constant__ Levels levels,
                                      const __grid_constant__ Plan plan) {
  extern __shared__ float4 acc4[];
  float* acc_s = reinterpret_cast<float*>(acc4);
  const int width = n_levels * n_features;
  for (int p0 = 0; p0 < plan.n_private;) {
    int p1 = p0, used = 0;
    while (p1 < plan.n_private &&
           used + (int)levels.lv[plan.private_level[p1]].size * n_features <= plan.shared_floats) {
      used += (int)levels.lv[plan.private_level[p1]].size * n_features;
      ++p1;
    }
    const int base = plan.packed[p0];
    for (int k = threadIdx.x; k < used; k += blockDim.x) acc_s[k] = 0.f;
    __syncthreads();
    for (int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x; i < n;
         i += (int64_t)gridDim.x * kThreads) {
      for (int p = p0; p < p1; ++p) {
        const int l = plan.private_level[p];
        const Level& lv = levels.lv[l];
        int rows[1 << D];
        float w[1 << D];
        corners<D>(x + i * D, lv, rows, w);
        const float* gp = g + i * (int64_t)width + (int64_t)l * n_features;
        const int shift = plan.packed[p] - base - lv.offset;  // fused row -> accumulator row
        for (int f = 0; f < n_features; ++f) {
          const float gf = __ldg(gp + f);
#pragma unroll
          for (int c = 0; c < (1 << D); ++c)
            atomicAdd(acc_s + (rows[c] + shift) * n_features + f, __fmul_rn(gf, w[c]));
        }
      }
    }
    __syncthreads();
    for (int p = p0; p < p1; ++p) {  // one global atomic per nonzero (row, feature) and block
      const Level& lv = levels.lv[plan.private_level[p]];
      const float* src = acc_s + (plan.packed[p] - base) * n_features;
      float* dst = dtable + (int64_t)lv.offset * n_features;
      const int vw = n_features % 4 == 0 ? 4 : n_features % 2 == 0 ? 2 : 1;
      for (int k = threadIdx.x * vw; k < (int)lv.size * n_features; k += blockDim.x * vw) {
        if (vw == 4) {
          const float4 v = *reinterpret_cast<const float4*>(src + k);
          if (v.x != 0.f || v.y != 0.f || v.z != 0.f || v.w != 0.f) atomicAdd(reinterpret_cast<float4*>(dst + k), v);
        } else if (vw == 2) {
          const float2 v = *reinterpret_cast<const float2*>(src + k);
          if (v.x != 0.f || v.y != 0.f) atomicAdd(reinterpret_cast<float2*>(dst + k), v);
        } else if (src[k] != 0.f) {
          atomicAdd(dst + k, src[k]);
        }
      }
    }
    __syncthreads();  // the next group rezeroes the same shared memory
    p0 = p1;
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
                  float* dtable, int64_t n, int n_features, int n_levels, const Levels& lv,
                  const Plan& plan) {
    if (n_features % 4 == 0)
      hash_encode_table_grad_kernel<D, 4><<<grid, kThreads, 0, stream>>>(x, g, dtable, n, n_features, n_levels,
                                                                          lv, plan);
    else if (n_features % 2 == 0)
      hash_encode_table_grad_kernel<D, 2><<<grid, kThreads, 0, stream>>>(x, g, dtable, n, n_features, n_levels,
                                                                          lv, plan);
    else
      hash_encode_table_grad_kernel<D, 1><<<grid, kThreads, 0, stream>>>(x, g, dtable, n, n_features, n_levels,
                                                                          lv, plan);
  }
};

template <int D>
struct TableGradPrivateLaunch {
  static void run(dim3 grid, int smem, cudaStream_t stream, const float* x, const float* g,
                  float* dtable, int64_t n, int n_features, int n_levels, const Levels& lv,
                  const Plan& plan) {
    if (smem > kDefaultSharedBytes)
      cudaFuncSetAttribute(hash_encode_table_grad_private_kernel<D>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    hash_encode_table_grad_private_kernel<D><<<grid, kThreads, smem, stream>>>(x, g, dtable, n, n_features,
                                                                               n_levels, lv, plan);
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

// Unpacks and validates the host plan words against the levels.
cudaError_t unpack_plan(int d, int n_features, int n_levels, const Levels& levels, const int32_t* words,
                        Plan* plan) {
  if (words == nullptr) return cudaErrorInvalidValue;
  memset(plan, 0, sizeof(Plan));
  plan->n_private = words[0];
  plan->n_global = words[1];
  plan->corner_split = words[2];
  const int shared_bytes = words[3];
  plan->shared_floats = shared_bytes / (int)sizeof(float);
  if (plan->n_private < 0 || plan->n_global < 0 || plan->n_private + plan->n_global != n_levels ||
      plan->corner_split < 1 || plan->corner_split > (1 << d) || (1 << d) % plan->corner_split ||
      shared_bytes < 0 || shared_bytes > kMaxSharedBytes)
    return cudaErrorInvalidValue;
  const int32_t* priv = words + 4;
  const int32_t* packed = priv + plan->n_private;
  const int32_t* glob = packed + plan->n_private;
  for (int p = 0; p < plan->n_private; ++p) {
    const int l = priv[p];
    if (l < 0 || l >= n_levels || !levels.lv[l].dense ||
        (int64_t)levels.lv[l].size * n_features > plan->shared_floats)
      return cudaErrorInvalidValue;
    plan->private_level[p] = l;
    plan->packed[p] = packed[p];
  }
  for (int q = 0; q < plan->n_global; ++q) {
    if (glob[q] < 0 || glob[q] >= n_levels) return cudaErrorInvalidValue;
    plan->global_level[q] = glob[q];
  }
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

// dtable[row(n, l, c), f] += g[n, l*F + f] * w(n, l, c): the privatised
// levels through shared memory, then the others with global atomics, as
// `plan` (host pointer to 4 + 2 * n_private + n_global int32 words; see
// Plan) says. dtable must be zeroed by the caller; g: (n, L*F) f32.
int hash_encode_table_grad(const float* x, const float* g, float* dtable, int64_t n, int d,
                           int n_features, int n_levels, const int32_t* level_consts,
                           const int32_t* plan_words, void* stream) {
  Levels levels;
  cudaError_t err = pack_levels(d, n_features, n_levels, level_consts, &levels);
  if (err != cudaSuccess) return (int)err;
  Plan plan;
  err = unpack_plan(d, n_features, n_levels, levels, plan_words, &plan);
  if (err != cudaSuccess) return (int)err;
  if (n <= 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  if (plan.n_private > 0) {
    int dev = 0, sms = 0;
    err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
    const int64_t blocks = (n + kThreads - 1) / kThreads, cap = (int64_t)kCoarseBlocksPerSM * sms;
    const dim3 grid((unsigned)(blocks < cap ? blocks : cap));
    err = dispatch_dim<TableGradPrivateLaunch>(d, grid, plan.shared_floats * (int)sizeof(float), s, x, g,
                                               dtable, n, n_features, n_levels, levels, plan);
    if (err != cudaSuccess) return (int)err;
  }
  if (plan.n_global > 0) {
    const dim3 grid((unsigned)((n + kThreads - 1) / kThreads), (unsigned)plan.n_global,
                    (unsigned)plan.corner_split);
    err = dispatch_dim<TableGradLaunch>(d, grid, s, x, g, dtable, n, n_features, n_levels, levels, plan);
  }
  return (int)err;
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
