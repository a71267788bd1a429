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
// and hash_encode_forward_kernel's grid variant (Grid = true), the forward of
// a chunk of a dense grid's voxels, which makes their coordinates from the
// flat voxel index instead of reading them (the grid chunk op of
// ops/hash_mlp_grid.py).
//
// Semantics (shared with the plain PyTorch version in ops/hash_encode.py and
// with encodings/hashgrid.py): per level, scale x by the level resolution,
// truncate to a cell index (clamped to res-1 on dense levels), enumerate the
// 2^D corners, map each corner to a row of ONE fused (T, F) table (row-major
// vertex index on dense levels, tcnn's uint32 prime-XOR hash modulo the level
// size on hashed levels, plus the level offset), and take the multilinear
// weighted sum of the F-wide rows. Products and sums are rounded one by one
// (__fmul_rn / __fadd_rn) in the reference's order, so no FMA contraction
// moves a weight or the truncation point. All the kernels share corners_at().
//
// Design of the all-level forward: a block owns a run of 128 (or 64) points
// over all levels. Per-level constants and the points' coordinates are
// copied to shared memory once (not reread per level, and read without the
// constant cache's serialisation where a warp's threads index different
// levels); corner rows are gathered as float4 or float2 where F allows; the
// block's (points x L*F) output is assembled in shared memory and written as
// one contiguous run in 16-byte stores, where one thread per (point, level)
// used to store F scalars at a stride of L*F floats. The table is read from
// global memory: it is not limited to what fits on chip (the TPU kernel's
// 8 MB VMEM gate is gone), and the flagship's 625 KB table stays in the
// 50 MB L2.
//
// Design of the all-level table gradient: a zeroed (T, F) buffer (nothing
// rereads a whole accumulator per tile as the TPU kernel did) that one call
// fills with up to two kernels, after a per-level plan made on the host
// (ops/hash_encode.py:table_grad_plan, passed as a Plan):
//   - privatised levels (hash_encode_table_grad_private_kernel): dense
//     levels whose rows fit a block's accumulator (at most 113.5 KB, so two
//     blocks share an SM) and whose rows take at least 256 updates each on
//     average (N * 2^D / rows): about as many as the kernel has blocks, so
//     its flush adds no more global atomics than it removes. A grid of at
//     most two blocks per SM walks the points, adds g*w into a shared-memory copy of the levels' rows with
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
// thread gathers, so neither the one-hot nor the padding is carried over.
// The forward (kernel 3) is one thread a point over every coarse level: the
// coordinates loaded once, the corner rows gathered through the read-only
// path from the fused table (the coarse rows, a few KB, stay in L1 and L2:
// no staging copy and no barrier), the point's L*F outputs written 16 bytes
// at a time. The gradient (kernel 4) keeps a shared-memory accumulator of
// the coarse rows per block, after a host plan
// (ops/hash_encode.py:coarse_grad_plan, passed as a CoarsePlan: grid,
// cluster size, groups of levels). Shared fp32 atomicAdd is a compare-and-swap
// loop on this card (ATOMS.CAST.SPIN), so lanes of a warp that would retry on
// one row instead sum their terms by shuffles and make one shared add;
// after the points, the blocks of a thread-block cluster add up their
// accumulators through distributed shared memory, each block one slice, and
// each entry takes one global atomic per cluster. Where the coarse levels
// together exceed a block's shared memory (227 KB opt-in), they are taken in
// groups of whole levels, one group after another; a level that alone
// exceeds it is refused before launch.
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

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxDim = 4;
constexpr int kMaxFeatures = 8;
constexpr int kMaxLevels = 64;
constexpr int kMaxCluster = 8;  // blocks a thread-block cluster (the portable limit)
constexpr int kThreads = 256;
constexpr int kCoarseForwardThreads = 256;  // kernel 3's blocks (64 and 128 were no faster on the card)
constexpr int kDefaultSharedBytes = 48 * 1024;  // dynamic shared memory without the opt-in
constexpr int kMaxSharedBytes = 232448;         // Hopper's opt-in limit per block (227 KB)
// int32 words per level in the host constant block (encodings/hashgrid.py
// LEVEL_CONST_WIDTH): res[4], vertex strides[4], size, offset, dense, source.
constexpr int kLevelWords = 12;
// Blocks per SM of the private table gradient's grid-stride grid.
constexpr int kPrivateBlocksPerSM = 2;

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

// Rows and weights of the 2^D corners of the point at coordinates xv on level lv.
template <int D>
__device__ __forceinline__ void corners_at(const float (&xv)[D], const Level& lv, int* rows, float* w) {
  int xi[D];
  float xf[D];
#pragma unroll
  for (int k = 0; k < D; ++k) {
    const float s = __fmul_rn(xv[k], (float)lv.res[k]);
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

// corners_at() of point xp (D floats in global memory).
template <int D>
__device__ __forceinline__ void corners(const float* __restrict__ xp, const Level& lv, int* rows, float* w) {
  float xv[D];
#pragma unroll
  for (int k = 0; k < D; ++k) xv[k] = __ldg(xp + k);
  corners_at<D>(xv, lv, rows, w);
}

// A dense grid's voxels as kernel 1's grid variant makes their coordinates
// (ops/hash_mlp_grid.py:flat_index_to_coords, as torch computes it on the
// card): voxel i's digit on axis k is i / stride[k] % size[k] (C order,
// int32: the grid is refused at 2^31 voxels), its coordinate
// lo + (hi - lo) * digit / max(size[k] - 1, 1), where torch multiplies by
// the float32 reciprocal of a scalar divisor and rounds each step to
// float32.
struct GridSpec {
  int size[kMaxDim];
  int stride[kMaxDim];
  float inv[kMaxDim];  // 1 / max(size - 1, 1), rounded to float32
  float lo, span;      // lo and hi - lo (taken in double), rounded to float32
  int64_t start;       // the voxel of the launch's point 0
  int64_t total;       // voxels of the grid: later points repeat the last one
};

// Kernel 1: a block owns `points` consecutive points over every level. It
// copies the per-level constants and the points' coordinates to shared
// memory (coalesced), then its threads take (point, level) pairs with the
// level slowest, so a warp shares one level (broadcast reads of its
// constants) and neighbouring points; each gathers its 2^D corner rows V
// floats at a time (V = 4 or 2 where F and the table's alignment allow) and
// writes the level's F features to a shared-memory tile of the block's
// output (row stride width | 1: conflict-free scalar stores). The tile is
// one contiguous run of out, written with 16-byte stores from the first
// 16-byte boundary on and scalar stores at its two ends.
// Grid = true is the grid variant: it reads no x, and stages the
// coordinates of the grid's voxels start, ..., start + n - 1 (past the last
// voxel, the last one again) that it makes from the flat voxel index; the
// rest of the kernel is the same. Grid = false ignores `grid`.
template <int D, int V, bool Grid>
__global__ void __launch_bounds__(kThreads)
hash_encode_forward_kernel(const float* __restrict__ x, const float* __restrict__ table,
                           float* __restrict__ out, int64_t n, int n_features, int n_levels, int points,
                           const __grid_constant__ Levels levels, const __grid_constant__ GridSpec grid) {
  extern __shared__ float4 smem4[];
  Level* lv_s = reinterpret_cast<Level*>(smem4);
  float* xs = reinterpret_cast<float*>(lv_s + n_levels);
  const int width = n_levels * n_features, ldo = width | 1;
  float* os = xs + (points * D + 3) / 4 * 4;
  const int64_t p0 = (int64_t)blockIdx.x * points;
  const int np = (int)(n - p0 < points ? n - p0 : points);
  {
    const int* src = reinterpret_cast<const int*>(levels.lv);
    int* dst = reinterpret_cast<int*>(lv_s);
    for (int e = threadIdx.x; e < n_levels * kLevelWords; e += kThreads) dst[e] = src[e];
    if constexpr (Grid) {
      for (int p = threadIdx.x; p < np; p += kThreads) {
        const int64_t last = grid.total - 1, v = grid.start + p0 + p;
        const int i = (int)(v < last ? v : last);
#pragma unroll
        for (int k = 0; k < D; ++k) {
          const float digit = __int2float_rn(i / grid.stride[k] % grid.size[k]);
          xs[p * D + k] = __fadd_rn(__fmul_rn(__fmul_rn(grid.span, digit), grid.inv[k]), grid.lo);
        }
      }
    } else {
      for (int e = threadIdx.x; e < np * D; e += kThreads) xs[e] = __ldg(x + p0 * D + e);
    }
  }
  __syncthreads();
  for (int e = threadIdx.x; e < np * n_levels; e += kThreads) {
    const int l = e / np, p = e % np;
    float xv[D];
#pragma unroll
    for (int k = 0; k < D; ++k) xv[k] = xs[p * D + k];
    int rows[1 << D];
    float w[1 << D];
    corners_at<D>(xv, lv_s[l], rows, w);
    float* o = os + p * ldo + l * n_features;
    for (int f = 0; f < n_features; f += V) {
      float acc[V];
#pragma unroll
      for (int c = 0; c < (1 << D); ++c) {
        const float* src = table + (int64_t)rows[c] * n_features + f;
        float t[V];
        if constexpr (V == 4) {
          const float4 v = __ldg(reinterpret_cast<const float4*>(src));
          t[0] = v.x; t[1] = v.y; t[2] = v.z; t[3] = v.w;
        } else if constexpr (V == 2) {
          const float2 v = __ldg(reinterpret_cast<const float2*>(src));
          t[0] = v.x; t[1] = v.y;
        } else {
          t[0] = __ldg(src);
        }
#pragma unroll
        for (int q = 0; q < V; ++q) acc[q] = (c == 0) ? __fmul_rn(t[q], w[c]) : __fadd_rn(acc[q], __fmul_rn(t[q], w[c]));
      }
#pragma unroll
      for (int q = 0; q < V; ++q) o[f + q] = acc[q];
    }
  }
  __syncthreads();
  float* ob = out + p0 * width;
  const int total = np * width;
  const int head = min(total, (int)((16 - ((uintptr_t)ob & 15)) & 15) / 4);  // floats before a 16-byte boundary
  const int quads = (total - head) / 4;
  auto tile = [&](int q) { return os[(q / width) * ldo + q % width]; };
  for (int q = threadIdx.x; q < head; q += kThreads) ob[q] = tile(q);
  for (int i = threadIdx.x; i < quads; i += kThreads) {
    const int q = head + 4 * i;
    *reinterpret_cast<float4*>(ob + q) = make_float4(tile(q), tile(q + 1), tile(q + 2), tile(q + 3));
  }
  for (int q = head + 4 * quads + threadIdx.x; q < total; q += kThreads) ob[q] = tile(q);
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

// Kernel 3: one thread a point. Its coordinates are loaded once into
// registers for every coarse level; its 2^D corner rows are gathered through
// the read-only path from the fused table, which the coarse levels' few KB
// of rows keep resident in L1 and L2 (no staging copy, no barrier); the
// sums keep kernel 1's order, so the two agree bit for bit. F = 0: the
// feature count at run time, scalar gathers and stores. Otherwise, where the
// rows lie on 4F bytes (vec_rows), each row is gathered as float4 or float2
// loads; where a point's L*F outputs start on 16 bytes (wide: L*F a
// multiple of 4 and out aligned), they are written 16 bytes at a time,
// 4 / F levels (F < 4) or one level (F >= 4) a store group, and the levels
// past the last whole group as scalars.
template <int D, int F>
__device__ __forceinline__ void coarse_features(const float (&xv)[D], const Level& lv,
                                                const float* __restrict__ table, bool vec_rows, float* v) {
  int rows[1 << D];
  float w[1 << D];
  corners_at<D>(xv, lv, rows, w);
  const int shift = lv.source - lv.offset;  // packed row -> fused row
#pragma unroll
  for (int c = 0; c < (1 << D); ++c) {
    const float* src = table + (int64_t)(rows[c] + shift) * F;
    float t[F];
    if constexpr (F % 4 == 0) {
      if (vec_rows) {
#pragma unroll
        for (int q = 0; q < F; q += 4) {
          const float4 u = __ldg(reinterpret_cast<const float4*>(src + q));
          t[q] = u.x; t[q + 1] = u.y; t[q + 2] = u.z; t[q + 3] = u.w;
        }
      } else {
#pragma unroll
        for (int q = 0; q < F; ++q) t[q] = __ldg(src + q);
      }
    } else if constexpr (F % 2 == 0) {
      if (vec_rows) {
#pragma unroll
        for (int q = 0; q < F; q += 2) {
          const float2 u = __ldg(reinterpret_cast<const float2*>(src + q));
          t[q] = u.x; t[q + 1] = u.y;
        }
      } else {
#pragma unroll
        for (int q = 0; q < F; ++q) t[q] = __ldg(src + q);
      }
    } else {
#pragma unroll
      for (int q = 0; q < F; ++q) t[q] = __ldg(src + q);
    }
#pragma unroll
    for (int q = 0; q < F; ++q) v[q] = (c == 0) ? __fmul_rn(t[q], w[c]) : __fadd_rn(v[q], __fmul_rn(t[q], w[c]));
  }
}

template <int D, int F>
__global__ void __launch_bounds__(kCoarseForwardThreads)
hash_encode_coarse_forward_kernel(const float* __restrict__ x, const float* __restrict__ table,
                                  float* __restrict__ out, int64_t n, int n_features, int n_levels, bool vec_rows,
                                  bool wide, const __grid_constant__ Levels levels) {
  const int64_t i = (int64_t)blockIdx.x * kCoarseForwardThreads + threadIdx.x;
  if (i >= n) return;
  float xv[D];
#pragma unroll
  for (int k = 0; k < D; ++k) xv[k] = __ldg(x + i * D + k);
  if constexpr (F == 0) {
    float* o = out + i * (int64_t)(n_levels * n_features);
    for (int j = 0; j < n_levels; ++j) {
      const Level& lv = levels.lv[j];
      int rows[1 << D];
      float w[1 << D];
      corners_at<D>(xv, lv, rows, w);
      const float* src = table + (int64_t)(lv.source - lv.offset) * n_features;
      for (int f = 0; f < n_features; ++f) {
        float acc = 0.f;
#pragma unroll
        for (int c = 0; c < (1 << D); ++c) {
          const float t = __ldg(src + (int64_t)rows[c] * n_features + f);
          acc = (c == 0) ? __fmul_rn(t, w[c]) : __fadd_rn(acc, __fmul_rn(t, w[c]));
        }
        o[j * n_features + f] = acc;
      }
    }
  } else {
    constexpr int G = F >= 4 ? 1 : 4 / F;  // levels a store group: 4 or 8 floats
    float* o = out + i * (int64_t)(n_levels * F);
    int j = 0;
    if (wide) {
      for (; j + G <= n_levels; j += G) {
        float v[G * F];
#pragma unroll
        for (int u = 0; u < G; ++u) coarse_features<D, F>(xv, levels.lv[j + u], table, vec_rows, v + u * F);
#pragma unroll
        for (int q = 0; q < G * F; q += 4)
          *reinterpret_cast<float4*>(o + j * F + q) = make_float4(v[q], v[q + 1], v[q + 2], v[q + 3]);
      }
    }
    for (; j < n_levels; ++j) {
      float v[F];
      coarse_features<D, F>(xv, levels.lv[j], table, vec_rows, v);
#pragma unroll
      for (int q = 0; q < F; ++q) o[j * F + q] = v[q];
    }
  }
}

// The coarse table gradient's plan (ops/hash_encode.py:coarse_grad_plan;
// host words: grid, cluster, copies, shared_bytes, n_groups, then the end
// level of each group of levels that the accumulators take at once).
struct CoarsePlan {
  int grid;
  int cluster;        // blocks a thread-block cluster: 1, 2, 4 or 8
  int copies;         // accumulators a block: 1 (shared atomics) or one a warp (plain adds)
  int shared_floats;  // a block's accumulators
  int n_groups;
  int group_end[kMaxLevels];
};

// The lanes of a warp that share a key (a dense level's cell: the same cell
// gives the same row for every corner, another cell another row) and the
// pointers of a pairwise tree over each group in lane order: rank r takes
// rank r + 2^k's partial at step k where r % 2^(k+1) == 0. next[k] is the
// lane of rank + 2^k (32: none), for the steps the widest group needs (none
// where every key differs). Every lane of the warp calls it.
struct WarpGroups {
  int rank;
  int steps;
  int next[5];
};

__device__ __forceinline__ WarpGroups warp_groups(int key, int lane) {
  WarpGroups wg;
  const unsigned peers = __match_any_sync(0xffffffffu, key);
  wg.rank = __popc(peers & ((1u << lane) - 1u));
  const int widest = (int)__reduce_max_sync(0xffffffffu, (unsigned)__popc(peers));
  wg.steps = 32 - __clz(widest - 1);  // ceil(log2(widest))
  const unsigned above = lane == 31 ? 0u : peers & (0xffffffffu << (lane + 1));
  int next = above ? __ffs(above) - 1 : 32;
#pragma unroll
  for (int k = 0; k < 5; ++k) {
    wg.next[k] = next;
    if (k + 1 < wg.steps) {  // warp-uniform
      const int further = __shfl_sync(0xffffffffu, next, next & 31);
      next = next < 32 ? further : 32;
    }
  }
  return wg;
}

// Sums the V terms v of each group of wg along its tree; returns true on
// each group's lowest lane, whose v then holds the group's sum.
template <int V>
__device__ __forceinline__ bool warp_tree_sum(const WarpGroups& wg, float* v) {
#pragma unroll
  for (int k = 0; k < 5; ++k) {
    if (k < wg.steps) {  // warp-uniform
      const int src = wg.next[k] & 31;
      float t[V];
#pragma unroll
      for (int q = 0; q < V; ++q) t[q] = __shfl_sync(0xffffffffu, v[q], src);
      if ((wg.rank & ((2 << k) - 1)) == 0 && wg.next[k] < 32) {
#pragma unroll
        for (int q = 0; q < V; ++q) v[q] = __fadd_rn(v[q], t[q]);
      }
    }
  }
  return wg.rank == 0;
}

// Kernel 4: a grid-stride walk over the points in warps of 32 consecutive
// points, one group of coarse levels at a time (the plan's groups; one group
// unless the levels pass the accumulator). Each block zeroes its
// shared-memory accumulator of the group's rows; for each (point, level,
// corner) a lane forms the F terms g*w (__fmul_rn), the lanes of a warp in
// the same cell of the level (warp_groups, once per level) sum theirs for
// each corner (warp_tree_sum) and the group's lowest lane adds the sum with
// one shared atomic per feature. Where the plan gives each warp its own copy
// of the accumulator (small levels: the copies fit 48 KB), the leader adds
// with a plain read and write instead (a warp's leaders hit distinct rows,
// and no other warp touches the copy), and the block sums its copies in
// warp order before the flush. Then the blocks of a cluster meet
// (cluster.sync), block r sums slice r of each level's entries over the
// cluster's accumulators in rank order (distributed shared memory, every
// rank's loads issued before the sums) and adds each nonzero sum to the
// fused gradient with one global atomic (float4 or float2 where F allows;
// dtable lies on 16 bytes): each entry takes one global atomic per cluster,
// not one per block, and the flush is spread over the cluster. A second
// cluster.sync keeps every accumulator alive until the cluster has read it.
// F = 0: the feature count at run time.
template <int D, int F>
__global__ void __launch_bounds__(kThreads)
hash_encode_coarse_table_grad_kernel(const float* __restrict__ x, const float* __restrict__ g,
                                     float* __restrict__ dtable, int64_t n, int n_features, int n_levels,
                                     const __grid_constant__ Levels levels,
                                     const __grid_constant__ CoarsePlan plan) {
  constexpr int VF = F > 0 ? F : kMaxFeatures;
  constexpr int VW = F % 4 == 0 && F > 0 ? 4 : F % 2 == 0 && F > 0 ? 2 : 1;  // the flush's vector width
  extern __shared__ float4 acc4[];
  float* acc_s = reinterpret_cast<float*>(acc4);
  cg::cluster_group cluster = cg::this_cluster();
  const int nf = F > 0 ? F : n_features;
  const int width = n_levels * nf;
  const int lane = threadIdx.x & 31;
  const int csize = (int)cluster.num_blocks(), crank = (int)cluster.block_rank();
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  const bool per_warp = plan.copies > 1;
  int j0 = 0;
  for (int grp = 0; grp < plan.n_groups; ++grp) {
    const int j1 = plan.group_end[grp];
    const int base = levels.lv[j0].offset;
    const int used = (levels.lv[j1 - 1].offset + (int)levels.lv[j1 - 1].size - base) * nf;
    for (int k = threadIdx.x; k < used * plan.copies; k += kThreads) acc_s[k] = 0.f;
    __syncthreads();
    float* acc = acc_s + (per_warp ? (threadIdx.x >> 5) * used : 0);
    for (int64_t p0 = (int64_t)blockIdx.x * kThreads + (threadIdx.x & ~31); p0 < n; p0 += stride) {
      const int64_t i = p0 + lane;
      const bool live = i < n;
      float xv[D];
#pragma unroll
      for (int k = 0; k < D; ++k) xv[k] = live ? __ldg(x + i * D + k) : 0.f;
      float gn[VF];  // the next level's cotangents, loaded a level ahead
#pragma unroll
      for (int q = 0; q < VF; ++q) gn[q] = (live && q < nf) ? __ldg(g + i * width + j0 * nf + q) : 0.f;
      for (int j = j0; j < j1; ++j) {
        float gv[VF];
#pragma unroll
        for (int q = 0; q < VF; ++q) {
          gv[q] = gn[q];
          gn[q] = (live && q < nf && j + 1 < j1) ? __ldg(g + i * width + (j + 1) * nf + q) : 0.f;
        }
        int rows[1 << D];
        float w[1 << D];
        corners_at<D>(xv, levels.lv[j], rows, w);
        const WarpGroups wg = warp_groups(live ? rows[0] : -1 - lane, lane);  // a dead lane's key is its own
#pragma unroll
        for (int c = 0; c < (1 << D); ++c) {
          float v[VF];
#pragma unroll
          for (int q = 0; q < VF; ++q) v[q] = __fmul_rn(gv[q], w[c]);
          if (warp_tree_sum<VF>(wg, v) && live) {
            float* a = acc + (rows[c] - base) * nf;
            if (per_warp) {  // the warp's own copy, and one leader a row: no atomic
#pragma unroll
              for (int q = 0; q < VF; ++q)
                if (q < nf) a[q] = __fadd_rn(a[q], v[q]);
            } else {
#pragma unroll
              for (int q = 0; q < VF; ++q)
                if (q < nf) atomicAdd(a + q, v[q]);
            }
          }
          if (per_warp) __syncwarp();  // the next corner's leaders may read these rows
        }
      }
    }
    if (per_warp) {  // the warps' copies into the first, in warp order
      __syncthreads();
      for (int k = threadIdx.x; k < used; k += kThreads) {
        float sum = acc_s[k];
        for (int w = 1; w < plan.copies; ++w) sum = __fadd_rn(sum, acc_s[w * used + k]);
        acc_s[k] = sum;
      }
    }
    cluster.sync();
    for (int j = j0; j < j1; ++j) {
      const Level& lv = levels.lv[j];
      const int len = (int)lv.size * nf, first = (lv.offset - base) * nf;
      const int chunk = ((len + csize - 1) / csize + VW - 1) / VW * VW;
      const int s0 = min(len, crank * chunk), s1 = min(len, s0 + chunk);
      float* dst = dtable + (int64_t)lv.source * nf;
      for (int k = s0 + threadIdx.x * VW; k < s1; k += kThreads * VW) {
        float part[kMaxCluster][VW];  // every rank's entries loaded before any is added
#pragma unroll
        for (int r = 0; r < kMaxCluster; ++r) {
          if (r >= csize) break;
          const float* src = cluster.map_shared_rank(acc_s, r) + first + k;
          if constexpr (VW == 4) {
            const float4 u = *reinterpret_cast<const float4*>(src);
            part[r][0] = u.x; part[r][1] = u.y; part[r][2] = u.z; part[r][3] = u.w;
          } else if constexpr (VW == 2) {
            const float2 u = *reinterpret_cast<const float2*>(src);
            part[r][0] = u.x; part[r][1] = u.y;
          } else {
            part[r][0] = *src;
          }
        }
        float sum[VW];
        bool nonzero = false;
#pragma unroll
        for (int q = 0; q < VW; ++q) {
          sum[q] = 0.f;
#pragma unroll
          for (int r = 0; r < kMaxCluster; ++r)
            if (r < csize) sum[q] = __fadd_rn(sum[q], part[r][q]);
          nonzero = nonzero || sum[q] != 0.f;
        }
        if (nonzero) atomic_add_vec<VW>(dst + k, sum);
      }
    }
    cluster.sync();  // the cluster has read every accumulator: the next group may rezero them
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
  static void run(unsigned blocks, int points, int smem, cudaStream_t stream, const float* x, const float* table,
                  float* out, int64_t n, int n_features, int n_levels, const Levels& lv) {
    const bool aligned4 = ((uintptr_t)table & 15) == 0, aligned2 = ((uintptr_t)table & 7) == 0;
    const GridSpec none = {};
    if (n_features % 4 == 0 && aligned4)
      hash_encode_forward_kernel<D, 4, false><<<blocks, kThreads, smem, stream>>>(x, table, out, n, n_features,
                                                                                  n_levels, points, lv, none);
    else if (n_features % 2 == 0 && aligned2)
      hash_encode_forward_kernel<D, 2, false><<<blocks, kThreads, smem, stream>>>(x, table, out, n, n_features,
                                                                                  n_levels, points, lv, none);
    else
      hash_encode_forward_kernel<D, 1, false><<<blocks, kThreads, smem, stream>>>(x, table, out, n, n_features,
                                                                                  n_levels, points, lv, none);
  }
};

template <int D>
struct GridForwardLaunch {
  static void run(unsigned blocks, int points, int smem, cudaStream_t stream, const float* table, float* out,
                  int64_t n, int n_features, int n_levels, const Levels& lv, const GridSpec& grid) {
    const bool aligned4 = ((uintptr_t)table & 15) == 0, aligned2 = ((uintptr_t)table & 7) == 0;
    if (n_features % 4 == 0 && aligned4)
      hash_encode_forward_kernel<D, 4, true><<<blocks, kThreads, smem, stream>>>(nullptr, table, out, n, n_features,
                                                                                 n_levels, points, lv, grid);
    else if (n_features % 2 == 0 && aligned2)
      hash_encode_forward_kernel<D, 2, true><<<blocks, kThreads, smem, stream>>>(nullptr, table, out, n, n_features,
                                                                                 n_levels, points, lv, grid);
    else
      hash_encode_forward_kernel<D, 1, true><<<blocks, kThreads, smem, stream>>>(nullptr, table, out, n, n_features,
                                                                                 n_levels, points, lv, grid);
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
  template <int F>
  static void go(cudaStream_t stream, const float* x, const float* table, float* out, int64_t n, int n_features,
                 int n_levels, bool vec_rows, bool wide, const Levels& lv) {
    const unsigned blocks = (unsigned)((n + kCoarseForwardThreads - 1) / kCoarseForwardThreads);
    hash_encode_coarse_forward_kernel<D, F><<<blocks, kCoarseForwardThreads, 0, stream>>>(
        x, table, out, n, n_features, n_levels, vec_rows, wide, lv);
  }
  static void run(cudaStream_t stream, const float* x, const float* table, float* out, int64_t n, int n_features,
                  int n_levels, const Levels& lv) {
    const bool vec_rows = ((uintptr_t)table & (n_features % 4 == 0 ? 15 : 7)) == 0;
    const bool wide = (n_levels * n_features) % 4 == 0 && ((uintptr_t)out & 15) == 0;
    switch (n_features) {
      case 1: go<1>(stream, x, table, out, n, n_features, n_levels, vec_rows, wide, lv); break;
      case 2: go<2>(stream, x, table, out, n, n_features, n_levels, vec_rows, wide, lv); break;
      case 4: go<4>(stream, x, table, out, n, n_features, n_levels, vec_rows, wide, lv); break;
      case 8: go<8>(stream, x, table, out, n, n_features, n_levels, vec_rows, wide, lv); break;
      default: go<0>(stream, x, table, out, n, n_features, n_levels, vec_rows, wide, lv);
    }
  }
};

// The cluster launch of kernel 4 at the plan's grid, cluster and shared
// memory; its error is the call's (a refused launch never runs).
template <int D>
struct CoarseTableGradLaunch {
  template <int F>
  static cudaError_t go(cudaStream_t stream, const float* x, const float* g, float* dtable, int64_t n,
                        int n_features, int n_levels, const Levels& lv, const CoarsePlan& plan) {
    void (*kernel)(const float*, const float*, float*, int64_t, int, int, const Levels, const CoarsePlan) =
        hash_encode_coarse_table_grad_kernel<D, F>;
    const int smem = plan.shared_floats * (int)sizeof(float);
    if (smem > kDefaultSharedBytes) {
      const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (err != cudaSuccess) return err;
    }
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = (unsigned)plan.cluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cudaLaunchConfig_t config = {};
    config.gridDim = dim3((unsigned)plan.grid);
    config.blockDim = dim3(kThreads);
    config.dynamicSmemBytes = (size_t)smem;
    config.stream = stream;
    config.attrs = attr;
    config.numAttrs = 1;
    return cudaLaunchKernelEx(&config, kernel, x, g, dtable, n, n_features, n_levels, lv, plan);
  }
  static cudaError_t run(cudaStream_t stream, const float* x, const float* g, float* dtable, int64_t n,
                         int n_features, int n_levels, const Levels& lv, const CoarsePlan& plan) {
    switch (n_features) {
      case 1: return go<1>(stream, x, g, dtable, n, n_features, n_levels, lv, plan);
      case 2: return go<2>(stream, x, g, dtable, n, n_features, n_levels, lv, plan);
      case 4: return go<4>(stream, x, g, dtable, n, n_features, n_levels, lv, plan);
      case 8: return go<8>(stream, x, g, dtable, n, n_features, n_levels, lv, plan);
      default: return go<0>(stream, x, g, dtable, n, n_features, n_levels, lv, plan);
    }
  }
};

// Launch<d>::run(args...)'s own error, else cudaGetLastError().
template <template <int> class Launch, typename... Args>
cudaError_t dispatch_dim_checked(int d, Args... args) {
  cudaError_t err;
  switch (d) {
    case 1: err = Launch<1>::run(args...); break;
    case 2: err = Launch<2>::run(args...); break;
    case 3: err = Launch<3>::run(args...); break;
    case 4: err = Launch<4>::run(args...); break;
    default: return cudaErrorInvalidValue;
  }
  return err != cudaSuccess ? err : cudaGetLastError();
}

// The coarse levels as kernels 3-4 take them: dense, packed one after
// another from row 0 (word 9), with their rows in the fused table (word 11).
cudaError_t check_coarse_levels(int n_levels, const Levels& levels) {
  int next = 0;
  for (int j = 0; j < n_levels; ++j) {
    const Level& lv = levels.lv[j];
    if (!lv.dense || lv.offset != next || lv.source < 0 || lv.size < 1) return cudaErrorInvalidValue;
    next += (int)lv.size;
  }
  return cudaSuccess;
}

// Unpacks and validates kernel 4's plan words against the levels: a grid of
// whole clusters of 1, 2, 4 or 8 blocks, one accumulator a block or one a
// warp, shared memory within the opt-in limit, and groups of consecutive
// levels that end at the last level and each fit the accumulators.
cudaError_t unpack_coarse_plan(int n_features, int n_levels, const Levels& levels, const int32_t* words,
                               CoarsePlan* plan) {
  if (words == nullptr) return cudaErrorInvalidValue;
  memset(plan, 0, sizeof(CoarsePlan));
  plan->grid = words[0];
  plan->cluster = words[1];
  plan->copies = words[2];
  const int shared_bytes = words[3];
  plan->shared_floats = shared_bytes / (int)sizeof(float);
  plan->n_groups = words[4];
  const int c = plan->cluster;
  if (plan->grid < 1 || c < 1 || c > kMaxCluster || (c & (c - 1)) != 0 || plan->grid % c != 0 ||
      (plan->copies != 1 && plan->copies != kThreads / 32) || shared_bytes < 1 || shared_bytes > kMaxSharedBytes ||
      plan->n_groups < 1 || plan->n_groups > n_levels)
    return cudaErrorInvalidValue;
  int j0 = 0;
  for (int k = 0; k < plan->n_groups; ++k) {
    const int j1 = words[5 + k];
    if (j1 <= j0 || j1 > n_levels) return cudaErrorInvalidValue;
    const int64_t rows = (int64_t)levels.lv[j1 - 1].offset + levels.lv[j1 - 1].size - levels.lv[j0].offset;
    if (rows * n_features * plan->copies > plan->shared_floats) return cudaErrorInvalidValue;
    plan->group_end[k] = j1;
    j0 = j1;
  }
  return j0 == n_levels ? cudaSuccess : cudaErrorInvalidValue;
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

// The grid's spec from its d sizes (host pointer) and range: C-order
// strides, each axis's float32 reciprocal 1 / max(size - 1, 1) and the
// float32 lo and hi - lo, as torch rounds a Python scalar. Refuses an empty
// axis, a grid of 2^31 voxels or more and a negative start.
cudaError_t pack_grid(int d, const int32_t* shape, double lo, double hi, int64_t start, GridSpec* grid) {
  if (shape == nullptr || start < 0) return cudaErrorInvalidValue;
  memset(grid, 0, sizeof(GridSpec));
  int64_t total = 1;
  for (int k = d - 1; k >= 0; --k) {
    if (shape[k] < 1) return cudaErrorInvalidValue;
    grid->size[k] = shape[k];
    grid->stride[k] = (int)total;
    grid->inv[k] = 1.0f / (float)(shape[k] > 1 ? shape[k] - 1 : 1);
    total *= shape[k];
    if (total >= ((int64_t)1 << 31)) return cudaErrorInvalidValue;
  }
  grid->lo = (float)lo;
  grid->span = (float)(hi - lo);
  grid->start = start;
  grid->total = total;
  return cudaSuccess;
}

// The SMs of the current card, asked once.
cudaError_t card_sms(int* sms) {
  static int cached = 0;
  if (cached == 0) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&cached, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
  }
  *sms = cached;
  return cudaSuccess;
}

// Kernel 1's points per block: 128, or 64 where 128 would give fewer than
// two blocks an SM; fewer (a multiple of 4) where the output tile would
// pass the 48 KB of shared memory a block has without the opt-in. Returns
// the block's shared bytes.
int forward_points(int64_t n, int d, int n_features, int n_levels, int sms, int* points) {
  const int ldo = (n_levels * n_features) | 1;
  int p = n >= (int64_t)128 * 2 * sms ? 128 : 64;
  const int room = (kDefaultSharedBytes - n_levels * (int)sizeof(Level)) / (int)sizeof(float) - 4;
  while (p > 4 && p * (ldo + d) > room) p -= 4;
  *points = p;
  return n_levels * (int)sizeof(Level) + (int)sizeof(float) * ((p * d + 3) / 4 * 4 + p * ldo);
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
  int sms = 0;
  err = card_sms(&sms);
  if (err != cudaSuccess) return (int)err;
  int points = 0;
  const int smem = forward_points(n, d, n_features, n_levels, sms, &points);
  const unsigned blocks = (unsigned)((n + points - 1) / points);
  return (int)dispatch_dim<ForwardLaunch>(d, blocks, points, smem, (cudaStream_t)stream, x, table, out, n,
                                          n_features, n_levels, levels);
}

// hash_encode_forward of the n voxels start, ..., start + n - 1 of a dense
// grid of d sizes (shape: host pointer to d int32 words) over [lo, hi] on
// every axis, in C order, the voxels past the last one repeating it: the
// coordinates are made in the kernel (GridSpec), bit for bit those of
// flat_index_to_coords on the card. Constants and out as for
// hash_encode_forward. n == 0 launches nothing.
int hash_encode_grid_forward(const float* table, float* out, int64_t start, int64_t n, int d, int n_features,
                             int n_levels, const int32_t* level_consts, const int32_t* shape, double lo,
                             double hi, void* stream) {
  Levels levels;
  cudaError_t err = pack_levels(d, n_features, n_levels, level_consts, &levels);
  if (err != cudaSuccess) return (int)err;
  GridSpec grid;
  err = pack_grid(d, shape, lo, hi, start, &grid);
  if (err != cudaSuccess) return (int)err;
  if (n <= 0) return (int)cudaSuccess;
  int sms = 0;
  err = card_sms(&sms);
  if (err != cudaSuccess) return (int)err;
  int points = 0;
  const int smem = forward_points(n, d, n_features, n_levels, sms, &points);
  const unsigned blocks = (unsigned)((n + points - 1) / points);
  return (int)dispatch_dim<GridForwardLaunch>(d, blocks, points, smem, (cudaStream_t)stream, table, out, n,
                                              n_features, n_levels, levels, grid);
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
    const int64_t blocks = (n + kThreads - 1) / kThreads, cap = (int64_t)kPrivateBlocksPerSM * sms;
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
  if (err == cudaSuccess) err = check_coarse_levels(n_levels, levels);
  if (err != cudaSuccess) return (int)err;
  if (n <= 0) return (int)cudaSuccess;
  return (int)dispatch_dim<CoarseForwardLaunch>(d, (cudaStream_t)stream, x, table, out, n, n_features, n_levels,
                                                levels);
}

// dtable[source_j + r, f] += sum over points of g[n, j*F + f] * w(n, level j, c)
// for the corners c that fall on row r of coarse level j, after `plan`
// (host pointer to 5 + n_groups int32 words; see CoarsePlan): per block, a
// shared-memory accumulator filled by warp sums and shared atomics, or one
// per warp filled by warp sums and plain adds; per cluster, one global
// atomic per nonzero (row, feature). dtable is the fused
// (T, F) gradient, zeroed by the caller; rows outside the coarse levels are
// not touched. Constants as above.
int hash_encode_coarse_table_grad(const float* x, const float* g, float* dtable, int64_t n, int d,
                                  int n_features, int n_levels, const int32_t* level_consts,
                                  const int32_t* plan_words, void* stream) {
  Levels levels;
  cudaError_t err = pack_levels(d, n_features, n_levels, level_consts, &levels);
  if (err == cudaSuccess) err = check_coarse_levels(n_levels, levels);
  CoarsePlan plan;
  if (err == cudaSuccess) err = unpack_coarse_plan(n_features, n_levels, levels, plan_words, &plan);
  if (err != cudaSuccess) return (int)err;
  if (n <= 0) return (int)cudaSuccess;
  if (((uintptr_t)dtable & 15) != 0) return (int)cudaErrorInvalidValue;  // the flush's vector atomics
  return (int)dispatch_dim_checked<CoarseTableGradLaunch>(d, (cudaStream_t)stream, x, g, dtable, n, n_features,
                                                          n_levels, levels, plan);
}

const char* hash_encode_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
