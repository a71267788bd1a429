// Fused MLP stack on Hopper: forward and backward, 3xTF32 on the tensor
// cores, relu layers' forward products in fp32 on the CUDA cores.
//
// Replaces two Pallas TPU kernels of mri_interpolation_tpu/ops/pallas/fused_mlp.py:
//   fused_mlp_split_weights_kernel  \
//   fused_mlp_forward_kernel<C>     /  <- _forward_kernel  (called by _forward_call)
//   fused_mlp_backward_tile_kernel  \
//   fused_mlp_weight_grad_kernel    /  <- _backward_kernel (called by _backward_call)
//
// Semantics (shared with the plain PyTorch version in ops/fused_mlp.py): the
// stack z_l = h_l @ W_l + b_l, h_{l+1} = act_l(z_l), W_l in the (K_l, N_l)
// layout; act_l is sine(w0) = sin(w0 z), relu, tanh-approximate gelu or the
// identity. The backward recomputes the forward, then dz_{L-1} = g * act'(z),
// dW_l = h_l^T dz_l, db_l = sum_rows dz_l, dz_{l-1} = (dz_l W_l^T) * act'(z_{l-1}),
// and, when asked for, dx = dz_0 W_0^T.
//
// Forward (kernel 5). One block per tile of rows walks the whole stack; the
// tile's activations stay in shared memory (row stride ld + 4, ld = the
// widest layer rounded up to 32): one buffer that each layer writes over
// when every width is <= 128, else two used in turn. Each layer takes one of
// two routes, chosen before launch by ops/fused_mlp.py:forward_plan (block
// shape, ring depth, route per layer; pack_forward derives the layout):
//   1. sine, gelu and identity layers on the tensor cores in 3xTF32
//      (mma.sync m16n8k8, kernel 6's split and order of terms). A prologue
//      kernel (fused_mlp_split_weights_kernel) splits every W element once
//      per call into TF32 hi/lo planes, stored in the order of the MMA's B
//      fragments; chunks of 4 steps reach shared memory by cp.async through
//      a ring of 2, 4 or 8. The 8 warps of a block take 16-row bands and 2
//      or 4 column groups of each 128-column pass, so an activation is split
//      at its fragment load by 2 or 4 warps, not by every column group of
//      the tile; the epilogue of a layer of width <= 128 writes over its own
//      input rows. The layer's bias is staged before the accumulators are
//      read; a sine layer takes sin_reduced, 16 outputs at a time.
//   2. relu layers on the CUDA cores in fp32, per output acc = 0,
//      acc = fmaf(h_k, w_kn, acc) for k ascending, z = acc + b_n: the order
//      of tile_gemm, which kernel 6 uses to recompute a relu layer, so that
//      relu's 0/1 mask is bit for bit the same in both kernels. The chunk
//      width follows N (32, 64 or 128 columns), the block's rows are one
//      tile, a relu decoder's whole W is one staged chunk, and a layer of
//      N <= 8 is a per-row dot product. Every layer of a stack too wide for
//      route 1's shared memory goes here too.
// Block shapes: 8 warps over 64 rows, or over 32 where 64-row blocks would
// number fewer than the SMs; two blocks an SM. tanhf, and sinf past
// sin_reduced's domain, are the accurate library functions (no
// --use_fast_math) in both kernels: a first SIREN layer's argument reaches
// ~40 rad, where the __sinf intrinsic loses digits. The MMAs are
// mma.sync, not wgmma: TF32 wgmma takes K-major operands from shared memory
// in a swizzled layout, and a 64-row tile's hi and lo activations beside a
// double-buffered weight chunk leave little room at width 128; mma.sync
// reads fragments in any layout the kernel chooses.
//
// Backward (kernel 6). The TPU backward sums dW over a sequential grid.
// Blocks here run in no order, so the backward is two kernels:
//   1. fused_mlp_backward_tile_kernel, one block per tile of 32 or 64 rows:
//      recompute the forward, writing every act'(z_l) and every hidden
//      h_{l+1} = act(z_l) to scratch buffers (one sincosf gives a sine
//      layer's both), then backpropagate dz through the stack (dz_l W_l^T
//      reads W_l transposed; act'(z_{l-1}) comes back from the scratch),
//      writing every dz_l to a third scratch buffer and dx if asked for;
//   2. fused_mlp_weight_grad_kernel: dW_l = h_l^T dz_l and db_l, with h_l
//      read from the scratch (h_0 = x). A block owns
//      a 128 x 128 tile of one layer's dW (the whole dW at width 128, so each
//      h and dz element of its rows is read once) and one slice of the rows;
//      the slices' partial sums meet in dW with one atomicAdd per weight
//      (float2 where the row length is even) and block (dW and db are zeroed
//      by the caller). The order of those adds changes from run to run, so
//      dW and db are not bitwise reproducible.
// The products of both passes run on the tensor cores as mma.sync m16n8k8
// TF32 in "3xTF32": each fp32 operand a is split into hi = tf32(a)
// (nearest, ties away, as cvt.rna gives it; two integer operations) and
// lo = tf32(a - hi), and a*b is accumulated in fp32 as
// lo*hi' + hi*lo' + hi*hi'. That leaves about 2^-21 of |a*b| per product,
// against 2^-24 for fp32 and 2^-11 for plain TF32, whose error times
// w0 = 30 breaks parity. tests/test_torch_tf32x3.py emulates the split on
// the CPU and holds every main-path stack (SIREN at w0 = 30, 3 -> 352 x 5,
// the multi-frame SIREN's two stacks, the relu decoders with dx) to a
// quarter of the tolerances that the card holds the kernel to; all passed.
// One exception, fixed by activation: a relu layer's recomputed z_l (pass
// 1's forward) stays on the CUDA cores, in tile_gemm, kernel 5's route 2 and its
// order of additions, so that z_l, and relu's 0/1 derivative, are bit for
// bit what the forward computed. A 3xTF32 z_l lies ~2^-21 away from it and
// flips the mask of the pre-activations that lie closer to 0 (on the card,
// one in ~10^6 at the relu decoders' widths): a gradient, wrong by a whole
// term there, of a function that the forward did not compute. Its dz W^T
// and dW products stay on the tensor cores. A layer of depth K <= 8 takes
// one MMA step per chunk (the steps past K are skipped), so the coordinate
// layer costs little.
// The weights reach shared memory through cp.async into two chunk buffers
// used in turn: the next chunk loads while this one's MMAs run (16-byte
// copies where a W row is a multiple of 4 floats and W is 16-byte aligned,
// 4-byte copies otherwise), one barrier a chunk. Pass 2 stages its h and dz
// rows the same way, 32 rows a step through a ring of three, two steps
// ahead; the scratch rows are padded so that every layer's block of z and
// dz starts on 16 bytes.
// Shapes, fixed in code (fused_mlp_backward):
//   - pass 1 takes 64-row tiles (4 warps x 2 along the rows, 32 x 32 outputs
//     a warp) where the batch holds at least two such tiles per SM (>= 16,896
//     rows on 132 SMs) and their shared memory fits, else 32-row tiles;
//   - its weight chunks are 32 deep and 128 outputs wide, or 64 wide where
//     128 would not fit beside the activations (widths past 736 at 32 rows;
//     64-row tiles fit up to width 352);
//   - a stack that fits neither is refused (cudaErrorInvalidValue).
// Masked rows (the ragged tail of the last tile) read x = 0 and g = 0, so
// their dz is 0 and they add nothing to dW or db, like the TPU kernel's
// zero-padded rows.
//
// What bounds them on this card: operations. At SIREN 3 -> 128 x 6 -> 1 a
// row costs 82,432 MACs forward and three times that backward against 16
// bytes in and out, far above the H100's balance point for fp32 (20
// flop/byte) and for 3xTF32 on the tensor cores (3 x 495 TFLOP/s of TF32,
// 49 flop/byte per fp32-accurate product).
//
// Interface: plain C, raw pointers, the caller's stream; every entry point
// returns cudaGetLastError() (or the error of a refused attribute), so the
// Python wrapper raises on a refused launch.

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kMaxLayers = 16;
constexpr int kTileRows = 32;   // rows of a tile (8 row groups x 4 rows)
constexpr int kChunkK = 32;     // depth of a staged B chunk
constexpr int kChunkN = 128;    // width of a staged B chunk (32 column groups x 4)
constexpr int kChunkLd = kChunkN + 4;
constexpr int kThreads = 256;
constexpr int kMaxSharedBytes = 232448;  // Hopper's per-block limit (227 KB)

enum Act : int { kId = 0, kRelu = 1, kGelu = 2, kSine = 3 };

struct Layer {
  const float* w;  // (k, n) row-major
  const float* b;  // (n,)
  float* dw;       // (k, n), zeroed by the caller (backward only)
  float* db;       // (n,), zeroed by the caller (backward only)
  int k;
  int n;
  int act;
  float w0;
  int wvec;        // n % 4 == 0 and w 16-byte aligned: W rows staged in 16-byte copies
  int zoff;        // column offset of act'(z_l) / dz_l in the scratch rows (a multiple of 4)
  int hoff;        // column offset of h_{l+1} = act(z_l) in the h scratch rows (l < L - 1; a multiple of 4)
  int tile_start;  // first 128 x 128 weight-gradient tile of this layer
};

struct Net {
  Layer layer[kMaxLayers];
  int n_layers;
  int ld;          // row stride of the activation buffers
  int ztot;        // row stride of the act' and dz scratch (sum of n, each rounded up to 4)
  int htot;        // row stride of the h scratch (the same over all layers but the last)
  int n_tiles;     // weight-gradient tiles over all layers
};

constexpr float kSqrt2OverPi = 0.7978845608028654f;

__device__ __forceinline__ float act_fwd(int act, float w0, float z) {
  switch (act) {
    case kSine: return sinf(w0 * z);
    case kRelu: return fmaxf(z, 0.f);
    case kGelu: {
      const float u = kSqrt2OverPi * (z + 0.044715f * (z * z * z));
      return 0.5f * z * (1.f + tanhf(u));
    }
    default: return z;
  }
}

// h = act(z) (act_fwd's formulas) and d = act'(z) together (one sincosf
// for a sine layer).
__device__ __forceinline__ void act_both(int act, float w0, float z, float& h, float& d) {
  switch (act) {
    case kSine: {
      float sn, cs;
      sincosf(w0 * z, &sn, &cs);
      h = sn;
      d = w0 * cs;
      return;
    }
    case kRelu:
      h = fmaxf(z, 0.f);
      d = z > 0.f ? 1.f : 0.f;
      return;
    case kGelu: {
      const float u = kSqrt2OverPi * (z + 0.044715f * (z * z * z));
      const float t = tanhf(u);
      const float du = kSqrt2OverPi * (1.f + 0.134145f * (z * z));
      h = 0.5f * z * (1.f + t);
      d = 0.5f * (1.f + t) + 0.5f * z * (1.f - t * t) * du;
      return;
    }
    default:
      h = z;
      d = 1.f;
  }
}

__device__ __forceinline__ float lane(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// acc[i][j] += sum_{kk < 32} a[(ty*4+i)*lda + kk] * bs[kk*kChunkLd + tx*4+j]
__device__ __forceinline__ void mac_chunk(const float* __restrict__ a, int lda,
                                          const float* __restrict__ bs, float acc[4][4],
                                          int ty, int tx) {
#pragma unroll
  for (int kk = 0; kk < kChunkK; kk += 4) {
    float4 av[4], bv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      av[i] = *reinterpret_cast<const float4*>(a + (ty * 4 + i) * lda + kk);
#pragma unroll
    for (int q = 0; q < 4; ++q)
      bv[q] = *reinterpret_cast<const float4*>(bs + (kk + q) * kChunkLd + tx * 4);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float aq = lane(av[i], q);
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(aq, lane(bv[q], j), acc[i][j]);
      }
  }
}

// Stage B[k0:k0+32, n0:n0+128] into bs (zeros outside k < K, n < N), where
// B[k][n] = bg[k * sk + n * sn]: sn == 1 is W itself, sk == 1 is W^T.
__device__ __forceinline__ void stage_b(float* __restrict__ bs, const float* __restrict__ bg,
                                        int sk, int sn, int K, int N, int k0, int n0) {
  const int tid = threadIdx.x;
  if (sn == 1) {
#pragma unroll 4
    for (int e = tid; e < kChunkK * kChunkN; e += kThreads) {
      const int k = e / kChunkN, n = e % kChunkN;
      const int gk = k0 + k, gn = n0 + n;
      bs[k * kChunkLd + n] = (gk < K && gn < N) ? bg[(int64_t)gk * sk + gn] : 0.f;
    }
  } else {
#pragma unroll 4
    for (int e = tid; e < kChunkK * kChunkN; e += kThreads) {
      const int n = e / kChunkK, k = e % kChunkK;
      const int gk = k0 + k, gn = n0 + n;
      bs[k * kChunkLd + n] = (gk < K && gn < N) ? bg[gk + (int64_t)gn * sn] : 0.f;
    }
  }
}

// out = a @ B over the tile: a is 32 x K in shared memory (row stride lda,
// finite zeros in columns K .. round_up(K, 32)); B is K x N in global memory.
// For every 128-column chunk, epi(i_row, col, value) is called for the 4 x 4
// outputs a thread holds (col may reach past N: the epilogue masks).
template <typename Epilogue>
__device__ __forceinline__ void tile_gemm(const float* a, int lda, const float* bg, int sk, int sn,
                                          int K, int N, float* bs, Epilogue epi) {
  const int tx = threadIdx.x % 32, ty = threadIdx.x / 32;
  for (int n0 = 0; n0 < N; n0 += kChunkN) {
    float acc[4][4] = {};
    for (int k0 = 0; k0 < K; k0 += kChunkK) {
      __syncthreads();
      stage_b(bs, bg, sk, sn, K, N, k0, n0);
      __syncthreads();
      mac_chunk(a + k0, lda, bs, acc, ty, tx);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) epi(ty * 4 + i, n0 + tx * 4 + j, acc[i][j]);
  }
}

// ---------------------------------------------------------------------------
// Kernel 6: the backward on the tensor cores (3xTF32), fed by cp.async.

constexpr int kStepK = 8;         // depth of one mma.sync m16n8k8
constexpr int kBwdChunkK = 32;    // depth of a staged weight chunk
constexpr int kGradTile = 128;    // a weight-gradient block's dW tile: 128 (k) x 128 (n)
constexpr int kGradRows = 32;     // rows of h and dz staged per step of pass 2
constexpr int kGradLd = kGradTile + 8;  // = 8 (mod 32): conflict-free fragment loads
constexpr int kGradBufFloats = kGradRows * kGradLd;
constexpr int kGradStages = 3;  // steps of h and dz in flight: this one and the next two

// Floats of one weight-chunk buffer of NC output columns: the larger of the
// two layouts (W as it is: 32 x (NC + 8); W transposed: NC x (32 + 4)).
template <int NC>
__host__ __device__ constexpr int chunk_floats() {
  return kBwdChunkK * (NC + 8) > NC * (kBwdChunkK + 4) ? kBwdChunkK * (NC + 8) : NC * (kBwdChunkK + 4);
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src, int bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src), "r"(bytes) : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src, int bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src), "r"(bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The TF32 value nearest to a, ties away from zero (what cvt.rna.tf32.f32
// gives), in two integer operations: half of the 13 dropped bits added to
// the magnitude, then cleared.
__device__ __forceinline__ uint32_t tf32_rna(float a) { return (__float_as_uint(a) + 0x1000u) & 0xFFFFE000u; }

// a = hi + lo in TF32, both rounded to nearest (ties away).
__device__ __forceinline__ void split_tf32(float a, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(a);
  lo = tf32_rna(a - __uint_as_float(hi));  // a - hi is exact: hi is a's leading 11 bits
}

__device__ __forceinline__ void mma_tf32(float c[4], const uint32_t a[4], const uint32_t b[2]) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// acc[i][j] += a[i] * b[j] in 3xTF32 for every fragment pair whose column
// block j is live: the two small cross terms first, then hi * hi, each term
// in one sweep over all pairs, so that the three MMAs into one accumulator
// are never issued back to back (each would wait out the last's latency).
template <int MT, int NT>
__device__ __forceinline__ void mma_3xtf32(float (&acc)[MT][NT][4], const uint32_t (&ah)[MT][4],
                                           const uint32_t (&al)[MT][4], const uint32_t (&bh)[NT][2],
                                           const uint32_t (&bl)[NT][2], int live) {
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int i = 0; i < MT; ++i)
      if (j < live) mma_tf32(acc[i][j], al[i], bh[j]);
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int i = 0; i < MT; ++i)
      if (j < live) mma_tf32(acc[i][j], ah[i], bl[j]);
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int i = 0; i < MT; ++i)
      if (j < live) mma_tf32(acc[i][j], ah[i], bh[j]);
}

// Fragment of A (16 x 8, row-major) at rows r0.., depth k0.. of a[row * lda + k]:
// lane (g = lane / 4, t = lane % 4) holds (g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4).
__device__ __forceinline__ void load_a(const float* a, int lda, int g, int t, uint32_t hi[4], uint32_t lo[4]) {
  const float* p = a + g * lda + t;
  split_tf32(p[0], hi[0], lo[0]);
  split_tf32(p[8 * lda], hi[1], lo[1]);
  split_tf32(p[4], hi[2], lo[2]);
  split_tf32(p[8 * lda + 4], hi[3], lo[3]);
}

// Stage B[k0:k0+32, n0:n0+NC] of the product into bs, zeros outside k < K,
// n < N. !BT: B[k][n] = w[k * N + n] (W itself), kept as bs[k][n] with row
// stride NC + 8. BT: B[k][n] = w[n * K + k] (W transposed: K is W's row
// length), kept as bs[n][k] with row stride 36. Either way the copies read
// whole W rows; vec: 16-byte copies (the row length is a multiple of 4 and
// w is 16-byte aligned). The caller commits the group.
template <int NC, bool BT>
__device__ __forceinline__ void stage_w(float* bs, const float* __restrict__ w, int K, int N, int k0, int n0,
                                        bool vec) {
  const int tid = threadIdx.x;
  if (!BT) {
    constexpr int ld = NC + 8;
    if (vec) {
      for (int e = tid; e < kBwdChunkK * NC / 4; e += kThreads) {
        const int k = e / (NC / 4), n = (e % (NC / 4)) * 4;
        const bool ok = k0 + k < K && n0 + n < N;
        cp_async16(bs + k * ld + n, ok ? w + (int64_t)(k0 + k) * N + n0 + n : w, ok ? 16 : 0);
      }
    } else {
      for (int e = tid; e < kBwdChunkK * NC; e += kThreads) {
        const int k = e / NC, n = e % NC;
        const bool ok = k0 + k < K && n0 + n < N;
        cp_async4(bs + k * ld + n, ok ? w + (int64_t)(k0 + k) * N + n0 + n : w, ok ? 4 : 0);
      }
    }
  } else {
    constexpr int ld = kBwdChunkK + 4;
    if (vec) {
      for (int e = tid; e < NC * kBwdChunkK / 4; e += kThreads) {
        const int n = e / (kBwdChunkK / 4), k = (e % (kBwdChunkK / 4)) * 4;
        const bool ok = k0 + k < K && n0 + n < N;
        cp_async16(bs + n * ld + k, ok ? w + (int64_t)(n0 + n) * K + k0 + k : w, ok ? 16 : 0);
      }
    } else {
      for (int e = tid; e < NC * kBwdChunkK; e += kThreads) {
        const int n = e / kBwdChunkK, k = e % kBwdChunkK;
        const bool ok = k0 + k < K && n0 + n < N;
        cp_async4(bs + n * ld + k, ok ? w + (int64_t)(n0 + n) * K + k0 + k : w, ok ? 4 : 0);
      }
    }
  }
}

// out = a @ B over a tile of 32 * MT rows: a in shared memory (row stride
// lda, finite zeros in columns K .. round_up(K, 32)); B = W (!BT) or W^T
// (BT) in global memory, streamed in 32 x NC chunks (NC = 32 * NT) through
// the two buffers at bsm, the next chunk's cp.async in flight while this
// one's MMAs run. 8 warps: 2 along the rows (16 * MT rows each) x 4 along
// the chunk's columns (8 * NT each). For every NC-column chunk, the outputs
// a thread holds go to epi(row, col, value, pre(row, col)) (col may reach
// past N: both mask): every pre() of the chunk first, so that their global
// loads are in flight together and not each behind the last one's stores.
template <int MT, int NT, bool BT, typename Pre, typename Epilogue>
__device__ __forceinline__ void mma_gemm(const float* a, int lda, const float* __restrict__ w, int K, int N,
                                         bool vec, float* bsm, Pre pre, Epilogue epi) {
  constexpr int NC = 32 * NT;
  constexpr int kBuf = chunk_floats<NC>();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int rb = (warp / 4) * (16 * MT), cb = (warp % 4) * (8 * NT);
  const int nk = (K + kBwdChunkK - 1) / kBwdChunkK, nn = (N + NC - 1) / NC, total = nk * nn;
  float acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.f;
  stage_w<NC, BT>(bsm, w, K, N, 0, 0, vec);
  cp_async_commit();
  for (int s = 0; s < total; ++s) {
    cp_async_wait<0>();
    __syncthreads();  // chunk s has landed, and every warp is done with chunk s - 1's buffer
    if (s + 1 < total) {
      stage_w<NC, BT>(bsm + ((s + 1) & 1) * kBuf, w, K, N, ((s + 1) % nk) * kBwdChunkK, ((s + 1) / nk) * NC, vec);
      cp_async_commit();
    }
    const float* bs = bsm + (s & 1) * kBuf;
    const int k0 = (s % nk) * kBwdChunkK, n0 = (s / nk) * NC;
    const int steps = min(kBwdChunkK / kStepK, (K - k0 + kStepK - 1) / kStepK);
    const int live = (N - n0 - cb + 7) / 8;  // column blocks of this warp inside N (warp-uniform)
    if (live > 0) {
#pragma unroll
      for (int kk = 0; kk < kBwdChunkK / kStepK; ++kk) {
        if (kk < steps) {
          uint32_t ah[MT][4], al[MT][4], bh[NT][2], bl[NT][2];
#pragma unroll
          for (int i = 0; i < MT; ++i) load_a(a + (rb + 16 * i) * lda + k0 + kk * kStepK, lda, g, t, ah[i], al[i]);
#pragma unroll
          for (int j = 0; j < NT; ++j) {  // B fragment: lane holds (k = t, n = g), (t + 4, g)
            const int col = cb + 8 * j + g, kr = kk * kStepK + t;
            if (BT) {
              split_tf32(bs[col * (kBwdChunkK + 4) + kr], bh[j][0], bl[j][0]);
              split_tf32(bs[col * (kBwdChunkK + 4) + kr + 4], bh[j][1], bl[j][1]);
            } else {
              split_tf32(bs[kr * (NC + 8) + col], bh[j][0], bl[j][0]);
              split_tf32(bs[(kr + 4) * (NC + 8) + col], bh[j][1], bl[j][1]);
            }
          }
          mma_3xtf32<MT, NT>(acc, ah, al, bh, bl, live);
        }
      }
    }
    if (s % nk == nk - 1) {  // the chunk's last depth: hand its outputs over, 16 rows at a time
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        float aux[NT][4];  // fragment element q sits at row + 8 * (q / 2), col + q % 2
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int q = 0; q < 4; ++q) aux[j][q] = pre(rb + 16 * i + g + 8 * (q / 2), n0 + cb + 8 * j + 2 * t + q % 2);
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            epi(rb + 16 * i + g + 8 * (q / 2), n0 + cb + 8 * j + 2 * t + q % 2, acc[i][j][q], aux[j][q]);
            acc[i][j][q] = 0.f;
          }
      }
    }
  }
  __syncthreads();  // the next product restages bsm
}

// ---------------------------------------------------------------------------
// Kernel 5: the forward, two routes chosen per layer before launch
// (ops/fused_mlp.py:forward_plan, passed as plan words; pack_forward derives
// the layout from them).

constexpr int kRouteTC = 1;       // 3xTF32 mma.sync on the tensor cores
constexpr int kRouteFP32 = 2;     // fp32 FMAs on the CUDA cores, in the order of tile_gemm
constexpr int kFwdSteps = 4;      // MMA steps of 8 per staged weight chunk (32 deep)
constexpr int kFwdMaxNB = 16;     // column blocks of 8 per route-1 pass: 128 columns
constexpr int kFwdPass = 8 * kFwdMaxNB;
constexpr int kFwdChunkK = 32;    // depth of a route-2 weight chunk
constexpr int kFwdThreads = 256;  // 8 warps a block, two blocks an SM
constexpr int kFwdConfigs = 2;    // block shapes: 64 or 32 rows (fwd_rows)
constexpr float kSinReduced = 105615.f;  // sin_reduced's domain: |a| <= this

// Block shape c: its 8 warps as fwd_warp_cols(c) warps along a route-1
// pass's 128 columns by 8 / fwd_warp_cols(c) bands of 16 rows: 64 or 32
// rows. (16 warps over 128 rows, with half the weight traffic, and 32 rows
// a warp were slower on the card.)
__host__ __device__ constexpr int fwd_warp_cols(int c) { return c == 0 ? 2 : 4; }
__host__ __device__ constexpr int fwd_rows(int c) { return 16 * (8 / fwd_warp_cols(c)); }

// sin(a) for |a| <= kSinReduced, as accurate as sinf there (within 1.5 ulp
// of sin on the CPU emulation in tests/test_torch_fused_forward_plan.py):
// a = j pi/2 + r with pi/2 in three fp32 parts (Cody-Waite), then the
// minimax polynomials of sin and cos on |r| <= pi/4. It is sinf's own
// reduction and polynomials without sinf's branch to its Payne-Hanek path,
// so a group of these interleaves; the caller takes sinf past the domain.
__device__ __forceinline__ float sin_reduced(float a) {
  const float j = rintf(a * 6.36619772e-01f);  // 2 / pi
  const int q = (int)j;
  float r = fmaf(j, -1.57079601e+00f, a);
  r = fmaf(j, -3.13916473e-07f, r);
  r = fmaf(j, -5.39030253e-15f, r);
  const float s = r * r;
  float ps = 2.86567956e-6f;
  ps = fmaf(ps, s, -1.98559923e-4f);
  ps = fmaf(ps, s, 8.33338592e-3f);
  ps = fmaf(ps, s, -1.66666672e-1f);
  ps = fmaf(ps, r * s, r);
  float pc = 2.44677067e-5f;
  pc = fmaf(pc, s, -1.38877297e-3f);
  pc = fmaf(pc, s, 4.16666567e-2f);
  pc = fmaf(pc, s, -5.00000000e-1f);
  pc = fmaf(pc, s, 1.00000000e+0f);
  const float v = (q & 1) ? pc : ps;
  return (q & 2) ? -v : v;
}

// v[i] = act(v[i]) over a group: a sine layer's group takes sin_reduced
// where every argument of the group lies in its domain (all of them, on the
// main paths), sinf otherwise.
template <int V>
__device__ __forceinline__ void act_group(int act, float w0, float (&v)[V]) {
  if (act == kSine) {
    bool reduced = true;
#pragma unroll
    for (int i = 0; i < V; ++i) {
      v[i] = w0 * v[i];
      reduced = reduced && fabsf(v[i]) <= kSinReduced;
    }
    if (reduced) {
#pragma unroll
      for (int i = 0; i < V; ++i) v[i] = sin_reduced(v[i]);
    } else {
#pragma unroll
      for (int i = 0; i < V; ++i) v[i] = sinf(v[i]);
    }
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i) v[i] = act_fwd(act, w0, v[i]);
  }
}

struct FwdLayer {
  const float* w;    // (k, n) row-major
  const float* b;    // (n,)
  const uint4* ws;   // route 1: W split once into TF32 hi/lo, in MMA fragment order (split kernel)
  int k, n, act;
  float w0;
  int route;
  int chunk;         // route 1: column blocks of 8 per pass; route 2: columns per chunk (32, 64, 128; 0: n <= 8)
};

struct FwdNet {
  FwdLayer layer[kMaxLayers];
  int n_layers;
  int ld;            // columns of an activation row that are ever read (the widest layer rounded up to 32)
  int lda;           // row stride of the activation buffers: ld + 4 (= 4 mod 32: conflict-free A fragments)
  int nbuf;          // 1: each layer writes over its input (every width <= 128); 2: two buffers in turn
  int ring;          // route 1's staged weight chunks in flight (2, 4 or 8)
  int wfloats;       // the weight region: route 1's ring or one route-2 chunk, the larger; two staged biases follow
};

// The split kernel's work: route-1 layer j of the forward.
struct SplitJob {
  const float* w;
  uint4* ws;
  int k, n, nb, k8, count;  // count = passes * k8 * nb * 32 fragment words
};

struct SplitJobs {
  SplitJob job[kMaxLayers];
  int n_jobs;
};

// W of every route-1 layer split once per call into hi = tf32(w), lo =
// tf32(w - hi), stored as the B fragments of mma.sync m16n8k8: for pass p,
// step s (depth 8s..8s+7), column block j (columns 128p + 8j ..) and lane
// (g = lane / 4, t = lane % 4) one uint4 {hi(w[8s+t][c]), hi(w[8s+t+4][c]),
// lo(w[8s+t][c]), lo(w[8s+t+4][c])}, c = 128p + 8j + g, zeros outside W.
// A staged chunk of 4 steps is one contiguous run; a lane's fragment is one
// 16-byte load.
__global__ void __launch_bounds__(256)
fused_mlp_split_weights_kernel(const __grid_constant__ SplitJobs jobs) {
  for (int q = 0; q < jobs.n_jobs; ++q) {
    const SplitJob& J = jobs.job[q];
    for (int e = blockIdx.x * blockDim.x + threadIdx.x; e < J.count; e += gridDim.x * blockDim.x) {
      const int lane = e % 32, j = (e / 32) % J.nb, s = (e / (32 * J.nb)) % J.k8, p = e / (32 * J.nb * J.k8);
      const int c = kFwdPass * p + 8 * j + (lane >> 2), k = 8 * s + (lane & 3);
      const float b0 = (k < J.k && c < J.n) ? J.w[(int64_t)k * J.n + c] : 0.f;
      const float b1 = (k + 4 < J.k && c < J.n) ? J.w[(int64_t)(k + 4) * J.n + c] : 0.f;
      uint32_t h0, l0, h1, l1;
      split_tf32(b0, h0, l0);
      split_tf32(b1, h1, l1);
      J.ws[e] = make_uint4(h0, h1, l0, l1);
    }
  }
}

// Route 1: out = hin @ W on the tensor cores in 3xTF32. The block's 8 warps
// take 16-row bands and WC column groups of a pass of 128 columns; W's split
// chunks (4 steps x nb column blocks) reach shared memory through cp.async
// into a ring of `ring` buffers, ring - 1 chunks ahead (up to a whole
// 128-wide layer where a small batch leaves one block an SM). An activation
// is split at its fragment load, once by each of the WC (2 or 4) warps of
// its band. inplace: hin is also the output buffer (a
// single pass, N <= 128), so the warps that read a row finish before its
// outputs are written. Per output the order is kernel 6's (mma_gemm):
// acc = 0, then for every step of 8, lo*hi', hi*lo', hi*hi'; z = acc + b.
// The epilogue takes 4 column blocks at a time: their 16 activations
// together (act_group), then their stores.
template <int WC, int T, typename Store>
__device__ __forceinline__ void fwd_tc_layer(const float* hin, int lda, const FwdLayer& L, float* wsm,
                                             const float* bsm, bool inplace, int ring, Store store) {
  constexpr int NT = kFwdMaxNB / WC;  // column blocks of a warp per pass, in groups of 4
  static_assert(NT % 4 == 0, "route-1 column groups");
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane >> 2, t = lane & 3;
  const int rb = (warp / WC) * 16, jb = (warp % WC) * NT;
  const int nb = L.chunk, k8 = (L.k + 7) / 8, nkc = (k8 + kFwdSteps - 1) / kFwdSteps;
  const int total = nkc * ((L.n + kFwdPass - 1) / kFwdPass);
  const int stage_words = kFwdSteps * nb * 32;
  const int live = nb - jb;  // this warp's column blocks inside the layer (warp-uniform)
  uint4* wbuf = reinterpret_cast<uint4*>(wsm);
  auto stage = [&](int s) {  // one commit group per chunk, empty past the last
    if (s < total) {
      const int p = s / nkc, kc = s % nkc, steps = min(kFwdSteps, k8 - kFwdSteps * kc);
      const uint4* src = L.ws + ((int64_t)p * k8 + kFwdSteps * kc) * nb * 32;
      uint4* dst = wbuf + (s % ring) * stage_words;
      for (int e = threadIdx.x; e < steps * nb * 32; e += T)
        cp_async16(reinterpret_cast<float*>(dst + e), reinterpret_cast<const float*>(src + e), 16);
    }
    cp_async_commit();
  };
  float acc[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[j][q] = 0.f;
  for (int q = 0; q + 1 < ring; ++q) stage(q);
  for (int s = 0; s < total; ++s) {
    switch (ring) {  // chunk s has landed: at most ring - 2 later groups pending
      case 8: cp_async_wait<6>(); break;
      case 4: cp_async_wait<2>(); break;
      default: cp_async_wait<0>();
    }
    __syncthreads();  // ... for every thread, and every warp is done with chunk s - 1's buffer
    stage(s + ring - 1);
    const uint4* bs = wbuf + (s % ring) * stage_words;
    const int p = s / nkc, kc = s % nkc, steps = min(kFwdSteps, k8 - kFwdSteps * kc);
    if (live > 0) {
#pragma unroll
      for (int kk = 0; kk < kFwdSteps; ++kk) {
        if (kk < steps) {
          uint32_t ah[4], al[4];
          load_a(hin + rb * lda + (kFwdSteps * kc + kk) * 8, lda, g, t, ah, al);
#pragma unroll
          for (int j0 = 0; j0 < NT; j0 += 4) {
            if (j0 < live) {
              uint32_t bh[4][2], bl[4][2];
#pragma unroll
              for (int jj = 0; jj < 4; ++jj) {
                const uint4 v = j0 + jj < live ? bs[(kk * nb + jb + j0 + jj) * 32 + lane] : make_uint4(0, 0, 0, 0);
                bh[jj][0] = v.x; bh[jj][1] = v.y; bl[jj][0] = v.z; bl[jj][1] = v.w;
              }
              // each term in one sweep over the group's accumulators: no two MMAs into one accumulator back to back
#pragma unroll
              for (int jj = 0; jj < 4; ++jj)
                if (j0 + jj < live) mma_tf32(acc[j0 + jj], al, bh[jj]);
#pragma unroll
              for (int jj = 0; jj < 4; ++jj)
                if (j0 + jj < live) mma_tf32(acc[j0 + jj], ah, bl[jj]);
#pragma unroll
              for (int jj = 0; jj < 4; ++jj)
                if (j0 + jj < live) mma_tf32(acc[j0 + jj], ah, bh[jj]);
            }
          }
        }
      }
    }
    if (kc == nkc - 1) {  // the pass's last depth: its outputs
      if (inplace && WC > 1) __syncthreads();  // every warp of the band has read its rows
      else __syncwarp();                       // the warp's own fragment loads are done
#pragma unroll
      for (int j0 = 0; j0 < NT; j0 += 4) {
        if (j0 < live) {
          float h[16];  // column block j0 + jj, fragment element q (row + 8 * (q / 2), col + q % 2) at 4 jj + q
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) {
            const int c = kFwdPass * p + 8 * (jb + j0 + jj) + 2 * t;
            const float b0 = c < L.n ? bsm[c] : 0.f, b1 = c + 1 < L.n ? bsm[c + 1] : 0.f;
#pragma unroll
            for (int q = 0; q < 4; ++q) h[4 * jj + q] = acc[j0 + jj][q] + (q % 2 ? b1 : b0);
          }
          act_group(L.act, L.w0, h);
#pragma unroll
          for (int jj = 0; jj < 4; ++jj)
#pragma unroll
            for (int q = 0; q < 4; ++q)
              if (j0 + jj < live)
                store(rb + g + 8 * (q / 2), kFwdPass * p + 8 * (jb + j0 + jj) + 2 * t + q % 2, h[4 * jj + q]);
        }
      }
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[j][q] = 0.f;
    }
  }
}

// Route 2: out = hin @ W in fp32 on the CUDA cores, the order of tile_gemm
// (and so of kernel 6's relu recompute) for every output: acc = 0, then
// acc = fmaf(h_k, w_kn, acc) for k ascending, z = acc + b_n. The block's R
// rows and NC columns (N rounded up to 32, 64 or 128) are one tile: each
// thread keeps R * NC / (4 T) rows of 4 columns; W is staged in chunks of 32
// x NC (one chunk for a relu decoder's whole layer). inplace: hin is also
// the output buffer (a single chunk, N <= NC), so every thread finishes its
// reads first.
template <int R, int T, int NC, typename Store>
__device__ __forceinline__ void fwd_fp32_layer(const float* hin, int lda, const FwdLayer& L, float* wsm,
                                               bool inplace, Store store) {
  constexpr int CG = NC / 4, RG = T / CG, TR = R / RG, ldw = NC + 4;
  static_assert(T % CG == 0 && R % RG == 0 && TR >= 1, "route-2 tile");
  const int tx = threadIdx.x % CG, ty = threadIdx.x / CG;
  const int K = L.k, N = L.n, kpad = (K + 3) & ~3;
  for (int n0 = 0; n0 < N; n0 += NC) {
    float bias[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) bias[j] = n0 + tx * 4 + j < N ? __ldg(L.b + n0 + tx * 4 + j) : 0.f;
    float acc[TR][4];
#pragma unroll
    for (int i = 0; i < TR; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    for (int k0 = 0; k0 < kpad; k0 += kFwdChunkK) {
      const int kc = min(kFwdChunkK, kpad - k0);
      __syncthreads();  // every thread is done with the last chunk
      for (int e = threadIdx.x; e < kc * NC; e += T) {
        const int k = e / NC, c = e % NC;
        wsm[k * ldw + c] = (k0 + k < K && n0 + c < N) ? __ldg(L.w + (int64_t)(k0 + k) * N + n0 + c) : 0.f;
      }
      __syncthreads();
      for (int kk = 0; kk < kc; kk += 4) {
        float4 bv[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) bv[q] = *reinterpret_cast<const float4*>(wsm + (kk + q) * ldw + tx * 4);
#pragma unroll
        for (int i = 0; i < TR; ++i) {
          const float4 av = *reinterpret_cast<const float4*>(hin + (ty * TR + i) * lda + k0 + kk);
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const float aq = lane(av, q);
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(aq, lane(bv[q], j), acc[i][j]);
          }
        }
      }
    }
    if (inplace) __syncthreads();  // every thread has read hin
#pragma unroll
    for (int i = 0; i < TR; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) store(ty * TR + i, n0 + tx * 4 + j, act_fwd(L.act, L.w0, acc[i][j] + bias[j]));
  }
}

// Route 2 for N <= 8: one thread per (row, column), a dot product over k
// ascending (the same fmaf order), W read through the read-only cache.
template <int R, int T, typename Store>
__device__ __forceinline__ void fwd_dot_layer(const float* hin, int lda, const FwdLayer& L, bool inplace,
                                              Store store) {
  constexpr int kPer = (R * 8 + T - 1) / T;
  float z[kPer];
#pragma unroll
  for (int u = 0; u < kPer; ++u) {
    const int e = threadIdx.x + u * T, r = e / 8, c = e % 8;
    z[u] = 0.f;
    if (e < R * 8 && c < L.n) {
      float acc = 0.f;
      for (int k = 0; k < L.k; ++k) acc = fmaf(hin[r * lda + k], __ldg(L.w + (int64_t)k * L.n + c), acc);
      z[u] = acc + __ldg(L.b + c);
    }
  }
  if (inplace) __syncthreads();
#pragma unroll
  for (int u = 0; u < kPer; ++u) {
    const int e = threadIdx.x + u * T;
    if (e < R * 8) store(e / 8, e % 8, act_fwd(L.act, L.w0, z[u]));
  }
}

// One block per tile of R rows walks the whole stack; the tile's activations
// stay in shared memory. x arrives as the tile's one contiguous run of R x
// K0 floats (zeros past the batch), with zeros in the columns up to the next
// multiple of 32. A layer's epilogue writes act(z) for its N columns and
// zeros up to the next multiple of 8 that the next layer reads, or, for the
// last layer, the output rows inside the batch.
template <int C>
__global__ void __launch_bounds__(kFwdThreads, 2)
fused_mlp_forward_kernel(const float* __restrict__ x, float* __restrict__ out, int64_t batch,
                         const __grid_constant__ FwdNet net) {
  constexpr int R = fwd_rows(C), T = kFwdThreads;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int ld = net.ld, lda = net.lda, nl = net.n_layers;
  const bool inplace = net.nbuf == 1;
  float* buf0 = smem;
  float* buf1 = smem + (net.nbuf - 1) * R * lda;
  float* wsm = smem + net.nbuf * R * lda;
  float* bsm = wsm + net.wfloats;
  const int64_t row0 = (int64_t)blockIdx.x * R;
  {
    const int k0 = net.layer[0].k, kz = (k0 + 31) / 32 * 32 - k0;
    const int live = (int)((batch - row0 < R ? batch - row0 : R) * k0);
    const float* xs = x + row0 * k0;
#pragma unroll 4
    for (int e = threadIdx.x; e < R * k0; e += T) buf0[(e / k0) * lda + e % k0] = e < live ? __ldg(xs + e) : 0.f;
    if (kz > 0)
      for (int e = threadIdx.x; e < R * kz; e += T) buf0[(e / kz) * lda + k0 + e % kz] = 0.f;
  }
  for (int l = 0; l < nl; ++l) {
    const FwdLayer& L = net.layer[l];
    const bool last = l == nl - 1;
    const int n = L.n;
    const float* hin = (l & 1) ? buf1 : buf0;
    float* hout = (l & 1) ? buf0 : buf1;
    // the bias in one of two buffers by layer, so that no warp still reading the last layer's meets it
    float* bias = bsm + (l & 1) * ld;
    if (L.route == kRouteTC)
      for (int c = threadIdx.x; c < n; c += T) bias[c] = __ldg(L.b + c);
    __syncthreads();  // the layer's input and bias are in place, the weight region is free
    auto store = [&](int r, int c, float h) {  // h = act(z) at (r, c)
      if (c < n) {
        if (!last) hout[r * lda + c] = h;
        else if (row0 + r < batch) out[(row0 + r) * n + c] = h;
      } else if (!last && c < ld) {
        hout[r * lda + c] = 0.f;
      }
    };
    if (L.route == kRouteTC) {
      fwd_tc_layer<fwd_warp_cols(C), T>(hin, lda, L, wsm, bias, inplace, net.ring, store);
      continue;
    }
    switch (L.chunk) {
      case 32: fwd_fp32_layer<R, T, 32>(hin, lda, L, wsm, inplace, store); break;
      case 64: fwd_fp32_layer<R, T, 64>(hin, lda, L, wsm, inplace, store); break;
      case 128: fwd_fp32_layer<R, T, 128>(hin, lda, L, wsm, inplace, store); break;
      default: fwd_dot_layer<R, T>(hin, lda, L, inplace, store);
    }
  }
}

// Pass 1 of the backward: per tile of 32 * MT rows, recompute the forward,
// keeping act'(z_l) in dact and h_{l+1} = act(z_l) in hact, and
// backpropagate dz_l into dzs (dact, dzs: (rows, ztot); hact: (rows, htot);
// rows = the batch rounded up to 64); dx (batch, K0) when it is not null.
template <int MT, int NT>
__global__ void __launch_bounds__(kThreads, 2)
fused_mlp_backward_tile_kernel(const float* __restrict__ x, const float* __restrict__ g,
                               float* __restrict__ dact, float* __restrict__ hact, float* __restrict__ dzs,
                               float* __restrict__ dx, int64_t batch, const __grid_constant__ Net net) {
  constexpr int R = 32 * MT;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int ld = net.ld, lda = net.ld + 4;  // = 4 (mod 32): conflict-free A fragments
  const int ztot = net.ztot, htot = net.htot;
  float* hin = smem;
  float* hout = smem + R * lda;
  float* bsm = smem + 2 * R * lda;
  const int64_t row0 = (int64_t)blockIdx.x * R;
  const int nl = net.n_layers;

  // x into the first buffer, zeros past the batch and past column K0
  {
    const int k0 = net.layer[0].k;
    for (int e = threadIdx.x; e < R * ld; e += kThreads) {
      const int r = e / ld, c = e % ld;
      const int64_t row = row0 + r;
      hin[r * lda + c] = (row < batch && c < k0) ? x[row * k0 + c] : 0.f;
    }
  }
  // recompute the forward, keeping every pre-activation
  for (int l = 0; l < nl; ++l) {
    const Layer& L = net.layer[l];
    const bool last = l == nl - 1;
    const int n = L.n, act = L.act, zoff = L.zoff, hoff = L.hoff;
    const float w0 = L.w0;
    const float* bias = L.b;
    auto keep = [&](int r, int c, float acc, float b) {
      if (c < n) {
        float h, d;
        act_both(act, w0, acc + b, h, d);
        dact[(row0 + r) * ztot + zoff + c] = d;
        if (!last) {
          hact[(row0 + r) * htot + hoff + c] = h;
          hout[r * lda + c] = h;
        }
      } else if (!last && c < ld) {
        hout[r * lda + c] = 0.f;
      }
    };
    if (act == kRelu) {  // kernel 5's fp32 product, 32 rows at a time: relu's mask is the forward's
#pragma unroll
      for (int half = 0; half < MT; ++half)
        tile_gemm(hin + half * kTileRows * lda, lda, L.w, n, 1, L.k, n, bsm, [&](int r, int c, float acc) {
          keep(half * kTileRows + r, c, acc, c < n ? bias[c] : 0.f);
        });
      __syncthreads();  // before the next product restages bsm
    } else {
      mma_gemm<MT, NT, false>(hin, lda, L.w, L.k, n, L.wvec, bsm,
                              [&](int, int c) { return c < n ? __ldg(bias + c) : 0.f; }, keep);
    }
    float* tmp = hin; hin = hout; hout = tmp;
  }

  // dz of the last layer: g * act'(z), four elements a thread at a time
  // (their loads issued together)
  {
    const Layer& L = net.layer[nl - 1];
    constexpr int kBatch = 4;
    for (int e0 = 0; e0 < R * ld; e0 += kBatch * kThreads) {
      float gv[kBatch], dv[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int e = e0 + u * kThreads + threadIdx.x, r = e / ld, c = e % ld;
        const int64_t row = row0 + r;
        const bool live = e < R * ld && c < L.n;
        gv[u] = live && row < batch ? g[row * L.n + c] : 0.f;
        dv[u] = live ? dact[row * ztot + L.zoff + c] : 0.f;
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int e = e0 + u * kThreads + threadIdx.x, r = e / ld, c = e % ld;
        if (e >= R * ld) continue;
        float v = 0.f;
        if (c < L.n) {
          v = gv[u] * dv[u];
          dzs[(row0 + r) * ztot + L.zoff + c] = v;
        }
        hin[r * lda + c] = v;
      }
    }
  }

  // dz_{l-1} = (dz_l W_l^T) * act'(z_{l-1}); dx = dz_0 W_0^T
  for (int l = nl - 1; l >= 0; --l) {
    const Layer& L = net.layer[l];
    if (l == 0) {
      if (dx == nullptr) break;
      const int k0 = L.k;
      mma_gemm<MT, NT, true>(hin, lda, L.w, L.n, L.k, L.wvec, bsm, [](int, int) { return 0.f; },
                             [&](int r, int c, float acc, float) {
                               if (c < k0 && row0 + r < batch) dx[(row0 + r) * k0 + c] = acc;
                             });
      break;
    }
    const Layer& P = net.layer[l - 1];
    const int kp = L.k, pzoff = P.zoff;
    mma_gemm<MT, NT, true>(
        hin, lda, L.w, L.n, L.k, L.wvec, bsm,
        [&](int r, int c) { return c < kp ? dact[(row0 + r) * ztot + pzoff + c] : 0.f; },
        [&](int r, int c, float acc, float d) {
          if (c < kp) {
            const float v = acc * d;
            dzs[(row0 + r) * ztot + pzoff + c] = v;
            hout[r * lda + c] = v;
          } else if (c < ld) {
            hout[r * lda + c] = 0.f;
          }
        });
    float* tmp = hin; hin = hout; hout = tmp;
  }
}

// Stage rows [r0, r0 + 32) of one weight-gradient step, zeros at rows past
// `end`: hs[r][m] = h_l[row, m0 + m] (x, or pass 1's h scratch) for
// m0 + m < K, ds[r][n] = dz_l[row, n0 + n] for n0 + n < N.
// Columns past K (N) are zero-filled within the 16-byte copy that holds the
// last valid one, or not written; they only reach dW rows (columns) that
// are never stored.
__device__ __forceinline__ void stage_grad_rows(float* hs, float* ds, const float* __restrict__ hsrc,
                                                int64_t hstride, bool hvec, const float* __restrict__ dsrc,
                                                int64_t dstride, int64_t r0, int64_t end, int K, int N,
                                                int m0, int n0) {
  const int tid = threadIdx.x;
  if (hvec) {
    for (int e = tid; e < kGradRows * kGradTile / 4; e += kThreads) {
      const int r = e / (kGradTile / 4), m = (e % (kGradTile / 4)) * 4;
      const int valid = min(4, K - m0 - m);
      if (valid <= 0) continue;
      const bool ok = r0 + r < end;
      cp_async16(hs + r * kGradLd + m, ok ? hsrc + (r0 + r) * hstride + m0 + m : hsrc, ok ? 4 * valid : 0);
    }
  } else {
    const int width = min(kGradTile, K - m0);
    for (int e = tid; e < kGradRows * width; e += kThreads) {
      const int r = e / width, m = e % width;
      const bool ok = r0 + r < end;
      cp_async4(hs + r * kGradLd + m, ok ? hsrc + (r0 + r) * hstride + m0 + m : hsrc, ok ? 4 : 0);
    }
  }
  for (int e = tid; e < kGradRows * kGradTile / 4; e += kThreads) {
    const int r = e / (kGradTile / 4), n = (e % (kGradTile / 4)) * 4;
    const int valid = min(4, N - n0 - n);
    if (valid <= 0) continue;
    const bool ok = r0 + r < end;
    cp_async16(ds + r * kGradLd + n, ok ? dsrc + (r0 + r) * dstride + n0 + n : dsrc, ok ? 4 * valid : 0);
  }
}

// Pass 2 of the backward: blockIdx.x is one 128 x 128 tile of one layer's
// dW, blockIdx.y one slice of rows_per_slice rows. dW_tile = h^T dz over the
// slice, as MMAs with A = h^T (16 x 8 fragments read down the staged rows)
// and B = dz; 8 warps of 64 x 32 outputs. The partial sums go into dW (and,
// for the tiles of the first 128 rows of dW, db) by atomicAdd.
__global__ void __launch_bounds__(kThreads, 2)
fused_mlp_weight_grad_kernel(const float* __restrict__ x, const float* __restrict__ hact,
                             const float* __restrict__ dzs, int64_t batch, int64_t rows_per_slice, int xvec,
                             const __grid_constant__ Net net) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);  // hs[kGradStages], ds[kGradStages]: kGradRows x kGradLd each
  int l = 0;
  while (l + 1 < net.n_layers && (int)blockIdx.x >= net.layer[l + 1].tile_start) ++l;
  const Layer& L = net.layer[l];
  const int K = L.k, N = L.n, ztot = net.ztot;
  const int n_ntiles = (N + kGradTile - 1) / kGradTile;
  const int local = blockIdx.x - L.tile_start;
  const int m0 = (local / n_ntiles) * kGradTile, n0 = (local % n_ntiles) * kGradTile;
  const int64_t begin = (int64_t)blockIdx.y * rows_per_slice;
  const int64_t end = begin + rows_per_slice < batch ? begin + rows_per_slice : batch;
  const Layer* P = l > 0 ? &net.layer[l - 1] : nullptr;
  const float* hsrc = P == nullptr ? x : hact + P->hoff;
  const int64_t hstride = P == nullptr ? K : net.htot;
  const bool hvec = P != nullptr || xvec;
  const float* dsrc = dzs + L.zoff;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int mb = (warp / 4) * 64, nb = (warp % 4) * 32;
  const bool with_db = m0 == 0 && threadIdx.x < kGradTile && n0 + (int)threadIdx.x < N;
  const int live_m = (K - m0 - mb + 15) / 16, live_n = (N - n0 - nb + 7) / 8;  // the warp's blocks inside dW
  float acc[2][2][4][4];  // [32-row half][16-row block][8-column block][fragment]
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[h][i][j][q] = 0.f;
  float dbacc = 0.f;

  const int steps = (int)((end - begin + kGradRows - 1) / kGradRows);
  auto stage = [&](int step) {  // one commit group per step, empty past the last
    if (step < steps) {
      const int b = step % kGradStages;
      stage_grad_rows(smem + b * kGradBufFloats, smem + (kGradStages + b) * kGradBufFloats, hsrc, hstride, hvec,
                      dsrc, ztot, begin + (int64_t)step * kGradRows, end, K, N, m0, n0);
    }
    cp_async_commit();
  };
  stage(0);
  stage(1);
  for (int s = 0; s < steps; ++s) {
    float* hs = smem + (s % kGradStages) * kGradBufFloats;
    float* ds = smem + (kGradStages + s % kGradStages) * kGradBufFloats;
    cp_async_wait<1>();  // step s has landed (step s + 1 may be in flight)
    __syncthreads();     // ... for every thread, and every warp is done with step s - 1's buffers
    stage(s + 2);
    if (with_db) {
#pragma unroll 8
      for (int r = 0; r < kGradRows; ++r) dbacc += ds[r * kGradLd + threadIdx.x];
    }
    if (live_m > 0 && live_n > 0) {
#pragma unroll
      for (int kk = 0; kk < kGradRows / kStepK; ++kk) {
        const int kr = kk * kStepK + t;
        uint32_t ah[2][4], al[2][4], bh[4][2], bl[4][2];
#pragma unroll
        for (int j = 0; j < 4; ++j) {  // B = dz: lane holds (row kr, col g), (kr + 4, g)
          split_tf32(ds[kr * kGradLd + nb + 8 * j + g], bh[j][0], bl[j][0]);
          split_tf32(ds[(kr + 4) * kGradLd + nb + 8 * j + g], bh[j][1], bl[j][1]);
        }
#pragma unroll
        for (int half = 0; half < 2; ++half) {  // the warp's 64 rows of dW, 32 at a time
          if (2 * half >= live_m) continue;  // warp-uniform: rows of dW past K
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            // A = h^T: lane holds (m = g, row kr), (g + 8, kr), (g, kr + 4), (g + 8, kr + 4)
            const float* p = hs + kr * kGradLd + mb + 32 * half + 16 * i + g;
            split_tf32(p[0], ah[i][0], al[i][0]);
            split_tf32(p[8], ah[i][1], al[i][1]);
            split_tf32(p[4 * kGradLd], ah[i][2], al[i][2]);
            split_tf32(p[4 * kGradLd + 8], ah[i][3], al[i][3]);
          }
          mma_3xtf32<2, 4>(acc[half], ah, al, bh, bl, live_n);
        }
      }
    }
  }

  const bool pairs = (N % 2) == 0;  // float2 atomics: (k, n) and (k, n + 1) share 8 aligned bytes
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int k = m0 + mb + 16 * i + g + 8 * h, n = n0 + nb + 8 * j + 2 * t;
        if (k >= K || n >= N) continue;
        const float* v = acc[i / 2][i % 2][j] + 2 * h;
        float* dst = L.dw + (int64_t)k * N + n;
        if (pairs) {
          atomicAdd(reinterpret_cast<float2*>(dst), make_float2(v[0], v[1]));
        } else {
          atomicAdd(dst, v[0]);
          if (n + 1 < N) atomicAdd(dst + 1, v[1]);
        }
      }
  if (with_db) atomicAdd(L.db + n0 + threadIdx.x, dbacc);
}

// Validates the layer chain and fills the kernel parameter. Returns
// cudaErrorInvalidValue for a chain the kernels do not take.
cudaError_t pack_net(int n_layers, const int32_t* dims, const int32_t* acts, const float* w0s,
                     const float* const* ws, const float* const* bs, float* const* dws,
                     float* const* dbs, Net* net) {
  if (n_layers < 1 || n_layers > kMaxLayers || dims == nullptr || acts == nullptr ||
      w0s == nullptr || ws == nullptr || bs == nullptr)
    return cudaErrorInvalidValue;
  memset(net, 0, sizeof(Net));
  int widest = 0, zoff = 0, hoff = 0, tiles = 0;
  for (int l = 0; l <= n_layers; ++l) {
    if (dims[l] < 1) return cudaErrorInvalidValue;
    widest = dims[l] > widest ? dims[l] : widest;
  }
  for (int l = 0; l < n_layers; ++l) {
    Layer& L = net->layer[l];
    if (acts[l] < kId || acts[l] > kSine || ws[l] == nullptr || bs[l] == nullptr)
      return cudaErrorInvalidValue;
    L.w = ws[l];
    L.b = bs[l];
    L.dw = dws ? dws[l] : nullptr;
    L.db = dbs ? dbs[l] : nullptr;
    L.k = dims[l];
    L.n = dims[l + 1];
    L.act = acts[l];
    L.w0 = w0s[l];
    L.wvec = L.n % 4 == 0 && ((uintptr_t)ws[l] & 15) == 0;
    L.zoff = zoff;
    L.hoff = l + 1 < n_layers ? hoff : 0;
    L.tile_start = tiles;
    zoff += (L.n + 3) / 4 * 4;  // each layer's block of a scratch row starts on 16 bytes
    if (l + 1 < n_layers) hoff += (L.n + 3) / 4 * 4;
    tiles += ((L.k + kGradTile - 1) / kGradTile) * ((L.n + kGradTile - 1) / kGradTile);
  }
  net->n_layers = n_layers;
  net->ld = (widest + kChunkK - 1) / kChunkK * kChunkK;
  net->ztot = zoff;
  net->htot = hoff;
  net->n_tiles = tiles;
  return cudaSuccess;
}

// Pass 1's shared memory: two activation buffers of 32 * mt rows (row stride
// ld + 4) and two weight-chunk buffers of 32 * nt output columns.
size_t backward_tile_smem_bytes(int ld, int mt, int nt) {
  const int chunk = nt == 4 ? chunk_floats<128>() : chunk_floats<64>();
  return sizeof(float) * (size_t)(2 * 32 * mt * (ld + 4) + 2 * chunk);
}

constexpr size_t kGradSmemBytes = sizeof(float) * 2 * kGradStages * kGradBufFloats;  // hs and ds per stage

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes > (size_t)kMaxSharedBytes) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// The forward's layout from the host's choices (ops/fused_mlp.py:forward_plan,
// which computes the same layout to make them): plan words are the block
// shape, the ring depth, then the route of each layer. Fills the kernel
// parameter, the split jobs and the shared bytes. Returns
// cudaErrorInvalidValue for a stack or a plan the kernels do not take: a
// relu layer on route 1, split weights past the scratch's split_cap
// 16-byte words, or more shared memory than a block has.
cudaError_t pack_forward(int n_layers, const int32_t* dims, const int32_t* acts, const float* w0s,
                         const float* const* ws, const float* const* bs, const int32_t* words, uint4* wsplit,
                         int64_t split_cap, int* config, size_t* smem, FwdNet* net, SplitJobs* jobs) {
  if (n_layers < 1 || n_layers > kMaxLayers || dims == nullptr || acts == nullptr || w0s == nullptr ||
      ws == nullptr || bs == nullptr || words == nullptr || ((uintptr_t)wsplit & 15))
    return cudaErrorInvalidValue;
  memset(net, 0, sizeof(FwdNet));
  memset(jobs, 0, sizeof(SplitJobs));
  const int c = words[0], ring = words[1];
  if (c < 0 || c >= kFwdConfigs || (ring != 2 && ring != 4 && ring != 8)) return cudaErrorInvalidValue;
  int widest = 0;
  for (int l = 0; l <= n_layers; ++l) {
    if (dims[l] < 1) return cudaErrorInvalidValue;
    widest = dims[l] > widest ? dims[l] : widest;
  }
  const int ld = (widest + 31) / 32 * 32, nbuf = ld <= kFwdPass ? 1 : 2;
  int64_t wfloats = 0, split = 0;
  int bias = 0;
  for (int l = 0; l < n_layers; ++l) {
    FwdLayer& L = net->layer[l];
    if (acts[l] < kId || acts[l] > kSine || ws[l] == nullptr || bs[l] == nullptr) return cudaErrorInvalidValue;
    L.w = ws[l];
    L.b = bs[l];
    L.k = dims[l];
    L.n = dims[l + 1];
    L.act = acts[l];
    L.w0 = w0s[l];
    L.route = words[2 + l];
    if (L.route == kRouteTC) {  // relu's mask must stay the fp32 one that kernel 6 repeats
      if (acts[l] == kRelu || wsplit == nullptr) return cudaErrorInvalidValue;
      L.chunk = (L.n + 7) / 8 < kFwdMaxNB ? (L.n + 7) / 8 : kFwdMaxNB;
      SplitJob& J = jobs->job[jobs->n_jobs++];
      J.w = ws[l];
      J.ws = wsplit + split;
      J.k = L.k;
      J.n = L.n;
      J.nb = L.chunk;
      J.k8 = (L.k + 7) / 8;
      J.count = (L.n + kFwdPass - 1) / kFwdPass * J.k8 * J.nb * 32;
      L.ws = J.ws;
      split += J.count;
      wfloats = wfloats > ring * kFwdSteps * L.chunk * 32 * 4 ? wfloats : ring * kFwdSteps * L.chunk * 32 * 4;
      bias = 2 * ld;
    } else if (L.route == kRouteFP32) {
      L.chunk = L.n <= 8 ? 0 : L.n <= 32 ? 32 : L.n <= 64 ? 64 : 128;
      if (L.chunk) wfloats = wfloats > kFwdChunkK * (L.chunk + 4) ? wfloats : kFwdChunkK * (L.chunk + 4);
    } else {
      return cudaErrorInvalidValue;
    }
  }
  if (split > split_cap) return cudaErrorInvalidValue;
  net->n_layers = n_layers;
  net->ld = ld;
  net->lda = ld + 4;
  net->nbuf = nbuf;
  net->ring = ring;
  net->wfloats = (int)wfloats;
  *smem = sizeof(float) * ((size_t)nbuf * fwd_rows(c) * (ld + 4) + wfloats + bias);
  if (*smem > (size_t)kMaxSharedBytes) return cudaErrorInvalidValue;
  *config = c;
  return cudaSuccess;
}

template <int MT, int NT>
cudaError_t launch_backward_tiles(const float* x, const float* g, float* dact, float* hact, float* dzs,
                                  float* dx, int64_t batch, const Net& net, cudaStream_t s) {
  const size_t smem = backward_tile_smem_bytes(net.ld, MT, NT);
  cudaError_t err = allow_smem(fused_mlp_backward_tile_kernel<MT, NT>, smem);
  if (err != cudaSuccess) return err;
  const unsigned tiles = (unsigned)((batch + 32 * MT - 1) / (32 * MT));
  fused_mlp_backward_tile_kernel<MT, NT><<<tiles, kThreads, smem, s>>>(x, g, dact, hact, dzs, dx, batch, net);
  return cudaGetLastError();
}

template <int C>
cudaError_t launch_forward(const float* x, float* out, int64_t batch, const FwdNet& net, size_t smem,
                           cudaStream_t s) {
  cudaError_t err = allow_smem(fused_mlp_forward_kernel<C>, smem);
  if (err != cudaSuccess) return err;
  const unsigned tiles = (unsigned)((batch + fwd_rows(C) - 1) / fwd_rows(C));
  fused_mlp_forward_kernel<C><<<tiles, kFwdThreads, smem, s>>>(x, out, batch, net);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// out (batch, dims[L]) = the stack applied to x (batch, dims[0]).
// dims: host array of L+1 widths; acts, w0s: host arrays of L codes
// (0 id, 1 relu, 2 gelu, 3 sine) and sine frequencies; ws, bs: host arrays
// of L device pointers; plan: host array of 2 + L words (pack_forward);
// wsplit: 16-byte aligned device scratch of split_cap 16-byte words for the
// split weights. batch == 0 launches nothing.
int fused_mlp_forward(const float* x, float* out, int64_t batch, int n_layers, const int32_t* dims,
                      const int32_t* acts, const float* w0s, const float* const* ws,
                      const float* const* bs, const int32_t* plan, void* wsplit, int64_t split_cap,
                      void* stream) {
  FwdNet net;
  SplitJobs jobs;
  int config = 0;
  size_t smem = 0;
  cudaError_t err = pack_forward(n_layers, dims, acts, w0s, ws, bs, plan, reinterpret_cast<uint4*>(wsplit),
                                 split_cap, &config, &smem, &net, &jobs);
  if (err != cudaSuccess) return (int)err;
  if (batch <= 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  if (jobs.n_jobs > 0) {
    int most = 0;
    for (int q = 0; q < jobs.n_jobs; ++q) most = jobs.job[q].count > most ? jobs.job[q].count : most;
    const int blocks = (most + 255) / 256 < 1024 ? (most + 255) / 256 : 1024;
    fused_mlp_split_weights_kernel<<<blocks, 256, 0, s>>>(jobs);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)(config == 0 ? launch_forward<0>(x, out, batch, net, smem, s)
                            : launch_forward<1>(x, out, batch, net, smem, s));
}

// dW_l, db_l (zeroed by the caller; dws, dbs: host arrays of L device
// pointers) and, when dx is not null, dx (batch, dims[0]) for upstream g
// (batch, dims[L]). dact, dzs: 16-byte aligned scratch of (batch rounded up
// to 64) x sum(round_up(dims[l], 4), 1 <= l <= L) floats each; hact: the same
// rows x sum(round_up(dims[l], 4), 1 <= l < L). rows_per_slice (a multiple
// of 32) sets how many rows one weight-gradient block sums.
int fused_mlp_backward(const float* x, const float* g, float* dx, float* dact, float* hact, float* dzs,
                       int64_t batch, int64_t rows_per_slice, int n_layers, const int32_t* dims,
                       const int32_t* acts, const float* w0s, const float* const* ws,
                       const float* const* bs, float* const* dws, float* const* dbs,
                       void* stream) {
  Net net;
  if (dws == nullptr || dbs == nullptr || rows_per_slice < kGradRows || rows_per_slice % kGradRows ||
      ((uintptr_t)dact & 15) || ((uintptr_t)hact & 15) || ((uintptr_t)dzs & 15))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = pack_net(n_layers, dims, acts, w0s, ws, bs, dws, dbs, &net);
  if (err != cudaSuccess) return (int)err;
  for (int l = 0; l < n_layers; ++l)
    if (dws[l] == nullptr || dbs[l] == nullptr) return (int)cudaErrorInvalidValue;
  if (batch <= 0) return (int)cudaSuccess;
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
  }
  cudaStream_t s = (cudaStream_t)stream;
  const size_t max = (size_t)kMaxSharedBytes;
  if (batch >= (int64_t)2 * sms * 64 && backward_tile_smem_bytes(net.ld, 2, 4) <= max)
    err = launch_backward_tiles<2, 4>(x, g, dact, hact, dzs, dx, batch, net, s);
  else if (backward_tile_smem_bytes(net.ld, 1, 4) <= max)
    err = launch_backward_tiles<1, 4>(x, g, dact, hact, dzs, dx, batch, net, s);
  else if (backward_tile_smem_bytes(net.ld, 1, 2) <= max)
    err = launch_backward_tiles<1, 2>(x, g, dact, hact, dzs, dx, batch, net, s);
  else
    err = cudaErrorInvalidValue;
  if (err != cudaSuccess) return (int)err;
  err = allow_smem(fused_mlp_weight_grad_kernel, kGradSmemBytes);
  if (err != cudaSuccess) return (int)err;
  const int xvec = dims[0] % 4 == 0 && ((uintptr_t)x & 15) == 0;
  const unsigned slices = (unsigned)((batch + rows_per_slice - 1) / rows_per_slice);
  fused_mlp_weight_grad_kernel<<<dim3((unsigned)net.n_tiles, slices), kThreads, kGradSmemBytes, s>>>(
      x, hact, dzs, batch, rows_per_slice, xvec, net);
  return (int)cudaGetLastError();
}

const char* fused_mlp_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
