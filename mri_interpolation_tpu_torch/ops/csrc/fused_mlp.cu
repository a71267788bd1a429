// Fused MLP stack on Hopper: forward and backward, fp32 on the CUDA cores.
//
// Replaces two Pallas TPU kernels of mri_interpolation_tpu/ops/pallas/fused_mlp.py:
//   fused_mlp_forward_kernel        <- _forward_kernel  (called by _forward_call)
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
// Design. A block owns a tile of kTileRows = 32 rows and walks the whole
// stack for it. The tile's activations stay in shared memory, in two buffers
// of 32 x ld floats used in turn (ld = the widest layer rounded up to 32; at
// width 352 a buffer is 45 KB). The weights do not fit (330 KB at SIREN
// 128 x 6, 496 KB per 352 x 352 layer), so each layer's W is streamed through
// shared memory in chunks of 32 (K) x 128 (N). 256 threads each keep a 4 x 4
// block of the 32 x 128 output chunk in registers and accumulate with fp32
// FMAs on the CUDA cores: no tensor cores, so no TF32 rounding, whose ~1e-3
// error times w0 = 30 would break parity. sinf/cosf/tanhf are the accurate
// library functions (no --use_fast_math): a first SIREN layer's argument
// reaches ~40 rad, where the __sinf intrinsic loses digits.
//
// The TPU backward sums dW over a sequential grid. Blocks here run in no
// order, so the backward is two kernels:
//   1. fused_mlp_backward_tile_kernel, one block per 32-row tile: recompute
//      the forward, writing every z_l to a scratch buffer, then backpropagate
//      dz through the stack (dz_l W_l^T streams W_l transposed), writing every
//      dz_l to a second scratch buffer and dx if asked for;
//   2. fused_mlp_weight_grad_kernel: dW_l = h_l^T dz_l and db_l, with h_l
//      rebuilt as act_{l-1}(z_{l-1}) (h_0 = x) from the scratch. Each block
//      owns a 32 x 128 tile of one layer's dW and one slice of the rows; the
//      slices' partial sums meet in dW with one fp32 atomicAdd per weight per
//      block (dW and db are zeroed by the caller). The order of those adds
//      changes from run to run, so dW and db are not bitwise reproducible.
// Masked rows (the ragged tail of the last tile) read x = 0 and g = 0, so
// their dz is 0 and they add nothing to dW or db, like the TPU kernel's
// zero-padded rows.
//
// What bounds them on this card: fp32 operations. At SIREN 3 -> 128 x 6 -> 1
// a row costs 82,432 MACs forward and three times that backward against 16
// bytes in and out, far above the H100's 20 flop/byte fp32 balance point.
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
constexpr int kGradALd = kTileRows + 4;
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
  int zoff;        // column offset of z_l / dz_l in the scratch rows
  int tile_start;  // first weight-gradient tile of this layer
};

struct Net {
  Layer layer[kMaxLayers];
  int n_layers;
  int ld;          // row stride of the activation buffers
  int ztot;        // row stride of the scratch buffers (sum of n)
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

__device__ __forceinline__ float act_grad(int act, float w0, float z) {
  switch (act) {
    case kSine: return w0 * cosf(w0 * z);
    case kRelu: return z > 0.f ? 1.f : 0.f;
    case kGelu: {
      const float u = kSqrt2OverPi * (z + 0.044715f * (z * z * z));
      const float t = tanhf(u);
      const float du = kSqrt2OverPi * (1.f + 0.134145f * (z * z));
      return 0.5f * (1.f + t) + 0.5f * z * (1.f - t * t) * du;
    }
    default: return 1.f;
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

// Copy the tile's x rows into buf (zeros past the batch and past column K0).
__device__ __forceinline__ void stage_x(float* buf, int ld, const float* __restrict__ x, int64_t row0,
                                        int64_t batch, int k0) {
  for (int e = threadIdx.x; e < kTileRows * ld; e += kThreads) {
    const int r = e / ld, c = e % ld;
    const int64_t row = row0 + r;
    buf[e] = (row < batch && c < k0) ? x[row * k0 + c] : 0.f;
  }
}

__global__ void __launch_bounds__(kThreads)
fused_mlp_forward_kernel(const float* __restrict__ x, float* __restrict__ out, int64_t batch,
                         const __grid_constant__ Net net) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int ld = net.ld;
  float* hin = smem;
  float* hout = smem + kTileRows * ld;
  float* bs = smem + 2 * kTileRows * ld;
  const int64_t row0 = (int64_t)blockIdx.x * kTileRows;
  stage_x(hin, ld, x, row0, batch, net.layer[0].k);
  for (int l = 0; l < net.n_layers; ++l) {
    const Layer& L = net.layer[l];
    const bool last = l == net.n_layers - 1;
    const int n = L.n, act = L.act;
    const float w0 = L.w0;
    const float* bias = L.b;
    tile_gemm(hin, ld, L.w, n, 1, L.k, n, bs, [&](int r, int c, float acc) {
      if (c < n) {
        const float h = act_fwd(act, w0, acc + bias[c]);
        if (!last) hout[r * ld + c] = h;
        else if (row0 + r < batch) out[(row0 + r) * n + c] = h;
      } else if (!last && c < ld) {
        hout[r * ld + c] = 0.f;
      }
    });
    float* t = hin; hin = hout; hout = t;
  }
}

// Pass 1 of the backward: per tile, recompute z_l into zs and backpropagate
// dz_l into dzs (both (rows, ztot), rows = the batch rounded up to 32); dx
// (batch, K0) when it is not null.
__global__ void __launch_bounds__(kThreads)
fused_mlp_backward_tile_kernel(const float* __restrict__ x, const float* __restrict__ g,
                               float* zs, float* dzs, float* __restrict__ dx, int64_t batch,
                               const __grid_constant__ Net net) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int ld = net.ld;
  const int ztot = net.ztot;
  float* hin = smem;
  float* hout = smem + kTileRows * ld;
  float* bs = smem + 2 * kTileRows * ld;
  const int64_t row0 = (int64_t)blockIdx.x * kTileRows;
  const int nl = net.n_layers;

  // recompute the forward, keeping every pre-activation
  stage_x(hin, ld, x, row0, batch, net.layer[0].k);
  for (int l = 0; l < nl; ++l) {
    const Layer& L = net.layer[l];
    const bool last = l == nl - 1;
    const int n = L.n, act = L.act, zoff = L.zoff;
    const float w0 = L.w0;
    const float* bias = L.b;
    tile_gemm(hin, ld, L.w, n, 1, L.k, n, bs, [&](int r, int c, float acc) {
      if (c < n) {
        const float z = acc + bias[c];
        zs[(row0 + r) * ztot + zoff + c] = z;
        if (!last) hout[r * ld + c] = act_fwd(act, w0, z);
      } else if (!last && c < ld) {
        hout[r * ld + c] = 0.f;
      }
    });
    float* t = hin; hin = hout; hout = t;
  }
  __syncthreads();

  // dz of the last layer: g * act'(z)
  {
    const Layer& L = net.layer[nl - 1];
    float* dz = hin;
    for (int e = threadIdx.x; e < kTileRows * ld; e += kThreads) {
      const int r = e / ld, c = e % ld;
      const int64_t row = row0 + r;
      float v = 0.f;
      if (c < L.n) {
        const float gv = row < batch ? g[row * L.n + c] : 0.f;
        v = gv * act_grad(L.act, L.w0, zs[row * ztot + L.zoff + c]);
        dzs[row * ztot + L.zoff + c] = v;
      }
      dz[e] = v;
    }
  }

  // dz_{l-1} = (dz_l W_l^T) * act'(z_{l-1}); dx = dz_0 W_0^T
  for (int l = nl - 1; l >= 0; --l) {
    const Layer& L = net.layer[l];
    if (l == 0) {
      if (dx == nullptr) break;
      const int k0 = L.k;
      tile_gemm(hin, ld, L.w, 1, L.n, L.n, L.k, bs, [&](int r, int c, float acc) {
        if (c < k0 && row0 + r < batch) dx[(row0 + r) * k0 + c] = acc;
      });
      break;
    }
    const Layer& P = net.layer[l - 1];
    const int kp = L.k, pact = P.act, pzoff = P.zoff;
    const float pw0 = P.w0;
    tile_gemm(hin, ld, L.w, 1, L.n, L.n, L.k, bs, [&](int r, int c, float acc) {
      if (c < kp) {
        const int64_t at = (row0 + r) * ztot + pzoff + c;
        const float v = acc * act_grad(pact, pw0, zs[at]);
        dzs[at] = v;
        hout[r * ld + c] = v;
      } else if (c < ld) {
        hout[r * ld + c] = 0.f;
      }
    });
    float* t = hin; hin = hout; hout = t;
  }
}

// Pass 2 of the backward: blockIdx.x is one 32 x 128 tile of one layer's dW,
// blockIdx.y one slice of rows_per_slice rows; the partial sums go into dW
// (and, for the tiles of the first row of k, into db) by fp32 atomicAdd.
__global__ void __launch_bounds__(kThreads)
fused_mlp_weight_grad_kernel(const float* __restrict__ x, const float* __restrict__ zs,
                             const float* __restrict__ dzs, int64_t batch, int64_t rows_per_slice,
                             const __grid_constant__ Net net) {
  __shared__ __align__(16) float as[kChunkK * kGradALd];  // as[k][row]
  __shared__ __align__(16) float bs[kChunkK * kChunkLd];  // bs[row][n]
  int l = 0;
  while (l + 1 < net.n_layers && (int)blockIdx.x >= net.layer[l + 1].tile_start) ++l;
  const Layer& L = net.layer[l];
  const int K = L.k, N = L.n, ztot = net.ztot;
  const int n_ntiles = (N + kChunkN - 1) / kChunkN;
  const int local = blockIdx.x - L.tile_start;
  const int kt = local / n_ntiles, nt = local % n_ntiles;
  const int k0 = kt * kChunkK, n0 = nt * kChunkN;
  const int64_t begin = (int64_t)blockIdx.y * rows_per_slice;
  const int64_t end = begin + rows_per_slice < batch ? begin + rows_per_slice : batch;
  const int tx = threadIdx.x % 32, ty = threadIdx.x / 32;
  const bool with_db = kt == 0 && ty == 0;
  const Layer* P = l > 0 ? &net.layer[l - 1] : nullptr;

  float acc[4][4] = {};
  float dbacc[4] = {};
  for (int64_t b0 = begin; b0 < end; b0 += kChunkK) {
    __syncthreads();
    for (int e = threadIdx.x; e < kChunkK * kChunkK; e += kThreads) {
      const int r = e / kChunkK, k = e % kChunkK;
      const int64_t row = b0 + r;
      float v = 0.f;
      if (row < end && k0 + k < K) {
        v = P == nullptr ? x[row * K + k0 + k]
                         : act_fwd(P->act, P->w0, zs[row * ztot + P->zoff + k0 + k]);
      }
      as[k * kGradALd + r] = v;
    }
    for (int e = threadIdx.x; e < kChunkK * kChunkN; e += kThreads) {
      const int r = e / kChunkN, n = e % kChunkN;
      const int64_t row = b0 + r;
      bs[r * kChunkLd + n] = (row < end && n0 + n < N) ? dzs[row * ztot + L.zoff + n0 + n] : 0.f;
    }
    __syncthreads();
    mac_chunk(as, kGradALd, bs, acc, ty, tx);
    if (with_db) {
#pragma unroll 8
      for (int r = 0; r < kChunkK; ++r) {
        const float4 v = *reinterpret_cast<const float4*>(bs + r * kChunkLd + tx * 4);
        dbacc[0] += v.x; dbacc[1] += v.y; dbacc[2] += v.z; dbacc[3] += v.w;
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int k = k0 + ty * 4 + i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (k < K && n < N) atomicAdd(L.dw + (int64_t)k * N + n, acc[i][j]);
    }
  }
  if (with_db) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (n < N) atomicAdd(L.db + n, dbacc[j]);
    }
  }
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
  int widest = 0, zoff = 0, tiles = 0;
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
    L.zoff = zoff;
    L.tile_start = tiles;
    zoff += L.n;
    tiles += ((L.k + kChunkK - 1) / kChunkK) * ((L.n + kChunkN - 1) / kChunkN);
  }
  net->n_layers = n_layers;
  net->ld = (widest + kChunkK - 1) / kChunkK * kChunkK;
  net->ztot = zoff;
  net->n_tiles = tiles;
  return cudaSuccess;
}

size_t tile_smem_bytes(int ld) {
  return sizeof(float) * (size_t)(2 * kTileRows * ld + kChunkK * kChunkLd);
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes > (size_t)kMaxSharedBytes) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

unsigned grid_tiles(int64_t batch) { return (unsigned)((batch + kTileRows - 1) / kTileRows); }

}  // namespace

extern "C" {

// out (batch, dims[L]) = the stack applied to x (batch, dims[0]).
// dims: host array of L+1 widths; acts, w0s: host arrays of L codes
// (0 id, 1 relu, 2 gelu, 3 sine) and sine frequencies; ws, bs: host arrays
// of L device pointers. batch == 0 launches nothing.
int fused_mlp_forward(const float* x, float* out, int64_t batch, int n_layers, const int32_t* dims,
                      const int32_t* acts, const float* w0s, const float* const* ws,
                      const float* const* bs, void* stream) {
  Net net;
  cudaError_t err = pack_net(n_layers, dims, acts, w0s, ws, bs, nullptr, nullptr, &net);
  if (err != cudaSuccess) return (int)err;
  if (batch <= 0) return (int)cudaSuccess;
  const size_t smem = tile_smem_bytes(net.ld);
  err = allow_smem(fused_mlp_forward_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  fused_mlp_forward_kernel<<<grid_tiles(batch), kThreads, smem, (cudaStream_t)stream>>>(x, out, batch,
                                                                                    net);
  return (int)cudaGetLastError();
}

// dW_l, db_l (zeroed by the caller; dws, dbs: host arrays of L device
// pointers) and, when dx is not null, dx (batch, dims[0]) for upstream g
// (batch, dims[L]). zs and dzs: scratch of (batch rounded up to 32) x
// sum(dims[1:]) floats each. rows_per_slice (a multiple of 32) sets how many
// rows one weight-gradient block sums.
int fused_mlp_backward(const float* x, const float* g, float* dx, float* zs, float* dzs,
                       int64_t batch, int64_t rows_per_slice, int n_layers, const int32_t* dims,
                       const int32_t* acts, const float* w0s, const float* const* ws,
                       const float* const* bs, float* const* dws, float* const* dbs,
                       void* stream) {
  Net net;
  if (dws == nullptr || dbs == nullptr || rows_per_slice < kChunkK || rows_per_slice % kChunkK)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = pack_net(n_layers, dims, acts, w0s, ws, bs, dws, dbs, &net);
  if (err != cudaSuccess) return (int)err;
  for (int l = 0; l < n_layers; ++l)
    if (dws[l] == nullptr || dbs[l] == nullptr) return (int)cudaErrorInvalidValue;
  if (batch <= 0) return (int)cudaSuccess;
  const size_t smem = tile_smem_bytes(net.ld);
  err = allow_smem(fused_mlp_backward_tile_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  fused_mlp_backward_tile_kernel<<<grid_tiles(batch), kThreads, smem, s>>>(x, g, zs, dzs, dx, batch, net);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const unsigned slices = (unsigned)((batch + rows_per_slice - 1) / rows_per_slice);
  fused_mlp_weight_grad_kernel<<<dim3((unsigned)net.n_tiles, slices), kThreads, 0, s>>>(
      x, zs, dzs, batch, rows_per_slice, net);
  return (int)cudaGetLastError();
}

const char* fused_mlp_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
