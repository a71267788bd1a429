// One SIREN sine layer's elementwise chain on Hopper: the bias add, the w0
// scale and the sine in one pass forward, their gradient and the bias
// gradient's sum in one pass backward. The layer's product (z = x @ W)
// stays with cuBLAS, outside these kernels.
//
// Replaces no TPU kernel: the JAX package leaves this chain to XLA, which
// fuses it around its own products. On the card, autograd ran it as six
// elementwise kernels forward and backward (the bias add, the w0 scale, sin;
// cos, g * cos, * w0, the bias gradient's reduction), 14 passes over the
// (n, width) activations a layer; these kernels make it 5.
//
// Semantics (shared with the plain PyTorch version in ops/sine_layer.py), in
// autograd's order of operations, each rounded alone (__fadd_rn / __fmul_rn:
// no contraction into an FMA):
//   forward:  a  = sinf(w0 * (z + b))
//   backward: u  = w0 * (z + b)          (recomputed: nothing saved but z)
//             dz = (g * cosf(u)) * w0
//             db = sum over rows of dz
// so a and dz equal the plain path's bit for bit, and only the order of
// db's sum differs. sinf and cosf are the accurate library functions (no
// __sinf, no --use_fast_math): a first layer's argument reaches ~40 rad.
//
// What bounds them: bytes. At 512,000 x 256 fp32 a pass is 524 MB, 0.157 ms
// at 3.35 TB/s; the forward reads z and writes a (2 passes, 0.313 ms), the
// backward reads g and z and writes dz (3 passes, 0.469 ms); the arithmetic
// (a sine or cosine and three operations an element) is a few percent of
// that at 67 TFLOP/s. The design serves the bytes:
//   - 16-byte loads and stores: a thread owns one float4 column group (4
//     columns) of a column tile of up to 1024 columns (blockIdx.y), and its
//     4 biases sit in registers while it strides over rows;
//   - a block of 256 threads sweeps 256 / (tile / 4) whole rows at a time
//     (4 rows of 1 KB at width 256), so a warp's accesses are contiguous;
//   - each thread keeps 4 rows in flight (loads first, then math and
//     stores), and the grid is as many blocks as the card holds at once
//     (the occupancy the runtime reports x the SMs, fewer where the rows
//     run out), each striding over the rows with a masked ragged tail;
//   - the backward keeps its column group's running sums of dz in
//     registers, reduces them across the block's row lanes in shared memory
//     in a fixed order, and writes one partial row per block;
//     sine_layer_bias_grad_kernel sums the partial rows in a fixed order
//     into db. No atomics: two runs give the same db bit for bit.
//
// Interface: plain C, raw device pointers, the caller's stream; allocates
// nothing; returns cudaGetLastError() (or cudaErrorInvalidValue on sizes it
// does not take) so the Python wrapper raises on a refused launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // a block; also the widest column tile, in float4 groups (1024 columns)
constexpr int kUnroll = 4;     // rows a thread keeps in flight
constexpr int kGradCols = 32;  // the bias-gradient kernel's block: 32 columns x 8 slices of the partial rows
constexpr int kGradSlices = 8;

// A thread's place: its float4 column group, its row lane within a sweep,
// and the rows a sweep of the block covers. Threads past rows * tile (where
// the tile does not divide 256) hold nothing.
struct Lanes {
  int col4;
  int lane;
  int rows;
  int tile;
};

__device__ __forceinline__ Lanes lanes_of(int width4) {
  Lanes l;
  const int tile0 = blockIdx.y * kThreads;
  l.tile = min(kThreads, width4 - tile0);
  l.rows = kThreads / l.tile;
  l.lane = threadIdx.x / l.tile;
  l.col4 = tile0 + threadIdx.x % l.tile;
  return l;
}

__device__ __forceinline__ float4 bias_of(const float* __restrict__ b, int col4) {
  // four scalar loads once a thread: the bias need not be 16-byte aligned
  return make_float4(b[4 * col4], b[4 * col4 + 1], b[4 * col4 + 2], b[4 * col4 + 3]);
}

__device__ __forceinline__ float arg(float z, float b, float w0) { return __fmul_rn(w0, __fadd_rn(z, b)); }

__device__ __forceinline__ float grad(float g, float z, float b, float w0) {
  return __fmul_rn(__fmul_rn(g, cosf(arg(z, b, w0))), w0);
}

__global__ void __launch_bounds__(kThreads)
sine_layer_forward_kernel(const float4* __restrict__ z, const float* __restrict__ b, float4* __restrict__ a,
                          int64_t n, int width4, float w0) {
  const Lanes l = lanes_of(width4);
  if (l.lane >= l.rows) return;
  const float4 bias = bias_of(b, l.col4);
  const int64_t step = (int64_t)gridDim.x * l.rows;
  for (int64_t r = (int64_t)blockIdx.x * l.rows + l.lane; r < n; r += kUnroll * step) {
    float4 v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t ru = r + u * step;
      if (ru < n) v[u] = z[ru * width4 + l.col4];
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t ru = r + u * step;
      if (ru < n) {
        a[ru * width4 + l.col4] = make_float4(sinf(arg(v[u].x, bias.x, w0)), sinf(arg(v[u].y, bias.y, w0)),
                                              sinf(arg(v[u].z, bias.z, w0)), sinf(arg(v[u].w, bias.w, w0)));
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads)
sine_layer_backward_kernel(const float4* __restrict__ g, const float4* __restrict__ z, const float* __restrict__ b,
                           float4* __restrict__ dz, float4* __restrict__ partial, int64_t n, int width4, float w0) {
  __shared__ float4 sums[kThreads];
  const Lanes l = lanes_of(width4);
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  if (l.lane < l.rows) {
    const float4 bias = bias_of(b, l.col4);
    const int64_t step = (int64_t)gridDim.x * l.rows;
    for (int64_t r = (int64_t)blockIdx.x * l.rows + l.lane; r < n; r += kUnroll * step) {
      float4 gv[kUnroll], zv[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int64_t ru = r + u * step;
        if (ru < n) {
          gv[u] = g[ru * width4 + l.col4];
          zv[u] = z[ru * width4 + l.col4];
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int64_t ru = r + u * step;
        if (ru < n) {
          const float4 d = make_float4(grad(gv[u].x, zv[u].x, bias.x, w0), grad(gv[u].y, zv[u].y, bias.y, w0),
                                       grad(gv[u].z, zv[u].z, bias.z, w0), grad(gv[u].w, zv[u].w, bias.w, w0));
          dz[ru * width4 + l.col4] = d;
          acc = make_float4(__fadd_rn(acc.x, d.x), __fadd_rn(acc.y, d.y), __fadd_rn(acc.z, d.z),
                            __fadd_rn(acc.w, d.w));
        }
      }
    }
  }
  sums[threadIdx.x] = acc;
  __syncthreads();
  if (threadIdx.x < l.tile) {  // row lane 0 of each column group: its lanes' sums in lane order
    float4 s = sums[threadIdx.x];
    for (int k = 1; k < l.rows; ++k) {
      const float4 t = sums[k * l.tile + threadIdx.x];
      s = make_float4(__fadd_rn(s.x, t.x), __fadd_rn(s.y, t.y), __fadd_rn(s.z, t.z), __fadd_rn(s.w, t.w));
    }
    partial[(int64_t)blockIdx.x * width4 + l.col4] = s;
  }
}

// db[c] = the sum of partial[p][c] over the blocks p: each of 8 slices sums
// the rows p = s, s + 8, ... in order, then slice 0 adds the slices in order.
__global__ void __launch_bounds__(kGradCols * kGradSlices)
sine_layer_bias_grad_kernel(const float* __restrict__ partial, float* __restrict__ db, int blocks, int width) {
  __shared__ float sums[kGradSlices][kGradCols];
  const int c = threadIdx.x % kGradCols, s = threadIdx.x / kGradCols;
  const int col = blockIdx.x * kGradCols + c;
  float acc = 0.f;
  if (col < width) {
    for (int p = s; p < blocks; p += kGradSlices) acc = __fadd_rn(acc, partial[(int64_t)p * width + col]);
  }
  sums[s][c] = acc;
  __syncthreads();
  if (s == 0 && col < width) {
    float t = sums[0][c];
    for (int k = 1; k < kGradSlices; ++k) t = __fadd_rn(t, sums[k][c]);
    db[col] = t;
  }
}

// Blocks along the rows: as many as the card holds at once (the runtime's
// occupancy of `kernel` x sms, queried once), no more than the rows need (a
// whole tile's sweeps), nor than cap; at least 1.
template <typename Kernel>
cudaError_t row_blocks(Kernel kernel, int* per_sm, int64_t n, int width4, int sms, int64_t cap, unsigned* blocks) {
  if (*per_sm == 0) {
    int k = 0;
    const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&k, kernel, kThreads, 0);
    if (err != cudaSuccess) return err;
    *per_sm = k < 1 ? 1 : k;
  }
  const int64_t rows = kThreads / (width4 < kThreads ? width4 : kThreads);
  int64_t most = (int64_t)*per_sm * sms;
  const int64_t need = (n + rows - 1) / rows;
  most = most < need ? most : need;
  most = most < cap ? most : cap;
  *blocks = (unsigned)(most < 1 ? 1 : most);
  return cudaSuccess;
}

int forward_per_sm = 0;
int backward_per_sm = 0;

}  // namespace

extern "C" {

// a (n, width) = sinf(w0 * (z + b)) for z (n, width) row-major and b
// (width,) (device pointers; z and a 16-byte aligned); width a positive
// multiple of 4; sms: the card's SMs. n == 0 launches nothing.
int sine_layer_forward(const float* z, const float* b, float* a, int64_t n, int width, float w0, int sms,
                       void* stream) {
  if (n < 0 || width <= 0 || width % 4 != 0 || sms <= 0) return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  const int width4 = width / 4;
  unsigned blocks = 0;
  const cudaError_t err = row_blocks(sine_layer_forward_kernel, &forward_per_sm, n, width4, sms, INT64_MAX, &blocks);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(blocks, (width4 + kThreads - 1) / kThreads);
  sine_layer_forward_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      reinterpret_cast<const float4*>(z), b, reinterpret_cast<float4*>(a), n, width4, w0);
  return (int)cudaGetLastError();
}

// dz (n, width) = (g * cosf(w0 * (z + b))) * w0 and db (width,) = its sum
// over rows, for g, z (n, width) row-major and b (width,) (device pointers;
// g, z, dz and partial 16-byte aligned). partial: scratch of partial_rows x
// width floats, one row per block (the grid takes no more blocks than
// that). Two kernels on the stream: the elementwise pass, then the sum of
// the partial rows. n == 0 launches nothing (db is the caller's).
int sine_layer_backward(const float* g, const float* z, const float* b, float* dz, float* partial,
                        int64_t partial_rows, float* db, int64_t n, int width, float w0, int sms, void* stream) {
  if (n < 0 || width <= 0 || width % 4 != 0 || sms <= 0 || partial_rows <= 0) return (int)cudaErrorInvalidValue;
  if (n == 0) return (int)cudaSuccess;
  const int width4 = width / 4;
  unsigned blocks = 0;
  cudaError_t err = row_blocks(sine_layer_backward_kernel, &backward_per_sm, n, width4, sms, partial_rows, &blocks);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  const dim3 grid(blocks, (width4 + kThreads - 1) / kThreads);
  sine_layer_backward_kernel<<<grid, kThreads, 0, s>>>(
      reinterpret_cast<const float4*>(g), reinterpret_cast<const float4*>(z), b, reinterpret_cast<float4*>(dz),
      reinterpret_cast<float4*>(partial), n, width4, w0);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  sine_layer_bias_grad_kernel<<<(width + kGradCols - 1) / kGradCols, kGradCols * kGradSlices, 0, s>>>(
      partial, db, (int)blocks, width);
  return (int)cudaGetLastError();
}

const char* sine_layer_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
