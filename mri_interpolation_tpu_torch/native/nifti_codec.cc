// Native IO runtime of the PyTorch port: NIfTI-1 decode + voxel-dataset
// construction (the port's own copy of the JAX package's codec, with the
// same C ABI and arithmetic, so that both load a file to the same bits; its
// probe reads the header alone, where the JAX one gunzips the whole file).
//
// The host-side runtime around the device path (volume decode,
// normalization, coordinate-grid synthesis) in C++, bound with ctypes
// (mri_interpolation_tpu_torch/native/__init__.py); the numpy modules of
// io/ read the layouts it does not decode.
//
// Exports (C ABI):
//   mit_nifti_probe(path, shape[8], &ndim, pixdim[8]) -> n_voxels, -1 (unreadable
//                                                        or malformed) or -2 (a
//                                                        datatype it does not decode)
//   mit_nifti_decode(path, out[n_voxels]) -> 0/err      (scl_slope applied,
//                                                        Fortran->C reorder)
//   mit_nifti_encode(path, data, shape, ndim, pixdim)   (float32 gzip write,
//                                                        C->Fortran reorder)
//   mit_minmax_normalize(data, n, zero_centered)
//   mit_make_coords(shape, ndim, lo, hi, out[n*ndim])   (C-order flat mgrid)
//
// Build (native/build.py): g++ -O3 -march=native -shared -fPIC nifti_codec.cc -o libmit_native.so -l:libz.so.1
// Where zlib's header is missing, the few zlib functions used are declared
// here; the runtime library libz.so.1 is linked either way.

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <cstdlib>
#include <vector>

#if __has_include(<zlib.h>)
#include <zlib.h>
#else
extern "C" {
typedef struct gzFile_s* gzFile;
gzFile gzopen(const char* path, const char* mode);
int gzread(gzFile file, void* buf, unsigned len);
int gzwrite(gzFile file, const void* buf, unsigned len);
int gzclose(gzFile file);
}
#endif

namespace {

struct NiftiHeader {
  int64_t shape[8];
  int ndim;
  int datatype;
  float pixdim[8];
  float vox_offset;
  float scl_slope;
  float scl_inter;
};

// Read a whole file, transparently gunzipping (gzread handles plain files too).
bool read_all(const char* path, std::vector<unsigned char>& out) {
  gzFile f = gzopen(path, "rb");
  if (!f) return false;
  const size_t chunk = 1 << 20;
  size_t used = 0;
  for (;;) {
    out.resize(used + chunk);
    int got = gzread(f, out.data() + used, chunk);
    if (got < 0) { gzclose(f); return false; }
    used += static_cast<size_t>(got);
    if (static_cast<size_t>(got) < chunk) break;
  }
  out.resize(used);
  gzclose(f);
  return true;
}

// Read the first `len` bytes of a file (gunzipped as read_all does), or
// fewer where the file is shorter: what the probe needs, the header.
bool read_prefix(const char* path, size_t len, std::vector<unsigned char>& out) {
  gzFile f = gzopen(path, "rb");
  if (!f) return false;
  out.resize(len);
  int got = gzread(f, out.data(), static_cast<unsigned>(len));
  gzclose(f);
  if (got < 0) return false;
  out.resize(static_cast<size_t>(got));
  return true;
}

bool parse_header(const unsigned char* buf, size_t len, NiftiHeader* h) {
  if (len < 348) return false;
  int32_t sizeof_hdr;
  std::memcpy(&sizeof_hdr, buf, 4);
  if (sizeof_hdr != 348) return false;  // little-endian NIfTI-1 only
  int16_t dim[8];
  std::memcpy(dim, buf + 40, 16);
  h->ndim = dim[0];
  if (h->ndim < 1 || h->ndim > 7) return false;
  for (int i = 0; i < 8; ++i) h->shape[i] = (i < h->ndim) ? dim[i + 1] : 1;
  int16_t datatype;
  std::memcpy(&datatype, buf + 70, 2);
  h->datatype = datatype;
  float pixdim[8];
  std::memcpy(pixdim, buf + 76, 32);
  for (int i = 0; i < 8; ++i) h->pixdim[i] = pixdim[i];
  std::memcpy(&h->vox_offset, buf + 108, 4);
  std::memcpy(&h->scl_slope, buf + 112, 4);
  std::memcpy(&h->scl_inter, buf + 116, 4);
  return true;
}

template <typename T>
void convert_fortran_to_c(const T* src, float* dst, const int64_t* shape, int ndim,
                          float slope, float inter) {
  // NIfTI data is Fortran-ordered (axis 0 fastest); emit C order (last axis
  // fastest). Walk the C-order output; compute the Fortran source index
  // incrementally.
  int64_t n = 1;
  for (int i = 0; i < ndim; ++i) n *= shape[i];
  std::vector<int64_t> fstride(ndim);  // Fortran strides
  int64_t s = 1;
  for (int i = 0; i < ndim; ++i) { fstride[i] = s; s *= shape[i]; }
  std::vector<int64_t> idx(ndim, 0);
  int64_t fidx = 0;
  const bool scale = !(slope == 0.0f || (slope == 1.0f && inter == 0.0f));
  for (int64_t c = 0; c < n; ++c) {
    float v = static_cast<float>(src[fidx]);
    dst[c] = scale ? v * slope + inter : v;
    // increment mixed-radix counter over C order (last axis fastest)
    for (int a = ndim - 1; a >= 0; --a) {
      idx[a]++;
      fidx += fstride[a];
      if (idx[a] < shape[a]) break;
      fidx -= shape[a] * fstride[a];
      idx[a] = 0;
    }
  }
}

}  // namespace

extern "C" {

// Voxel count from header dims, guarding each dim and the running product
// against hostile/malformed headers (an int64 overflow could wrap to a small
// positive n and defeat downstream size checks). Returns -1 on failure.
static int64_t checked_voxel_count(const NiftiHeader& h) {
  int64_t n = 1;
  for (int i = 0; i < h.ndim; ++i) {
    if (h.shape[i] <= 0) return -1;
    if (__builtin_mul_overflow(n, h.shape[i], &n)) return -1;
  }
  // 2^40 voxels (1 TiB as uint8) is far beyond any real NIfTI and keeps the
  // byte-size products (n * 8) safely inside size_t.
  if (n > (int64_t(1) << 40)) return -1;
  return n;
}

// Returns total voxel count, -1 on failure, or -2 for a datatype that
// mit_nifti_decode does not decode.
int64_t mit_nifti_probe(const char* path, int64_t* shape, int* ndim, float* pixdim) {
  std::vector<unsigned char> buf;
  if (!read_prefix(path, 352, buf)) return -1;
  NiftiHeader h;
  if (!parse_header(buf.data(), buf.size(), &h)) return -1;
  int64_t n = checked_voxel_count(h);
  if (n < 0) return -1;
  switch (h.datatype) {
    case 2: case 4: case 8: case 16: case 64: break;
    default: return -2;
  }
  *ndim = h.ndim;
  for (int i = 0; i < h.ndim; ++i) shape[i] = h.shape[i];
  for (int i = 0; i < h.ndim; ++i) pixdim[i] = h.pixdim[i + 1];
  return n;
}

// Decode into caller-allocated float32 buffer (C order, scaling applied).
int mit_nifti_decode(const char* path, float* out) {
  std::vector<unsigned char> buf;
  if (!read_all(path, buf)) return 1;
  NiftiHeader h;
  if (!parse_header(buf.data(), buf.size(), &h)) return 2;
  size_t off = static_cast<size_t>(h.vox_offset);
  if (off < 352) off = 352;
  if (off > buf.size()) return 3;
  const unsigned char* data = buf.data() + off;
  int64_t n = checked_voxel_count(h);
  if (n < 0) return 6;
  const size_t avail = buf.size() - off;
  switch (h.datatype) {
    case 2:  // uint8
      if (avail < static_cast<size_t>(n)) return 4;
      convert_fortran_to_c(reinterpret_cast<const uint8_t*>(data), out, h.shape, h.ndim, h.scl_slope, h.scl_inter);
      break;
    case 4:  // int16
      if (avail < static_cast<size_t>(n) * 2) return 4;
      convert_fortran_to_c(reinterpret_cast<const int16_t*>(data), out, h.shape, h.ndim, h.scl_slope, h.scl_inter);
      break;
    case 8:  // int32
      if (avail < static_cast<size_t>(n) * 4) return 4;
      convert_fortran_to_c(reinterpret_cast<const int32_t*>(data), out, h.shape, h.ndim, h.scl_slope, h.scl_inter);
      break;
    case 16:  // float32
      if (avail < static_cast<size_t>(n) * 4) return 4;
      convert_fortran_to_c(reinterpret_cast<const float*>(data), out, h.shape, h.ndim, h.scl_slope, h.scl_inter);
      break;
    case 64:  // float64
      if (avail < static_cast<size_t>(n) * 8) return 4;
      convert_fortran_to_c(reinterpret_cast<const double*>(data), out, h.shape, h.ndim, h.scl_slope, h.scl_inter);
      break;
    default:
      return 5;
  }
  return 0;
}

// Encode a C-ordered float32 array as gzipped NIfTI-1 (datatype 16,
// vox_offset 352, identity orientation). Returns 0 on success.
int mit_nifti_encode(const char* path, const float* data, const int64_t* shape,
                     int ndim, const float* pixdim) {
  if (ndim < 1 || ndim > 7) return 1;
  NiftiHeader h;
  h.ndim = ndim;
  for (int i = 0; i < 8; ++i) h.shape[i] = (i < ndim) ? shape[i] : 1;
  int64_t n = checked_voxel_count(h);
  if (n < 0) return 1;

  unsigned char hdr[352];
  std::memset(hdr, 0, sizeof(hdr));
  int32_t sizeof_hdr = 348;
  std::memcpy(hdr, &sizeof_hdr, 4);
  int16_t dim[8] = {static_cast<int16_t>(ndim), 1, 1, 1, 1, 1, 1, 1};
  for (int i = 0; i < ndim; ++i) dim[i + 1] = static_cast<int16_t>(shape[i]);
  std::memcpy(hdr + 40, dim, 16);
  int16_t datatype = 16, bitpix = 32;  // float32
  std::memcpy(hdr + 70, &datatype, 2);
  std::memcpy(hdr + 72, &bitpix, 2);
  float pd[8] = {1, 1, 1, 1, 1, 1, 1, 1};
  if (pixdim) for (int i = 0; i < ndim && i < 7; ++i) pd[i + 1] = pixdim[i];
  std::memcpy(hdr + 76, pd, 32);
  float vox_offset = 352.0f;
  std::memcpy(hdr + 108, &vox_offset, 4);
  float slope = 1.0f, inter = 0.0f;
  std::memcpy(hdr + 112, &slope, 4);
  std::memcpy(hdr + 116, &inter, 4);
  // identity sform (sform_code=1 at offset 254; srow diagonals = pixdim)
  int16_t sform_code = 1;
  std::memcpy(hdr + 254, &sform_code, 2);
  float srow[12] = {pd[1], 0, 0, 0, 0, pd[2], 0, 0, 0, 0, pd[3], 0};
  std::memcpy(hdr + 280, srow, 48);
  std::memcpy(hdr + 344, "n+1\0", 4);

  // C order -> Fortran order
  std::vector<float> fdata(static_cast<size_t>(n));
  std::vector<int64_t> fstride(ndim);
  int64_t s = 1;
  for (int i = 0; i < ndim; ++i) { fstride[i] = s; s *= shape[i]; }
  std::vector<int64_t> idx(ndim, 0);
  int64_t fidx = 0;
  for (int64_t c = 0; c < n; ++c) {
    fdata[fidx] = data[c];
    for (int a = ndim - 1; a >= 0; --a) {
      idx[a]++;
      fidx += fstride[a];
      if (idx[a] < shape[a]) break;
      fidx -= shape[a] * fstride[a];
      idx[a] = 0;
    }
  }

  gzFile f = gzopen(path, "wb");
  if (!f) return 2;
  bool ok = gzwrite(f, hdr, 352) == 352;
  const size_t total_bytes = static_cast<size_t>(n) * 4;
  const unsigned char* p = reinterpret_cast<const unsigned char*>(fdata.data());
  size_t written = 0;
  while (ok && written < total_bytes) {
    unsigned chunk = static_cast<unsigned>(
        std::min<size_t>(total_bytes - written, 1u << 28));
    ok = gzwrite(f, p + written, chunk) == static_cast<int>(chunk);
    written += chunk;
  }
  gzclose(f);
  return ok ? 0 : 3;
}

void mit_minmax_normalize(float* data, int64_t n, int zero_centered) {
  if (n <= 0) return;
  float lo = data[0], hi = data[0];
  for (int64_t i = 1; i < n; ++i) {
    if (data[i] < lo) lo = data[i];
    if (data[i] > hi) hi = data[i];
  }
  const float range = hi - lo;
  const float inv = range > 0 ? 1.0f / range : 0.0f;
  if (zero_centered) {
    for (int64_t i = 0; i < n; ++i) data[i] = ((data[i] - lo) * inv) * 2.0f - 1.0f;
  } else {
    for (int64_t i = 0; i < n; ++i) data[i] = (data[i] - lo) * inv;
  }
}

// C-order flat coordinate grid: row k = normalized mixed-radix digits of k.
void mit_make_coords(const int64_t* shape, int ndim, float lo, float hi, float* out) {
  int64_t n = 1;
  for (int i = 0; i < ndim; ++i) n *= shape[i];
  std::vector<float> step(ndim);
  for (int i = 0; i < ndim; ++i)
    step[i] = shape[i] > 1 ? (hi - lo) / static_cast<float>(shape[i] - 1) : 0.0f;
  std::vector<int64_t> idx(ndim, 0);
  std::vector<float> cur(ndim, lo);
  for (int64_t k = 0; k < n; ++k) {
    float* row = out + k * ndim;
    for (int i = 0; i < ndim; ++i) row[i] = cur[i];
    for (int a = ndim - 1; a >= 0; --a) {
      idx[a]++;
      if (idx[a] < shape[a]) { cur[a] = lo + step[a] * idx[a]; break; }
      idx[a] = 0;
      cur[a] = lo;
    }
  }
}

}  // extern "C"
