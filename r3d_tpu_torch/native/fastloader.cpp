// fastloader: host-side feature loading for the PyTorch port.
//
// One pass from a .npy file's bytes to the observed, strided, zero-padded
// window an example needs, with no intermediate whole-video array; a batch
// of such windows with one thread per item, so that file reads overlap.
// The same algorithm and C interface as the JAX package's
// native/fastloader.cpp, kept as the port's own copy.
//
// Exposed through a plain C ABI loaded with ctypes
// (r3d_tpu_torch/data/native.py), which builds this file with the host's
// C++ compiler at first use.
//
// Supported inputs: .npy v1/v2, C-order, dtype <f4 or <f8 (converted to
// float32 here), 2-D [S, C] (or [C, S] with transpose=1, the
// breakfast/50salads layout) and n-D [S, ...] frame-major stacks (depth
// streams).

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

namespace {

struct NpyInfo {
  std::vector<int64_t> shape;
  int64_t word_size = 0;     // 4 or 8
  bool fortran = false;
  int64_t data_offset = 0;
};

// Minimal .npy header parser (format spec v1.0/2.0).
bool parse_npy_header(FILE* f, NpyInfo* info) {
  unsigned char magic[8];
  if (fread(magic, 1, 8, f) != 8) return false;
  if (memcmp(magic, "\x93NUMPY", 6) != 0) return false;
  int major = magic[6];
  uint32_t header_len = 0;
  if (major == 1) {
    unsigned char b[2];
    if (fread(b, 1, 2, f) != 2) return false;
    header_len = b[0] | (b[1] << 8);
    info->data_offset = 10 + header_len;
  } else {
    unsigned char b[4];
    if (fread(b, 1, 4, f) != 4) return false;
    header_len = b[0] | (b[1] << 8) | (b[2] << 16) | (b[3] << 24);
    info->data_offset = 12 + header_len;
  }
  std::string header(header_len, '\0');
  if (fread(&header[0], 1, header_len, f) != header_len) return false;

  size_t p = header.find("descr");
  if (p == std::string::npos) return false;
  p = header.find(':', p);
  p = header.find('\'', p);               // opening quote of the dtype string
  size_t q = header.find('\'', p + 1);
  std::string descr = header.substr(p + 1, q - p - 1);
  if (descr == "<f4" || descr == "|f4" || descr == "=f4") info->word_size = 4;
  else if (descr == "<f8" || descr == "=f8") info->word_size = 8;
  else return false;  // only float features supported

  p = header.find("fortran_order");
  if (p == std::string::npos) return false;
  info->fortran = header.compare(header.find(':', p) + 2, 4, "True") == 0;

  p = header.find("shape");
  p = header.find('(', p);
  q = header.find(')', p);
  std::string dims = header.substr(p + 1, q - p - 1);
  info->shape.clear();
  const char* s = dims.c_str();
  while (*s) {
    while (*s == ' ' || *s == ',') s++;
    if (!*s) break;
    info->shape.push_back(strtoll(s, const_cast<char**>(&s), 10));
  }
  return !info->shape.empty();
}

// Copy rows [0, observed) with stride into out[0..out_rows), zero untouched
// rows. Returns rows written, or -1 on error.
int64_t load_rows(const char* path, int64_t observed_len, int64_t stride,
                  float* out, int64_t out_rows, int64_t row_elems,
                  int transpose) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  NpyInfo info;
  if (!parse_npy_header(f, &info)) { fclose(f); return -1; }
  if (info.fortran) { fclose(f); return -1; }

  int64_t S, C;
  if (transpose) {
    if (info.shape.size() != 2) { fclose(f); return -1; }
    C = info.shape[0];
    S = info.shape[1];
  } else {
    S = info.shape[0];
    C = 1;
    for (size_t i = 1; i < info.shape.size(); i++) C *= info.shape[i];
  }
  if (C != row_elems) { fclose(f); return -1; }

  int64_t obs = observed_len < S ? observed_len : S;
  if (obs < 0) obs = S;
  int64_t n_rows = (obs + stride - 1) / stride;
  if (n_rows > out_rows) n_rows = out_rows;

  if (!transpose) {
    std::vector<char> rowbuf(C * info.word_size);
    for (int64_t r = 0; r < n_rows; r++) {
      int64_t src_row = r * stride;
      if (fseek(f, info.data_offset + src_row * C * info.word_size, SEEK_SET)) {
        fclose(f);
        return -1;
      }
      if (fread(rowbuf.data(), info.word_size, C, f) != (size_t)C) {
        fclose(f);
        return -1;
      }
      float* dst = out + r * row_elems;
      if (info.word_size == 4) {
        memcpy(dst, rowbuf.data(), C * 4);
      } else {
        const double* src = reinterpret_cast<const double*>(rowbuf.data());
        for (int64_t c = 0; c < C; c++) dst[c] = (float)src[c];
      }
    }
    fclose(f);
    return n_rows;
  }

  // transposed layout [C, S]: read the whole block once, scatter columns
  std::vector<char> buf(C * S * info.word_size);
  if (fseek(f, info.data_offset, SEEK_SET) ||
      fread(buf.data(), info.word_size, C * S, f) != (size_t)(C * S)) {
    fclose(f);
    return -1;
  }
  fclose(f);
  for (int64_t r = 0; r < n_rows; r++) {
    int64_t src_col = r * stride;
    float* dst = out + r * row_elems;
    if (info.word_size == 4) {
      const float* src = reinterpret_cast<const float*>(buf.data());
      for (int64_t c = 0; c < C; c++) dst[c] = src[c * S + src_col];
    } else {
      const double* src = reinterpret_cast<const double*>(buf.data());
      for (int64_t c = 0; c < C; c++) dst[c] = (float)src[c * S + src_col];
    }
  }
  return n_rows;
}

}  // namespace

extern "C" {

// Probe a .npy file: writes up to max_dims dims into shape_out, returns ndim
// (or -1). word_size_out gets 4/8.
int64_t npy_probe(const char* path, int64_t* shape_out, int64_t max_dims,
                  int64_t* word_size_out) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  NpyInfo info;
  bool ok = parse_npy_header(f, &info);
  fclose(f);
  if (!ok) return -1;
  int64_t nd = (int64_t)info.shape.size();
  for (int64_t i = 0; i < nd && i < max_dims; i++) shape_out[i] = info.shape[i];
  *word_size_out = info.word_size;
  return nd;
}

// Single-video sliced/strided load into a caller buffer (pre-zeroed or not;
// rows beyond the return value are zero-filled here).
int64_t load_sliced(const char* path, int64_t observed_len, int64_t stride,
                    float* out, int64_t out_rows, int64_t row_elems,
                    int transpose) {
  int64_t n = load_rows(path, observed_len, stride, out, out_rows, row_elems,
                        transpose);
  if (n >= 0 && n < out_rows) {
    memset(out + n * row_elems, 0, (out_rows - n) * row_elems * sizeof(float));
  }
  return n;
}

// Batched assembly: B videos into one [B, out_rows, row_elems] buffer with
// one thread per item (IO overlap). observed_lens/strides are per item.
// Returns 0 on success, else a bitmask of failed items (capped at 63).
int64_t load_batch(const char** paths, const int64_t* observed_lens,
                   int64_t stride, int64_t batch, float* out,
                   int64_t out_rows, int64_t row_elems, int transpose,
                   int64_t* rows_out) {
  std::vector<std::thread> threads;
  std::vector<int64_t> results(batch, 0);
  int64_t n_threads = batch < 8 ? batch : 8;
  for (int64_t t = 0; t < n_threads; t++) {
    threads.emplace_back([&, t]() {
      for (int64_t i = t; i < batch; i += n_threads) {
        results[i] = load_sliced(paths[i], observed_lens[i], stride,
                                 out + i * out_rows * row_elems, out_rows,
                                 row_elems, transpose);
      }
    });
  }
  for (auto& th : threads) th.join();
  int64_t failed = 0;
  for (int64_t i = 0; i < batch; i++) {
    if (rows_out) rows_out[i] = results[i];
    if (results[i] < 0 && i < 63) failed |= (1ll << i);
  }
  return failed;
}

}  // extern "C"
