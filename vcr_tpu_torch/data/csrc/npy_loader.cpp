// Native batch feature loader of vcr_tpu_torch (vcr_tpu_torch/data/native.py).
//
// The training input path loads one .npy feature file per video, zero-pads or
// truncates the frame axis, and assembles a contiguous (B, num_frames, feat)
// float32 batch. This library does the whole assembly in C++: per-file .npy
// header parsing, one fread straight into the row's slot of the
// caller-provided output buffer, float64->float32 conversion when needed, and
// a std::thread fan-out across files. It is called through ctypes, which
// releases the interpreter lock for the call. Built by g++ at first use
// (vcr_tpu_torch/ops/_build.py); the C ABI is the JAX package's
// native/npy_loader.cpp's, call for call.
//
// Supported .npy payloads: v1/v2 headers, little-endian '<f4' / '<f8',
// C-contiguous, ndim >= 1 (frame axis first). BatchIterator reads the first
// file's header in Python and takes this route only for such a layout.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <cstdlib>
#include <string>
#include <thread>
#include <vector>

namespace {

struct NpyInfo {
  long long rows = 0;        // shape[0]
  long long row_elems = 1;   // product(shape[1:])
  int elem_size = 4;         // 4 = f32, 8 = f64
  long long data_offset = 0; // byte offset of payload
};

// Parse a .npy header. Returns 0 on success, negative error code otherwise.
int parse_header(FILE* f, NpyInfo* info) {
  unsigned char magic[8];
  if (fread(magic, 1, 8, f) != 8) return -1;
  if (memcmp(magic, "\x93NUMPY", 6) != 0) return -2;
  int major = magic[6];
  uint32_t header_len = 0;
  if (major == 1) {
    unsigned char b[2];
    if (fread(b, 1, 2, f) != 2) return -3;
    header_len = b[0] | (b[1] << 8);
    info->data_offset = 10 + header_len;
  } else {
    unsigned char b[4];
    if (fread(b, 1, 4, f) != 4) return -3;
    header_len = b[0] | (b[1] << 8) | (b[2] << 16) | ((uint32_t)b[3] << 24);
    info->data_offset = 12 + header_len;
  }
  std::string header(header_len, '\0');
  if (fread(&header[0], 1, header_len, f) != header_len) return -4;

  // descr
  size_t dpos = header.find("'descr'");
  if (dpos == std::string::npos) return -5;
  if (header.find("'<f4'", dpos) != std::string::npos)
    info->elem_size = 4;
  else if (header.find("'<f8'", dpos) != std::string::npos)
    info->elem_size = 8;
  else
    return -6;

  // fortran_order must be False
  size_t fpos = header.find("'fortran_order'");
  if (fpos == std::string::npos) return -7;
  size_t fval = header.find_first_not_of(": ", fpos + 15);
  if (header.compare(fval, 5, "False") != 0) return -8;

  // shape tuple
  size_t spos = header.find("'shape'");
  if (spos == std::string::npos) return -9;
  size_t open = header.find('(', spos);
  size_t close = header.find(')', open);
  if (open == std::string::npos || close == std::string::npos) return -10;
  std::string shape_str = header.substr(open + 1, close - open - 1);
  std::vector<long long> dims;
  const char* p = shape_str.c_str();
  while (*p) {
    while (*p == ' ' || *p == ',') p++;
    if (!*p) break;
    dims.push_back(strtoll(p, const_cast<char**>(&p), 10));
  }
  if (dims.empty()) return -11;
  info->rows = dims[0];
  info->row_elems = 1;
  for (size_t i = 1; i < dims.size(); ++i) info->row_elems *= dims[i];
  return 0;
}

// Load one file into out (capacity max_rows * row_elems floats, pre-zeroed by
// the caller). Pads with zeros (left pre-zeroed) / truncates on the row axis.
int load_one(const char* path, float* out, long long max_rows,
             long long row_elems) {
  FILE* f = fopen(path, "rb");
  if (!f) return -100;
  NpyInfo info;
  int rc = parse_header(f, &info);
  if (rc != 0) {
    fclose(f);
    return rc;
  }
  if (info.row_elems != row_elems) {
    fclose(f);
    return -101;  // feature shape mismatch
  }
  long long rows = info.rows < max_rows ? info.rows : max_rows;
  long long n = rows * row_elems;
  if (fseek(f, (long)info.data_offset, SEEK_SET) != 0) {
    fclose(f);
    return -102;
  }
  if (info.elem_size == 4) {
    if ((long long)fread(out, 4, n, f) != n) {
      fclose(f);
      return -103;
    }
  } else {
    std::vector<double> tmp(n);
    if ((long long)fread(tmp.data(), 8, n, f) != n) {
      fclose(f);
      return -103;
    }
    for (long long i = 0; i < n; ++i) out[i] = (float)tmp[i];
  }
  fclose(f);
  return 0;
}

}  // namespace

extern "C" {

// Load a batch: paths[i] -> out[i * max_rows * row_elems]. out must be
// pre-zeroed (padding). Returns 0, or the first nonzero per-file error code.
int vcr_load_feature_batch(const char** paths, int n_paths, float* out,
                           long long max_rows, long long row_elems,
                           int n_threads) {
  if (n_threads < 1) n_threads = 1;
  std::vector<int> rcs(n_paths, 0);
  std::vector<std::thread> workers;
  int per = (n_paths + n_threads - 1) / n_threads;
  for (int t = 0; t < n_threads; ++t) {
    int lo = t * per;
    int hi = lo + per < n_paths ? lo + per : n_paths;
    if (lo >= hi) break;
    workers.emplace_back([=, &rcs]() {
      for (int i = lo; i < hi; ++i) {
        rcs[i] = load_one(paths[i], out + (long long)i * max_rows * row_elems,
                          max_rows, row_elems);
      }
    });
  }
  for (auto& w : workers) w.join();
  for (int i = 0; i < n_paths; ++i)
    if (rcs[i] != 0) return rcs[i];
  return 0;
}

// Probe a single file's shape: fills rows/row_elems. Returns 0 on success.
int vcr_probe_npy(const char* path, long long* rows, long long* row_elems) {
  FILE* f = fopen(path, "rb");
  if (!f) return -100;
  NpyInfo info;
  int rc = parse_header(f, &info);
  fclose(f);
  if (rc != 0) return rc;
  *rows = info.rows;
  *row_elems = info.row_elems;
  return 0;
}

}  // extern "C"
