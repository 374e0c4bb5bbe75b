// Native ark table I/O: binary Kaldi-format matrix archives.
//
// (ref: the reference's Table system util/kaldi-table.h:105-421 and binary
//  stream format base/io-funcs.h — "key ␣ \0B FM <int32 rows> <int32 cols>
//  <float data>". The reference's data-loader path is C++; this library is
//  the equivalent native runtime component: zero-copy scanning of feature
//  archives feeding the host pipeline, exposed to Python via ctypes.
//  Supports FM (float32) and DM (float64, converted to float32) matrices
//  and FV/DV vectors; the CM compressed format is decoded host-side in
//  Python where it is not on the hot path.)
//
// The port's copy of native/ark_io.cc. kaldi_tpu_torch/io/native.py builds
// it at first use: g++ -O3 -shared -fPIC -o libkaldi_tpu_torch_ark.so ark_io.cc

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

namespace {

struct ArkReader {
  FILE* f = nullptr;
  std::string err;
};

struct ArkWriter {
  FILE* f = nullptr;
  FILE* scp = nullptr;
  std::string path;
};

bool read_exact(FILE* f, void* buf, size_t n) {
  return fread(buf, 1, n, f) == n;
}

// Reads a Kaldi binary token like "FM " (token + trailing space).
bool read_token(FILE* f, std::string* tok) {
  tok->clear();
  int c;
  while ((c = fgetc(f)) != EOF && c != ' ') tok->push_back((char)c);
  return c == ' ';
}

bool read_int32(FILE* f, int32_t* v) {
  unsigned char sz;
  if (!read_exact(f, &sz, 1) || sz != 4) return false;
  return read_exact(f, v, 4);
}

}  // namespace

extern "C" {

void* ark_open(const char* path) {
  ArkReader* r = new ArkReader;
  r->f = strcmp(path, "-") == 0 ? stdin : fopen(path, "rb");
  if (!r->f) {
    delete r;
    return nullptr;
  }
  return r;
}

// Returns 1 on success, 0 on EOF, -1 on parse error.
// key: caller buffer; *data is malloc'd float32 row-major, caller frees
// via ark_free. *rows==0 && *cols>0 signals a vector of length *cols.
int ark_next(void* handle, char* key, int key_cap, float** data, int* rows,
             int* cols) {
  ArkReader* r = (ArkReader*)handle;
  FILE* f = r->f;
  // key up to space
  int c = fgetc(f);
  if (c == EOF) return 0;
  int k = 0;
  while (c != EOF && c != ' ') {
    if (k + 1 >= key_cap) return -1;
    key[k++] = (char)c;
    c = fgetc(f);
  }
  key[k] = 0;
  if (c == EOF) return -1;
  // binary marker \0B
  int b0 = fgetc(f), b1 = fgetc(f);
  if (b0 != 0 || b1 != 'B') return -1;  // text mode not handled natively
  std::string tok;
  if (!read_token(f, &tok)) return -1;
  bool dbl = false, vec = false;
  if (tok == "FM") {
  } else if (tok == "DM") {
    dbl = true;
  } else if (tok == "FV") {
    vec = true;
  } else if (tok == "DV") {
    dbl = vec = true;
  } else {
    return -1;
  }
  int32_t nr = 0, nc = 0;
  if (vec) {
    if (!read_int32(f, &nc)) return -1;
    nr = 0;
  } else {
    if (!read_int32(f, &nr) || !read_int32(f, &nc)) return -1;
  }
  int64_t n = (int64_t)(vec ? 1 : nr) * nc;
  float* out = (float*)malloc(sizeof(float) * (n > 0 ? n : 1));
  if (!out) return -1;
  if (dbl) {
    std::vector<double> tmp(n);
    if (!read_exact(f, tmp.data(), n * 8)) {
      free(out);
      return -1;
    }
    for (int64_t i = 0; i < n; i++) out[i] = (float)tmp[i];
  } else {
    if (!read_exact(f, out, n * 4)) {
      free(out);
      return -1;
    }
  }
  *data = out;
  *rows = nr;
  *cols = nc;
  return 1;
}

void ark_free(float* data) { free(data); }

void ark_close(void* handle) {
  ArkReader* r = (ArkReader*)handle;
  if (r->f && r->f != stdin) fclose(r->f);
  delete r;
}

void* ark_create(const char* path, const char* scp_path) {
  ArkWriter* w = new ArkWriter;
  w->f = strcmp(path, "-") == 0 ? stdout : fopen(path, "wb");
  if (!w->f) {
    delete w;
    return nullptr;
  }
  if (scp_path && scp_path[0]) w->scp = fopen(scp_path, "w");
  w->path = path;
  return w;
}

int ark_write(void* handle, const char* key, const float* data, int rows,
              int cols) {
  ArkWriter* w = (ArkWriter*)handle;
  FILE* f = w->f;
  fputs(key, f);
  fputc(' ', f);
  long off = ftell(f);
  fputc(0, f);
  fputc('B', f);
  if (rows == 0) {
    fputs("FV ", f);
    unsigned char four = 4;
    fwrite(&four, 1, 1, f);
    int32_t n = cols;
    fwrite(&n, 4, 1, f);
    fwrite(data, 4, cols, f);
  } else {
    fputs("FM ", f);
    unsigned char four = 4;
    int32_t r32 = rows, c32 = cols;
    fwrite(&four, 1, 1, f);
    fwrite(&r32, 4, 1, f);
    fwrite(&four, 1, 1, f);
    fwrite(&c32, 4, 1, f);
    fwrite(data, 4, (int64_t)rows * cols, f);
  }
  if (w->scp)
    fprintf(w->scp, "%s %s:%ld\n", key, w->path.c_str(), off);
  return ferror(f) ? -1 : 0;
}

void ark_close_writer(void* handle) {
  ArkWriter* w = (ArkWriter*)handle;
  if (w->f && w->f != stdout) fclose(w->f);
  if (w->scp) fclose(w->scp);
  delete w;
}

}  // extern "C"
