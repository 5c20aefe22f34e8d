// Native data-path primitives of musketeer_tpu_torch (the port's copy of
// musketeer_tpu/native/tsv_reader.cpp, unchanged in what it computes).
//
// The joint loader's host loop reads TSV rows with base64 image payloads; a
// Python readline per row makes the host the bottleneck feeding the device.
// This library provides:
//   - mmap'd newline indexing (single pass, no per-line Python objects),
//   - zero-copy row reads by byte offset, one call for a whole batch,
//   - urlsafe base64 decoding,
// exposed as a plain C ABI consumed via ctypes.
//
// Built at first use by musketeer_tpu_torch/native/__init__.py:
//   g++ -O3 -shared -fPIC tsv_reader.cpp -o build/<hash>/libtsv.so

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

extern "C" {

struct TsvFile {
  int fd;
  const char* data;
  int64_t size;
  int64_t* offsets;  // line start offsets
  int64_t n_rows;
};

// Open + index a TSV. Returns handle or nullptr.
TsvFile* tsv_open(const char* path) {
  int fd = open(path, O_RDONLY);
  if (fd < 0) return nullptr;
  struct stat st;
  if (fstat(fd, &st) != 0) {
    close(fd);
    return nullptr;
  }
  const char* data = nullptr;
  if (st.st_size > 0) {
    data = static_cast<const char*>(
        mmap(nullptr, st.st_size, PROT_READ, MAP_PRIVATE, fd, 0));
    if (data == MAP_FAILED) {
      close(fd);
      return nullptr;
    }
    madvise(const_cast<char*>(data), st.st_size, MADV_SEQUENTIAL);
  }

  // count lines first (memchr scan — ~GB/s)
  int64_t n = 0;
  const char* p = data;
  const char* end = data + st.st_size;
  while (p < end) {
    const char* nl = static_cast<const char*>(memchr(p, '\n', end - p));
    ++n;
    if (!nl) break;
    p = nl + 1;
  }
  if (st.st_size > 0 && data[st.st_size - 1] == '\n') {
    // trailing newline: the loop counted the final empty segment only if
    // p < end; memchr semantics above already handle it (p becomes end).
  }

  int64_t* offsets = static_cast<int64_t*>(malloc(sizeof(int64_t) * (n + 1)));
  int64_t i = 0;
  p = data;
  while (p < end) {
    offsets[i++] = p - data;
    const char* nl = static_cast<const char*>(memchr(p, '\n', end - p));
    if (!nl) break;
    p = nl + 1;
  }
  offsets[i] = st.st_size;

  TsvFile* f = new TsvFile{fd, data, st.st_size, offsets, i};
  return f;
}

int64_t tsv_num_rows(TsvFile* f) { return f ? f->n_rows : -1; }

// Row byte length (excluding trailing newline).
int64_t tsv_row_len(TsvFile* f, int64_t row) {
  if (!f || row < 0 || row >= f->n_rows) return -1;
  int64_t start = f->offsets[row];
  int64_t stop = f->offsets[row + 1];
  while (stop > start &&
         (f->data[stop - 1] == '\n' || f->data[stop - 1] == '\r'))
    --stop;
  return stop - start;
}

// Copy a row into caller buffer. Returns bytes copied or -1.
int64_t tsv_read_row(TsvFile* f, int64_t row, char* buf, int64_t bufsize) {
  int64_t len = tsv_row_len(f, row);
  if (len < 0 || len > bufsize) return -1;
  memcpy(buf, f->data + f->offsets[row], len);
  return len;
}

// Total byte length of a set of rows (for presizing a batch buffer).
int64_t tsv_rows_total_len(TsvFile* f, const int64_t* rows, int64_t n) {
  if (!f) return -1;
  int64_t total = 0;
  for (int64_t i = 0; i < n; ++i) {
    int64_t len = tsv_row_len(f, rows[i]);
    if (len < 0) return -1;
    total += len;
  }
  return total;
}

// Batched row read: copies n rows back-to-back into buf, writing each row's
// byte length into lens[i]. One ctypes call per BATCH instead of two per row
// (the per-call ctypes overhead dominates for short TSV rows). Returns total
// bytes copied, or -1 on bad row / insufficient buffer.
int64_t tsv_read_rows(TsvFile* f, const int64_t* rows, int64_t n, char* buf,
                      int64_t bufsize, int64_t* lens) {
  if (!f) return -1;
  int64_t o = 0;
  for (int64_t i = 0; i < n; ++i) {
    int64_t len = tsv_row_len(f, rows[i]);
    if (len < 0 || o + len > bufsize) return -1;
    memcpy(buf + o, f->data + f->offsets[rows[i]], len);
    lens[i] = len;
    o += len;
  }
  return o;
}

void tsv_close(TsvFile* f) {
  if (!f) return;
  if (f->data && f->size > 0)
    munmap(const_cast<char*>(f->data), f->size);
  close(f->fd);
  free(f->offsets);
  delete f;
}

// Copy line-start offsets out (for Python-side caching). Returns n_rows.
int64_t tsv_copy_offsets(TsvFile* f, int64_t* out, int64_t cap) {
  if (!f || cap < f->n_rows) return -1;
  memcpy(out, f->offsets, sizeof(int64_t) * f->n_rows);
  return f->n_rows;
}

// urlsafe base64 decode ('-' and '_' variants accepted alongside '+'/'/').
// Returns decoded length or -1 on bad input.
int64_t b64_decode(const char* in, int64_t n, uint8_t* out) {
  static int8_t table[256];
  static bool init = false;
  if (!init) {
    memset(table, -1, sizeof(table));
    const char* std64 =
        "ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz0123456789+/";
    for (int i = 0; i < 64; ++i) table[(uint8_t)std64[i]] = i;
    table[(uint8_t)'-'] = 62;
    table[(uint8_t)'_'] = 63;
    init = true;
  }
  int64_t o = 0;
  uint32_t acc = 0;
  int bits = 0;
  for (int64_t i = 0; i < n; ++i) {
    char c = in[i];
    if (c == '=' || c == '\n' || c == '\r') continue;
    int8_t v = table[(uint8_t)c];
    if (v < 0) return -1;
    acc = (acc << 6) | v;
    bits += 6;
    if (bits >= 8) {
      bits -= 8;
      out[o++] = (acc >> bits) & 0xFF;
    }
  }
  return o;
}

}  // extern "C"
