// Native libsvm tokenizer — the hot parse path of the data layer.
//
// The one place the reference is CPU-native and stays CPU-native in the
// TPU framework: its equivalent is the hand-rolled parser stack in
// include/data_iter.h:16-35 + src/util.cc (Split/ToInt/ToFloat), which
// (a) re-parses the whole shard from disk every epoch and (b) cannot
// parse signs or exponents in feature values (SURVEY.md Q6).  This
// parser is a two-pass CSR tokenizer over one contiguous buffer using
// strtof/strtol (full float syntax), exposed through a plain-C API for
// ctypes (distlr_tpu/data/_native.py).
//
// Pass 1 (libsvm_count): count rows and nonzeros so Python can allocate
// exact-size numpy arrays.  Pass 2 (libsvm_parse) fills them.
//
// Label rule matches the reference (data_iter.h:27): binary mode maps
// label != 1 -> 0; multiclass keeps the integer.

#include <cstdint>
#include <cstdlib>
#include <cstring>

namespace {

inline bool is_space(char c) { return c == ' ' || c == '\t' || c == '\r'; }

}  // namespace

extern "C" {

// Counts rows (non-empty lines) and total nonzero features.
// Returns 0 on success.
int libsvm_count(const char* buf, int64_t n, int64_t* n_rows, int64_t* n_nnz) {
  int64_t rows = 0, nnz = 0;
  int64_t i = 0;
  while (i < n) {
    // skip leading whitespace on the line
    while (i < n && is_space(buf[i])) ++i;
    if (i >= n) break;
    if (buf[i] == '\n') { ++i; continue; }  // empty line
    ++rows;
    // label token
    while (i < n && !is_space(buf[i]) && buf[i] != '\n') ++i;
    // feature tokens
    while (i < n && buf[i] != '\n') {
      while (i < n && is_space(buf[i])) ++i;
      if (i >= n || buf[i] == '\n') break;
      if (buf[i] == '#') {  // trailing comment: skip to EOL
        while (i < n && buf[i] != '\n') ++i;
        break;
      }
      ++nnz;
      while (i < n && !is_space(buf[i]) && buf[i] != '\n') ++i;
    }
    if (i < n) ++i;  // consume newline
  }
  *n_rows = rows;
  *n_nnz = nnz;
  return 0;
}

// Fills pre-allocated arrays:
//   labels:  int32 [n_rows]
//   row_ptr: int64 [n_rows + 1]   (row_ptr[0] = 0)
//   cols:    int32 [n_nnz]        (1-based input -> 0-based output)
//   vals:    float32 [n_nnz]
// Returns number of rows parsed, or -1 on malformed input.
int64_t libsvm_parse(const char* buf, int64_t n, int multiclass,
                     int32_t* labels, int64_t* row_ptr, int32_t* cols,
                     float* vals) {
  int64_t row = 0, k = 0;
  int64_t i = 0;
  row_ptr[0] = 0;
  while (i < n) {
    while (i < n && is_space(buf[i])) ++i;
    if (i >= n) break;
    if (buf[i] == '\n') { ++i; continue; }

    char* end = nullptr;
    const double raw_label = strtod(buf + i, &end);
    if (end == buf + i) return -1;  // no numeric label
    i = end - buf;
    labels[row] = multiclass ? static_cast<int32_t>(raw_label)
                             : (raw_label == 1.0 ? 1 : 0);

    while (i < n && buf[i] != '\n') {
      while (i < n && is_space(buf[i])) ++i;
      if (i >= n || buf[i] == '\n') break;
      if (buf[i] == '#') {
        while (i < n && buf[i] != '\n') ++i;
        break;
      }
      const long idx = strtol(buf + i, &end, 10);
      if (end == buf + i || *end != ':') return -1;
      i = (end - buf) + 1;  // skip ':'
      const float v = strtof(buf + i, &end);
      if (end == buf + i) return -1;
      i = end - buf;
      cols[k] = static_cast<int32_t>(idx - 1);  // 1-based -> 0-based
      vals[k] = v;
      ++k;
    }
    ++row;
    row_ptr[row] = k;
    if (i < n) ++i;
  }
  return row;
}

}  // extern "C"
