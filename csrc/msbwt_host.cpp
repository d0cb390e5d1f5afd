// Native host runtime for msbwt_jax: FASTX ingestion + RLE codec.
//
// Plays the role the reference delegates to native crates: needletail's
// FASTA/FASTQ(+gzip) parsing (ref: src/dynamic_bwt.rs:453-473) and the RLE
// byte codec hot loops (ref: src/bwt_converter.rs:26-80, src/rle_bwt.rs:352-384).
// The device compute path stays in XLA; this library keeps the host side
// (IO, decode, encode) off the Python interpreter.
//
// C ABI, consumed from Python via ctypes (no pybind11 in the image).
//
// Build: g++ -O3 -march=native -shared -fPIC csrc/msbwt_host.cpp -o libmsbwt_host.so -lz

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>
#include <algorithm>
#if defined(_OPENMP)
#include <parallel/algorithm>
#include <omp.h>
#endif

#include <zlib.h>

namespace {

// '$ A C G N T' -> 0..5; unknowns -> N(4); U/u -> T (needletail
// normalize(false) semantics, see utils/fastx.py)
struct Tables {
  uint8_t base_to_int[256];
  Tables() {
    for (int i = 0; i < 256; ++i) base_to_int[i] = 4;
    const char* up = "$ACGNT";
    for (int i = 0; i < 6; ++i) base_to_int[(uint8_t)up[i]] = (uint8_t)i;
    const char* lo = "$acgnt";
    for (int i = 0; i < 6; ++i) base_to_int[(uint8_t)lo[i]] = (uint8_t)i;
    base_to_int[(uint8_t)'U'] = 5;
    base_to_int[(uint8_t)'u'] = 5;
  }
};
const Tables kTables;

// gzFile transparently reads both plain and gzip files.
class LineReader {
 public:
  explicit LineReader(const char* path) : f_(gzopen(path, "rb")) {}
  ~LineReader() {
    if (f_) gzclose(f_);
  }
  bool ok() const { return f_ != nullptr; }
  // Reads one line (without trailing \r\n) into line_. Returns false at EOF.
  bool next(std::vector<char>& line) {
    line.clear();
    char buf[65536];
    bool got = false;
    while (gzgets(f_, buf, sizeof(buf)) != nullptr) {
      got = true;
      size_t len = strlen(buf);
      bool complete = len > 0 && buf[len - 1] == '\n';
      while (len > 0 && (buf[len - 1] == '\n' || buf[len - 1] == '\r')) --len;
      line.insert(line.end(), buf, buf + len);
      if (complete) break;
    }
    return got;
  }

 private:
  gzFile f_;
};

struct ParseResult {
  std::vector<uint8_t> seq;     // concatenated int-encoded reads
  std::vector<int64_t> offsets; // n_reads+1 offsets into seq
};

void append_normalized(const std::vector<char>& line, std::vector<uint8_t>* out) {
  size_t old = out->size();
  out->resize(old + line.size());
  uint8_t* dst = out->data() + old;
  const uint8_t* tab = kTables.base_to_int;
  for (size_t i = 0; i < line.size(); ++i) dst[i] = tab[(uint8_t)line[i]];
}

}  // namespace

extern "C" {

// Parses a FASTA or FASTQ file (plain or gzip). Reads are int-encoded
// ($ACGNT -> 0..5). Returns 0 on success. Caller frees with msbwt_free.
//   out_seq     -> concatenated reads, *out_total bytes
//   out_offsets -> (*out_n_reads + 1) int64 offsets
int msbwt_parse_fastx(const char* path, uint8_t** out_seq, int64_t* out_total,
                      int64_t** out_offsets, int64_t* out_n_reads) {
  LineReader reader(path);
  if (!reader.ok()) return 1;
  ParseResult res;
  res.offsets.push_back(0);
  std::vector<char> line;
  if (!reader.next(line)) {  // empty file: zero reads
    *out_seq = nullptr;
    *out_total = 0;
    *out_offsets = (int64_t*)malloc(sizeof(int64_t));
    (*out_offsets)[0] = 0;
    *out_n_reads = 0;
    return 0;
  }
  if (!line.empty() && line[0] == '>') {  // FASTA: sequences span lines
    // each subsequent '>' closes the previous record; EOF closes the last
    while (reader.next(line)) {
      if (!line.empty() && line[0] == '>') {
        res.offsets.push_back((int64_t)res.seq.size());
      } else {
        append_normalized(line, &res.seq);
      }
    }
    res.offsets.push_back((int64_t)res.seq.size());
  } else if (!line.empty() && line[0] == '@') {  // FASTQ: strict 4-line records
    while (true) {
      if (!reader.next(line)) return 2;  // missing sequence line
      append_normalized(line, &res.seq);
      res.offsets.push_back((int64_t)res.seq.size());
      if (!reader.next(line) || line.empty() || line[0] != '+') return 2;
      if (!reader.next(line)) return 2;  // quality line
      if (!reader.next(line)) break;     // next header or EOF
      if (line.empty() || line[0] != '@') return 2;
    }
  } else {
    return 3;  // unrecognized format
  }

  *out_total = (int64_t)res.seq.size();
  *out_seq = (uint8_t*)malloc(res.seq.size() ? res.seq.size() : 1);
  memcpy(*out_seq, res.seq.data(), res.seq.size());
  *out_n_reads = (int64_t)res.offsets.size() - 1;
  *out_offsets = (int64_t*)malloc(res.offsets.size() * sizeof(int64_t));
  memcpy(*out_offsets, res.offsets.data(), res.offsets.size() * sizeof(int64_t));
  return 0;
}

void msbwt_free(void* p) { free(p); }

// RLE decode: compressed bytes -> total symbol count (pass out=null to size),
// then decoded symbols (ref format: src/bwt_converter.rs:53-56).
int64_t msbwt_rle_decode(const uint8_t* rle, int64_t n_bytes, uint8_t* out) {
  int64_t total = 0;
  int64_t i = 0;
  while (i < n_bytes) {
    uint8_t sym = rle[i] & 0x07;
    uint64_t count = 0, mult = 1;
    while (i < n_bytes && (rle[i] & 0x07) == sym) {
      count += (uint64_t)(rle[i] >> 3) * mult;
      mult <<= 5;
      ++i;
    }
    if (out) memset(out + total, sym, count);
    total += (int64_t)count;
  }
  return total;
}

// RLE encode: decoded symbols -> bytes. Returns byte count; pass out=null to
// size first (two-pass).
int64_t msbwt_rle_encode(const uint8_t* syms, int64_t n, uint8_t* out) {
  int64_t written = 0;
  int64_t i = 0;
  while (i < n) {
    uint8_t sym = syms[i];
    int64_t j = i;
    while (j < n && syms[j] == sym) ++j;
    uint64_t count = (uint64_t)(j - i);
    while (count > 0) {
      if (out) out[written] = sym | (uint8_t)((count & 0x1F) << 3);
      ++written;
      count >>= 5;
    }
    i = j;
  }
  return written;
}


// --- read-matrix host kernels (the remaining host-side hot paths of the
// builder: lexicographic row sort and the column-major stage view) ---------

// Lexicographic argsort of N fixed-width L-byte rows. Parallel std::sort on
// row indices with memcmp keys (rows are 0-padded, so plain byte order ==
// the '$'-terminated lexicographic order used by sorted insertion).
int msbwt_sort_rows(const uint8_t* rows, int64_t n, int64_t l, int32_t* order) {
  std::vector<int32_t> idx(n);
  for (int64_t i = 0; i < n; ++i) idx[i] = (int32_t)i;
  auto cmp = [rows, l](int32_t a, int32_t b) {
    int c = memcmp(rows + (int64_t)a * l, rows + (int64_t)b * l, (size_t)l);
    if (c != 0) return c < 0;
    return a < b;  // stable
  };
#if defined(_OPENMP)
  __gnu_parallel::sort(idx.begin(), idx.end(), cmp);
#else
  std::sort(idx.begin(), idx.end(), cmp);
#endif
  memcpy(order, idx.data(), n * sizeof(int32_t));
  return 0;
}

// cols[j, i] = reads[order[i], lengths[order[i]] - j] for 1 <= j <= len, else
// 0 — the [L+2, N] stage view (see ops.bcr.reads_to_cols), fused with the
// row-gather by `order` so the sorted read matrix never materializes.
int msbwt_reads_to_cols(const uint8_t* reads, const int32_t* lengths,
                        const int32_t* order, int64_t n, int64_t l,
                        uint8_t* cols /* (l+2) * n bytes */) {
  memset(cols, 0, (size_t)(l + 2) * n);
#if defined(_OPENMP)
#pragma omp parallel for schedule(static)
#endif
  for (int64_t i = 0; i < n; ++i) {
    int64_t src = order ? order[i] : i;
    int32_t len = lengths[src];
    if (len < 0) continue;
    const uint8_t* row = reads + src * l;
    for (int32_t j = 1; j <= len; ++j) {
      cols[(int64_t)j * n + i] = row[len - j];
    }
  }
  return 0;
}

}  // extern "C"
