// Native host-runtime kernels for libpll_tpu (C ABI, loaded via ctypes).
//
// The reference implements its entire host layer in C (fasta.c, compress.c,
// pll.c tip encoding); the rebuild keeps the compute path in
// JAX/XLA/Pallas and implements the same host-side hot paths natively here:
//
//   * site-pattern compression  (reference: compress.c:138-286, 3-way radix
//     quicksort ssort1 at compress.c:33-81 — here a hashed dedup, same
//     result set, first-occurrence order)
//   * tip-state encoding        (reference: pll_set_tip_states charmap walk,
//     pll.c:905-964)
//   * FASTA record scanning     (reference: fasta.c streaming getnext)
//
// Build: g++ -O3 -march=native -shared -fPIC host.cpp -o libpllhost.so
// (done on demand by libpll_tpu.native; no Python headers needed).

#include <cstdint>
#include <cstring>
#include <unordered_map>
#include <vector>
#include <string>

extern "C" {

// ---------------------------------------------------------------------------
// Site-pattern compression.
// matrix: [n_seq * n_sites] row-major alignment bytes.
// charmap: 256 validity/state entries; a zero entry = illegal character.
// out_matrix: caller-allocated [n_seq * n_sites] (only the first
//   n_seq*n_patterns bytes are written, column-major patterns rewritten
//   back as rows).
// out_weights: caller-allocated [n_sites] uint64.
// Returns n_patterns, or -(position+1) of the first illegal character.
// ---------------------------------------------------------------------------
long long pllhost_compress_patterns(const uint8_t* matrix, long long n_seq,
                                    long long n_sites,
                                    const uint32_t* charmap,
                                    uint8_t* out_matrix,
                                    uint64_t* out_weights) {
  for (long long i = 0; i < n_seq * n_sites; ++i)
    if (!charmap[matrix[i]]) return -(i + 1);

  struct ColHash {
    const uint8_t* base;
    long long n_seq, n_sites;
    size_t operator()(long long col) const {
      // FNV-1a over the column bytes
      size_t h = 1469598103934665603ULL;
      for (long long r = 0; r < n_seq; ++r) {
        h ^= base[r * n_sites + col];
        h *= 1099511628211ULL;
      }
      return h;
    }
  };
  struct ColEq {
    const uint8_t* base;
    long long n_seq, n_sites;
    bool operator()(long long a, long long b) const {
      for (long long r = 0; r < n_seq; ++r)
        if (base[r * n_sites + a] != base[r * n_sites + b]) return false;
      return true;
    }
  };

  ColHash hash{matrix, n_seq, n_sites};
  ColEq eq{matrix, n_seq, n_sites};
  std::unordered_map<long long, long long, ColHash, ColEq> seen(
      (size_t)n_sites * 2, hash, eq);

  std::vector<long long> kept;
  kept.reserve(n_sites);
  for (long long c = 0; c < n_sites; ++c) {
    auto it = seen.find(c);
    if (it == seen.end()) {
      seen.emplace(c, (long long)kept.size());
      kept.push_back(c);
      out_weights[kept.size() - 1] = 1;
    } else {
      ++out_weights[it->second];
    }
  }

  const long long np = (long long)kept.size();
  for (long long r = 0; r < n_seq; ++r)
    for (long long p = 0; p < np; ++p)
      out_matrix[r * np + p] = matrix[r * n_sites + kept[p]];
  return np;
}

// ---------------------------------------------------------------------------
// Tip-state encoding: sequence bytes -> per-site state bitmasks.
// Returns 0 on success, or (position+1) of the first illegal character.
// ---------------------------------------------------------------------------
long long pllhost_encode_tips(const uint8_t* seq, long long n,
                              const uint32_t* charmap, uint32_t* out_mask) {
  for (long long i = 0; i < n; ++i) {
    const uint32_t m = charmap[seq[i]];
    if (!m) return i + 1;
    out_mask[i] = m;
  }
  return 0;
}

// ---------------------------------------------------------------------------
// FASTA scanning over an in-memory file image.
// Pass 1 (out_* null): returns the record count, or -(line+1) on a
//   structural error (sequence data before the first header).
// Pass 2: fills, per record, the [start, end) byte ranges of the header
//   line (sans '>') and the packed sequence (whitespace stripped in
//   pllhost_fasta_pack).
// ---------------------------------------------------------------------------
long long pllhost_fasta_scan(const uint8_t* data, long long n,
                             long long* hdr_start, long long* hdr_end,
                             long long* seq_start, long long* seq_end) {
  long long count = 0;
  long long line = 0;
  long long i = 0;
  const bool fill = hdr_start != nullptr;
  while (i < n) {
    // skip blank lines
    if (data[i] == '\n') { ++i; ++line; continue; }
    if (data[i] == '>') {
      long long hs = i + 1;
      while (i < n && data[i] != '\n') ++i;
      if (fill) { hdr_start[count] = hs; hdr_end[count] = i; }
      if (i < n) { ++i; ++line; }
      long long ss = i;
      while (i < n && data[i] != '>') {
        if (data[i] == '\n') ++line;
        ++i;
      }
      if (fill) { seq_start[count] = ss; seq_end[count] = i; }
      ++count;
    } else {
      return -(line + 1);
    }
  }
  return count;
}

// Pack a [start, end) sequence region using the reference's validity-code
// convention (fasta.c char filtering): map==1 keep, map==2 fatal, any other
// value (incl. whitespace) stripped with count.  Returns packed length, or
// -(offset+1) at the first fatal character; *stripped gets the strip count.
long long pllhost_fasta_pack(const uint8_t* data, long long start,
                             long long end, const uint32_t* charmap,
                             uint8_t* out, long long* stripped) {
  long long k = 0, s = 0;
  for (long long i = start; i < end; ++i) {
    const uint8_t c = data[i];
    const uint32_t v = charmap[c];
    if (v == 1) {
      out[k++] = c;
    } else if (v == 2) {
      return -(i - start + 1);
    } else if (c != '\n' && c != '\r' && v != 3) {
      ++s;  // whitespace (code 3) and newlines are silent
    }
  }
  if (stripped) *stripped = s;
  return k;
}

}  // extern "C"
