// fastingest — native host-side tokenizer + hasher.
//
// The device pipeline's host-side work is corpus ingestion: tokenize each
// fanwork and hash every token, ahead of every device batch.  This
// implements data/tokenizer.py + data/hashing.py semantics byte-for-byte:
//
//   * tokens: maximal runs of [0-9a-z] on the lowercased text, with
//     single apostrophes allowed between runs ("don't");
//   * lowercasing: ASCII A-Z only (plus U+212A KELVIN SIGN -> 'k', the
//     one non-ASCII char whose Python str.lower() lands in ASCII);
//     all other code points are separators, matching the Python regex;
//   * offsets: in Unicode code points of the ORIGINAL string (Python
//     str indices);
//   * hash: FNV-1a over the lowercased ASCII token bytes, finalized
//     with murmur3 fmix32 (data/hashing.py hash_word).
//
// Exposed as a C ABI for ctypes (no pybind11 in this image).  The
// function releases no Python state and is thread-safe, so Python can
// fan it out over a thread pool (ctypes drops the GIL during the call).
//
// Build: g++ -O3 -shared -fPIC -o libfastingest.so fastingest.cpp

#include <cstdint>
#include <cstddef>

namespace {

inline uint32_t fmix32(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h;
}

constexpr uint32_t kFnvOffset = 2166136261u;
constexpr uint32_t kFnvPrime = 16777619u;

// Decode one UTF-8 code point at p (n bytes remaining).
// Returns the number of bytes consumed (>=1) and writes the code point.
// Invalid sequences decode as U+FFFD one byte at a time (they are
// separators either way, so exact behavior only affects offsets of
// malformed input, which Python would have rejected upstream).
inline int decode_utf8(const uint8_t* p, int64_t n, uint32_t* cp) {
  uint8_t b0 = p[0];
  if (b0 < 0x80) { *cp = b0; return 1; }
  if ((b0 >> 5) == 0x6 && n >= 2 && (p[1] & 0xC0) == 0x80) {
    *cp = ((b0 & 0x1F) << 6) | (p[1] & 0x3F);
    return 2;
  }
  if ((b0 >> 4) == 0xE && n >= 3 && (p[1] & 0xC0) == 0x80 &&
      (p[2] & 0xC0) == 0x80) {
    *cp = ((b0 & 0x0F) << 12) | ((p[1] & 0x3F) << 6) | (p[2] & 0x3F);
    return 3;
  }
  if ((b0 >> 3) == 0x1E && n >= 4 && (p[1] & 0xC0) == 0x80 &&
      (p[2] & 0xC0) == 0x80 && (p[3] & 0xC0) == 0x80) {
    *cp = ((b0 & 0x07) << 18) | ((p[1] & 0x3F) << 12) |
          ((p[2] & 0x3F) << 6) | (p[3] & 0x3F);
    return 4;
  }
  *cp = 0xFFFD;
  return 1;
}

// Map a code point to its token character ([0-9a-z]), or 0 if it is
// not a token character, or '\'' for the apostrophe.
inline char token_char(uint32_t cp) {
  if (cp >= 'a' && cp <= 'z') return (char)cp;
  if (cp >= '0' && cp <= '9') return (char)cp;
  if (cp >= 'A' && cp <= 'Z') return (char)(cp + 32);
  if (cp == 0x212A) return 'k';  // KELVIN SIGN lowercases to ASCII k
  if (cp == '\'') return '\'';
  return 0;
}

}  // namespace

extern "C" {

// Tokenize+hash one UTF-8 document.
//   utf8/nbytes : input buffer
//   hashes      : out, capacity >= number of code points
//   starts/ends : out, token offsets in code points
// Returns the number of tokens.
int64_t fs_tokenize(const uint8_t* utf8, int64_t nbytes,
                    uint32_t* hashes, int64_t* starts, int64_t* ends) {
  int64_t ntok = 0;
  int64_t cp_index = 0;   // code-point position in the original string
  int64_t i = 0;          // byte position

  // decoded lookahead of one code point
  while (i < nbytes) {
    uint32_t cp;
    int adv = decode_utf8(utf8 + i, nbytes - i, &cp);
    char c = token_char(cp);
    if (c == 0 || c == '\'') {  // separators (incl. leading apostrophes)
      i += adv;
      ++cp_index;
      continue;
    }
    // start of a token
    int64_t tok_start = cp_index;
    uint32_t h = kFnvOffset;
    int64_t tok_end = cp_index;
    while (i < nbytes) {
      adv = decode_utf8(utf8 + i, nbytes - i, &cp);
      c = token_char(cp);
      if (c == 0) break;
      if (c == '\'') {
        // include only if followed by a token character
        if (i + adv >= nbytes) break;
        uint32_t cp2;
        int adv2 = decode_utf8(utf8 + i + adv, nbytes - i - adv, &cp2);
        char c2 = token_char(cp2);
        if (c2 == 0 || c2 == '\'') break;
        h = (h ^ (uint32_t)'\'') * kFnvPrime;
        h = (h ^ (uint32_t)c2) * kFnvPrime;
        i += adv + adv2;
        cp_index += 2;
        tok_end = cp_index;
        continue;
      }
      h = (h ^ (uint32_t)c) * kFnvPrime;
      i += adv;
      ++cp_index;
      tok_end = cp_index;
    }
    hashes[ntok] = fmix32(h);
    starts[ntok] = tok_start;
    ends[ntok] = tok_end;
    ++ntok;
  }
  return ntok;
}

// Encode a u32 hash stream against an open-addressing probe table
// (search/vocab_stream.py keeps the table; the hashes are already
// fmix32-finalized, so the probe index is just `key & mask` with
// linear probing at load factor <= 0.5).
//   stream/n   : input token hashes
//   pk/pv      : probe keys / values, size mask+1 (power of two);
//                pv[i] == 0xFFFFFFFF marks an empty slot (values are
//                vocab ids <= 65534, so the marker is unambiguous)
//   ids        : out, u16 vocab ids; 0xFFFF where the hash is not in
//                the table ("miss")
//   mpos/mhash : out, first `mcap` miss positions + hashes
// Returns the TOTAL number of misses (may exceed mcap; the caller
// compares against its patch budget and falls back to a raw upload).
int64_t fs_encode_stream(const uint32_t* stream, int64_t n,
                         const uint32_t* pk, const uint32_t* pv,
                         uint32_t mask, uint16_t* ids,
                         int64_t* mpos, uint32_t* mhash, int64_t mcap) {
  int64_t nmiss = 0;
  for (int64_t i = 0; i < n; ++i) {
    uint32_t key = stream[i];
    uint32_t p = key & mask;
    uint32_t id = 0xFFFFu;
    while (pv[p] != 0xFFFFFFFFu) {
      if (pk[p] == key) { id = pv[p]; break; }
      p = (p + 1) & mask;
    }
    ids[i] = (uint16_t)id;
    if (id == 0xFFFFu) {
      if (nmiss < mcap) { mpos[nmiss] = i; mhash[nmiss] = key; }
      ++nmiss;
    }
  }
  return nmiss;
}

// Build ONE probe table of the bucketed inverted index
// (ops/bucketed.py BucketedIndex.build): counting sort of shingle ids
// by bucket key, ties in ascending id (bit-identical to NumPy's
// stable argsort).  Key mix must match ops/bucketed.py _bucket_ids:
// fmix32(fmix32(w_a + salt) ^ w_b) & mask, wrapping u32 arithmetic.
//   wa, wb  : word-hash columns [ns] (window positions a and b)
//   keys    : scratch [ns] (caller-allocated so the builder is
//             allocation-free and thread-safe)
//   entries : out [ns] shingle ids sorted by bucket
//   offsets : out [num_buckets + 1] CSR boundaries (int32: bucket
//             boundaries are shingle counts, always < 2^31, and the
//             narrower type halves the dominant memory traffic —
//             num_buckets is ~4x ns)
//   mask    : num_buckets - 1 (num_buckets is a power of two)
//   cap     : bucket capacity for the overflow accounting
// Returns the number of entries living in over-cap buckets.
int64_t fs_bucketed_table(const uint32_t* wa, const uint32_t* wb,
                          int64_t ns, uint32_t salt, uint32_t mask,
                          int32_t cap, uint32_t* keys, int32_t* entries,
                          int32_t* offsets) {
  const int64_t nbuckets = (int64_t)mask + 1;
  for (int64_t b = 0; b <= nbuckets; ++b) offsets[b] = 0;
  for (int64_t i = 0; i < ns; ++i) {
    uint32_t k = fmix32(fmix32(wa[i] + salt) ^ wb[i]) & mask;
    keys[i] = k;
    ++offsets[k + 1];  // counts, shifted one right
  }
  int64_t over = 0;
  for (int64_t b = 1; b <= nbuckets; ++b) {
    if (offsets[b] > cap) over += offsets[b];
    offsets[b] += offsets[b - 1];  // exclusive prefix -> CSR
  }
  // stable scatter: ascending i placement preserves id order per
  // bucket.  offsets double as cursors (each ends at the next bucket's
  // start), then one shift restores the CSR — no allocation.
  for (int64_t i = 0; i < ns; ++i) {
    entries[offsets[keys[i]]++] = (int32_t)i;
  }
  for (int64_t b = nbuckets; b >= 1; --b) offsets[b] = offsets[b - 1];
  offsets[0] = 0;
  return over;
}

// Version stamp so Python can detect stale binaries.
int32_t fs_abi_version() { return 4; }

}  // extern "C"
