// Verbatim copy of wax_tpu/native/lz4.cpp, built by wax_tpu_torch/native/build.py. Keep the two in step.
// LZ4 block-format codec (compressor + safe decompressor).
//
// Native counterpart of the reference's compression shims (reference:
// Sources/WaxCoreCompressionC/include/wax_compression_shims.h:7-34 —
// wax_lz4_{compress,decompress} backed by liblz4 on Linux). No liblz4 ships in this
// image, so this is a self-contained implementation of the public LZ4 block format:
// greedy hash-chain match finder, standard token/literal/offset/matchlen encoding,
// bounds-checked decompression.
//
// Built into libwaxnative.so (see build.py).

#include <cstdint>
#include <cstring>

namespace {

constexpr int MINMATCH = 4;
constexpr int LAST_LITERALS = 5;
constexpr int MFLIMIT = 12;  // encoder lookahead guard
constexpr int HASH_LOG = 16;

inline uint32_t read32(const uint8_t* p) {
  uint32_t v;
  std::memcpy(&v, p, 4);
  return v;
}

inline uint32_t hash4(uint32_t v) { return (v * 2654435761u) >> (32 - HASH_LOG); }

}  // namespace

extern "C" {

// Worst-case compressed size for n input bytes (standard LZ4 bound).
int64_t wax_lz4_bound(int64_t n) { return n + n / 255 + 16; }

// Returns compressed size, or -1 if dst is too small / input too large.
int64_t wax_lz4_compress(const uint8_t* src, int64_t src_len, uint8_t* dst, int64_t dst_cap) {
  if (src_len < 0 || src_len > (1LL << 31) - 1) return -1;
  if (dst_cap < wax_lz4_bound(src_len)) return -1;
  if (src_len == 0) return 0;

  const uint8_t* ip = src;
  const uint8_t* const iend = src + src_len;
  const uint8_t* const mflimit = iend - MFLIMIT;
  const uint8_t* anchor = src;
  uint8_t* op = dst;

  if (src_len >= MFLIMIT) {
    static thread_local int32_t table[1 << HASH_LOG];
    std::memset(table, -1, sizeof(table));

    while (ip < mflimit) {
      // find a match
      uint32_t h = hash4(read32(ip));
      int32_t ref_idx = table[h];
      table[h] = (int32_t)(ip - src);
      const uint8_t* ref = src + ref_idx;
      if (ref_idx < 0 || (ip - ref) > 65535 || read32(ref) != read32(ip)) {
        ++ip;
        continue;
      }
      // extend match forward
      const uint8_t* match_end = ip + MINMATCH;
      const uint8_t* ref_end = ref + MINMATCH;
      const uint8_t* const match_limit = iend - LAST_LITERALS;
      while (match_end < match_limit && *match_end == *ref_end) {
        ++match_end;
        ++ref_end;
      }
      int64_t match_len = match_end - ip - MINMATCH;
      int64_t lit_len = ip - anchor;

      // token
      uint8_t* token = op++;
      if (lit_len >= 15) {
        *token = 15 << 4;
        int64_t l = lit_len - 15;
        while (l >= 255) {
          *op++ = 255;
          l -= 255;
        }
        *op++ = (uint8_t)l;
      } else {
        *token = (uint8_t)(lit_len << 4);
      }
      std::memcpy(op, anchor, lit_len);
      op += lit_len;

      uint16_t offset = (uint16_t)(ip - ref);
      *op++ = (uint8_t)offset;
      *op++ = (uint8_t)(offset >> 8);

      if (match_len >= 15) {
        *token |= 15;
        int64_t l = match_len - 15;
        while (l >= 255) {
          *op++ = 255;
          l -= 255;
        }
        *op++ = (uint8_t)l;
      } else {
        *token |= (uint8_t)match_len;
      }
      ip = match_end;
      anchor = ip;
    }
  }

  // trailing literals
  int64_t lit_len = iend - anchor;
  uint8_t* token = op++;
  if (lit_len >= 15) {
    *token = 15 << 4;
    int64_t l = lit_len - 15;
    while (l >= 255) {
      *op++ = 255;
      l -= 255;
    }
    *op++ = (uint8_t)l;
  } else {
    *token = (uint8_t)(lit_len << 4);
  }
  std::memcpy(op, anchor, lit_len);
  op += lit_len;
  return op - dst;
}

// Safe decompress: returns decompressed size, or -1 on malformed input/overflow.
int64_t wax_lz4_decompress(const uint8_t* src, int64_t src_len, uint8_t* dst, int64_t dst_cap) {
  const uint8_t* ip = src;
  const uint8_t* const iend = src + src_len;
  uint8_t* op = dst;
  uint8_t* const oend = dst + dst_cap;
  if (src_len == 0) return 0;

  while (ip < iend) {
    uint8_t token = *ip++;
    // literals
    int64_t lit_len = token >> 4;
    if (lit_len == 15) {
      uint8_t b;
      do {
        if (ip >= iend) return -1;
        b = *ip++;
        lit_len += b;
      } while (b == 255);
    }
    if (ip + lit_len > iend || op + lit_len > oend) return -1;
    std::memcpy(op, ip, lit_len);
    ip += lit_len;
    op += lit_len;
    if (ip >= iend) break;  // last sequence has no match

    // match
    if (ip + 2 > iend) return -1;
    uint16_t offset = (uint16_t)(ip[0] | (ip[1] << 8));
    ip += 2;
    if (offset == 0 || op - dst < offset) return -1;
    int64_t match_len = (token & 15) + MINMATCH;
    if ((token & 15) == 15) {
      uint8_t b;
      do {
        if (ip >= iend) return -1;
        b = *ip++;
        match_len += b;
      } while (b == 255);
    }
    if (op + match_len > oend) return -1;
    const uint8_t* ref = op - offset;
    // byte-wise copy: overlapping matches are the LZ4 RLE mechanism
    for (int64_t i = 0; i < match_len; ++i) op[i] = ref[i];
    op += match_len;
  }
  return op - dst;
}

}  // extern "C"
