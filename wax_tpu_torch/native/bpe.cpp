// Verbatim copy of wax_tpu/native/bpe.cpp, built by wax_tpu_torch/native/build.py. Keep the two in step.
// BPE merge core: the token-counting hot loop, kept native for the same reason the
// reference ships its own NativeBpeTokenizer next to swift-tiktoken (reference:
// Sources/Wax/RAG/NativeBpeTokenizer.swift:5-225) — exact cl100k counts gate the
// token-budgeted RAG assembly, and the greedy pair-merge dominates host-side counting.
//
// Semantics mirror wax_tpu/text/bpe.py:_merge_piece exactly: repeatedly merge the
// LEFTMOST adjacent pair with the strictly lowest rank; when no adjacent pair is in
// the rank table, emit ranks for the remaining parts, falling back to single-byte
// ranks for any part that is itself unranked.
#include <cstdint>
#include <cstring>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

struct BpeTable {
  std::unordered_map<std::string, int32_t> ranks;
  int32_t byte_rank[256];
};

}  // namespace

extern "C" {

void* wax_bpe_create(const uint8_t* keys, const int32_t* key_lens,
                     const int32_t* ranks, int64_t n) {
  auto* t = new BpeTable();
  t->ranks.reserve(static_cast<size_t>(n) * 2);
  for (int i = 0; i < 256; ++i) t->byte_rank[i] = -1;
  const uint8_t* p = keys;
  for (int64_t i = 0; i < n; ++i) {
    std::string key(reinterpret_cast<const char*>(p), static_cast<size_t>(key_lens[i]));
    t->ranks.emplace(key, ranks[i]);
    if (key_lens[i] == 1) t->byte_rank[static_cast<uint8_t>(key[0])] = ranks[i];
    p += key_lens[i];
  }
  return t;
}

void wax_bpe_destroy(void* h) { delete static_cast<BpeTable*>(h); }

// Returns the token count (may exceed max_out; only the first max_out ids are
// written), or -1 if a needed single-byte rank is missing from the table.
int32_t wax_bpe_encode_piece(void* h, const uint8_t* piece, int32_t len,
                             int32_t* out, int32_t max_out) {
  auto* t = static_cast<BpeTable*>(h);
  int32_t n_out = 0;
  auto emit = [&](int32_t id) {
    if (n_out < max_out) out[n_out] = id;
    ++n_out;
  };
  if (len <= 0) return 0;
  {
    std::string whole(reinterpret_cast<const char*>(piece), static_cast<size_t>(len));
    auto it = t->ranks.find(whole);
    if (it != t->ranks.end()) {
      emit(it->second);
      return n_out;
    }
  }
  // part boundaries: parts[i] = [starts[i], starts[i+1])
  std::vector<int32_t> starts;
  starts.reserve(static_cast<size_t>(len) + 1);
  for (int32_t i = 0; i <= len; ++i) starts.push_back(i);

  std::string pair;
  while (starts.size() > 2) {
    int32_t best_rank = -1;
    size_t best_i = 0;
    for (size_t i = 0; i + 2 < starts.size(); ++i) {
      pair.assign(reinterpret_cast<const char*>(piece) + starts[i],
                  static_cast<size_t>(starts[i + 2] - starts[i]));
      auto it = t->ranks.find(pair);
      if (it != t->ranks.end() && (best_rank < 0 || it->second < best_rank)) {
        best_rank = it->second;
        best_i = i;
      }
    }
    if (best_rank < 0) break;
    starts.erase(starts.begin() + static_cast<int64_t>(best_i) + 1);
  }

  for (size_t i = 0; i + 1 < starts.size(); ++i) {
    std::string part(reinterpret_cast<const char*>(piece) + starts[i],
                     static_cast<size_t>(starts[i + 1] - starts[i]));
    auto it = t->ranks.find(part);
    if (it != t->ranks.end()) {
      emit(it->second);
    } else {
      for (int32_t j = starts[i]; j < starts[i + 1]; ++j) {
        int32_t br = t->byte_rank[piece[j]];
        if (br < 0) return -1;
        emit(br);
      }
    }
  }
  return n_out;
}

// Encode many pre-tokenized pieces in one call (amortizes FFI overhead: the Python
// side runs the cl100k regex, ships the memo-miss pieces as one blob + length
// array) with a per-piece token-count out array (piece_counts[i] = ids emitted
// for piece i). The per-piece boundaries let the Python side memoize piece -> ids
// (BPE merges are context-free per regex piece), so repeated words across a
// corpus skip the FFI + merge entirely. Returns total token count, or -1 on
// missing byte rank / out overflow.
int32_t wax_bpe_encode_batch_counts(void* h, const uint8_t* blob, const int32_t* lens,
                                    int32_t n_pieces, int32_t* out, int32_t max_out,
                                    int32_t* piece_counts) {
  auto* t = static_cast<BpeTable*>(h);
  int32_t n_out = 0;
  const uint8_t* p = blob;
  std::string key;
  for (int32_t i = 0; i < n_pieces; ++i) {
    int32_t len = lens[i];
    key.assign(reinterpret_cast<const char*>(p), static_cast<size_t>(len));
    auto it = t->ranks.find(key);
    if (it != t->ranks.end()) {
      if (n_out >= max_out) return -1;
      out[n_out++] = it->second;
      piece_counts[i] = 1;
    } else {
      int32_t n = wax_bpe_encode_piece(h, p, len, out + n_out, max_out - n_out);
      if (n < 0 || n_out + n > max_out) return -1;
      piece_counts[i] = n;
      n_out += n;
    }
    p += len;
  }
  return n_out;
}

}  // extern "C"
