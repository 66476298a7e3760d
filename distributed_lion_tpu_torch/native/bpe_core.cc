// BPE merge core: the hot inner loop of GPT-2 byte-level BPE encoding.
//
// The reference's tokenizer is HF `transformers` GPT2Tokenizer(Fast) — a
// native (Rust) encoder behind a Python API (the reference's run_clm.py:
// 398-423). Our equivalent: Python owns the published pre-tokenization
// regex and the byte<->unicode table (data/bpe.py); this file owns the
// merge loop, which dominates encoding cost for uncached words.
//
// Everything runs in *id space*: Python lowers the vocab to raw byte
// strings (id = array index) and each merge rule to an (left_id, right_id)
// pair; the merged token's id is resolved here once at construction. A
// word is then a vector<int32>, and one merge step is "find the
// lowest-ranked adjacent pair, replace every occurrence left-to-right" —
// exactly data/bpe.py's _bpe, which tests pin token-for-token.
//
// C ABI (consumed via ctypes in distributed_lion_tpu/native/__init__.py):
//   bpe_new(vocab_blob, vocab_off, n_vocab, merge_pairs, n_merges) -> handle
//   bpe_encode(handle, bytes, pretok_off, n_pretok, out, cap) -> n or -needed
//   bpe_cache_size(handle) -> entries in the word cache
//   bpe_free(handle)
//   bpe_last_error() -> static message for the last failed bpe_new

#include <cstdint>
#include <cstring>
#include <string>
#include <unordered_map>
#include <utility>
#include <vector>

namespace {

struct Encoder {
  std::unordered_map<std::string, int32_t> vocab;  // raw byte-string -> id
  // (left_id, right_id) -> (rank, merged_id)
  std::unordered_map<uint64_t, std::pair<int32_t, int32_t>> ranks;
  int32_t byte_id[256];  // id of each single-byte token, -1 if absent
  std::unordered_map<std::string, std::vector<int32_t>> cache;
};

inline uint64_t pair_key(int32_t l, int32_t r) {
  return (uint64_t(uint32_t(l)) << 32) | uint32_t(r);
}

const char* g_err = "";

// Merge one pre-token (raw bytes, already regex-split by the caller) into
// ids appended onto `out`. Mirrors data/bpe.py::_bpe: repeatedly find the
// best-ranked adjacent pair and collapse every occurrence in one pass.
void encode_word(Encoder* e, const std::string& w, std::vector<int32_t>& out) {
  auto hit = e->cache.find(w);
  if (hit != e->cache.end()) {
    out.insert(out.end(), hit->second.begin(), hit->second.end());
    return;
  }
  std::vector<int32_t> ids;
  ids.reserve(w.size());
  for (unsigned char ch : w) {
    int32_t id = e->byte_id[ch];
    if (id >= 0) ids.push_back(id);  // byte-level vocabs cover all 256
  }
  while (ids.size() > 1) {
    int32_t best_rank = INT32_MAX, best_merged = -1;
    int32_t L = 0, R = 0;
    for (size_t i = 0; i + 1 < ids.size(); ++i) {
      auto it = e->ranks.find(pair_key(ids[i], ids[i + 1]));
      if (it != e->ranks.end() && it->second.first < best_rank) {
        best_rank = it->second.first;
        best_merged = it->second.second;
        L = ids[i];
        R = ids[i + 1];
      }
    }
    if (best_merged < 0) break;
    std::vector<int32_t> next;
    next.reserve(ids.size());
    for (size_t i = 0; i < ids.size();) {
      if (i + 1 < ids.size() && ids[i] == L && ids[i + 1] == R) {
        next.push_back(best_merged);
        i += 2;
      } else {
        next.push_back(ids[i]);
        ++i;
      }
    }
    ids.swap(next);
  }
  if (e->cache.size() < 65536) e->cache.emplace(w, ids);
  out.insert(out.end(), ids.begin(), ids.end());
}

}  // namespace

extern "C" {

// vocab_blob/vocab_off: n_vocab raw byte-string tokens, token i =
// blob[off[i], off[i+1]); id == i. merge_pairs: [n_merges*2] left/right ids
// in merge-priority order. Returns nullptr (and sets bpe_last_error) if a
// merge references an out-of-range id or a merged token missing from vocab.
void* bpe_new(const uint8_t* vocab_blob, const int64_t* vocab_off,
              int32_t n_vocab, const int32_t* merge_pairs, int32_t n_merges) {
  auto* e = new Encoder();
  std::vector<std::string> toks(n_vocab);
  e->vocab.reserve(size_t(n_vocab) * 2);
  for (int32_t i = 0; i < n_vocab; ++i) {
    toks[i].assign(reinterpret_cast<const char*>(vocab_blob) + vocab_off[i],
                   size_t(vocab_off[i + 1] - vocab_off[i]));
    e->vocab.emplace(toks[i], i);
  }
  for (int b = 0; b < 256; ++b) e->byte_id[b] = -1;
  for (int32_t i = 0; i < n_vocab; ++i)
    if (toks[i].size() == 1) e->byte_id[uint8_t(toks[i][0])] = i;
  for (int b = 0; b < 256; ++b) {
    if (e->byte_id[b] < 0) {
      // refuse partial byte coverage: silently dropping bytes would corrupt
      // the token stream; the caller falls back to the Python path, which
      // raises KeyError if such a byte is ever actually encoded
      delete e;
      g_err = "vocab does not cover all 256 byte values";
      return nullptr;
    }
  }
  e->ranks.reserve(size_t(n_merges) * 2);
  for (int32_t m = 0; m < n_merges; ++m) {
    int32_t l = merge_pairs[2 * m], r = merge_pairs[2 * m + 1];
    if (l < 0 || l >= n_vocab || r < 0 || r >= n_vocab) {
      delete e;
      g_err = "merge pair id out of range";
      return nullptr;
    }
    auto it = e->vocab.find(toks[l] + toks[r]);
    if (it == e->vocab.end()) {
      delete e;
      g_err = "merged token not present in vocab";
      return nullptr;
    }
    e->ranks.emplace(pair_key(l, r), std::make_pair(m, it->second));
  }
  return e;
}

// bytes/off: n_pretok regex pre-tokens, pre-token p = bytes[off[p],
// off[p+1]). Writes ids to out (capacity cap); returns the count, or
// -needed if cap was too small (never happens when cap >= off[n_pretok],
// since merging only shrinks the per-byte id sequence).
int64_t bpe_encode(void* h, const uint8_t* bytes, const int64_t* off,
                   int64_t n_pretok, int32_t* out_buf, int64_t cap) {
  auto* e = static_cast<Encoder*>(h);
  std::vector<int32_t> out;
  out.reserve(size_t(off[n_pretok] / 3 + 8));
  std::string w;
  for (int64_t p = 0; p < n_pretok; ++p) {
    w.assign(reinterpret_cast<const char*>(bytes) + off[p],
             size_t(off[p + 1] - off[p]));
    encode_word(e, w, out);
  }
  if (int64_t(out.size()) > cap) return -int64_t(out.size());
  std::memcpy(out_buf, out.data(), out.size() * sizeof(int32_t));
  return int64_t(out.size());
}

int64_t bpe_cache_size(void* h) {
  return int64_t(static_cast<Encoder*>(h)->cache.size());
}

void bpe_free(void* h) { delete static_cast<Encoder*>(h); }

const char* bpe_last_error() { return g_err; }

}  // extern "C"
