// Native Viterbi tokenizer encode.
//
// C++ core for the unigram tokenizer's hot loop (Viterbi best segmentation
// per word), the role the sentencepiece C++ runtime plays for the reference
// (reference train.py:205 encodes every segment text on the hot path).
// Pieces are byte strings (valid UTF-8 from training); the byte-level
// Viterbi visits the same segmentations as the Python char-level one because
// matches only occur at piece boundaries.  Tie-breaking matches the Python
// fallback exactly (strict improvement, ascending start position).

#include <cstdint>
#include <cstring>
#include <limits>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

struct Vocab {
  std::unordered_map<std::string, int> id_of;
  std::vector<float> score;    // indexed by id
  size_t max_piece_bytes = 1;
};

constexpr double kNegInf = -std::numeric_limits<double>::infinity();

}  // namespace

extern "C" {

// Build a vocab handle from concatenated pieces.
//   pieces_blob: all piece bytes concatenated
//   lens[i]: byte length of piece i
//   ids[i]: token id of piece i; scores[i]: log prob
void* sc_vocab_create(const uint8_t* pieces_blob, const int32_t* lens,
                      const int32_t* ids, const float* scores, int n_pieces) {
  auto* v = new Vocab();
  int32_t max_id = 0;
  for (int i = 0; i < n_pieces; ++i) max_id = ids[i] > max_id ? ids[i] : max_id;
  v->score.assign(static_cast<size_t>(max_id) + 1, 0.f);
  size_t off = 0;
  for (int i = 0; i < n_pieces; ++i) {
    std::string p(reinterpret_cast<const char*>(pieces_blob) + off,
                  static_cast<size_t>(lens[i]));
    off += static_cast<size_t>(lens[i]);
    v->id_of.emplace(std::move(p), ids[i]);
    v->score[static_cast<size_t>(ids[i])] = scores[i];
    if (static_cast<size_t>(lens[i]) > v->max_piece_bytes)
      v->max_piece_bytes = static_cast<size_t>(lens[i]);
  }
  return v;
}

void sc_vocab_destroy(void* handle) { delete static_cast<Vocab*>(handle); }

// Viterbi-segment one word (bytes).  Writes up to out_capacity ids; returns
// the number of pieces, 0 if the word is empty, or -1 if unsegmentable
// (caller falls back to its unknown-character path).
int sc_viterbi_encode(void* handle, const uint8_t* word, int n_bytes,
                      int32_t* out, int out_capacity) {
  const Vocab& v = *static_cast<Vocab*>(handle);
  const int n = n_bytes;
  if (n == 0) return 0;
  std::vector<double> best(static_cast<size_t>(n) + 1, kNegInf);
  std::vector<int> back(static_cast<size_t>(n) + 1, 0);
  best[0] = 0.0;
  std::string key;
  key.reserve(v.max_piece_bytes);
  for (int i = 1; i <= n; ++i) {
    int j0 = i - static_cast<int>(v.max_piece_bytes);
    if (j0 < 0) j0 = 0;
    for (int j = j0; j < i; ++j) {
      key.assign(reinterpret_cast<const char*>(word) + j,
                 static_cast<size_t>(i - j));
      auto it = v.id_of.find(key);
      if (it == v.id_of.end()) continue;
      double cand = best[static_cast<size_t>(j)] +
                    static_cast<double>(v.score[static_cast<size_t>(it->second)]);
      if (best[static_cast<size_t>(j)] > kNegInf && cand > best[static_cast<size_t>(i)]) {
        best[static_cast<size_t>(i)] = cand;
        back[static_cast<size_t>(i)] = j;
      }
    }
  }
  if (best[static_cast<size_t>(n)] == kNegInf) return -1;
  // walk back, then reverse
  std::vector<int32_t> rev;
  int i = n;
  while (i > 0) {
    int j = back[static_cast<size_t>(i)];
    key.assign(reinterpret_cast<const char*>(word) + j,
               static_cast<size_t>(i - j));
    rev.push_back(v.id_of.at(key));
    i = j;
  }
  int count = static_cast<int>(rev.size());
  int n_out = count < out_capacity ? count : out_capacity;
  for (int k = 0; k < n_out; ++k) out[k] = rev[static_cast<size_t>(count - 1 - k)];
  return count;
}

}  // extern "C"
