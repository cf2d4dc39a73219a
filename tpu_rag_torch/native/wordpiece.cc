// First-party C++ WordPiece tokenizer — the native replacement for the
// HuggingFace `tokenizers` Rust crate the reference pulls in via
// sentence-transformers (SURVEY.md §2.4).  Host-side hot loop of ingestion:
// tokenizes UTF-8 text into BERT-style ids (greedy longest-match WordPiece,
// CJK chars as single tokens, ASCII lowercasing).
//
// Exposed as a C ABI for ctypes (no pybind11 in this image):
//   void*  wp_create(const char* vocab_path);
//   void   wp_free(void* h);
//   int    wp_tokenize(void* h, const char* utf8, int32_t* out, int cap);
//
// Build: make -C tpu_rag/native   (g++ -O2 -shared -fPIC)

#include <cstdint>
#include <cstring>
#include <fstream>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

struct Vocab {
  std::unordered_map<std::string, int32_t> table;
  int32_t unk_id = 3;
  size_t max_word_chars = 100;
};

bool is_cjk(uint32_t cp) {
  return (cp >= 0x4E00 && cp <= 0x9FFF) || (cp >= 0x3400 && cp <= 0x4DBF) ||
         (cp >= 0xF900 && cp <= 0xFAFF) || (cp >= 0x3040 && cp <= 0x30FF) ||
         (cp >= 0xAC00 && cp <= 0xD7AF);
}

// Decode one UTF-8 codepoint at s[i]; advances i. Returns 0xFFFD on error.
uint32_t decode_utf8(const char* s, size_t len, size_t& i) {
  const auto b0 = static_cast<unsigned char>(s[i]);
  if (b0 < 0x80) { i += 1; return b0; }
  size_t n = (b0 >= 0xF0) ? 4 : (b0 >= 0xE0) ? 3 : (b0 >= 0xC0) ? 2 : 1;
  if (n == 1 || i + n > len) { i += 1; return 0xFFFD; }
  uint32_t cp = b0 & (0xFF >> (n + 1));
  for (size_t k = 1; k < n; ++k) {
    const auto bk = static_cast<unsigned char>(s[i + k]);
    if ((bk & 0xC0) != 0x80) { i += 1; return 0xFFFD; }
    cp = (cp << 6) | (bk & 0x3F);
  }
  i += n;
  return cp;
}

void append_utf8(std::string& out, uint32_t cp) {
  if (cp < 0x80) {
    out.push_back(static_cast<char>(cp));
  } else if (cp < 0x800) {
    out.push_back(static_cast<char>(0xC0 | (cp >> 6)));
    out.push_back(static_cast<char>(0x80 | (cp & 0x3F)));
  } else if (cp < 0x10000) {
    out.push_back(static_cast<char>(0xE0 | (cp >> 12)));
    out.push_back(static_cast<char>(0x80 | ((cp >> 6) & 0x3F)));
    out.push_back(static_cast<char>(0x80 | (cp & 0x3F)));
  } else {
    out.push_back(static_cast<char>(0xF0 | (cp >> 18)));
    out.push_back(static_cast<char>(0x80 | ((cp >> 12) & 0x3F)));
    out.push_back(static_cast<char>(0x80 | ((cp >> 6) & 0x3F)));
    out.push_back(static_cast<char>(0x80 | (cp & 0x3F)));
  }
}

// Greedy longest-match WordPiece over a word given as UTF-8 codepoint slices.
void wordpiece(const Vocab& v, const std::vector<std::string>& chars,
               std::vector<int32_t>& out) {
  if (chars.size() > v.max_word_chars) {
    out.push_back(v.unk_id);
    return;
  }
  size_t start = 0;
  std::vector<int32_t> pieces;
  while (start < chars.size()) {
    size_t end = chars.size();
    int32_t found = -1;
    std::string piece;
    while (start < end) {
      piece.clear();
      if (start > 0) piece = "##";
      for (size_t k = start; k < end; ++k) piece += chars[k];
      auto it = v.table.find(piece);
      if (it != v.table.end()) { found = it->second; break; }
      --end;
    }
    if (found < 0) {
      out.push_back(v.unk_id);
      return;
    }
    pieces.push_back(found);
    start = end;
  }
  out.insert(out.end(), pieces.begin(), pieces.end());
}

}  // namespace

extern "C" {

void* wp_create(const char* vocab_path) {
  std::ifstream in(vocab_path);
  if (!in.good()) return nullptr;
  auto* v = new Vocab();
  std::string line;
  int32_t id = 0;
  while (std::getline(in, line)) {
    if (!line.empty() && line.back() == '\r') line.pop_back();
    v->table.emplace(line, id++);
  }
  auto unk = v->table.find("[UNK]");
  if (unk != v->table.end()) v->unk_id = unk->second;
  return v;
}

void wp_free(void* h) { delete static_cast<Vocab*>(h); }

// Tokenize UTF-8 text into ids. Returns the number of ids written (<= cap),
// or -1 on error. Pretokenization: ASCII lowercased; ASCII alnum + '_' and
// non-CJK codepoints >= 0x80 form words; CJK codepoints are single tokens;
// everything else splits.
int wp_tokenize(void* h, const char* utf8, int32_t* out, int cap) {
  if (h == nullptr || utf8 == nullptr || out == nullptr) return -1;
  const auto& v = *static_cast<Vocab*>(h);
  const size_t len = std::strlen(utf8);

  std::vector<int32_t> ids;
  std::vector<std::string> word;  // per-codepoint UTF-8 slices
  ids.reserve(64);

  auto flush = [&]() {
    if (!word.empty()) {
      wordpiece(v, word, ids);
      word.clear();
    }
  };

  size_t i = 0;
  while (i < len) {
    uint32_t cp = decode_utf8(utf8, len, i);
    if (cp < 0x80) {
      const char c = static_cast<char>(cp >= 'A' && cp <= 'Z' ? cp + 32 : cp);
      if ((c >= 'a' && c <= 'z') || (c >= '0' && c <= '9') || c == '_') {
        word.emplace_back(1, c);
      } else {
        flush();
      }
    } else if (is_cjk(cp)) {
      flush();
      std::vector<std::string> one;
      std::string s;
      append_utf8(s, cp);
      one.push_back(std::move(s));
      wordpiece(v, one, ids);
    } else {
      std::string s;
      append_utf8(s, cp);
      word.push_back(std::move(s));
    }
    if (static_cast<int>(ids.size()) >= cap) break;
  }
  flush();

  const int n = static_cast<int>(std::min<size_t>(ids.size(), cap));
  std::memcpy(out, ids.data(), n * sizeof(int32_t));
  return n;
}

}  // extern "C"
