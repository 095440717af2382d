// The PyTorch port's own copy of ai_font_renderer_tpu/fontgen/native/corpus.cpp, code unchanged.
// Native corpus generator: LCG text + greedy word-wrap + monospace grid.
//
// C++ twin of textgen.py (the reference's seeded generator,
// generate_font.ts:164-199) and layout.py's wrap/grid encoding, for
// first-time corpus builds: 150k samples lay out in well under a second
// versus ~2 minutes in Python. Must stay bit-exact with the Python
// implementations — tests/test_native_corpus.py locks them against each
// other.
//
// C ABI:
//   generate_corpus_grids(num_samples, base_seed, min_len, max_len,
//                         advance_px,                 // double, bit-identical
//                         max_width, n_lines, n_slots, max_chars,
//                         codes_out[num_samples*max_chars]   (int32),
//                         grids_out[num_samples*n_lines*n_slots] (int16))
//
// The charset index convention matches layout.py: printable ASCII, index =
// code - 32, space (0) marks empty cells. Monospace only (the grid path);
// proportional layout stays in Python where kerning lives.

#include <algorithm>
#include <cstdint>
#include <string>
#include <vector>

namespace {

struct Lcg {
  uint64_t seed;
  explicit Lcg(uint64_t s) : seed(s) {}
  // Exactly generate_font.ts:166-168 (all values < 2^53, exact in f64).
  double next() {
    seed = (seed * 1664525ull + 1013904223ull) % 4294967296ull;
    return static_cast<double>(seed) / 4294967296.0;
  }
};

std::string generate_text(uint64_t seed, int min_len, int max_len) {
  Lcg rng(seed);
  std::string out;
  int length = static_cast<int>(rng.next() * (max_len - min_len + 1)) + min_len;
  int remaining = length;
  while (remaining > 0) {
    int word_len = static_cast<int>(rng.next() * 10.0) + 1;
    if (word_len > remaining) word_len = remaining;
    for (int i = 0; i < word_len; ++i) {
      out.push_back(static_cast<char>(65 + static_cast<int>(rng.next() * 26.0)));
    }
    remaining -= word_len;
    if (remaining > 0) {
      out.push_back(' ');
      remaining -= 1;
    }
  }
  return out;
}

// Greedy wrap, semantics of generate_font.ts:75-97 with monospace measure:
// width(test) = len(test) * advance. Pushes current line only when the
// candidate overflows AND current is non-empty.
void wrap_lines(const std::string& text, double adv, double max_width,
                std::vector<std::string>* lines) {
  std::string current;
  size_t pos = 0;
  bool done = false;
  while (!done) {
    size_t sp = text.find(' ', pos);
    std::string word = sp == std::string::npos
                           ? text.substr(pos)
                           : text.substr(pos, sp - pos);
    if (sp == std::string::npos) done = true;
    pos = sp + 1;
    std::string test = current.empty() ? word : current + " " + word;
    if (static_cast<double>(test.size()) * adv > max_width && !current.empty()) {
      lines->push_back(current);
      current = word;
    } else {
      current = test;
    }
  }
  if (!current.empty()) lines->push_back(current);
}

}  // namespace

extern "C" {

void generate_corpus_grids(int64_t num_samples, int64_t base_seed,
                           int32_t min_len, int32_t max_len,
                           double advance_px,
                           int32_t max_width, int32_t n_lines,
                           int32_t n_slots, int32_t max_chars,
                           int32_t* codes_out, int16_t* grids_out) {
  const double adv = advance_px;
  std::vector<std::string> lines;
  for (int64_t i = 0; i < num_samples; ++i) {
    std::string text = generate_text(i + base_seed, min_len, max_len);
    if (static_cast<int32_t>(text.size()) > max_chars) {
      text.resize(max_chars);
    }
    int32_t* codes = codes_out + i * max_chars;
    for (int32_t j = 0; j < max_chars; ++j) {
      codes[j] = j < static_cast<int32_t>(text.size())
                     ? (text[j] & 0x7F)
                     : 0;
    }
    lines.clear();
    wrap_lines(text, adv, static_cast<double>(max_width), &lines);
    int16_t* grid = grids_out + i * n_lines * n_slots;
    for (int32_t k = 0; k < n_lines * n_slots; ++k) grid[k] = 0;
    const int32_t use_lines =
        std::min<int32_t>(static_cast<int32_t>(lines.size()), n_lines);
    for (int32_t l = 0; l < use_lines; ++l) {
      const std::string& line = lines[l];
      const int32_t use_slots =
          std::min<int32_t>(static_cast<int32_t>(line.size()), n_slots);
      for (int32_t s = 0; s < use_slots; ++s) {
        const int c = line[s];
        grid[l * n_slots + s] =
            (c >= 32 && c < 127) ? static_cast<int16_t>(c - 32) : 0;
      }
    }
  }
}

}  // extern "C"
