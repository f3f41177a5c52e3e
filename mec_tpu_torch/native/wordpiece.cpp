// Native WordPiece encoder (C ABI, loaded via ctypes).
//
// The reference's tokenization rides HuggingFace's Rust `tokenizers`
// inside `transformers` (reference preprocessing/text_preprocessing.py:35-46);
// this is the framework's equivalent native data-path component: BERT
// basic tokenization (lowercase, punctuation split) + greedy
// longest-match WordPiece, batch-encoding straight into caller-provided
// int32 id/mask buffers with one thread per slice of the batch.
//
// Scope: byte-oriented ASCII fast path. The Python tokenizer
// (mec_tpu/text/wordpiece.py) remains the reference implementation and
// handles non-ASCII input; mec_tpu.native.tokenizer routes only
// ASCII-pure batches here and asserts equivalence in tests.
//
// Build: g++ -O2 -shared -fPIC -std=c++17 wordpiece.cpp -o libwordpiece.so

#include <cstdint>
#include <cstring>
#include <string>
#include <thread>
#include <unordered_map>
#include <vector>

namespace {

struct Tokenizer {
    std::unordered_map<std::string, int32_t> vocab;
    int32_t unk_id = 0, cls_id = 0, sep_id = 0, pad_id = 0;
    int max_chars_per_word = 100;
};

inline bool is_ws(unsigned char c) {
    return c == ' ' || c == '\t' || c == '\n' || c == '\r';
}

inline bool is_punct(unsigned char c) {
    // BERT treats every ASCII non-alphanumeric printable as punctuation
    return (c >= 33 && c <= 47) || (c >= 58 && c <= 64) ||
           (c >= 91 && c <= 96) || (c >= 123 && c <= 126);
}

inline bool is_ctrl(unsigned char c) {
    // matches Python's unicodedata category Cc for ASCII: 0x00-0x1f
    // (minus the whitespace ones) plus DEL 0x7f
    return (c < 32 || c == 127) && !is_ws(c);
}

// lowercase + clean + whitespace/punctuation split
void basic_tokenize(const char* text, std::vector<std::string>& out) {
    std::string cur;
    auto flush = [&]() {
        if (!cur.empty()) {
            out.push_back(cur);
            cur.clear();
        }
    };
    for (const char* p = text; *p; ++p) {
        unsigned char c = (unsigned char)*p;
        if (c == 0 || c == 0xFF || is_ctrl(c)) continue;
        if (is_ws(c)) {
            flush();
        } else if (is_punct(c)) {
            flush();
            out.emplace_back(1, (char)c);
        } else {
            if (c >= 'A' && c <= 'Z') c += 32;
            cur.push_back((char)c);
        }
    }
    flush();
}

// greedy longest-match WordPiece for one word
void wordpiece(const Tokenizer& tk, const std::string& word,
               std::vector<int32_t>& ids) {
    if ((int)word.size() > tk.max_chars_per_word) {
        ids.push_back(tk.unk_id);
        return;
    }
    std::vector<int32_t> pieces;
    size_t start = 0;
    while (start < word.size()) {
        size_t end = word.size();
        int32_t cur_id = -1;
        while (start < end) {
            std::string sub = word.substr(start, end - start);
            if (start > 0) sub = "##" + sub;
            auto it = tk.vocab.find(sub);
            if (it != tk.vocab.end()) {
                cur_id = it->second;
                break;
            }
            --end;
        }
        if (cur_id < 0) {
            ids.push_back(tk.unk_id);
            return;
        }
        pieces.push_back(cur_id);
        start = end;
    }
    ids.insert(ids.end(), pieces.begin(), pieces.end());
}

void encode_one(const Tokenizer& tk, const char* text, int32_t max_len,
                int32_t* ids_out, int32_t* mask_out) {
    std::vector<std::string> words;
    basic_tokenize(text, words);
    std::vector<int32_t> ids;
    ids.reserve(max_len);
    ids.push_back(tk.cls_id);
    for (const auto& w : words) {
        if ((int32_t)ids.size() >= max_len - 1) break;
        wordpiece(tk, w, ids);
    }
    if ((int32_t)ids.size() > max_len - 1) ids.resize(max_len - 1);
    ids.push_back(tk.sep_id);
    int32_t n = (int32_t)ids.size();
    for (int32_t i = 0; i < max_len; ++i) {
        ids_out[i] = i < n ? ids[i] : tk.pad_id;
        mask_out[i] = i < n ? 1 : 0;
    }
}

}  // namespace

extern "C" {

void* wp_create(const char** tokens, const int32_t* ids, int32_t n_tokens,
                int32_t unk_id, int32_t cls_id, int32_t sep_id,
                int32_t pad_id) {
    auto* tk = new Tokenizer();
    tk->vocab.reserve((size_t)n_tokens * 2);
    for (int32_t i = 0; i < n_tokens; ++i) {
        tk->vocab.emplace(tokens[i], ids[i]);
    }
    tk->unk_id = unk_id;
    tk->cls_id = cls_id;
    tk->sep_id = sep_id;
    tk->pad_id = pad_id;
    return tk;
}

void wp_destroy(void* handle) { delete (Tokenizer*)handle; }

// texts: n C strings; ids_out/mask_out: n*max_len int32 buffers
void wp_encode_batch(void* handle, const char** texts, int32_t n,
                     int32_t max_len, int32_t* ids_out, int32_t* mask_out) {
    const auto& tk = *(const Tokenizer*)handle;
    int32_t n_threads =
        n >= 8 ? (int32_t)std::min<size_t>(
                     4, std::thread::hardware_concurrency())
               : 1;
    if (n_threads <= 1) {
        for (int32_t i = 0; i < n; ++i) {
            encode_one(tk, texts[i], max_len, ids_out + (size_t)i * max_len,
                       mask_out + (size_t)i * max_len);
        }
        return;
    }
    std::vector<std::thread> pool;
    for (int32_t t = 0; t < n_threads; ++t) {
        pool.emplace_back([&, t]() {
            for (int32_t i = t; i < n; i += n_threads) {
                encode_one(tk, texts[i], max_len,
                           ids_out + (size_t)i * max_len,
                           mask_out + (size_t)i * max_len);
            }
        });
    }
    for (auto& th : pool) th.join();
}

}  // extern "C"
