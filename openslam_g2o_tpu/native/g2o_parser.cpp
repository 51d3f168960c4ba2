// Fast .g2o tokenizer — the native data-loading path.
//
// The reference's loader is C++ iostream-based (optimizable_graph.cpp:356-569
// reads token by token through virtual read() methods). This module is the
// equivalent native layer for this framework: it tokenizes an entire .g2o
// buffer in one pass into (line records, numeric values) arrays that Python
// turns into struct-of-arrays tables without per-token Python overhead.
// BAL/venice-scale files (~100 MB) parse in well under a second vs tens of
// seconds for pure-Python splitting.
//
// C ABI (ctypes):
//   g2o_count(buf, len, &n_lines, &n_tokens)
//       upper bounds for allocation.
//   g2o_tokenize(buf, len, values, lines, &n_lines_out, &n_values_out)
//       fills LineRec per non-empty non-comment line; numeric tokens parsed
//       as doubles; a line with any non-numeric token after the tag gets
//       ok = 0 (Python re-parses it — data payload lines with hostnames).

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <cctype>

extern "C" {

struct LineRec {
    int64_t tag_offset;    // offset of the first token (tag) in buf
    int32_t tag_len;
    int32_t n_values;      // numeric values parsed after the tag
    int64_t value_start;   // index into the values array
    int64_t line_offset;   // offset of the start of the line (for fallback)
    int32_t line_len;
    int32_t ok;            // 1 = all tokens numeric, 0 = needs Python fallback
};

void g2o_count(const char* buf, int64_t len, int64_t* n_lines,
               int64_t* n_tokens) {
    int64_t lines = 1, tokens = 0;
    int in_tok = 0;
    for (int64_t i = 0; i < len; ++i) {
        char c = buf[i];
        if (c == '\n') { lines++; in_tok = 0; }
        else if (c == ' ' || c == '\t' || c == '\r') { in_tok = 0; }
        else if (!in_tok) { tokens++; in_tok = 1; }
    }
    *n_lines = lines;
    *n_tokens = tokens;
}

// strtod wrapper confined to [p, end)
static inline int parse_double(const char* p, const char* end, double* out,
                               const char** next) {
    char* e = nullptr;
    // strtod stops at the first invalid char; the buffer is NUL-free text,
    // but lines are newline-terminated so strtod cannot run past `end`
    // through valid numeric syntax.
    *out = strtod(p, &e);
    if (e == p || e > end) return 0;
    *next = e;
    return 1;
}

void g2o_tokenize(const char* buf, int64_t len, double* values,
                  LineRec* lines, int64_t* n_lines_out,
                  int64_t* n_values_out) {
    int64_t nl = 0, nv = 0;
    int64_t pos = 0;
    while (pos < len) {
        int64_t line_start = pos;
        int64_t line_end = pos;
        while (line_end < len && buf[line_end] != '\n') line_end++;
        pos = line_end + 1;

        const char* p = buf + line_start;
        const char* end = buf + line_end;
        while (p < end && (*p == ' ' || *p == '\t' || *p == '\r')) p++;
        if (p >= end || *p == '#') continue;  // blank or comment

        // tag token
        const char* tag = p;
        while (p < end && *p != ' ' && *p != '\t' && *p != '\r') p++;
        LineRec& r = lines[nl];
        r.tag_offset = tag - buf;
        r.tag_len = (int32_t)(p - tag);
        r.value_start = nv;
        r.line_offset = line_start;
        r.line_len = (int32_t)(line_end - line_start);
        r.ok = 1;
        int32_t count = 0;

        while (p < end) {
            while (p < end && (*p == ' ' || *p == '\t' || *p == '\r')) p++;
            if (p >= end) break;
            double v;
            const char* next;
            if (parse_double(p, end, &v, &next)) {
                values[nv++] = v;
                count++;
                p = next;
            } else {
                r.ok = 0;  // non-numeric token: Python re-parses this line
                // rewind values of this line
                nv = r.value_start;
                count = 0;
                break;
            }
        }
        r.n_values = count;
        nl++;
    }
    *n_lines_out = nl;
    *n_values_out = nv;
}

}  // extern "C"
