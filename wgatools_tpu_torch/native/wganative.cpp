// Native host kernels for wgatools-tpu.
//
// The reference relies on Rust + nom + htslib for its byte-level hot paths
// (reference: src/parser/cigar.rs:59-75 tokenizer, src/utils.rs:83-101
// reverse complement, per-char classify loops).  These C++ equivalents are
// compiled with -O3 and autovectorize; they feed the packed arrays that the
// device kernels consume.  Loaded via ctypes (no pybind11 in this image).
//
// Build: g++ -O3 -march=native -shared -fPIC wganative.cpp -o libwganative.so

#include <cstdint>
#include <cstring>

extern "C" {

// fused classify + RLE in one pass over the raw byte pair (no cat array:
// saves 2n bytes of memory traffic vs classify-then-rle).  '=' runs --
// ~97% of real alignment columns -- gallop 8 bytes at a time with word
// tricks; other categories are short and walk scalar.  caller != 0 uses
// the caller table (gap/gap -> 4 'W', reference cigar.rs:314-328), where
// an '=' run also stops at gap/gap columns.
static inline uint8_t cat_ext_one(uint8_t a, uint8_t b) {
    return (a == b) ? 0 : ((a == '-') ? 2 : ((b == '-') ? 3 : 1));
}

static inline uint8_t cat_caller_one(uint8_t a, uint8_t b) {
    if (a == '-') return (b == '-') ? 4 : 2;
    if (b == '-') return 3;
    return (a == b) ? 0 : 1;
}

static inline uint64_t nonzero_bytes_hi(uint64_t x) {
    // high bit set in every byte of x that is nonzero
    uint64_t y = (x & 0x7f7f7f7f7f7f7f7full) + 0x7f7f7f7f7f7f7f7full;
    return (y | x) & 0x8080808080808080ull;
}

int64_t classify_rle(const uint8_t* t, const uint8_t* q, int64_t n,
                     int caller, uint8_t* vals, int64_t* lens) {
    const uint64_t GAPS = 0x2d2d2d2d2d2d2d2dull;
    int64_t runs = 0;
    int64_t i = 0;
    while (i < n) {
        uint8_t cur = caller ? cat_caller_one(t[i], q[i])
                             : cat_ext_one(t[i], q[i]);
        int64_t j = i + 1;
        if (cur == 0) {
            while (j + 8 <= n) {
                uint64_t a, b;
                memcpy(&a, t + j, 8);
                memcpy(&b, q + j, 8);
                uint64_t stop = nonzero_bytes_hi(a ^ b);
                if (caller) {
                    // '-'-bytes of a end the run too (gap/gap -> W)
                    stop |= 0x8080808080808080ull & ~nonzero_bytes_hi(a ^ GAPS);
                }
                if (stop) {
                    j += (int64_t)(__builtin_ctzll(stop) >> 3);
                    break;
                }
                j += 8;
            }
            if (caller) {
                while (j < n && t[j] == q[j] && t[j] != '-') ++j;
            } else {
                while (j < n && t[j] == q[j]) ++j;
            }
        } else {
            if (caller) {
                while (j < n && cat_caller_one(t[j], q[j]) == cur) ++j;
            } else {
                while (j < n && cat_ext_one(t[j], q[j]) == cur) ++j;
            }
        }
        vals[runs] = cur;
        lens[runs] = j - i;
        ++runs;
        i = j;
    }
    return runs;
}

static inline int64_t write_i64(char* out, int64_t v);  // defined below

// classify + RLE + CIGAR-string formatting + per-category stats in ONE
// streaming pass over the column pair (parse_maf_seq_to_cigar's whole hot
// body, reference cigar.rs:344-432): no intermediate run arrays.
// chars maps cat code -> op char (ext "=XID", caller "=XIDW").
// stats[2c] = run events of cat c, stats[2c+1] = total columns of cat c,
// for c in 0..4 (10 slots).  Returns bytes written to out, or -1 if cap
// is too small.
int64_t classify_rle_format(const uint8_t* t, const uint8_t* q, int64_t n,
                            int caller, const char* chars, int64_t* stats,
                            char* out, int64_t cap) {
    const uint64_t GAPS = 0x2d2d2d2d2d2d2d2dull;
    for (int c = 0; c < 10; ++c) stats[c] = 0;
    int64_t w = 0;
    int64_t i = 0;
    while (i < n) {
        uint8_t cur = caller ? cat_caller_one(t[i], q[i])
                             : cat_ext_one(t[i], q[i]);
        int64_t j = i + 1;
        if (cur == 0) {
            while (j + 8 <= n) {
                uint64_t a, b;
                memcpy(&a, t + j, 8);
                memcpy(&b, q + j, 8);
                uint64_t stop = nonzero_bytes_hi(a ^ b);
                if (caller) {
                    stop |= 0x8080808080808080ull & ~nonzero_bytes_hi(a ^ GAPS);
                }
                if (stop) {
                    j += (int64_t)(__builtin_ctzll(stop) >> 3);
                    break;
                }
                j += 8;
            }
            if (caller) {
                while (j < n && t[j] == q[j] && t[j] != '-') ++j;
            } else {
                while (j < n && t[j] == q[j]) ++j;
            }
        } else {
            if (caller) {
                while (j < n && cat_caller_one(t[j], q[j]) == cur) ++j;
            } else {
                while (j < n && cat_ext_one(t[j], q[j]) == cur) ++j;
            }
        }
        int64_t len = j - i;
        stats[2 * cur] += 1;
        stats[2 * cur + 1] += len;
        if (w + 21 > cap) return -1;
        w += write_i64(out + w, len);
        out[w++] = chars[cur];
        i = j;
    }
    return w;
}

// SV-safe chunk boundary (reference caller.rs:159-219): scan the window
// [start, proposed_end) of the gap mask (t or q is '-'); the window is
// truncated to the end of the LAST gap run of length >= cutoff that
// completes inside it; when the window ends inside such a run, extend to
// the first column past proposed_end where both sequences are non-gap
// (or keep proposed_end if that never happens before `total`).
int64_t safe_chunk_boundary(const uint8_t* t, const uint8_t* q,
                            int64_t total, int64_t start,
                            int64_t proposed_end, int64_t cutoff) {
    int64_t safe_end = proposed_end;
    int64_t last_end = -1;
    int64_t run_len = 0;
    for (int64_t i = start; i < proposed_end; ++i) {
        bool g = (t[i] == '-') || (q[i] == '-');
        if (g) {
            ++run_len;
        } else {
            if (run_len > 0 && run_len >= cutoff) last_end = i;
            run_len = 0;
        }
    }
    if (last_end >= 0) safe_end = last_end;
    if (run_len > 0 && run_len >= cutoff) {
        int64_t j = proposed_end;
        while (j < total && ((t[j] == '-') || (q[j] == '-'))) ++j;
        safe_end = (j < total) ? j : proposed_end;
    }
    return safe_end;
}

// CIGAR string tokenizer (nom tokenizer analog, reference cigar.rs:59-75).
// Returns op count, or -(pos+1) on malformed input at byte pos.
int64_t tokenize_cigar(const char* s, int64_t n, uint8_t* ops,
                       int64_t* lens) {
    int64_t count = 0;
    int64_t i = 0;
    while (i < n) {
        int64_t start = i;
        int64_t v = 0;
        while (i < n && s[i] >= '0' && s[i] <= '9') {
            int64_t d = s[i] - '0';
            // overflow guard: the reference's parse_str2u64 surfaces a
            // ParseIntError on a 20+ digit length instead of wrapping.
            if (v > (INT64_MAX - d) / 10) return -(start + 1);
            v = v * 10 + d;
            ++i;
        }
        if (i == start) return -(i + 1);  // no digits before op
        if (i >= n) return -(i + 1);      // digits with no op
        ops[count] = (uint8_t)s[i];
        lens[count] = v;
        ++count;
        ++i;
    }
    return count;
}

// fused CIGAR text -> PAF stat counters (tokenize + parse_paf_to_cigar
// accumulation in one pass, reference cigar.rs:59-75 + 629-707):
// out[0..5] = match, mismatch, ins_event, ins_count, del_event, del_count.
// Returns 0 on success; -(pos+1) on a malformed numeric token at byte pos
// (same contract as tokenize_cigar); the invalid op byte (1..255, or 256
// for NUL) when an op is outside {M,=,X,I,D} -- first in scan order like
// the reference's match arm.
int64_t cigar_text_stats(const char* s, int64_t n, int64_t* out) {
    int64_t match = 0, mism = 0, ie = 0, ic = 0, de = 0, dc = 0;
    int64_t i = 0;
    while (i < n) {
        int64_t start = i, v = 0;
        while (i < n && s[i] >= '0' && s[i] <= '9') {
            int64_t d = s[i] - '0';
            if (v > (INT64_MAX - d) / 10) return -(start + 1);
            v = v * 10 + d;
            ++i;
        }
        if (i == start) return -(i + 1);  // no digits before op
        if (i >= n) return -(i + 1);      // digits with no op
        char op = s[i++];
        switch (op) {
            case 'M': case '=': match += v; break;
            case 'X': mism += v; break;
            case 'I': ++ie; ic += v; break;
            case 'D': ++de; dc += v; break;
            default: return op ? (int64_t)(uint8_t)op : 256;
        }
    }
    out[0] = match; out[1] = mism; out[2] = ie;
    out[3] = ic; out[4] = de; out[5] = dc;
    return 0;
}

// format runs back into a CIGAR string; returns bytes written or -1 if the
// buffer (cap) is too small.  chars maps cat code -> op char.
int64_t format_runs(const uint8_t* vals, const int64_t* lens, int64_t n_runs,
                    const char* chars, char* out, int64_t cap) {
    int64_t w = 0;
    char tmp[24];
    for (int64_t k = 0; k < n_runs; ++k) {
        int64_t v = lens[k];
        int64_t tl = 0;
        if (v == 0) {
            tmp[tl++] = '0';
        } else {
            while (v > 0) {
                tmp[tl++] = (char)('0' + (v % 10));
                v /= 10;
            }
        }
        if (w + tl + 1 > cap) return -1;
        for (int64_t d = tl - 1; d >= 0; --d) out[w++] = tmp[d];
        out[w++] = chars[vals[k]];
    }
    return w;
}

// strict reverse complement (reference utils.rs:83-101).
// Returns 0 on success, or (index+1) of the first invalid base.
int64_t reverse_complement(const uint8_t* in, int64_t n, uint8_t* out) {
    static uint8_t table[256];
    static bool init = false;
    if (!init) {
        memset(table, 0, sizeof(table));
        table['A'] = 'T'; table['C'] = 'G'; table['G'] = 'C';
        table['T'] = 'A'; table['N'] = 'N';
        table['a'] = 't'; table['c'] = 'g'; table['g'] = 'c';
        table['t'] = 'a'; table['n'] = 'n';
        init = true;
    }
    for (int64_t i = 0; i < n; ++i) {
        uint8_t c = table[in[n - 1 - i]];
        if (c == 0) return (n - 1 - i) + 1;
        out[i] = c;
    }
    return 0;
}

// bulk-format per-base BED lines: "<prefix>\t<pos>\t<pos+1>\t<count>\n"
// for pos in [start, start+n).  Returns bytes written, or -1 if cap is too
// small (caller sizes cap generously).
static inline int64_t write_i64(char* out, int64_t v) {
    char tmp[24];
    int64_t tl = 0;
    int64_t sign = 0;
    if (v < 0) {
        // negate via unsigned to stay defined on INT64_MIN
        uint64_t u = ~(uint64_t)v + 1;
        *out++ = '-';
        sign = 1;
        while (u > 0) { tmp[tl++] = (char)('0' + (u % 10)); u /= 10; }
    } else if (v == 0) {
        tmp[tl++] = '0';
    } else {
        while (v > 0) { tmp[tl++] = (char)('0' + (v % 10)); v /= 10; }
    }
    for (int64_t d = tl - 1; d >= 0; --d) *out++ = tmp[d];
    return tl + sign;
}

int64_t format_bed_lines(const char* prefix, int64_t prefix_len,
                         int64_t start, const int64_t* counts, int64_t n,
                         char* out, int64_t cap) {
    int64_t w = 0;
    for (int64_t i = 0; i < n; ++i) {
        if (w + prefix_len + 80 > cap) return -1;
        memcpy(out + w, prefix, prefix_len);
        w += prefix_len;
        out[w++] = '\t';
        w += write_i64(out + w, start + i);
        out[w++] = '\t';
        w += write_i64(out + w, start + i + 1);
        out[w++] = '\t';
        w += write_i64(out + w, counts[i]);
        out[w++] = '\n';
    }
    return w;
}

// parse chain data lines: up to 3 whitespace-separated non-negative ints
// per line (missing -> 0, extra tokens ignored); blank lines skipped.
// Returns line count, or -(pos+1) at the first non-numeric token start.
int64_t parse_chain_lines(const char* s, int64_t n, int64_t* sizes,
                          int64_t* dqs, int64_t* dts) {
    int64_t count = 0;
    int64_t i = 0;
    while (i < n) {
        // skip leading spaces/tabs/CR
        while (i < n && (s[i] == ' ' || s[i] == '\t' || s[i] == '\r')) ++i;
        if (i < n && s[i] == '\n') { ++i; continue; }
        if (i >= n) break;
        int64_t vals[3] = {0, 0, 0};
        int field = 0;
        while (i < n && s[i] != '\n') {
            while (i < n && (s[i] == ' ' || s[i] == '\t' || s[i] == '\r'))
                ++i;
            if (i >= n || s[i] == '\n') break;
            if (s[i] < '0' || s[i] > '9') return -(i + 1);
            int64_t start = i;
            int64_t v = 0;
            while (i < n && s[i] >= '0' && s[i] <= '9') {
                int64_t d = s[i] - '0';
                // overflow guard: match the reference's u64 parse error
                // on 20+ digit tokens instead of silently wrapping
                // (round-5 review finding; same pattern as
                // tokenize_cigar above)
                if (v > (INT64_MAX - d) / 10) return -(start + 1);
                v = v * 10 + d;
                ++i;
            }
            if (field < 3) vals[field] = v;
            ++field;
        }
        sizes[count] = vals[0];
        dqs[count] = vals[1];
        dts[count] = vals[2];
        ++count;
        if (i < n) ++i;  // consume newline
    }
    return count;
}

// bulk-format chain data lines: "\n<size>\t<dq>\t<dt>" per line.
// Returns bytes written or -1 if cap too small.
int64_t format_chain_lines(const int64_t* sizes, const int64_t* dqs,
                           const int64_t* dts, int64_t n, char* out,
                           int64_t cap) {
    int64_t w = 0;
    for (int64_t i = 0; i < n; ++i) {
        if (w + 66 > cap) return -1;
        out[w++] = '\n';
        w += write_i64(out + w, sizes[i]);
        out[w++] = '\t';
        w += write_i64(out + w, dqs[i]);
        out[w++] = '\t';
        w += write_i64(out + w, dts[i]);
    }
    return w;
}

// fused chain data-lines -> PAF cg CIGAR + stats (the hot chain2paf body,
// reference cigar.rs:554-626 + chain.rs:430-452).  Per line: "{size}M"
// (always emitted, even size 0 -- cigar.rs:580-582), then "{dt}I" if
// dt>0, then "{dq}D" if dq>0.  stats[0..4] = {match_sum, ins_event,
// ins_count, del_event, del_count}.  Returns bytes written or -1 if cap
// is too small.
int64_t chain_arrays_to_cg(const int64_t* sizes, const int64_t* dqs,
                           const int64_t* dts, int64_t n, int64_t* stats,
                           char* out, int64_t cap) {
    int64_t w = 0;
    int64_t match = 0, ins_ev = 0, ins_ct = 0, del_ev = 0, del_ct = 0;
    for (int64_t i = 0; i < n; ++i) {
        if (w + 66 > cap) return -1;
        int64_t sz = sizes[i], dt = dts[i], dq = dqs[i];
        match += sz;
        w += write_i64(out + w, sz);
        out[w++] = 'M';
        if (dt > 0) {
            ++ins_ev; ins_ct += dt;
            w += write_i64(out + w, dt);
            out[w++] = 'I';
        }
        if (dq > 0) {
            ++del_ev; del_ct += dq;
            w += write_i64(out + w, dq);
            out[w++] = 'D';
        }
    }
    stats[0] = match; stats[1] = ins_ev; stats[2] = ins_ct;
    stats[3] = del_ev; stats[4] = del_ct;
    return w;
}

// validate chain data-line text without materializing arrays: same
// grammar as parse_chain_lines.  Returns the line count, or -(pos+1) at
// the first malformed token.
int64_t validate_chain_lines(const char* s, int64_t n) {
    int64_t count = 0;
    int64_t i = 0;
    while (i < n) {
        while (i < n && (s[i] == ' ' || s[i] == '\t' || s[i] == '\r')) ++i;
        if (i < n && s[i] == '\n') { ++i; continue; }
        if (i >= n) break;
        while (i < n && s[i] != '\n') {
            while (i < n && (s[i] == ' ' || s[i] == '\t' || s[i] == '\r'))
                ++i;
            if (i >= n || s[i] == '\n') break;
            if (s[i] < '0' || s[i] > '9') return -(i + 1);
            int64_t start = i;
            int64_t v = 0;
            while (i < n && s[i] >= '0' && s[i] <= '9') {
                int64_t d = s[i] - '0';
                // reject what parse_chain_lines would reject (overflow)
                if (v > (INT64_MAX - d) / 10) return -(start + 1);
                v = v * 10 + d;
                ++i;
            }
        }
        ++count;
        if (i < n) ++i;  // consume newline
    }
    return count;
}

// streaming chain data-line text -> PAF cg CIGAR + stats in ONE pass (no
// intermediate arrays): parse_chain_lines' grammar fused with
// chain_arrays_to_cg's emission.  stats as in chain_arrays_to_cg.
// Returns bytes written, -(pos+1) at the first malformed token, or
// INT64_MIN if cap is too small.
int64_t chain_text_to_cg(const char* s, int64_t n, int64_t* stats, char* out,
                         int64_t cap) {
    int64_t w = 0;
    int64_t match = 0, ins_ev = 0, ins_ct = 0, del_ev = 0, del_ct = 0;
    int64_t i = 0;
    while (i < n) {
        while (i < n && (s[i] == ' ' || s[i] == '\t' || s[i] == '\r')) ++i;
        if (i < n && s[i] == '\n') { ++i; continue; }
        if (i >= n) break;
        int64_t vals[3] = {0, 0, 0};
        int field = 0;
        while (i < n && s[i] != '\n') {
            while (i < n && (s[i] == ' ' || s[i] == '\t' || s[i] == '\r'))
                ++i;
            if (i >= n || s[i] == '\n') break;
            if (s[i] < '0' || s[i] > '9') return -(i + 1);
            int64_t start = i;
            int64_t v = 0;
            while (i < n && s[i] >= '0' && s[i] <= '9') {
                int64_t d = s[i] - '0';
                // overflow guard (round-5 review finding): error like
                // the reference's u64 parse, never wrap into a bogus
                // negative cg token
                if (v > (INT64_MAX - d) / 10) return -(start + 1);
                v = v * 10 + d;
                ++i;
            }
            if (field < 3) vals[field] = v;
            ++field;
        }
        if (i < n) ++i;  // consume newline
        int64_t sz = vals[0], dq = vals[1], dt = vals[2];
        if (w + 66 > cap) return INT64_MIN;
        match += sz;
        w += write_i64(out + w, sz);
        out[w++] = 'M';
        if (dt > 0) {
            ++ins_ev; ins_ct += dt;
            w += write_i64(out + w, dt);
            out[w++] = 'I';
        }
        if (dq > 0) {
            ++del_ev; del_ct += dq;
            w += write_i64(out + w, dq);
            out[w++] = 'D';
        }
    }
    stats[0] = match; stats[1] = ins_ev; stats[2] = ins_ct;
    stats[3] = del_ev; stats[4] = del_ct;
    return w;
}

// fused CIGAR ops -> chain data-line text + header meta in ONE pass: the
// paf2chain/maf2chain hot body (reference cigar.rs:155-245 trims,
// cigar.rs:460-490 cigar_unit_chain state machine, converter.rs:148-173
// emission).  M/=/X accumulate size (zero-diff runs merge); I accumulates
// target_diff, D query_diff; a line "\n<size>\t<dq>\t<dt>" is emitted when
// a new M run starts with pending diffs.  Leading I/D sum into the head
// trims; I/D after the last M set (overwrite) the tail trims.
// meta[0..5] = {head_ins, head_del, tail_ins, tail_del, final_size,
// bad_op_byte}.  Returns bytes written; -1 if cap is too small; -2 on an
// invalid op (meta[5] = the op byte).
int64_t ops_to_chain_block(const uint8_t* ops, const int64_t* lens,
                           int64_t n_ops, int64_t* meta, char* out,
                           int64_t cap) {
    int64_t head_ins = 0, head_del = 0, tail_ins = 0, tail_del = 0;
    int64_t cur = 0, dq = 0, dt = 0;
    bool seen_m = false;
    int64_t w = 0;
    for (int64_t k = 0; k < n_ops; ++k) {
        uint8_t op = ops[k];
        int64_t L = lens[k];
        if (op == 'M' || op == '=' || op == 'X') {
            if (!seen_m) {
                seen_m = true;
                cur = L;
            } else if (cur != 0 && (dq != 0 || dt != 0)) {
                // flush gated on BOTH a nonzero size and nonzero diffs
                // (cigar_unit_chain, cigar.rs:467-470); when cur == 0
                // the pending diffs are DROPPED below, exactly like the
                // reference's unconditional diff reset in the M arm
                // (round-5 review finding: a '0M' between diffs)
                if (w + 66 > cap) return -1;
                out[w++] = '\n';
                w += write_i64(out + w, cur);
                out[w++] = '\t';
                w += write_i64(out + w, dq);
                out[w++] = '\t';
                w += write_i64(out + w, dt);
                cur = L;
            } else {
                cur += L;
            }
            dq = dt = 0;
            tail_ins = tail_del = 0;
        } else if (op == 'I') {
            if (!seen_m) head_ins += L; else dt += L;
            tail_ins = L;
        } else if (op == 'D') {
            if (!seen_m) head_del += L; else dq += L;
            tail_del = L;
        } else {
            meta[5] = (int64_t)op;
            return -2;
        }
    }
    meta[0] = head_ins; meta[1] = head_del;
    meta[2] = tail_ins; meta[3] = tail_del;
    meta[4] = cur;
    return w;
}

// text-input variant of ops_to_chain_block: tokenizes the CIGAR inline
// (one native call per record on the paf2chain hot path).  Same contract,
// plus return -3 with meta[5] = byte pos on a malformed numeric token.
int64_t cigar_text_to_chain_block(const char* s, int64_t n, int64_t* meta,
                                  char* out, int64_t cap) {
    int64_t head_ins = 0, head_del = 0, tail_ins = 0, tail_del = 0;
    int64_t cur = 0, dq = 0, dt = 0;
    bool seen_m = false;
    int64_t w = 0;
    int64_t i = 0;
    while (i < n) {
        int64_t tok = i, L = 0;
        while (i < n && s[i] >= '0' && s[i] <= '9') {
            int64_t d = s[i] - '0';
            if (L > (INT64_MAX - d) / 10) { meta[5] = tok; return -3; }
            L = L * 10 + d;
            ++i;
        }
        if (i == tok || i >= n) { meta[5] = i; return -3; }
        char op = s[i++];
        if (op == 'M' || op == '=' || op == 'X') {
            if (!seen_m) {
                seen_m = true;
                cur = L;
            } else if (cur != 0 && (dq != 0 || dt != 0)) {
                // flush gated on BOTH a nonzero size and nonzero diffs
                // (cigar_unit_chain, cigar.rs:467-470); when cur == 0
                // the pending diffs are DROPPED below, exactly like the
                // reference's unconditional diff reset in the M arm
                // (round-5 review finding: a '0M' between diffs)
                if (w + 66 > cap) return -1;
                out[w++] = '\n';
                w += write_i64(out + w, cur);
                out[w++] = '\t';
                w += write_i64(out + w, dq);
                out[w++] = '\t';
                w += write_i64(out + w, dt);
                cur = L;
            } else {
                cur += L;
            }
            dq = dt = 0;
            tail_ins = tail_del = 0;
        } else if (op == 'I') {
            if (!seen_m) head_ins += L; else dt += L;
            tail_ins = L;
        } else if (op == 'D') {
            if (!seen_m) head_del += L; else dq += L;
            tail_del = L;
        } else {
            meta[5] = (int64_t)(uint8_t)op;
            return -2;
        }
    }
    meta[0] = head_ins; meta[1] = head_del;
    meta[2] = tail_ins; meta[3] = tail_del;
    meta[4] = cur;
    return w;
}

// dotplot base-level segment emission (emit_baseplotdatas state machine,
// reference cigar.rs:815-952): indels at or below `cutoff` merge into the
// flanking match segment; larger ones emit their own I/D segment and break
// the match chain.  `ops` are CIGAR op chars; `negative` swaps the query
// ends at segment creation and extends query_start instead of query_end.
// Returns the segment count (bounded by n).
int64_t plot_segments(const uint8_t* ops, const int64_t* lens, int64_t n,
                      int64_t ref_off, int64_t q_off, int negative,
                      int64_t cutoff, int64_t* rs, int64_t* re,
                      int64_t* qs, int64_t* qe, uint8_t* cg) {
    int64_t m = 0;
    bool last_m = false;
    for (int64_t i = 0; i < n; ++i) {
        uint8_t op = ops[i];
        int64_t len = lens[i];
        if (op == 'M' || op == '=' || op == 'X') {
            int64_t ref_end = ref_off + len, q_end = q_off + len;
            if (!last_m) {
                rs[m] = ref_off; re[m] = ref_end;
                if (negative) { qs[m] = q_end; qe[m] = q_off; }
                else         { qs[m] = q_off; qe[m] = q_end; }
                cg[m] = 'M'; ++m;
            } else {
                re[m - 1] = ref_end;
                if (negative) qs[m - 1] = q_end; else qe[m - 1] = q_end;
            }
            ref_off += len; q_off += len; last_m = true;
        } else if (op == 'I') {
            int64_t q_end = q_off + len;
            if (len > cutoff) {
                rs[m] = ref_off; re[m] = ref_off;
                if (negative) { qs[m] = q_end; qe[m] = q_off; }
                else         { qs[m] = q_off; qe[m] = q_end; }
                cg[m] = 'I'; ++m; last_m = false;
            } else if (last_m) {
                if (negative) qs[m - 1] = q_end; else qe[m - 1] = q_end;
            }
            q_off += len;
        } else if (op == 'D') {
            int64_t ref_end = ref_off + len;
            if (len > cutoff) {
                rs[m] = ref_off; re[m] = ref_end;
                qs[m] = q_off; qe[m] = q_off;
                cg[m] = 'D'; ++m; last_m = false;
            } else if (last_m) {
                re[m - 1] = ref_end;
            }
            ref_off += len;
        }
        // any other op advances nothing, like the Python/reference walk
    }
    return m;
}

static inline int64_t cp_clamp(uint8_t* dst, int64_t w, const uint8_t* src,
                               int64_t len, int64_t off, int64_t L) {
    // copy L bytes from src[off..], clamping reads past the end to the
    // last byte (matches the numpy min(cum_index, len-1) gather)
    int64_t avail = len - off;
    if (avail < 0) avail = 0;
    int64_t c = avail < L ? avail : L;
    if (c > 0) memcpy(dst + w, src + off, c);
    if (c < L) memset(dst + w + c, src[len - 1], L - c);
    return L;
}

// chain data lines -> gapped sequences, fused (the op_arrays interleave
// {size}M {dt}I {dq}D of chain.rs:580-582 fed through gap insertion,
// without materializing the op arrays).  Same clamp semantics as
// insert_gaps.  Returns total columns written.
int64_t chain_insert_gaps(const int64_t* sizes, const int64_t* dqs,
                          const int64_t* dts, int64_t n,
                          const uint8_t* t_raw, int64_t t_len,
                          const uint8_t* q_raw, int64_t q_len,
                          uint8_t* t_out, uint8_t* q_out) {
    int64_t t_off = 0, q_off = 0, w = 0;
    for (int64_t k = 0; k < n; ++k) {
        int64_t m = sizes[k], dt = dts[k], dq = dqs[k];
        if (m > 0) {
            cp_clamp(t_out, w, t_raw, t_len, t_off, m);
            cp_clamp(q_out, w, q_raw, q_len, q_off, m);
            t_off += m; q_off += m; w += m;
        }
        if (dt > 0) {  // I: gap target, consume query
            memset(t_out + w, '-', dt);
            cp_clamp(q_out, w, q_raw, q_len, q_off, dt);
            q_off += dt; w += dt;
        }
        if (dq > 0) {  // D: gap query, consume target
            memset(q_out + w, '-', dq);
            cp_clamp(t_out, w, t_raw, t_len, t_off, dq);
            t_off += dq; w += dq;
        }
    }
    return w;
}

// gap insertion (parse_cigar_to_insert, reference cigar.rs:492-551):
// M/'='/'X' copy both sources, I gaps the target while consuming query,
// D gaps the query while consuming target.  Reads past the source end
// clamp to its LAST byte (the numpy formulation gathers via
// min(cum_index, len-1) -- callers substitute "-" for empty sources).
// Returns 0, or the invalid op byte negated for an op outside M/=/X/I/D.
int64_t insert_gaps(const uint8_t* ops, const int64_t* lens, int64_t n,
                    const uint8_t* t_raw, int64_t t_len,
                    const uint8_t* q_raw, int64_t q_len,
                    uint8_t* t_out, uint8_t* q_out) {
    int64_t t_off = 0, q_off = 0, w = 0;
    for (int64_t k = 0; k < n; ++k) {
        uint8_t op = ops[k];
        int64_t L = lens[k];
        bool take_t = (op == 'M' || op == '=' || op == 'X' || op == 'D');
        bool take_q = (op == 'M' || op == '=' || op == 'X' || op == 'I');
        if (!take_t && !take_q) return -(int64_t)op;
        if (take_t) {
            int64_t avail = t_len - t_off;
            if (avail < 0) avail = 0;
            int64_t c = avail < L ? avail : L;
            if (c > 0) memcpy(t_out + w, t_raw + t_off, c);
            if (c < L) memset(t_out + w + c, t_raw[t_len - 1], L - c);
            t_off += L;
        } else {
            memset(t_out + w, '-', L);
        }
        if (take_q) {
            int64_t avail = q_len - q_off;
            if (avail < 0) avail = 0;
            int64_t c = avail < L ? avail : L;
            if (c > 0) memcpy(q_out + w, q_raw + q_off, c);
            if (c < L) memset(q_out + w + c, q_raw[q_len - 1], L - c);
            q_off += L;
        } else {
            memset(q_out + w, '-', L);
        }
        w += L;
    }
    return 0;
}

// fused CIGAR text -> coverage difference array (tokenize +
// update_cov_vec walk, reference cigar.rs:59-75 + 710-741): M/'=' spans
// scatter +1 at span start and -1 at span end into the int32 difference
// array (length diff_len, clipped like the numpy path); I and S do not
// advance the cursor, every other op does.  Returns 0 or -(pos+1) on a
// malformed numeric token at byte pos.
int64_t cigar_cov_diff(const char* s, int64_t n, int64_t start,
                       int32_t* diff, int64_t diff_len) {
    int64_t pos = start;
    int64_t i = 0;
    while (i < n) {
        int64_t tok = i, len = 0;
        while (i < n && s[i] >= '0' && s[i] <= '9') {
            int64_t d = s[i] - '0';
            if (len > (INT64_MAX - d) / 10) return -(tok + 1);
            len = len * 10 + d;
            ++i;
        }
        if (i == tok || i >= n) return -(i + 1);
        char op = s[i++];
        if (op == 'M' || op == '=') {
            int64_t a = pos < 0 ? 0 : pos;
            int64_t b = pos + len < 0 ? 0 : pos + len;
            if (a < diff_len) ++diff[a];
            if (b < diff_len) --diff[b];
        }
        if (op != 'I' && op != 'S') pos += len;
    }
    return 0;
}

// fully fused dotplot hot body: CIGAR text -> base-level plot rows in one
// pass (tokenize + plot_segments state machine + row formatting).  A
// pending-segment register delays emission until a segment can no longer
// be extended (the state machine mutates the LAST segment on merges).
// csv=0 emits ','-joined serde_json objects (lead_comma prefixes the
// first); csv=1 emits '\n'-terminated CSV lines (lead_comma ignored).
// Returns bytes written, -1 if cap too small, or -(pos+2) on a malformed
// numeric token at byte pos (tokenize_cigar contract, shifted past -1).
int64_t cigar_text_to_plotdata(const char* s, int64_t n,
                               int64_t ref_off, int64_t q_off, int negative,
                               int64_t cutoff,
                               const char* rname, int64_t rname_len,
                               const char* qname, int64_t qname_len,
                               int lead_comma, int csv,
                               char* out, int64_t cap) {
    int64_t w = 0;
    bool have = false, first = true, overflow = false;
    int64_t prs = 0, pre = 0, pqs = 0, pqe = 0;
    char pcg = 'M';
    int64_t room = rname_len + qname_len + 208;

    auto flush = [&]() {
        if (!have) return;
        if (w + room > cap) { overflow = true; return; }
        if (csv) {
            w += write_i64(out + w, prs); out[w++] = ',';
            w += write_i64(out + w, pre); out[w++] = ',';
            w += write_i64(out + w, pqs); out[w++] = ',';
            w += write_i64(out + w, pqe); out[w++] = ',';
            out[w++] = pcg; out[w++] = ',';
            memcpy(out + w, rname, rname_len); w += rname_len;
            out[w++] = ',';
            memcpy(out + w, qname, qname_len); w += qname_len;
            out[w++] = '\n';
        } else {
            if (!first || lead_comma) out[w++] = ',';
            memcpy(out + w, "{\"cigar\":\"", 10); w += 10;
            out[w++] = pcg;
            memcpy(out + w, "\",\"query_chro\":", 15); w += 15;
            memcpy(out + w, qname, qname_len); w += qname_len;
            memcpy(out + w, ",\"query_end\":", 13); w += 13;
            w += write_i64(out + w, pqe);
            memcpy(out + w, ",\"query_start\":", 15); w += 15;
            w += write_i64(out + w, pqs);
            memcpy(out + w, ",\"ref_chro\":", 12); w += 12;
            memcpy(out + w, rname, rname_len); w += rname_len;
            memcpy(out + w, ",\"ref_end\":", 11); w += 11;
            w += write_i64(out + w, pre);
            memcpy(out + w, ",\"ref_start\":", 13); w += 13;
            w += write_i64(out + w, prs);
            out[w++] = '}';
        }
        first = false;
        have = false;
    };

    bool last_m = false;
    int64_t i = 0;
    while (i < n) {
        int64_t start = i, len = 0;
        while (i < n && s[i] >= '0' && s[i] <= '9') {
            int64_t d = s[i] - '0';
            if (len > (INT64_MAX - d) / 10) return -(start + 2);
            len = len * 10 + d;
            ++i;
        }
        if (i == start || i >= n) return -(i + 2);
        char op = s[i++];
        if (op == 'M' || op == '=' || op == 'X') {
            int64_t ref_end = ref_off + len, q_end = q_off + len;
            if (!last_m) {
                flush();
                prs = ref_off; pre = ref_end;
                if (negative) { pqs = q_end; pqe = q_off; }
                else         { pqs = q_off; pqe = q_end; }
                pcg = 'M'; have = true;
            } else {
                pre = ref_end;
                if (negative) pqs = q_end; else pqe = q_end;
            }
            ref_off += len; q_off += len; last_m = true;
        } else if (op == 'I') {
            int64_t q_end = q_off + len;
            if (len > cutoff) {
                flush();
                prs = ref_off; pre = ref_off;
                if (negative) { pqs = q_end; pqe = q_off; }
                else         { pqs = q_off; pqe = q_end; }
                pcg = 'I'; have = true; last_m = false;
            } else if (last_m && have) {
                if (negative) pqs = q_end; else pqe = q_end;
            }
            q_off += len;
        } else if (op == 'D') {
            int64_t ref_end = ref_off + len;
            if (len > cutoff) {
                flush();
                prs = ref_off; pre = ref_end;
                pqs = q_off; pqe = q_off;
                pcg = 'D'; have = true; last_m = false;
            } else if (last_m && have) {
                pre = ref_end;
            }
            ref_off += len;
        }
        if (overflow) return -1;
    }
    flush();
    if (overflow) return -1;
    return w;
}

// serde_json rows for base-level plot data in serde's BTreeMap key order:
// cigar, query_chro, query_end, query_start, ref_chro, ref_end, ref_start.
// Names arrive pre-escaped as complete JSON string tokens (quotes
// included).  Rows are ','-joined; lead_comma prefixes the first row.
// Returns bytes written or -1 if cap is too small.
int64_t format_plotdata_json(const int64_t* rs, const int64_t* re,
                             const int64_t* qs, const int64_t* qe,
                             const uint8_t* cg, int64_t n,
                             const char* rname, int64_t rname_len,
                             const char* qname, int64_t qname_len,
                             int lead_comma, char* out, int64_t cap) {
    int64_t w = 0;
    for (int64_t i = 0; i < n; ++i) {
        if (w + rname_len + qname_len + 200 > cap) return -1;
        if (i || lead_comma) out[w++] = ',';
        memcpy(out + w, "{\"cigar\":\"", 10); w += 10;
        out[w++] = (char)cg[i];
        memcpy(out + w, "\",\"query_chro\":", 15); w += 15;
        memcpy(out + w, qname, qname_len); w += qname_len;
        memcpy(out + w, ",\"query_end\":", 13); w += 13;
        w += write_i64(out + w, qe[i]);
        memcpy(out + w, ",\"query_start\":", 15); w += 15;
        w += write_i64(out + w, qs[i]);
        memcpy(out + w, ",\"ref_chro\":", 12); w += 12;
        memcpy(out + w, rname, rname_len); w += rname_len;
        memcpy(out + w, ",\"ref_end\":", 11); w += 11;
        w += write_i64(out + w, re[i]);
        memcpy(out + w, ",\"ref_start\":", 13); w += 13;
        w += write_i64(out + w, rs[i]);
        out[w++] = '}';
    }
    return w;
}

// CSV lines for base-level plot data in BASE_FIELDS order:
// ref_start,ref_end,query_start,query_end,cigar,ref_chro,query_chro.
// Names arrive pre-quoted per the csv crate's rules.  Each line ends
// with '\n'.  Returns bytes written or -1 if cap is too small.
int64_t format_plotdata_csv(const int64_t* rs, const int64_t* re,
                            const int64_t* qs, const int64_t* qe,
                            const uint8_t* cg, int64_t n,
                            const char* rname, int64_t rname_len,
                            const char* qname, int64_t qname_len,
                            char* out, int64_t cap) {
    int64_t w = 0;
    for (int64_t i = 0; i < n; ++i) {
        if (w + rname_len + qname_len + 100 > cap) return -1;
        w += write_i64(out + w, rs[i]); out[w++] = ',';
        w += write_i64(out + w, re[i]); out[w++] = ',';
        w += write_i64(out + w, qs[i]); out[w++] = ',';
        w += write_i64(out + w, qe[i]); out[w++] = ',';
        out[w++] = (char)cg[i]; out[w++] = ',';
        memcpy(out + w, rname, rname_len); w += rname_len;
        out[w++] = ',';
        memcpy(out + w, qname, qname_len); w += qname_len;
        out[w++] = '\n';
    }
    return w;
}

// bulk-format SNP VCF rows:
//   "<chrom>\t<pos+1>\t.\t<ref>\t<alt>\t.\t.\t.\tGT:QI\t1|1:<qchro>@<qpos>@<sfx>\n"
// ref/alt are single uppercase bases given as parallel byte arrays.
// row_end (nullable) receives the end byte offset of each row, letting the
// caller make ONE call for a whole chunk and slice the blob at indel-event
// boundaries (the caller interleaves SNP blocks with indel rows in run
// order, caller.rs:575-605).
// Returns bytes written or -1 if cap too small.
int64_t format_snp_rows(const char* chrom, int64_t chrom_len,
                        const char* qchro, int64_t qchro_len, char suffix,
                        const int64_t* pos, const int64_t* qpos,
                        const uint8_t* ref, const uint8_t* alt, int64_t n,
                        char* out, int64_t cap, int64_t* row_end) {
    static const char mid[] = "\t.\t";
    int64_t w = 0;
    for (int64_t i = 0; i < n; ++i) {
        if (w + chrom_len + qchro_len + 96 > cap) return -1;
        memcpy(out + w, chrom, chrom_len);
        w += chrom_len;
        out[w++] = '\t';
        w += write_i64(out + w, pos[i] + 1);
        memcpy(out + w, mid, 3); w += 3;            // \t.\t
        out[w++] = (char)ref[i];
        out[w++] = '\t';
        out[w++] = (char)alt[i];
        memcpy(out + w, "\t.\t.\t.\tGT:QI\t1|1:", 17); w += 17;
        memcpy(out + w, qchro, qchro_len); w += qchro_len;
        out[w++] = '@';
        w += write_i64(out + w, qpos[i]);
        out[w++] = '@';
        out[w++] = suffix;
        out[w++] = '\n';
        if (row_end) row_end[i] = w;
    }
    return w;
}

// 4-bit dictionary packing for the nibble classify kernel
// (ops/classify.py pack_nibble_words; the device kernel covers 8 columns
// per int32 lane).  lut256 maps byte -> 4-bit code with 0xFF marking
// out-of-dictionary bytes (the Python side owns the alphabet so the two
// can never drift).  Packs byte pairs low-nibble-first -- the same
// little-endian nibble order as numpy's c[:,0::2] | (c[:,1::2] << 4).
// n must be even.  Returns 0 on success, -1 on any out-of-dictionary
// byte (callers fall back to the byte-word kernel).
int32_t pack_nibbles(const uint8_t* src, int64_t n, const uint8_t* lut256,
                     uint8_t* dst) {
    uint8_t bad = 0;
    for (int64_t i = 0; i + 1 < n; i += 2) {
        uint8_t a = lut256[src[i]];
        uint8_t b = lut256[src[i + 1]];
        bad |= a | b;
        dst[i >> 1] = (uint8_t)((a & 0x0F) | (b << 4));
    }
    return (bad & 0x80) ? -1 : 0;
}

// CATEGORY-plane packing for the cat classify kernel (round 5,
// ops/classify.py pack_cat_nibbles): one nibble per COLUMN holding the
// classification of the (t, q) byte pair via a 64K (t << 8 | q) -> code
// LUT built on the Python side (one-hot codes X=0 EQ=1 I=2 D=4 GG=9).
// HALF the device input of the two nibble planes, and no dictionary
// restriction at all -- every byte pair classifies through the LUT.
// n must be even.  Never fails (the LUT is total).
void pack_cats(const uint8_t* t, const uint8_t* q, int64_t n,
               const uint8_t* lut64k, uint8_t* dst) {
    for (int64_t i = 0; i + 1 < n; i += 2) {
        uint8_t a = lut64k[((uint32_t)t[i] << 8) | q[i]];
        uint8_t b = lut64k[((uint32_t)t[i + 1] << 8) | q[i + 1]];
        dst[i >> 1] = (uint8_t)(a | (b << 4));
    }
}

// The same category nibbles, packed from each row where it lies instead
// of from padded byte planes (ops/batch.py pack_cat_plane): row k's lens[k]
// columns, read at the addresses t_addr[k] and q_addr[k], go to
// dst + k * row_bytes, two columns a byte.  A row's odd last column fills
// the low nibble of its last byte.  Nothing past a row's last byte is
// written: the kernel and its plain version mask every column at or past
// lens[k].
void pack_cat_rows(const int64_t* t_addr, const int64_t* q_addr,
                   const int32_t* lens, int64_t B, int64_t row_bytes,
                   const uint8_t* lut64k, uint8_t* dst) {
    for (int64_t k = 0; k < B; ++k) {
        const uint8_t* t = (const uint8_t*)(intptr_t)t_addr[k];
        const uint8_t* q = (const uint8_t*)(intptr_t)q_addr[k];
        uint8_t* d = dst + k * row_bytes;
        int64_t n = lens[k], i = 0;
        for (; i + 1 < n; i += 2) {
            uint8_t a = lut64k[((uint32_t)t[i] << 8) | q[i]];
            uint8_t b = lut64k[((uint32_t)t[i + 1] << 8) | q[i + 1]];
            d[i >> 1] = (uint8_t)(a | (b << 4));
        }
        if (i < n) d[i >> 1] = lut64k[((uint32_t)t[i] << 8) | q[i]];
    }
}

// bytes.split(None)'s whitespace but '\n', which ends the line instead
static inline bool maf_ws(uint8_t c) {
    return c == ' ' || c == '\t' || c == '\r' || c == 0x0b || c == 0x0c;
}

// A run of whitespace at i and past it; true when a field follows.
static inline bool maf_sep(const uint8_t* b, int64_t& i, int64_t end) {
    if (i >= end || !maf_ws(b[i])) return false;
    while (i < end && maf_ws(b[i])) ++i;
    return i < end;
}

// io/maf.py _parse_u64 at i (i < end): an optional '+', then ASCII digits
// up to whitespace or end, at most 0x7FFFFFFFFFFFFFFF.
static inline bool maf_u63(const uint8_t* b, int64_t& i, int64_t end,
                           int64_t* v) {
    if (b[i] == '+') ++i;
    const int64_t s = i;
    uint64_t x = 0;
    for (; i < end && b[i] >= '0' && b[i] <= '9'; ++i) {
        uint64_t d = b[i] - '0';
        if (x > (0x7FFFFFFFFFFFFFFFull - d) / 10) return false;
        x = x * 10 + d;
    }
    *v = (int64_t)x;
    return i > s && (i == end || maf_ws(b[i]));
}

// The first byte at or past k outside 0x21-0x7e, or end: 64 bytes a step
// with a branch-free test, so that a sequence is read once.
static inline int64_t maf_seq_end(const uint8_t* b, int64_t k, int64_t end) {
    for (; k + 64 <= end; k += 64) {
        uint8_t out = 0;
        for (int j = 0; j < 64; ++j) out |= (uint8_t)(b[k + j] - 0x21) > 0x5d;
        if (out) break;
    }
    while (k < end && (uint8_t)(b[k] - 0x21) <= 0x5d) ++k;
    return k;
}

// The fields of the s-line at p (base[p] == 's') into row[2..9]; true when
// the line is understood fully, with i then at its end (past its '\n').
// Every test stops at a '\n', so that on false i lies inside the line.
static bool maf_fields(const uint8_t* b, int64_t p, int64_t& i, int64_t end,
                       int64_t* row) {
    i = p + 1;  // past the 's'
    if (!maf_sep(b, i, end)) return false;
    const int64_t name = i;
    for (; i < end && !maf_ws(b[i]); ++i)
        if (b[i] < 0x21 || b[i] > 0x7e) return false;
    row[2] = name;
    row[3] = i - name;
    if (!maf_sep(b, i, end) || !maf_u63(b, i, end, &row[4])) return false;
    if (!maf_sep(b, i, end) || !maf_u63(b, i, end, &row[5])) return false;
    if (!maf_sep(b, i, end) || (b[i] != '+' && b[i] != '-')) return false;
    row[6] = b[i++] == '-';
    if (i < end && !maf_ws(b[i])) return false;
    if (!maf_sep(b, i, end) || !maf_u63(b, i, end, &row[7])) return false;
    if (!maf_sep(b, i, end)) return false;
    const int64_t seq = i;
    i = maf_seq_end(b, i, end);
    row[8] = seq;
    row[9] = i;
    if (i == seq) return false;
    while (i < end && maf_ws(b[i])) ++i;  // trailing whitespace
    if (i == end) return true;
    return b[i++] == '\n';
}

// MAF s-line blocks of base[start, end) in io/maf.py MafReader's grammar:
// a block is a maximal run of lines (split at '\n') whose first byte is
// 's'; any other line ends it and is consumed.  A line is tokenized only
// when it is fully understood: "s", then 6 fields split on runs of
// bytes.split(None)'s whitespace, the name of bytes 0x21-0x7e, start,
// align_size and size an optional '+' and ASCII digits of at most
// 0x7FFFFFFFFFFFFFFF, the strand '+' or '-', the sequence of bytes
// 0x21-0x7e up to trailing whitespace and the line's end.  Any other
// s-line is refused, and with it its block: the caller parses the lines
// of a refused block with parse_sline, so every input keeps MafReader's
// records and errors.  lines[k * 10 ...]: line start, line end (past its
// '\n'), name offset, name length, start, align_size, strand (1 for '-'),
// size, sequence start, sequence end (the fields only when its block is
// tokenized); a name equal to that of the line at the same place in the
// previous block of the call gets that line's name offset, so that the
// caller decodes it once.  blocks[b * 3 ...]: first line, line count, 1
// when every line was tokenized.  Returns the blocks written, at most
// cap_blocks, and sets *resume to the first offset not consumed; -1 when
// the first block alone has more than cap_lines lines.
int64_t scan_maf_blocks(const uint8_t* base, int64_t start, int64_t end,
                        int64_t cap_blocks, int64_t cap_lines,
                        int64_t* blocks, int64_t* lines, int64_t* resume) {
    int64_t p = start, nb = 0, nl = 0;
    int64_t prev = 0, prev_n = 0;  // the last tokenized block's lines
    while (p < end && nb < cap_blocks) {
        if (base[p] != 's') {
            const void* nlp = memchr(base + p, '\n', end - p);
            p = nlp ? (const uint8_t*)nlp - base + 1 : end;
            continue;
        }
        const int64_t first = nl, block = p;
        bool ok = true;
        while (p < end && base[p] == 's') {
            if (nl == cap_lines) {
                *resume = block;
                return first == 0 ? -1 : nb;
            }
            int64_t* row = lines + nl * 10;
            int64_t le;
            if (!maf_fields(base, p, le, end, row)) {
                ok = false;
                const void* nlp = memchr(base + le, '\n', end - le);
                le = nlp ? (const uint8_t*)nlp - base + 1 : end;
            }
            row[0] = p;
            row[1] = le;
            const int64_t* same = lines + (prev + nl - first) * 10;
            if (ok && nl - first < prev_n && same[3] == row[3] &&
                memcmp(base + same[2], base + row[2], row[3]) == 0)
                row[2] = same[2];
            ++nl;
            p = le;
        }
        if (ok) {
            prev = first;
            prev_n = nl - first;
        }
        blocks[nb * 3] = first;
        blocks[nb * 3 + 1] = nl - first;
        blocks[nb * 3 + 2] = ok;
        ++nb;
    }
    *resume = p;
    return nb;
}

// bulk-format indel (INS/DEL) VCF rows in event order, byte-identical to
// tools/caller.py write_record() on the tuples _emit_variant_rows_vec
// built per event (reference row shapes: caller.rs:500-561):
//   INS: "<chrom>\t<to>\t.\t<t[ts]>\t<q[qs..qs+ln]>\t.\t.\t"
//        "<init_info>SVTYPE=INS;SVLEN=<ln>;END=<to>\tGT:QI\t"
//        "1|1:<qchro>@<qo>@<qo+ln>@<sfx>\n"
//   DEL: ref/alt swap roles, END=<to+ln>, QI "@<qo>@<qo>@".
// tseq/qseq are the gap-free UPPERCASED sequences (lengths
// tseq_len/qseq_len) starting at t_start/q_start (ts = to - t_start - 1
// >= 0 because every emitted event follows a match run and the Python
// side filters negative-anchor events).  is_del[i] selects the row
// shape.  row_end receives each row's end offset (for run-order
// interleaving with SNP blocks).  Returns bytes written, or -1 if cap
// is too small OR any event's slice falls outside [0, seq_len) --
// malformed offsets never read out of bounds; the Python fallback
// takes over.
int64_t format_indel_rows(const char* chrom, int64_t chrom_len,
                          const char* qchro, int64_t qchro_len, char suffix,
                          const char* init_info, int64_t init_info_len,
                          const uint8_t* tseq, int64_t tseq_len,
                          const uint8_t* qseq, int64_t qseq_len,
                          int64_t t_start, int64_t q_start,
                          const int64_t* t_off, const int64_t* q_off,
                          const int64_t* lens, const uint8_t* is_del,
                          int64_t n, char* out, int64_t cap,
                          int64_t* row_end) {
    for (int64_t i = 0; i < n; ++i) {
        int64_t to = t_off[i], qo = q_off[i], ln = lens[i];
        int64_t ts = to - t_start - 1;
        int64_t qs = qo - q_start - 1;
        if (ts < 0 || qs < 0 || ln < 0) return -1;
        // DEL reads tseq[ts..ts+ln] + qseq[qs]; INS reads tseq[ts] +
        // qseq[qs..qs+ln] -- bound BOTH sides of each slice
        int64_t t_need = is_del[i] ? ts + ln + 1 : ts + 1;
        int64_t q_need = is_del[i] ? qs + 1 : qs + ln + 1;
        if (t_need > tseq_len || q_need > qseq_len) return -1;
        int64_t w = (i == 0) ? 0 : row_end[i - 1];
        if (w + chrom_len + qchro_len + init_info_len + ln + 152 > cap)
            return -1;
        memcpy(out + w, chrom, chrom_len); w += chrom_len;
        out[w++] = '\t';
        w += write_i64(out + w, to);
        memcpy(out + w, "\t.\t", 3); w += 3;
        if (is_del[i]) {
            memcpy(out + w, tseq + ts, (size_t)(ln + 1)); w += ln + 1;
            out[w++] = '\t';
            out[w++] = (char)qseq[qs];
        } else {
            out[w++] = (char)tseq[ts];
            out[w++] = '\t';
            memcpy(out + w, qseq + qs, (size_t)(ln + 1)); w += ln + 1;
        }
        memcpy(out + w, "\t.\t.\t", 5); w += 5;
        memcpy(out + w, init_info, init_info_len); w += init_info_len;
        memcpy(out + w, "SVTYPE=", 7); w += 7;
        memcpy(out + w, is_del[i] ? "DEL" : "INS", 3); w += 3;
        memcpy(out + w, ";SVLEN=", 7); w += 7;
        w += write_i64(out + w, ln);
        memcpy(out + w, ";END=", 5); w += 5;
        w += write_i64(out + w, is_del[i] ? to + ln : to);
        memcpy(out + w, "\tGT:QI\t1|1:", 11); w += 11;
        memcpy(out + w, qchro, qchro_len); w += qchro_len;
        out[w++] = '@';
        w += write_i64(out + w, qo);
        out[w++] = '@';
        w += write_i64(out + w, is_del[i] ? qo : qo + ln);
        out[w++] = '@';
        out[w++] = suffix;
        out[w++] = '\n';
        row_end[i] = w;
    }
    return n ? row_end[n - 1] : 0;
}

}  // extern "C"
