// CPU Aho-Corasick oracle — conformance ground truth at corpus scale.
//
// A third, independent matcher implementation (besides core/oracle.py's
// brute-force and dict-based walkers): classic goto/fail automaton with
// sparse per-node edge lists, walked with failure links (no dense DFA
// closure — deliberately a different construction than the framework's
// dense-table compiler so bugs can't be shared). Plays the ground-truth
// role BASELINE.json assigns to the reference's acsmx.c on the ClamAV
// conformance corpora.
//
// C ABI for ctypes. Symbols are generic int32 so the ushort (alphabet 2048)
// mode reuses the same oracle.

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

struct Node {
    // sorted (symbol, next) edge list; binary search on walk
    std::vector<std::pair<int32_t, int32_t>> edges;
    std::vector<int32_t> out;  // pattern indices ending here (closure)
    int32_t fail = 0;
};

struct Oracle {
    std::vector<Node> nodes;
    std::vector<int32_t> root_next;  // dense root row: the walk spends most
                                     // of its time at/near the root
    int32_t alphabet = 256;

    int32_t child(int32_t s, int32_t c) const {
        const auto &e = nodes[s].edges;
        size_t lo = 0, hi = e.size();
        while (lo < hi) {
            size_t mid = (lo + hi) / 2;
            if (e[mid].first < c)
                lo = mid + 1;
            else
                hi = mid;
        }
        if (lo < e.size() && e[lo].first == c) return e[lo].second;
        return -1;
    }

    void add_edge(int32_t s, int32_t c, int32_t t) {
        auto &e = nodes[s].edges;
        auto it = e.begin();
        while (it != e.end() && it->first < c) ++it;
        e.insert(it, {c, t});
    }
};

}  // namespace

// sym_bytes selects the input element width: 1 = uint8 (byte alphabet),
// 2 = uint16 (the ushort packet-metadata alphabet), 4 = int32.
// lane_stride is in ELEMENTS. Out-of-alphabet symbols reset to the root
// (no pattern contains them — same contract as oracle_match).
template <typename SYM>
static int64_t dense_walk(const int32_t *table, int32_t alphabet,
                          const SYM *data, int64_t lane_stride,
                          const int32_t *lanes, const int64_t *w0s,
                          const int64_t *w1s, const int64_t *keep_los,
                          const int64_t *keep_his, int64_t n_windows,
                          int32_t *out_lane, int64_t *out_end,
                          int32_t *out_state, int64_t cap) {
    // The walk is memory-latency bound: depth>=2 table rows of a big
    // automaton miss L2, so a one-window-at-a-time loop pays a full miss
    // per byte. Interleave GN independent windows so their loads overlap
    // (memory-level parallelism) — measured ~an order of magnitude faster
    // at ClamAV scale.
    constexpr int GN = 16;
    int64_t total = 0;
    for (int64_t base = 0; base < n_windows; base += GN) {
        const int g = (int)((n_windows - base < GN) ? n_windows - base : GN);
        const SYM *rows[GN];
        int64_t i1[GN], lo[GN], hi[GN], start[GN];
        int32_t st[GN];
        int64_t maxlen = 0;
        for (int j = 0; j < g; ++j) {
            const int64_t w = base + j;
            rows[j] = data + (int64_t)lanes[w] * lane_stride;
            start[j] = w0s[w];
            i1[j] = w1s[w];
            lo[j] = keep_los[w];
            hi[j] = keep_his[w];
            st[j] = 0;
            const int64_t len = w1s[w] - w0s[w];
            if (len > maxlen) maxlen = len;
        }
        for (int64_t off = 0; off < maxlen; ++off) {
            for (int j = 0; j < g; ++j) {
                const int64_t i = start[j] + off;
                if (i >= i1[j]) continue;
                const int32_t c = (int32_t)rows[j][i];
                if (c < 0 || c >= alphabet) {
                    st[j] = 0;
                    continue;
                }
                const int32_t raw = table[(int64_t)st[j] * alphabet + c];
                if (raw < 0) {
                    st[j] = -raw;
                    if (i >= lo[j] && i < hi[j]) {
                        if (total < cap) {
                            out_lane[total] = lanes[base + j];
                            out_end[total] = i;
                            out_state[total] = st[j];
                        }
                        ++total;
                    }
                } else {
                    st[j] = raw;
                }
            }
        }
    }
    return total;
}


extern "C" {

// Survivor-bitmap expansion: bits[w * n_cols + c] bit b set means the gram
// starting at row (w*32+b)*stride of lane c is a candidate. Emits
// (row, lane) pairs in ROW-MAJOR traversal order (the bitmap's memory
// order — a column-major walk cache-misses every word: ~9 ms vs ~0.5 ms
// at a 540k-word bitmap; the verify window merge sorts anyway). Returns
// the total candidate count; writes at most cap pairs.
// The numpy expansion of the same bitmap measured ~9.5 ms at 40k
// candidates on the bench host — a quarter of the whole decode budget;
// this loop is one ctz per set bit plus a sequential word scan.
int64_t unpack_bitmap(const uint32_t *bits, int64_t n_words_rows,
                      int64_t n_cols, int64_t stride, int64_t *out_rows,
                      int64_t *out_lanes, int64_t cap) {
    int64_t n = 0;
    const int64_t total_words = n_words_rows * n_cols;
    for (int64_t i = 0; i < total_words; ++i) {
        uint32_t v = bits[i];
        while (v) {
            int b = __builtin_ctz(v);
            v &= v - 1;
            if (n < cap) {
                out_rows[n] = ((i / n_cols) * 32 + b) * stride;
                out_lanes[n] = i % n_cols;
            }
            ++n;
        }
    }
    return n;
}

// Build from concatenated symbol arrays: patterns[i] occupies
// symbols[starts[i] .. starts[i] + lens[i]).
void *oracle_create(const int32_t *symbols, const int64_t *starts,
                    const int32_t *lens, int32_t n_patterns,
                    int32_t alphabet) {
    auto *o = new Oracle();
    o->alphabet = alphabet;
    o->nodes.emplace_back();
    for (int32_t p = 0; p < n_patterns; ++p) {
        int32_t s = 0;
        for (int32_t k = 0; k < lens[p]; ++k) {
            int32_t c = symbols[starts[p] + k];
            int32_t nxt = o->child(s, c);
            if (nxt < 0) {
                nxt = (int32_t)o->nodes.size();
                o->nodes.emplace_back();
                o->add_edge(s, c, nxt);
            }
            s = nxt;
        }
        o->nodes[s].out.push_back(p);
    }
    // dense root row (root has no fail link: missing symbol -> root)
    o->root_next.assign(alphabet, 0);
    for (auto &e : o->nodes[0].edges) o->root_next[e.first] = e.second;
    // BFS failure links + output closure
    std::vector<int32_t> queue;
    for (auto &e : o->nodes[0].edges) {
        o->nodes[e.second].fail = 0;
        queue.push_back(e.second);
    }
    for (size_t head = 0; head < queue.size(); ++head) {
        int32_t s = queue[head];
        for (auto &e : o->nodes[s].edges) {
            int32_t c = e.first, t = e.second;
            int32_t f = o->nodes[s].fail;
            while (f != 0 && o->child(f, c) < 0) f = o->nodes[f].fail;
            int32_t ft = o->child(f, c);
            o->nodes[t].fail = (ft >= 0 && ft != t) ? ft : 0;
            // output closure: inherit fail target's outputs
            const auto &inh = o->nodes[o->nodes[t].fail].out;
            auto &own = o->nodes[t].out;
            own.insert(own.end(), inh.begin(), inh.end());
            queue.push_back(t);
        }
    }
    return o;
}

void oracle_free(void *h) { delete static_cast<Oracle *>(h); }

// Walk `data` (int32 symbols) from state `*state_io`; append events
// (end_offset + offset_base, pattern_index) into out arrays up to `cap`.
// Returns the TOTAL number of events (may exceed cap); *state_io is
// updated to the final state so streams can be resumed.
int64_t oracle_match(void *h, const int32_t *data, int64_t n,
                     int64_t offset_base, int32_t *state_io,
                     int64_t *out_off, int32_t *out_pid, int64_t cap) {
    auto *o = static_cast<Oracle *>(h);
    const int32_t *root = o->root_next.data();
    int32_t s = *state_io;
    int64_t total = 0;
    for (int64_t i = 0; i < n; ++i) {
        int32_t c = data[i];
        if (c < 0 || c >= o->alphabet) {  // out-of-alphabet symbol: no
            s = 0;                        // pattern can contain it
            continue;
        }
        int32_t nxt;
        if (s == 0) {
            nxt = root[c];
        } else {
            nxt = o->child(s, c);
            while (nxt < 0 && s != 0) {
                s = o->nodes[s].fail;
                nxt = s == 0 ? root[c] : o->child(s, c);
            }
            if (nxt < 0) nxt = 0;
        }
        s = nxt;
        for (int32_t pid : o->nodes[s].out) {
            if (total < cap) {
                out_off[total] = offset_base + i;
                out_pid[total] = pid;
            }
            ++total;
        }
    }
    *state_io = s;
    return total;
}

// Byte-specialized walk (uint8 input) to avoid int32 widening on big corpora.
int64_t oracle_match_bytes(void *h, const uint8_t *data, int64_t n,
                           int64_t offset_base, int32_t *state_io,
                           int64_t *out_off, int32_t *out_pid, int64_t cap) {
    auto *o = static_cast<Oracle *>(h);
    const int32_t *root = o->root_next.data();
    int32_t s = *state_io;
    int64_t total = 0;
    for (int64_t i = 0; i < n; ++i) {
        int32_t c = data[i];
        if (c >= o->alphabet) {
            s = 0;
            continue;
        }
        int32_t nxt;
        if (s == 0) {
            nxt = root[c];
        } else {
            nxt = o->child(s, c);
            while (nxt < 0 && s != 0) {
                s = o->nodes[s].fail;
                nxt = s == 0 ? root[c] : o->child(s, c);
            }
            if (nxt < 0) nxt = 0;
        }
        s = nxt;
        if (!o->nodes[s].out.empty()) {
            for (int32_t pid : o->nodes[s].out) {
                if (total < cap) {
                    out_off[total] = offset_base + i;
                    out_pid[total] = pid;
                }
                ++total;
            }
        }
    }
    *state_io = s;
    return total;
}

// Batched window verification for the bloom filter engine
// (ops/bloom.py + runtime/verify.py): walk many small windows of a
// lane-major byte buffer in ONE call — a per-window Python/ctypes round
// trip would cap verification at <1M windows/s while the device filter
// emits tens of millions on match-heavy inputs.
//
// data is [n_lanes, lane_stride] row-major uint8. Window i scans
// data[lanes[i], w0s[i]:w1s[i]] from the root state; events whose end row
// e lies in [keep_los[i], keep_his[i]) are appended as (lane, e, pid).
// xlat, if non-null, is a 256-byte symbol translation (case folding).
// Returns the total event count (may exceed cap; callers re-run with room).
int64_t oracle_match_windows(void *h, const uint8_t *data,
                             int64_t lane_stride, const uint8_t *xlat,
                             const int32_t *lanes, const int64_t *w0s,
                             const int64_t *w1s, const int64_t *keep_los,
                             const int64_t *keep_his, int64_t n_windows,
                             int32_t *out_lane, int64_t *out_end,
                             int32_t *out_pid, int64_t cap) {
    auto *o = static_cast<Oracle *>(h);
    const int32_t *root = o->root_next.data();
    int64_t total = 0;
    for (int64_t w = 0; w < n_windows; ++w) {
        const uint8_t *row = data + (int64_t)lanes[w] * lane_stride;
        const int64_t lo = keep_los[w], hi = keep_his[w];
        int32_t s = 0;
        for (int64_t i = w0s[w]; i < w1s[w]; ++i) {
            int32_t c = xlat ? xlat[row[i]] : row[i];
            int32_t nxt;
            if (s == 0) {
                nxt = root[c];
            } else {
                nxt = o->child(s, c);
                while (nxt < 0 && s != 0) {
                    s = o->nodes[s].fail;
                    nxt = s == 0 ? root[c] : o->child(s, c);
                }
                if (nxt < 0) nxt = 0;
            }
            s = nxt;
            if (!o->nodes[s].out.empty() && i >= lo && i < hi) {
                for (int32_t pid : o->nodes[s].out) {
                    if (total < cap) {
                        out_lane[total] = lanes[w];
                        out_end[total] = i;
                        out_pid[total] = pid;
                    }
                    ++total;
                }
            }
        }
    }
    return total;
}

// Dense-table window walker: same job as oracle_match_windows but driven by
// the framework's compiled dense signed table (core/dfa.py goto_signed,
// flattened int32 [S * alphabet]; cell = next state, negated iff final) —
// two array loads per byte instead of binary-searched edge lists, ~20x
// faster per window. Emits the FINAL STATE of each match (the caller
// resolves it to the co-terminating pattern set via state_gid/groups,
// exactly like the device dense engine's decode). Case-insensitive tables
// already alias uppercase columns, so no xlat is needed here.
int64_t dense_match_windows(const int32_t *table, int32_t alphabet,
                            const void *data, int64_t lane_stride,
                            int32_t sym_bytes, const int32_t *lanes,
                            const int64_t *w0s, const int64_t *w1s,
                            const int64_t *keep_los, const int64_t *keep_his,
                            int64_t n_windows, int32_t *out_lane,
                            int64_t *out_end, int32_t *out_state,
                            int64_t cap) {
    switch (sym_bytes) {
        case 1:
            return dense_walk(table, alphabet, (const uint8_t *)data,
                              lane_stride, lanes, w0s, w1s, keep_los,
                              keep_his, n_windows, out_lane, out_end,
                              out_state, cap);
        case 2:
            return dense_walk(table, alphabet, (const uint16_t *)data,
                              lane_stride, lanes, w0s, w1s, keep_los,
                              keep_his, n_windows, out_lane, out_end,
                              out_state, cap);
        case 4:
            return dense_walk(table, alphabet, (const int32_t *)data,
                              lane_stride, lanes, w0s, w1s, keep_los,
                              keep_his, n_windows, out_lane, out_end,
                              out_state, cap);
        default:
            return -1;
    }
}

}  // extern "C"
