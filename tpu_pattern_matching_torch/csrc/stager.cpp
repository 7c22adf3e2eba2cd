// Native batch stager — the data-loader hot path.
//
// Fills chunk lanes of a [C, H+B] batch directly from a file descriptor
// using preadv (one syscall per ~IOV_MAX lanes, payload lands in-place, no
// intermediate buffer), then builds the prefix halos with small memcpys.
// Plays the role of the reference's databuf_add_fd read path
// (databuf.c:326-407) at native speed; the Python/NumPy path remains as the
// portable fallback.
//
// parse_tokens is the ushort feed's text-to-token parse
// (runtime/buffers.py parse_token_stream), the role of the reference's
// per-line strtol loop (AC_ushorts/databuf.c:154-190).

#include <cerrno>
#include <cstdint>
#include <cstring>
#include <sys/uio.h>
#include <unistd.h>
#include <algorithm>
#include <vector>

extern "C" {

// Returns bytes read (>=0), or -1 on I/O error (errno applies).
// Fills lanes [chunks0, chunks_out) of the batch arrays. The stream's
// trailing H bytes are written to tail_out (tail_out_len set).
int64_t stage_stream(int32_t fd, int64_t file_offset, const uint8_t *tail,
                     int32_t tail_len, uint8_t *data, int32_t *start_t,
                     int32_t *end_t, int32_t *file_ids, int64_t *base_off,
                     int32_t file_id, int32_t chunks0, int32_t max_chunks,
                     int32_t B, int32_t H, uint8_t *tail_out,
                     int32_t *tail_out_len, int32_t *chunks_out) {
    const int64_t row = (int64_t)H + B;
    int32_t lane = chunks0;
    int64_t total = 0;
    int64_t off = file_offset;

    // payload reads, batched through preadv
    std::vector<struct iovec> iov;
    while (lane < max_chunks) {
        iov.clear();
        int32_t first = lane;
        int32_t n = std::min<int32_t>(max_chunks - lane, 512);
        for (int32_t i = 0; i < n; ++i) {
            iov.push_back({data + (int64_t)(first + i) * row + H, (size_t)B});
        }
        ssize_t got = preadv(fd, iov.data(), (int)iov.size(), off);
        if (got < 0) return -1;
        if (got == 0) break;
        off += got;
        total += got;
        int32_t full = (int32_t)(got / B);
        int32_t rem = (int32_t)(got % B);
        for (int32_t i = 0; i < full; ++i) {
            int32_t ln = first + i;
            start_t[ln] = H;  // halo filled below
            end_t[ln] = H + B;
            file_ids[ln] = file_id;
            base_off[ln] = file_offset + (int64_t)(ln - chunks0) * B;
        }
        lane = first + full;
        if (rem) {
            int32_t ln = lane;
            start_t[ln] = H;
            end_t[ln] = H + rem;
            file_ids[ln] = file_id;
            base_off[ln] = file_offset + (int64_t)(ln - chunks0) * B;
            ++lane;
        }
        if (got < (ssize_t)((int64_t)n * B)) break;  // EOF (regular files)
    }

    // halos: lane chunks0 from the caller's tail; later lanes from the
    // preceding lane's payload (requires H <= B, enforced by the caller)
    if (H > 0 && lane > chunks0) {
        int32_t hl = std::min(tail_len, H);
        if (hl) {
            std::memcpy(data + (int64_t)chunks0 * row + H - hl,
                        tail + tail_len - hl, hl);
        }
        start_t[chunks0] = H - hl;
        for (int32_t ln = chunks0 + 1; ln < lane; ++ln) {
            std::memcpy(data + (int64_t)ln * row,
                        data + (int64_t)(ln - 1) * row + B, H);
            start_t[ln] = 0;
        }
    }

    // new tail = last H bytes of (old tail + payload)
    if (H > 0) {
        if (total >= H) {
            // reconstruct from the final lane's buffer
            int32_t last = lane - 1;
            int32_t last_len = end_t[last] - H;
            if (last_len >= H) {
                std::memcpy(tail_out,
                            data + (int64_t)last * row + H + last_len - H, H);
                *tail_out_len = H;
            } else {
                // spans the previous lane too
                int32_t need = H - last_len;
                int32_t have = 0;
                if (last > chunks0) {
                    std::memcpy(tail_out,
                                data + (int64_t)(last - 1) * row + H + B - need,
                                need);
                    have = need;
                } else {
                    int32_t hl = std::min(tail_len, H);
                    int32_t take = std::min(hl, need);
                    std::memcpy(tail_out, tail + tail_len - take, take);
                    have = take;
                }
                std::memcpy(tail_out + have, data + (int64_t)last * row + H,
                            last_len);
                *tail_out_len = have + last_len;
            }
        } else {
            int32_t keep = std::min<int32_t>(tail_len, H - (int32_t)total);
            int32_t pos = 0;
            if (keep) {
                std::memcpy(tail_out, tail + tail_len - keep, keep);
                pos = keep;
            }
            for (int32_t ln = chunks0; ln < lane; ++ln) {
                int32_t len = end_t[ln] - H;
                std::memcpy(tail_out + pos, data + (int64_t)ln * row + H, len);
                pos += len;
            }
            *tail_out_len = pos;
        }
    } else {
        *tail_out_len = 0;
    }

    *chunks_out = lane;
    return total;
}

// Parses the text rem + raw (two spans, never joined) into uint16 tokens:
// every maximal run of ASCII digits is one token of value
// min(int(run) & 0xFFFF, clamp); every other byte separates. Horner's rule
// masked to 16 bits at each step gives int(run) & 0xFFFF for a run of any
// length. Unless final, a trailing digit run is held back: its start (an
// index into rem + raw) goes to *held, which is rem_len + raw_len when
// nothing is held. out has room for (rem_len + raw_len + 1) / 2 tokens.
// Returns the number of tokens written.
int64_t parse_tokens(const uint8_t *rem, int64_t rem_len, const uint8_t *raw,
                     int64_t raw_len, int32_t final, uint32_t clamp,
                     uint16_t *out, int64_t *held) {
    const uint8_t *span[2] = {rem, raw};
    const int64_t len[2] = {rem_len, raw_len};
    int64_t n = 0, base = 0;
    int64_t start = -1;  // start of the open digit run; -1 outside one
    uint32_t v = 0;
    for (int s = 0; s < 2; base += len[s], ++s) {
        const uint8_t *p = span[s];
        for (int64_t i = 0; i < len[s]; ++i) {
            uint32_t d = (uint32_t)p[i] - '0';
            if (d < 10) {
                if (start < 0) {
                    start = base + i;
                    v = 0;
                }
                v = (v * 10 + d) & 0xFFFF;
            } else if (start >= 0) {
                out[n++] = (uint16_t)std::min(v, clamp);
                start = -1;
            }
        }
    }
    if (start >= 0 && final) {
        out[n++] = (uint16_t)std::min(v, clamp);
        start = -1;
    }
    *held = start >= 0 ? start : base;
    return n;
}

}  // extern "C"
