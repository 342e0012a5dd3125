// Native FLAC decoder for host-side audio reads (reference clips, corpus).
//
// The port's copy of styletts2_tpu/native/flac_decode.cpp. It mirrors the
// pure-python decoder in styletts2_tpu_torch/flac.py bit for bit:
// STREAMINFO metadata, frames with constant / verbatim / fixed / LPC
// subframes, 4- and 5-bit Rice residual partitions, left-side /
// right-side / mid-side stereo decorrelation, wasted-bits shift, first
// channel out (the reference's meldataset.py:104-105 mono policy). The
// python residual loops are O(samples) interpreter work per clip; this
// runs the read at native speed.
//
// Built on demand with g++ into build/styletts2_tpu_torch/ (see
// flac.py:_native_lib); python falls back to the pure decoder when
// compilation is unavailable or the stream needs the (rare) paths the
// wrapper does not route here (unknown total length).
//
// Entry point (C ABI, ctypes):
//   flac_decode(data, len, out, out_cap, &sample_rate) -> samples written
//   (negative on malformed/unsupported streams; caller falls back).

#include <cstdint>
#include <vector>

namespace {

struct BitReader {
    const uint8_t *data;
    int64_t nbits;
    int64_t pos = 0;
    bool fail = false;

    BitReader(const uint8_t *d, int64_t len_bytes, int64_t pos_bytes)
        : data(d), nbits(len_bytes * 8), pos(pos_bytes * 8) {}

    uint64_t read(int n) {
        uint64_t out = 0;
        if (pos + n > nbits) { fail = true; pos = nbits; return 0; }
        int64_t p = pos;
        int64_t end = pos + n;
        while (p < end) {
            uint8_t byte = data[p >> 3];
            int avail = 8 - static_cast<int>(p & 7);
            int take = avail < static_cast<int>(end - p)
                           ? avail : static_cast<int>(end - p);
            int shift = avail - take;
            uint64_t bits = (byte >> shift) & ((1u << take) - 1u);
            out = (out << take) | bits;
            p += take;
        }
        pos = end;
        return out;
    }

    int64_t read_signed(int n) {
        int64_t v = static_cast<int64_t>(read(n));
        if (n > 0 && v >= (int64_t(1) << (n - 1))) v -= int64_t(1) << n;
        return v;
    }

    int64_t read_unary() {
        int64_t count = 0;
        while (true) {
            if (pos >= nbits) { fail = true; return 0; }
            uint8_t byte = data[pos >> 3];
            int avail = 8 - static_cast<int>(pos & 7);
            uint32_t chunk = byte & ((1u << avail) - 1u);
            if (chunk == 0) { count += avail; pos += avail; continue; }
            int bl = 32 - __builtin_clz(chunk);  // chunk.bit_length()
            int lead = avail - bl;
            count += lead;
            pos += lead + 1;
            return count;
        }
    }

    void align() { pos = (pos + 7) & ~int64_t(7); }

    uint64_t read_utf8() {
        uint64_t first = read(8);
        if (first < 0x80) return first;
        int n = 0;
        uint64_t mask = 0x40;
        while (first & mask) { n += 1; mask >>= 1; }
        uint64_t value = first & (mask - 1);
        for (int i = 0; i < n; i++) value = (value << 6) | (read(8) & 0x3F);
        return value;
    }
};

const int kBlockSizes[16] = {0, 192, 576, 1152, 2304, 4608, 0, 0,
                             256, 512, 1024, 2048, 4096, 8192, 16384, 32768};
const int kSampleSizes[8] = {0, 8, 12, 0, 16, 20, 24, 32};
const int kFixedCoefs[5][4] = {
    {}, {1}, {2, -1}, {3, -3, 1}, {4, -6, 4, -1}};

// flac.py:_decode_residual
bool decode_residual(BitReader &br, int blocksize, int order,
                     std::vector<int64_t> &res) {
    res.clear();
    int method = static_cast<int>(br.read(2));
    if (method != 0 && method != 1) return false;
    int param_bits = method == 0 ? 4 : 5;
    uint64_t escape = (1u << param_bits) - 1u;
    int part_order = static_cast<int>(br.read(4));
    int n_parts = 1 << part_order;
    int part_len = blocksize >> part_order;
    for (int p = 0; p < n_parts; p++) {
        int n = part_len - (p == 0 ? order : 0);
        if (n < 0) return false;
        uint64_t param = br.read(param_bits);
        if (param == escape) {
            int raw = static_cast<int>(br.read(5));
            for (int i = 0; i < n; i++)
                res.push_back(raw == 0 ? 0 : br.read_signed(raw));
        } else {
            for (int i = 0; i < n; i++) {
                uint64_t q = static_cast<uint64_t>(br.read_unary());
                uint64_t u = param ? ((q << param) | br.read(param)) : q;
                res.push_back(static_cast<int64_t>(u >> 1) ^
                              -static_cast<int64_t>(u & 1));  // zigzag
            }
        }
        if (br.fail) return false;
    }
    return true;
}

// flac.py:_decode_subframe
bool decode_subframe(BitReader &br, int blocksize, int bps,
                     std::vector<int64_t> &out, std::vector<int64_t> &res) {
    if (br.read(1) != 0) return false;
    int ftype = static_cast<int>(br.read(6));
    int wasted = 0;
    if (br.read(1)) {
        wasted = static_cast<int>(br.read_unary()) + 1;
        bps -= wasted;
    }
    if (bps <= 0 || bps > 33) return false;
    out.resize(blocksize);

    if (ftype == 0) {  // constant
        int64_t v = br.read_signed(bps);
        for (int i = 0; i < blocksize; i++) out[i] = v;
    } else if (ftype == 1) {  // verbatim
        for (int i = 0; i < blocksize; i++) out[i] = br.read_signed(bps);
    } else if (ftype >= 8 && ftype <= 12) {  // fixed
        int order = ftype - 8;
        if (order > blocksize) return false;
        for (int i = 0; i < order; i++) out[i] = br.read_signed(bps);
        if (!decode_residual(br, blocksize, order, res)) return false;
        for (int i = order; i < blocksize; i++) {
            int64_t acc = res[i - order];
            for (int j = 0; j < order; j++)
                acc += kFixedCoefs[order][j] * out[i - 1 - j];
            out[i] = acc;
        }
    } else if (ftype >= 32) {  // LPC
        int order = ftype - 31;
        if (order > blocksize) return false;
        for (int i = 0; i < order; i++) out[i] = br.read_signed(bps);
        int precision = static_cast<int>(br.read(4)) + 1;
        int64_t shift = br.read_signed(5);
        if (shift < 0) shift = 0;  // negative shifts are invalid
        int64_t coefs[32];
        for (int j = 0; j < order; j++) coefs[j] = br.read_signed(precision);
        if (!decode_residual(br, blocksize, order, res)) return false;
        for (int i = order; i < blocksize; i++) {
            int64_t acc = 0;
            for (int j = 0; j < order; j++) acc += coefs[j] * out[i - 1 - j];
            out[i] = (acc >> shift) + res[i - order];
        }
    } else {
        return false;  // reserved subframe type
    }
    if (wasted)
        // shift via uint64_t: left-shifting a negative int64 is UB before
        // C++20; the cast round trip is the defined two's-complement shift
        for (int i = 0; i < blocksize; i++)
            out[i] = static_cast<int64_t>(
                static_cast<uint64_t>(out[i]) << wasted);
    return !br.fail;
}

}  // namespace

extern "C" {

// data/len: the whole FLAC file. out/out_cap: caller-allocated float32
// buffer (STREAMINFO total samples). Returns samples written (first
// channel, scaled to [-1, 1]); negative on malformed/unsupported input
// (-1 bad magic / missing STREAMINFO, -2 bitstream error, -3 overflow).
int64_t flac_decode(const uint8_t *data, int64_t len, float *out,
                    int64_t out_cap, int32_t *sample_rate_out) {
    if (len < 8 || data[0] != 'f' || data[1] != 'L' || data[2] != 'a' ||
        data[3] != 'C')
        return -1;

    int64_t pos = 4;
    int64_t sr = -1, channels = 0, bps = 0, total = 0;
    while (pos + 4 <= len) {
        uint8_t header = data[pos];
        int btype = header & 0x7F;
        bool last = header & 0x80;
        int64_t length = (int64_t(data[pos + 1]) << 16) |
                         (int64_t(data[pos + 2]) << 8) | data[pos + 3];
        if (btype == 0) {  // STREAMINFO
            BitReader si(data, len, pos + 4);
            si.read(16); si.read(16);  // min/max blocksize
            si.read(24); si.read(24);  // min/max framesize
            sr = static_cast<int64_t>(si.read(20));
            channels = static_cast<int64_t>(si.read(3)) + 1;
            bps = static_cast<int64_t>(si.read(5)) + 1;
            total = static_cast<int64_t>(si.read(36));
            if (si.fail) return -1;
        }
        pos += 4 + length;
        if (last) break;
    }
    if (sr < 0 || channels < 1 || channels > 8) return -1;
    *sample_rate_out = static_cast<int32_t>(sr);

    std::vector<int64_t> chan[2];   // channel 0 + (for decorrelation) 1
    std::vector<int64_t> skip, res;
    int64_t got = 0;
    // float32 cast then float32 divide — bit-exact with the python
    // decoder's samples.astype(np.float32) / scale
    float scale = static_cast<float>(int64_t(1) << (bps - 1));

    while (pos < len && (total == 0 || got < total)) {
        BitReader br(data, len, pos);
        if (br.read(14) != 0b11111111111110) return -2;
        br.read(1);  // reserved
        br.read(1);  // blocking strategy
        int bs_code = static_cast<int>(br.read(4));
        int sr_code = static_cast<int>(br.read(4));
        int ch_code = static_cast<int>(br.read(4));
        int ss_code = static_cast<int>(br.read(3));
        br.read(1);  // reserved
        br.read_utf8();
        int blocksize;
        if (bs_code == 6) blocksize = static_cast<int>(br.read(8)) + 1;
        else if (bs_code == 7) blocksize = static_cast<int>(br.read(16)) + 1;
        else if (kBlockSizes[bs_code]) blocksize = kBlockSizes[bs_code];
        else return -2;
        if (sr_code == 12) br.read(8);
        else if (sr_code == 13 || sr_code == 14) br.read(16);
        int frame_bps = kSampleSizes[ss_code]
                            ? kSampleSizes[ss_code] : static_cast<int>(bps);
        br.read(8);  // header CRC-8

        if (ch_code < 8) {
            int n_ch = ch_code + 1;
            if (!decode_subframe(br, blocksize, frame_bps, chan[0], res))
                return -2;
            for (int c = 1; c < n_ch; c++)  // parse (and discard) the rest
                if (!decode_subframe(br, blocksize, frame_bps, skip, res))
                    return -2;
        } else if (ch_code == 8) {  // left/side: out = left
            if (!decode_subframe(br, blocksize, frame_bps, chan[0], res) ||
                !decode_subframe(br, blocksize, frame_bps + 1, skip, res))
                return -2;
        } else if (ch_code == 9) {  // right/side: out = right + side
            if (!decode_subframe(br, blocksize, frame_bps + 1, chan[1],
                                 res) ||
                !decode_subframe(br, blocksize, frame_bps, chan[0], res))
                return -2;
            for (int i = 0; i < blocksize; i++) chan[0][i] += chan[1][i];
        } else if (ch_code == 10) {  // mid/side: out = (mid2 + side) >> 1
            if (!decode_subframe(br, blocksize, frame_bps, chan[0], res) ||
                !decode_subframe(br, blocksize, frame_bps + 1, chan[1],
                                 res))
                return -2;
            for (int i = 0; i < blocksize; i++) {
                int64_t mid2 = static_cast<int64_t>(  // defined signed shift
                    (static_cast<uint64_t>(chan[0][i]) << 1)
                    | (static_cast<uint64_t>(chan[1][i]) & 1));
                chan[0][i] = (mid2 + chan[1][i]) >> 1;
            }
        } else {
            return -2;  // reserved channel assignment
        }
        br.align();
        br.read(16);  // frame CRC-16
        if (br.fail) return -2;
        pos = br.pos >> 3;

        int64_t take = blocksize;
        if (total != 0 && got + take > total) take = total - got;
        if (got + take > out_cap) return -3;
        for (int64_t i = 0; i < take; i++)
            out[got + i] = static_cast<float>(chan[0][i]) / scale;
        got += take;
    }
    return got;
}

}  // extern "C"
