// Native PNG decoder for the host data pipeline: a copy of the
// repository root's csrc/dataio.cpp (the JAX package's decoder), built by
// supervised_gan_tpu_torch/data/native_io.py.
//
// The reference feeds the GPU from torch DataLoader worker *processes*
// (reference data/custom_dataset_data_loader.py:31-35) whose heavy lifting
// is PIL's C PNG decode.  The port's loader is a thread pool in one
// process (data/loader.py), and this translation unit supplies a PNG
// decoder that runs without the GIL (ctypes releases it for the call), so
// the pool's threads decode side by side while the card computes.
// Decoding is lossless, so the pixels are bit-exact with PIL and
// augmentation/output parity is unaffected.
//
// Scope: 8-bit greyscale (0), RGB (2), palette (3), grey+alpha (4) and
// RGBA (6) PNGs, non-interlaced, filters 0-4; always emits RGB.  Anything
// else returns an error and the Python side falls back to PIL for that
// file.
//
// Build: g++ -O3 -shared -fPIC dataio.cpp -lz -o libdataio-<hash>.so

#include <cstdint>
#include <cstring>
#include <vector>
#include <zlib.h>

namespace {

inline uint32_t be32(const uint8_t* p) {
    return (uint32_t(p[0]) << 24) | (uint32_t(p[1]) << 16) |
           (uint32_t(p[2]) << 8) | uint32_t(p[3]);
}

struct PngInfo {
    uint32_t width = 0, height = 0;
    int bit_depth = 0, color_type = 0, interlace = 0;
    std::vector<uint8_t> idat;     // concatenated compressed stream
    std::vector<uint8_t> palette;  // RGB triples for color type 3
};

const uint8_t SIG[8] = {0x89, 'P', 'N', 'G', '\r', '\n', 0x1a, '\n'};

bool parse_png(const uint8_t* data, size_t len, PngInfo* info) {
    if (len < 8 || memcmp(data, SIG, 8) != 0) return false;
    size_t pos = 8;
    while (pos + 8 <= len) {
        uint32_t chunk_len = be32(data + pos);
        const uint8_t* tag = data + pos + 4;
        const uint8_t* body = data + pos + 8;
        if (pos + 12 + chunk_len > len) return false;
        if (memcmp(tag, "IHDR", 4) == 0) {
            if (chunk_len < 13) return false;
            info->width = be32(body);
            info->height = be32(body + 4);
            info->bit_depth = body[8];
            info->color_type = body[9];
            info->interlace = body[12];
        } else if (memcmp(tag, "PLTE", 4) == 0) {
            info->palette.assign(body, body + chunk_len);
        } else if (memcmp(tag, "IDAT", 4) == 0) {
            info->idat.insert(info->idat.end(), body, body + chunk_len);
        } else if (memcmp(tag, "IEND", 4) == 0) {
            break;
        }
        pos += 12 + chunk_len;
    }
    return info->width && info->height;
}

int channels_for(int color_type) {
    switch (color_type) {
        case 0: return 1;  // grey
        case 2: return 3;  // rgb
        case 3: return 1;  // palette index
        case 4: return 2;  // grey+alpha
        case 6: return 4;  // rgba
    }
    return 0;
}

inline uint8_t paeth(int a, int b, int c) {
    int p = a + b - c;
    int pa = p > a ? p - a : a - p;
    int pb = p > b ? p - b : b - p;
    int pc = p > c ? p - c : c - p;
    if (pa <= pb && pa <= pc) return uint8_t(a);
    if (pb <= pc) return uint8_t(b);
    return uint8_t(c);
}

}  // namespace

extern "C" {

// Returns 0 on success; fills width/height.
int png_dims(const uint8_t* data, size_t len, int* width, int* height) {
    PngInfo info;
    if (!parse_png(data, len, &info)) return -1;
    *width = int(info.width);
    *height = int(info.height);
    return 0;
}

// Decodes into caller-allocated RGB buffer (width*height*3 bytes).
// Returns 0 on success, negative error codes otherwise.
int decode_png_rgb(const uint8_t* data, size_t len, uint8_t* out) {
    PngInfo info;
    if (!parse_png(data, len, &info)) return -1;
    if (info.bit_depth != 8 || info.interlace != 0) return -2;
    int ch = channels_for(info.color_type);
    if (ch == 0) return -3;
    if (info.color_type == 3 && info.palette.empty()) return -4;

    const size_t W = info.width, H = info.height;
    const size_t stride = W * ch;
    std::vector<uint8_t> raw((stride + 1) * H);
    uLongf raw_len = raw.size();
    if (uncompress(raw.data(), &raw_len, info.idat.data(),
                   info.idat.size()) != Z_OK || raw_len != raw.size())
        return -5;

    std::vector<uint8_t> prev(stride, 0), cur(stride);
    for (size_t y = 0; y < H; ++y) {
        const uint8_t* src = raw.data() + y * (stride + 1);
        int filter = src[0];
        const uint8_t* line = src + 1;
        switch (filter) {
            case 0:
                memcpy(cur.data(), line, stride);
                break;
            case 1:
                for (size_t x = 0; x < stride; ++x) {
                    uint8_t left = x >= size_t(ch) ? cur[x - ch] : 0;
                    cur[x] = uint8_t(line[x] + left);
                }
                break;
            case 2:
                for (size_t x = 0; x < stride; ++x)
                    cur[x] = uint8_t(line[x] + prev[x]);
                break;
            case 3:
                for (size_t x = 0; x < stride; ++x) {
                    uint8_t left = x >= size_t(ch) ? cur[x - ch] : 0;
                    cur[x] = uint8_t(line[x] + ((left + prev[x]) >> 1));
                }
                break;
            case 4:
                for (size_t x = 0; x < stride; ++x) {
                    uint8_t left = x >= size_t(ch) ? cur[x - ch] : 0;
                    uint8_t ul = x >= size_t(ch) ? prev[x - ch] : 0;
                    cur[x] = uint8_t(line[x] + paeth(left, prev[x], ul));
                }
                break;
            default:
                return -6;
        }
        // expand to RGB
        uint8_t* dst = out + y * W * 3;
        switch (info.color_type) {
            case 0:
                for (size_t x = 0; x < W; ++x)
                    dst[3 * x] = dst[3 * x + 1] = dst[3 * x + 2] = cur[x];
                break;
            case 2:
                memcpy(dst, cur.data(), W * 3);
                break;
            case 3:
                for (size_t x = 0; x < W; ++x) {
                    size_t idx = size_t(cur[x]) * 3;
                    if (idx + 2 >= info.palette.size()) return -7;
                    dst[3 * x] = info.palette[idx];
                    dst[3 * x + 1] = info.palette[idx + 1];
                    dst[3 * x + 2] = info.palette[idx + 2];
                }
                break;
            case 4:
                for (size_t x = 0; x < W; ++x)
                    dst[3 * x] = dst[3 * x + 1] = dst[3 * x + 2] = cur[2 * x];
                break;
            case 6:
                for (size_t x = 0; x < W; ++x) {
                    dst[3 * x] = cur[4 * x];
                    dst[3 * x + 1] = cur[4 * x + 1];
                    dst[3 * x + 2] = cur[4 * x + 2];
                }
                break;
        }
        prev.swap(cur);
    }
    return 0;
}

}  // extern "C"
