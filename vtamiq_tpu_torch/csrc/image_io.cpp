// Host image decode for the vtamiq_tpu_torch input pipeline (plain C ABI,
// loaded with ctypes; host C++, no CUDA).
//
// Decodes BMP (hand-rolled: 24/32-bit and 8-bit palette, bottom-up or
// top-down), JPEG (libjpeg) and PNG (libpng, or, where png.h is missing, a
// decoder of this file's own on zlib) straight into caller-provided float32
// HWC buffers with fused flip + normalize, and offers a threaded batch
// decoder so the host overlaps decode with device compute. The JPEG and PNG
// paths are compiled only where their headers exist (__has_include;
// -DVTAMIQ_WITHOUT_JPEG, -DVTAMIQ_WITHOUT_LIBPNG and -DVTAMIQ_WITHOUT_PNG
// leave one out where the header exists); vtamiq_io_codecs() says which the
// build holds, and a file of a codec the build lacks returns its own status.
//
// C ABI:
//   vtamiq_io_codecs()                                -> bit mask of VTAMIQ_CODEC_*
//   vtamiq_image_size(path, &h, &w)                   -> status
//   vtamiq_decode_rgb_f32(path, out, h, w, row_stride, hflip, vflip, mean3,
//                         std3)                       -> status
//   vtamiq_decode_batch(paths, n, outs, hs, ws, row_strides, hflips, vflips,
//                       mean3, std3, num_threads, statuses)
//                                                     -> number of failures
// Status: 0 ok, 1 cannot open, 2 unreadable or unsupported file, 3 JPEG
// file and no libjpeg in the build, 4 PNG file and no libpng in the build.
// row_stride: floats between the starts of two output rows (<= 0: w * 3), so
// an image can land in the top-left corner of a larger, padded buffer.
//
// Build: vtamiq_tpu_torch/_build.py::build_host (g++ -O3 -shared -fPIC,
// linking -ljpeg, -lpng and -lz only for the codecs compiled in).

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <atomic>
#include <thread>
#include <vector>

#include <csetjmp>

#if defined(__has_include)
#if __has_include(<jpeglib.h>) && !defined(VTAMIQ_WITHOUT_JPEG)
#define VTAMIQ_HAVE_JPEG 1
#include <jpeglib.h>
#endif
#if __has_include(<png.h>) && !defined(VTAMIQ_WITHOUT_PNG) && !defined(VTAMIQ_WITHOUT_LIBPNG)
#define VTAMIQ_HAVE_PNG 1
#define VTAMIQ_PNG_LIBPNG 1
#include <png.h>
#elif __has_include(<zlib.h>) && !defined(VTAMIQ_WITHOUT_PNG)
#define VTAMIQ_HAVE_PNG 1
#define VTAMIQ_PNG_ZLIB 1
#include <zlib.h>
#endif
#endif

#define VTAMIQ_CODEC_BMP 1
#define VTAMIQ_CODEC_JPEG 2
#define VTAMIQ_CODEC_PNG 4
#define VTAMIQ_CODEC_PNG_ZLIB 8  // PNG through this file's own decoder on zlib

enum Status { ST_OK = 0, ST_OPEN = 1, ST_BAD = 2, ST_NO_JPEG = 3, ST_NO_PNG = 4 };

namespace {

enum class Format { UNKNOWN, BMP, JPEG, PNG };

Format sniff_format(FILE* f) {
    unsigned char magic[8] = {0};
    size_t n = fread(magic, 1, 8, f);
    rewind(f);
    if (n >= 2 && magic[0] == 'B' && magic[1] == 'M') return Format::BMP;
    if (n >= 3 && magic[0] == 0xFF && magic[1] == 0xD8 && magic[2] == 0xFF)
        return Format::JPEG;
    static const unsigned char png_magic[8] = {0x89, 'P', 'N', 'G', '\r', '\n', 0x1A, '\n'};
    if (n >= 8 && memcmp(magic, png_magic, 8) == 0) return Format::PNG;
    return Format::UNKNOWN;
}

uint32_t rd_u32(const unsigned char* p) {
    return (uint32_t)p[0] | ((uint32_t)p[1] << 8) | ((uint32_t)p[2] << 16) |
           ((uint32_t)p[3] << 24);
}
int32_t rd_i32(const unsigned char* p) { return (int32_t)rd_u32(p); }
uint16_t rd_u16(const unsigned char* p) {
    return (uint16_t)p[0] | ((uint16_t)p[1] << 8);
}

// ---------------------------------------------------------------------------
// BMP: uncompressed 24/32-bit (+ 8-bit palette), bottom-up or top-down
// ---------------------------------------------------------------------------

struct BmpInfo {
    int width = 0, height = 0, bpp = 0;
    bool top_down = false;
    uint32_t data_offset = 0;
    uint32_t palette_offset = 0;
    uint32_t palette_count = 0;
};

bool bmp_read_info(FILE* f, BmpInfo* info) {
    unsigned char header[54];
    if (fread(header, 1, 54, f) != 54) return false;
    if (header[0] != 'B' || header[1] != 'M') return false;
    info->data_offset = rd_u32(header + 10);
    uint32_t dib_size = rd_u32(header + 14);
    if (dib_size < 40) return false;  // BITMAPINFOHEADER+
    info->width = rd_i32(header + 18);
    int32_t h = rd_i32(header + 22);
    info->top_down = h < 0;
    info->height = info->top_down ? -h : h;
    info->bpp = rd_u16(header + 28);
    uint32_t compression = rd_u32(header + 30);
    if (compression != 0) return false;  // only BI_RGB
    info->palette_count = rd_u32(header + 46);
    if (info->bpp == 8 && info->palette_count == 0) info->palette_count = 256;
    info->palette_offset = 14 + dib_size;
    return info->width > 0 && info->height > 0 &&
           (info->bpp == 24 || info->bpp == 32 || info->bpp == 8);
}

bool bmp_decode(FILE* f, const BmpInfo& info, unsigned char* rgb /*h*w*3*/) {
    const int w = info.width, h = info.height;
    const int channels = info.bpp / 8;
    const size_t row_size = ((size_t)w * channels + 3) & ~size_t(3);

    std::vector<unsigned char> palette;
    if (info.bpp == 8) {
        palette.resize(info.palette_count * 4);
        if (fseek(f, info.palette_offset, SEEK_SET) != 0) return false;
        if (fread(palette.data(), 1, palette.size(), f) != palette.size())
            return false;
    }

    if (fseek(f, info.data_offset, SEEK_SET) != 0) return false;
    std::vector<unsigned char> row(row_size);
    for (int y = 0; y < h; y++) {
        if (fread(row.data(), 1, row_size, f) != row_size) return false;
        const int out_y = info.top_down ? y : (h - 1 - y);
        unsigned char* dst = rgb + (size_t)out_y * w * 3;
        if (info.bpp == 8) {
            for (int x = 0; x < w; x++) {
                const unsigned char* e = &palette[row[x] * 4];  // BGRA entries
                dst[x * 3 + 0] = e[2];
                dst[x * 3 + 1] = e[1];
                dst[x * 3 + 2] = e[0];
            }
        } else {
            for (int x = 0; x < w; x++) {  // BGR(A) -> RGB
                dst[x * 3 + 0] = row[x * channels + 2];
                dst[x * 3 + 1] = row[x * channels + 1];
                dst[x * 3 + 2] = row[x * channels + 0];
            }
        }
    }
    return true;
}

// ---------------------------------------------------------------------------
// JPEG via libjpeg
// ---------------------------------------------------------------------------

#ifdef VTAMIQ_HAVE_JPEG

struct JpegErrorMgr {
    jpeg_error_mgr pub;
    jmp_buf setjmp_buffer;
};

void jpeg_error_exit(j_common_ptr cinfo) {
    JpegErrorMgr* err = reinterpret_cast<JpegErrorMgr*>(cinfo->err);
    longjmp(err->setjmp_buffer, 1);
}

bool jpeg_read_size(FILE* f, int* h, int* w) {
    jpeg_decompress_struct cinfo;
    JpegErrorMgr jerr;
    cinfo.err = jpeg_std_error(&jerr.pub);
    jerr.pub.error_exit = jpeg_error_exit;
    if (setjmp(jerr.setjmp_buffer)) {
        jpeg_destroy_decompress(&cinfo);
        return false;
    }
    jpeg_create_decompress(&cinfo);
    jpeg_stdio_src(&cinfo, f);
    jpeg_read_header(&cinfo, TRUE);
    *w = cinfo.image_width;
    *h = cinfo.image_height;
    jpeg_destroy_decompress(&cinfo);
    return true;
}

bool jpeg_decode(FILE* f, int h, int w, unsigned char* rgb) {
    jpeg_decompress_struct cinfo;
    JpegErrorMgr jerr;
    cinfo.err = jpeg_std_error(&jerr.pub);
    jerr.pub.error_exit = jpeg_error_exit;
    if (setjmp(jerr.setjmp_buffer)) {
        jpeg_destroy_decompress(&cinfo);
        return false;
    }
    jpeg_create_decompress(&cinfo);
    jpeg_stdio_src(&cinfo, f);
    jpeg_read_header(&cinfo, TRUE);
    cinfo.out_color_space = JCS_RGB;
    jpeg_start_decompress(&cinfo);
    if ((int)cinfo.output_width != w || (int)cinfo.output_height != h ||
        cinfo.output_components != 3) {
        jpeg_destroy_decompress(&cinfo);
        return false;
    }
    while (cinfo.output_scanline < cinfo.output_height) {
        unsigned char* rowp = rgb + (size_t)cinfo.output_scanline * w * 3;
        jpeg_read_scanlines(&cinfo, &rowp, 1);
    }
    jpeg_finish_decompress(&cinfo);
    jpeg_destroy_decompress(&cinfo);
    return true;
}

#endif  // VTAMIQ_HAVE_JPEG

// ---------------------------------------------------------------------------
// PNG via libpng
// ---------------------------------------------------------------------------

#ifdef VTAMIQ_PNG_LIBPNG

bool png_read_size(FILE* f, int* h, int* w) {
    png_structp png = png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr,
                                             nullptr, nullptr);
    if (!png) return false;
    png_infop info = png_create_info_struct(png);
    if (!info || setjmp(png_jmpbuf(png))) {
        png_destroy_read_struct(&png, &info, nullptr);
        return false;
    }
    png_init_io(png, f);
    png_read_info(png, info);
    *w = png_get_image_width(png, info);
    *h = png_get_image_height(png, info);
    png_destroy_read_struct(&png, &info, nullptr);
    return true;
}

bool png_decode(FILE* f, int h, int w, unsigned char* rgb) {
    png_structp png = png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr,
                                             nullptr, nullptr);
    if (!png) return false;
    png_infop info = png_create_info_struct(png);
    if (!info || setjmp(png_jmpbuf(png))) {
        png_destroy_read_struct(&png, &info, nullptr);
        return false;
    }
    png_init_io(png, f);
    png_read_info(png, info);
    if ((int)png_get_image_width(png, info) != w ||
        (int)png_get_image_height(png, info) != h) {
        png_destroy_read_struct(&png, &info, nullptr);
        return false;
    }
    // normalize everything to 8-bit RGB
    png_byte color_type = png_get_color_type(png, info);
    png_byte bit_depth = png_get_bit_depth(png, info);
    if (bit_depth == 16) png_set_strip_16(png);
    if (color_type == PNG_COLOR_TYPE_PALETTE) png_set_palette_to_rgb(png);
    if (color_type == PNG_COLOR_TYPE_GRAY && bit_depth < 8)
        png_set_expand_gray_1_2_4_to_8(png);
    if (png_get_valid(png, info, PNG_INFO_tRNS)) png_set_tRNS_to_alpha(png);
    if (color_type == PNG_COLOR_TYPE_GRAY ||
        color_type == PNG_COLOR_TYPE_GRAY_ALPHA)
        png_set_gray_to_rgb(png);
    if (color_type & PNG_COLOR_MASK_ALPHA ||
        png_get_valid(png, info, PNG_INFO_tRNS))
        png_set_strip_alpha(png);
    png_read_update_info(png, info);
    if (png_get_rowbytes(png, info) != (size_t)w * 3) {
        png_destroy_read_struct(&png, &info, nullptr);
        return false;
    }
    std::vector<png_bytep> rows(h);
    for (int y = 0; y < h; y++) rows[y] = rgb + (size_t)y * w * 3;
    png_read_image(png, rows.data());
    png_destroy_read_struct(&png, &info, nullptr);
    return true;
}

#endif  // VTAMIQ_PNG_LIBPNG

// ---------------------------------------------------------------------------
// PNG via zlib alone (where png.h is missing): non-interlaced, 8- or 16-bit
// gray, gray+alpha, RGB, RGBA, and 8-bit palette images; alpha is dropped
// and 16-bit samples keep their high byte, as the libpng path does.
// ---------------------------------------------------------------------------

#ifdef VTAMIQ_PNG_ZLIB

uint32_t rd_be32(const unsigned char* p) {
    return ((uint32_t)p[0] << 24) | ((uint32_t)p[1] << 16) | ((uint32_t)p[2] << 8) | p[3];
}

struct ZPngInfo {
    int width = 0, height = 0, depth = 0, color_type = 0, interlace = 0;
};

bool zpng_read_info(FILE* f, ZPngInfo* info) {
    unsigned char head[33];  // signature (8) + IHDR chunk (8 + 13 + 4)
    if (fread(head, 1, 33, f) != 33) return false;
    if (rd_be32(head + 8) != 13 || memcmp(head + 12, "IHDR", 4) != 0) return false;
    info->width = (int)rd_be32(head + 16);
    info->height = (int)rd_be32(head + 20);
    info->depth = head[24];
    info->color_type = head[25];
    info->interlace = head[28];
    return info->width > 0 && info->height > 0;
}

bool png_read_size(FILE* f, int* h, int* w) {
    ZPngInfo info;
    if (!zpng_read_info(f, &info)) return false;
    *h = info.height;
    *w = info.width;
    return true;
}

int paeth(int a, int b, int c) {
    const int p = a + b - c;
    const int pa = abs(p - a), pb = abs(p - b), pc = abs(p - c);
    if (pa <= pb && pa <= pc) return a;
    return pb <= pc ? b : c;
}

bool png_decode(FILE* f, int h, int w, unsigned char* rgb) {
    ZPngInfo info;
    if (!zpng_read_info(f, &info) || info.width != w || info.height != h) return false;
    int channels;
    switch (info.color_type) {
        case 0: channels = 1; break;  // gray
        case 2: channels = 3; break;  // RGB
        case 3: channels = 1; break;  // palette
        case 4: channels = 2; break;  // gray + alpha
        case 6: channels = 4; break;  // RGBA
        default: return false;
    }
    const bool depth_ok = info.color_type == 3 ? info.depth == 8
                                                : (info.depth == 8 || info.depth == 16);
    if (!depth_ok || info.interlace != 0) return false;
    const size_t bpp = (size_t)channels * info.depth / 8;  // bytes per pixel
    const size_t stride = (size_t)w * bpp;

    // gather the palette and the IDAT stream
    std::vector<unsigned char> idat, palette;
    if (fseek(f, 8, SEEK_SET) != 0) return false;
    for (;;) {
        unsigned char ch[8];
        if (fread(ch, 1, 8, f) != 8) return false;
        const uint32_t len = rd_be32(ch);
        if (memcmp(ch + 4, "IEND", 4) == 0) break;
        if (memcmp(ch + 4, "IDAT", 4) == 0 || memcmp(ch + 4, "PLTE", 4) == 0) {
            std::vector<unsigned char>& dst = ch[4] == 'I' ? idat : palette;
            const size_t at = dst.size();
            dst.resize(at + len);
            if (fread(dst.data() + at, 1, len, f) != len) return false;
            if (fseek(f, 4, SEEK_CUR) != 0) return false;  // CRC
        } else if (fseek(f, (long)len + 4, SEEK_CUR) != 0) {
            return false;
        }
    }
    std::vector<unsigned char> raw((stride + 1) * h);
    uLongf raw_len = raw.size();
    if (uncompress(raw.data(), &raw_len, idat.data(), idat.size()) != Z_OK ||
        raw_len != raw.size())
        return false;

    // undo the per-row filters in place
    std::vector<unsigned char> zero(stride, 0);
    for (int y = 0; y < h; y++) {
        unsigned char* row = raw.data() + (size_t)y * (stride + 1);
        const unsigned char filter = row[0];
        unsigned char* cur = row + 1;
        const unsigned char* up = y ? raw.data() + (size_t)(y - 1) * (stride + 1) + 1 : zero.data();
        for (size_t i = 0; i < stride; i++) {
            const int a = i >= bpp ? cur[i - bpp] : 0, b = up[i];
            const int c = i >= bpp ? up[i - bpp] : 0;
            switch (filter) {
                case 0: break;
                case 1: cur[i] = (unsigned char)(cur[i] + a); break;
                case 2: cur[i] = (unsigned char)(cur[i] + b); break;
                case 3: cur[i] = (unsigned char)(cur[i] + ((a + b) >> 1)); break;
                case 4: cur[i] = (unsigned char)(cur[i] + paeth(a, b, c)); break;
                default: return false;
            }
        }
    }

    // to 8-bit RGB
    const size_t step = info.depth / 8;  // the high byte of a 16-bit sample comes first
    for (int y = 0; y < h; y++) {
        const unsigned char* src = raw.data() + (size_t)y * (stride + 1) + 1;
        unsigned char* dst = rgb + (size_t)y * w * 3;
        for (int x = 0; x < w; x++) {
            const unsigned char* px = src + (size_t)x * bpp;
            if (info.color_type == 3) {
                const size_t k = (size_t)px[0] * 3;
                for (int c = 0; c < 3; c++)
                    dst[x * 3 + c] = k + 2 < palette.size() ? palette[k + c] : 0;
            } else if (channels <= 2) {
                dst[x * 3 + 0] = dst[x * 3 + 1] = dst[x * 3 + 2] = px[0];
            } else {
                for (int c = 0; c < 3; c++) dst[x * 3 + c] = px[c * step];
            }
        }
    }
    return true;
}

#endif  // VTAMIQ_PNG_ZLIB

// ---------------------------------------------------------------------------
// shared: decode to uint8 RGB, then fused flip + [0,1] scale + normalize
// ---------------------------------------------------------------------------

int decode_rgb_u8(const char* path, int h, int w, unsigned char* rgb) {
    FILE* f = fopen(path, "rb");
    if (!f) return ST_OPEN;
    Format fmt = sniff_format(f);
    int st = ST_BAD;
    if (fmt == Format::BMP) {
        BmpInfo info;
        if (bmp_read_info(f, &info) && info.width == w && info.height == h &&
            bmp_decode(f, info, rgb))
            st = ST_OK;
    } else if (fmt == Format::JPEG) {
#ifdef VTAMIQ_HAVE_JPEG
        if (jpeg_decode(f, h, w, rgb)) st = ST_OK;
#else
        st = ST_NO_JPEG;
#endif
    } else if (fmt == Format::PNG) {
#ifdef VTAMIQ_HAVE_PNG
        if (png_decode(f, h, w, rgb)) st = ST_OK;
#else
        st = ST_NO_PNG;
#endif
    }
    fclose(f);
    return st;
}

void postprocess(const unsigned char* rgb, float* out, int h, int w,
                 long row_stride, int hflip, int vflip, const float* mean,
                 const float* std) {
    const float inv255 = 1.0f / 255.0f;
    float scale[3], bias[3];
    for (int c = 0; c < 3; c++) {
        const float s = std ? std[c] : 1.0f;
        const float m = mean ? mean[c] : 0.0f;
        scale[c] = inv255 / s;
        bias[c] = -m / s;
    }
    for (int y = 0; y < h; y++) {
        const int src_y = vflip ? (h - 1 - y) : y;
        const unsigned char* src_row = rgb + (size_t)src_y * w * 3;
        float* dst_row = out + (size_t)y * row_stride;
        for (int x = 0; x < w; x++) {
            const int src_x = hflip ? (w - 1 - x) : x;
            const unsigned char* px = src_row + (size_t)src_x * 3;
            dst_row[x * 3 + 0] = px[0] * scale[0] + bias[0];
            dst_row[x * 3 + 1] = px[1] * scale[1] + bias[1];
            dst_row[x * 3 + 2] = px[2] * scale[2] + bias[2];
        }
    }
}

}  // namespace

extern "C" {

int vtamiq_io_codecs(void) {
    int codecs = VTAMIQ_CODEC_BMP;
#ifdef VTAMIQ_HAVE_JPEG
    codecs |= VTAMIQ_CODEC_JPEG;
#endif
#ifdef VTAMIQ_HAVE_PNG
    codecs |= VTAMIQ_CODEC_PNG;
#endif
#ifdef VTAMIQ_PNG_ZLIB
    codecs |= VTAMIQ_CODEC_PNG_ZLIB;
#endif
    return codecs;
}

// Query image dimensions.
int vtamiq_image_size(const char* path, int* h, int* w) {
    FILE* f = fopen(path, "rb");
    if (!f) return ST_OPEN;
    Format fmt = sniff_format(f);
    int st = ST_BAD;
    if (fmt == Format::BMP) {
        BmpInfo info;
        if (bmp_read_info(f, &info)) {
            *h = info.height;
            *w = info.width;
            st = ST_OK;
        }
    } else if (fmt == Format::JPEG) {
#ifdef VTAMIQ_HAVE_JPEG
        if (jpeg_read_size(f, h, w)) st = ST_OK;
#else
        st = ST_NO_JPEG;
#endif
    } else if (fmt == Format::PNG) {
#ifdef VTAMIQ_HAVE_PNG
        if (png_read_size(f, h, w)) st = ST_OK;
#else
        st = ST_NO_PNG;
#endif
    }
    fclose(f);
    return st;
}

// Decode into a caller-allocated float32 HWC buffer holding h rows of
// row_stride floats (w * 3 used), with optional flips and per-channel
// normalization ((x - mean) / std; NULL for raw [0,1]).
int vtamiq_decode_rgb_f32(const char* path, float* out, int h, int w,
                          long row_stride, int hflip, int vflip,
                          const float* mean, const float* std_) {
    std::vector<unsigned char> rgb((size_t)h * w * 3);
    const int st = decode_rgb_u8(path, h, w, rgb.data());
    if (st != ST_OK) return st;
    if (row_stride <= 0) row_stride = (long)w * 3;
    postprocess(rgb.data(), out, h, w, row_stride, hflip, vflip, mean, std_);
    return ST_OK;
}

// Decode a batch on num_threads threads. outs[i] holds hs[i] rows of
// row_strides[i] floats (NULL row_strides: ws[i] * 3). statuses[i] gets each
// image's status; returns the number of failed decodes (0 = all good).
int vtamiq_decode_batch(const char** paths, int n, float** outs,
                        const int* hs, const int* ws, const long* row_strides,
                        const int* hflips, const int* vflips,
                        const float* mean, const float* std_,
                        int num_threads, int* statuses) {
    if (num_threads < 1) num_threads = 1;
    if (num_threads > n) num_threads = n;
    std::atomic<int> next(0), failures(0);
    auto worker = [&]() {
        for (;;) {
            const int i = next.fetch_add(1);
            if (i >= n) break;
            const int st = vtamiq_decode_rgb_f32(
                paths[i], outs[i], hs[i], ws[i], row_strides ? row_strides[i] : 0,
                hflips ? hflips[i] : 0, vflips ? vflips[i] : 0, mean, std_);
            statuses[i] = st;
            if (st != ST_OK) failures.fetch_add(1);
        }
    };
    if (num_threads <= 1) {
        worker();
    } else {
        std::vector<std::thread> threads;
        for (int t = 0; t < num_threads; t++) threads.emplace_back(worker);
        for (auto& t : threads) t.join();
    }
    return failures.load();
}

}  // extern "C"
