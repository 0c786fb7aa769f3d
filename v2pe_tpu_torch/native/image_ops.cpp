// Native host-side image preprocessing for the data loader hot path
// (SURVEY §2.11: decode/resize/tiling kept on host; this replaces the
// per-tile PIL resize + numpy normalize Python loop with one C++ call).
//
// The resize replicates Pillow's resampling algorithm (separable
// convolution with antialias support scaling, bicubic a=-0.5, fixed-point
// 8-bit path with PRECISION_BITS=22) so outputs are bit-identical to the
// PIL pipeline used by the reference's build_transform
// (internvl/train/dataset.py:298-332) — verified by tests.
//
// Build: g++ -O3 -shared -fPIC image_ops.cpp -o image_ops.so

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <cmath>
#include <vector>
#include <algorithm>

namespace {

constexpr int PRECISION_BITS = 32 - 8 - 2;  // Pillow 8bpc fixed point

static inline uint8_t clip8(int in) {
    if (in >= (1 << PRECISION_BITS << 8)) return 255;
    if (in <= 0) return 0;
    return (uint8_t)(in >> PRECISION_BITS);
}

static inline double bicubic_filter(double x) {
    // Pillow BICUBIC: a = -0.5, support = 2.0
    constexpr double a = -0.5;
    if (x < 0.0) x = -x;
    if (x < 1.0) return ((a + 2.0) * x - (a + 3.0)) * x * x + 1.0;
    if (x < 2.0) return (((x - 5.0) * x + 8.0) * x - 4.0) * a;
    return 0.0;
}

// Pillow precompute_coeffs
static int precompute_coeffs(int in_size, int out_size, double* &bounds_ks,
                             int* &bounds, double* &kk) {
    const double scale = (double)in_size / out_size;
    double filterscale = scale;
    if (filterscale < 1.0) filterscale = 1.0;
    const double support = 2.0 * filterscale;  // bicubic support
    const int ksize = (int)ceil(support) * 2 + 1;

    kk = (double*)malloc(sizeof(double) * out_size * ksize);
    bounds = (int*)malloc(sizeof(int) * out_size * 2);
    const double ss = 1.0 / filterscale;
    for (int xx = 0; xx < out_size; xx++) {
        double center = (xx + 0.5) * scale;
        double ww = 0.0;
        int xmin = (int)(center - support + 0.5);
        if (xmin < 0) xmin = 0;
        int xmax = (int)(center + support + 0.5);
        if (xmax > in_size) xmax = in_size;
        xmax -= xmin;
        double* k = &kk[xx * ksize];
        int x;
        for (x = 0; x < xmax; x++) {
            double w = bicubic_filter((x + xmin - center + 0.5) * ss);
            k[x] = w;
            ww += w;
        }
        for (x = 0; x < xmax; x++) {
            if (ww != 0.0) k[x] /= ww;
        }
        for (; x < ksize; x++) k[x] = 0.0;
        bounds[xx * 2 + 0] = xmin;
        bounds[xx * 2 + 1] = xmax;
    }
    (void)bounds_ks;
    return ksize;
}

static void normalize_coeffs_8bpc(int out_size, int ksize, const double* prekk,
                                  int32_t* kk) {
    for (int i = 0; i < out_size * ksize; i++) {
        double v = prekk[i];
        kk[i] = (int32_t)(v < 0 ? v * (1 << PRECISION_BITS) - 0.5
                                : v * (1 << PRECISION_BITS) + 0.5);
    }
}

// Horizontal pass: src (h, sw, C) uint8 -> dst (h, dw, C) uint8
static void resample_horiz(const uint8_t* src, int h, int sw, uint8_t* dst,
                           int dw, int C, int ksize, const int* bounds,
                           const int32_t* kk) {
    for (int yy = 0; yy < h; yy++) {
        const uint8_t* row = src + (size_t)yy * sw * C;
        uint8_t* orow = dst + (size_t)yy * dw * C;
        for (int xx = 0; xx < dw; xx++) {
            int xmin = bounds[xx * 2 + 0];
            int xmax = bounds[xx * 2 + 1];
            const int32_t* k = &kk[xx * ksize];
            for (int c = 0; c < C; c++) {
                int ss = 1 << (PRECISION_BITS - 1);
                for (int x = 0; x < xmax; x++)
                    ss += row[(size_t)(x + xmin) * C + c] * k[x];
                orow[(size_t)xx * C + c] = clip8(ss);
            }
        }
    }
}

// Vertical pass: src (sh, w, C) uint8 -> dst (dh, w, C) uint8
static void resample_vert(const uint8_t* src, int sh, int w, uint8_t* dst,
                          int dh, int C, int ksize, const int* bounds,
                          const int32_t* kk) {
    for (int yy = 0; yy < dh; yy++) {
        int ymin = bounds[yy * 2 + 0];
        int ymax = bounds[yy * 2 + 1];
        const int32_t* k = &kk[yy * ksize];
        uint8_t* orow = dst + (size_t)yy * w * C;
        for (int xx = 0; xx < w * C; xx++) {
            int ss = 1 << (PRECISION_BITS - 1);
            for (int y = 0; y < ymax; y++)
                ss += src[(size_t)(y + ymin) * w * C + xx] * k[y];
            orow[xx] = clip8(ss);
        }
    }
}

static void resize_u8(const uint8_t* src, int sh, int sw, uint8_t* dst,
                      int dh, int dw, int C) {
    double* kk_h = nullptr; int* b_h = nullptr; double* dummy = nullptr;
    int ks_h = precompute_coeffs(sw, dw, dummy, b_h, kk_h);
    std::vector<int32_t> ki_h((size_t)dw * ks_h);
    normalize_coeffs_8bpc(dw, ks_h, kk_h, ki_h.data());

    std::vector<uint8_t> tmp((size_t)sh * dw * C);
    resample_horiz(src, sh, sw, tmp.data(), dw, C, ks_h, b_h, ki_h.data());
    free(kk_h); free(b_h);

    double* kk_v = nullptr; int* b_v = nullptr;
    int ks_v = precompute_coeffs(sh, dh, dummy, b_v, kk_v);
    std::vector<int32_t> ki_v((size_t)dh * ks_v);
    normalize_coeffs_8bpc(dh, ks_v, kk_v, ki_v.data());
    resample_vert(tmp.data(), sh, dw, dst, dh, C, ks_v, b_v, ki_v.data());
    free(kk_v); free(b_v);
}

static void normalize_to_chw(const uint8_t* tile, int S, const float* mean,
                             const float* stdv, float* out) {
    // uint8 HWC -> float32 CHW, (x/255 - mean) / std
    for (int c = 0; c < 3; c++) {
        const float m = mean[c], inv = 1.0f / stdv[c];
        float* oc = out + (size_t)c * S * S;
        for (int i = 0; i < S * S; i++) {
            oc[i] = ((float)tile[(size_t)i * 3 + c] / 255.0f - m) * inv;
        }
    }
}

}  // namespace

extern "C" {

// PIL-exact bicubic resize, RGB uint8.
void pil_resize_rgb_u8(const uint8_t* src, int sh, int sw, uint8_t* dst,
                       int dh, int dw) {
    resize_u8(src, sh, sw, dst, dh, dw, 3);
}

// Full tiling pipeline for one image:
//   src (sh, sw, 3) uint8 -> out (n_tiles, 3, S, S) float32 normalized,
// where n_tiles = grid_w*grid_h (+1 thumbnail if use_thumbnail and >1).
// Semantics: resize to (S*grid_h, S*grid_w), crop row-major SxS tiles,
// thumbnail resized from the ORIGINAL image (dataset.py:746-788).
void tile_resize_normalize(const uint8_t* src, int sh, int sw,
                           int grid_w, int grid_h, int S, int use_thumbnail,
                           const float* mean, const float* stdv,
                           float* out) {
    const int gw = grid_w, gh = grid_h;
    const int W = S * gw, H = S * gh;
    std::vector<uint8_t> grid((size_t)H * W * 3);
    resize_u8(src, sh, sw, grid.data(), H, W, 3);

    const int blocks = gw * gh;
    std::vector<uint8_t> tile((size_t)S * S * 3);
    for (int i = 0; i < blocks; i++) {
        const int bx = (i % gw) * S;
        const int by = (i / gw) * S;
        for (int y = 0; y < S; y++) {
            memcpy(&tile[(size_t)y * S * 3],
                   &grid[((size_t)(by + y) * W + bx) * 3], (size_t)S * 3);
        }
        normalize_to_chw(tile.data(), S, mean, stdv,
                         out + (size_t)i * 3 * S * S);
    }
    if (use_thumbnail && blocks != 1) {
        std::vector<uint8_t> thumb((size_t)S * S * 3);
        resize_u8(src, sh, sw, thumb.data(), S, S, 3);
        normalize_to_chw(thumb.data(), S, mean, stdv,
                         out + (size_t)blocks * 3 * S * S);
    }
}

}  // extern "C"
