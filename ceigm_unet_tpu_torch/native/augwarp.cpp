// Native host-side warp kernels for the CPU augmentation parity tier.
//
// The Python tier (data/augment.py) implements imgaug's
// geometric ops through scipy.ndimage; profiling puts ~95% of a
// 512x512 sample's augmentation cost in two places:
//   - piecewise_affine_warp: find_simplex over all pixels + a
//     per-triangle masked numpy loop + two map_coordinates passes
//     (~174 ms/invocation), and
//   - ndimage.affine_transform order-1/0 warps (~15 ms each).
// These kernels fuse each warp into one cache-friendly pass. Sampling
// reproduces scipy.ndimage map_coordinates/affine_transform semantics
// exactly (probed empirically, scipy 1.17):
//   - mode='constant': a RAW coordinate outside [0, size-1] (strictly)
//     yields cval for BOTH order 0 and 1 — no partial interpolation;
//   - order 0 rounds via floor(c + 0.5);
//   - order 1 is bilinear between the 4 in-bounds neighbors (the
//     c == size-1 edge works out through index clamping: the +1
//     neighbor's weight is exactly 0).
//
// Reference counterpart: imgaug delegates these loops to
// skimage/OpenCV C paths (gm-unet/dataset_synapse.py:61-72); this is
// the rebuilt framework's equivalent native tier.
//
// Built on demand by native/__init__.py, in each package from its own
// copy of this file (the code of the two copies is the same):
//   g++ -O3 -shared -fPIC -std=c++17 augwarp.cpp -o <library>

#include <cmath>
#include <cstdint>

namespace {

inline float sample_bilinear(const float* src, int H, int W,
                             double cy, double cx, float cval) {
    if (cy < 0.0 || cy > (double)(H - 1) || cx < 0.0 ||
        cx > (double)(W - 1))
        return cval;
    int y0 = (int)cy;
    int x0 = (int)cx;
    if (y0 > H - 2) y0 = H - 2;   // cy == H-1: weight of y1 is 0
    if (x0 > W - 2) x0 = W - 2;
    if (y0 < 0) y0 = 0;           // H == 1 / W == 1 degenerate sizes
    if (x0 < 0) x0 = 0;
    double fy = cy - y0, fx = cx - x0;
    const float* r0 = src + (size_t)y0 * W + x0;
    const float* r1 = (y0 + 1 < H) ? r0 + W : r0;
    double v00 = r0[0], v01 = (x0 + 1 < W) ? r0[1] : r0[0];
    double v10 = r1[0], v11 = (x0 + 1 < W) ? r1[1] : r1[0];
    double top = v00 + fx * (v01 - v00);
    double bot = v10 + fx * (v11 - v10);
    return (float)(top + fy * (bot - top));
}

inline float sample_nearest(const float* src, int H, int W,
                            double cy, double cx, float cval) {
    if (cy < 0.0 || cy > (double)(H - 1) || cx < 0.0 ||
        cx > (double)(W - 1))
        return cval;
    int y = (int)std::floor(cy + 0.5);
    int x = (int)std::floor(cx + 0.5);
    if (y > H - 1) y = H - 1;
    if (x > W - 1) x = W - 1;
    return src[(size_t)y * W + x];
}

}  // namespace

extern "C" {

// scipy.ndimage.affine_transform semantics: out[y, x] = src[M @ (y, x) + off]
// with M = [[m00, m01], [m10, m11]] in (row, col) convention.
void affine_warp_f32(const float* src, int H, int W,
                     double m00, double m01, double m10, double m11,
                     double off0, double off1,
                     int order, float cval, float* out) {
    // coordinates evaluated directly per pixel (not incrementally): the
    // fp values then match scipy's per-pixel matrix product bit-for-bit
    // in practice, which keeps order-0 rounding identical
    for (int y = 0; y < H; ++y) {
        double by = m00 * y + off0;
        double bx = m10 * y + off1;
        float* orow = out + (size_t)y * W;
        if (order == 0) {
            for (int x = 0; x < W; ++x)
                orow[x] = sample_nearest(src, H, W, by + m01 * x,
                                         bx + m11 * x, cval);
        } else {
            for (int x = 0; x < W; ++x)
                orow[x] = sample_bilinear(src, H, W, by + m01 * x,
                                          bx + m11 * x, cval);
        }
    }
}

// Fused piecewise-affine warp: per pixel, locate the containing source
// triangle (barycentric test, tol mirrors scipy find_simplex(tol=1e-8);
// scanline-coherent "last triangle first" probe), map through that
// triangle's affine, snap fp round-off at the domain boundary exactly
// like the Python tier, then sample image (order 1) and label (order 0)
// from the SAME coordinates in one pass.
//
// aff:   ns * 6 doubles per triangle [a00, a01, b0, a10, a11, b1]:
//        cy = a00*y + a01*x + b0 ; cx = a10*y + a11*x + b1
// verts: ns * 6 doubles per triangle [y0, x0, y1, x1, y2, x2]
void piecewise_warp_f32(const float* img, const float* lab, int H, int W,
                        const double* aff, const double* verts, int ns,
                        float cval, float* oimg, float* olab) {
    const double tol = 1e-8;
    const double hi_y = (double)(H - 1), hi_x = (double)(W - 1);
    // precompute inverse barycentric denominators
    double inv_den[256];
    int count = ns > 256 ? 256 : ns;
    for (int t = 0; t < count; ++t) {
        const double* v = verts + 6 * t;
        double d = (v[2] - v[0]) * (v[5] - v[1]) -
                   (v[4] - v[0]) * (v[3] - v[1]);
        inv_den[t] = d != 0.0 ? 1.0 / d : 0.0;
    }

    int last = 0;
    for (int y = 0; y < H; ++y) {
        float* oi = oimg + (size_t)y * W;
        float* ol = olab + (size_t)y * W;
        for (int x = 0; x < W; ++x) {
            int s = -1;
            for (int probe = 0; probe <= count; ++probe) {
                int t = probe == 0 ? last : probe - 1;
                if (probe > 0 && t == last) continue;
                const double* v = verts + 6 * t;
                double py = (double)y - v[0], px = (double)x - v[1];
                double e1y = v[2] - v[0], e1x = v[3] - v[1];
                double e2y = v[4] - v[0], e2x = v[5] - v[1];
                double l1 = (py * e2x - px * e2y) * inv_den[t];
                double l2 = (e1y * px - e1x * py) * inv_den[t];
                if (l1 >= -tol && l2 >= -tol && l1 + l2 <= 1.0 + tol) {
                    s = t;
                    last = t;
                    break;
                }
            }
            if (s < 0) {
                oi[x] = cval;
                ol[x] = cval;
                continue;
            }
            const double* a = aff + 6 * s;
            double cy = a[0] * y + a[1] * x + a[2];
            double cx = a[3] * y + a[4] * x + a[5];
            // snap: fp round-off in the affine solve lands boundary
            // pixels at -1e-16 / hi+1e-16; 'constant' mode would zero
            // them (augment.py snap())
            if (cy < 0.0 && cy > -1e-6) cy = 0.0;
            if (cy > hi_y && cy < hi_y + 1e-6) cy = hi_y;
            if (cx < 0.0 && cx > -1e-6) cx = 0.0;
            if (cx > hi_x && cx < hi_x + 1e-6) cx = hi_x;
            oi[x] = sample_bilinear(img, H, W, cy, cx, cval);
            ol[x] = sample_nearest(lab, H, W, cy, cx, cval);
        }
    }
}

// Separable banded resize: applies the EXACT scipy-zoom linear operator
// (rows extracted once per shape by ops/resize.py:zoom_matrix, truncated
// to their numeric band — cubic rows decay as |sqrt(3)-2|^d, so <= ~24
// taps hold everything above 1e-7) as two banded passes.
//
//   tmp[o, x] = sum_t yw[o*taps + t] * src[ys[o] + t, x]    (y pass)
//   out[o, p] = sum_t xw[p*taps + t] * tmp[o, xs[p] + t]    (x pass)
//
// Starts are pre-clamped so every window stays inside [0, size - taps];
// out-of-band tap weights are exactly 0.
void sep_resize_f32(const float* src, int H, int W,
                    const int32_t* ys, const float* yw, int Ho,
                    const int32_t* xs, const float* xw, int Wo,
                    int taps, float* tmp, float* out) {
    for (int o = 0; o < Ho; ++o) {
        float* trow = tmp + (size_t)o * W;
        const float* wrow = yw + (size_t)o * taps;
        const float* s0 = src + (size_t)ys[o] * W;
        for (int x = 0; x < W; ++x) trow[x] = 0.0f;
        for (int t = 0; t < taps; ++t) {
            float wt = wrow[t];
            if (wt == 0.0f) continue;
            const float* srow = s0 + (size_t)t * W;
            for (int x = 0; x < W; ++x) trow[x] += wt * srow[x];
        }
    }
    for (int o = 0; o < Ho; ++o) {
        const float* trow = tmp + (size_t)o * W;
        float* orow = out + (size_t)o * Wo;
        for (int p = 0; p < Wo; ++p) {
            const float* wrow = xw + (size_t)p * taps;
            const float* t0 = trow + xs[p];
            float acc = 0.0f;
            for (int t = 0; t < taps; ++t) acc += wrow[t] * t0[t];
            orow[p] = acc;
        }
    }
}

}  // extern "C"
