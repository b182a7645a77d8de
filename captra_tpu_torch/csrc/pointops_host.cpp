// The host data core: farthest-point sampling and PNG unfiltering for the
// dataset readers, which run on the host inside loader workers.  The FPS
// has the algorithm, arithmetic and argument order of `native/pointops.cpp`
// of the JAX package, so both give the same indices on the same input.
//
// Build: g++ -O3 -ffp-contract=off -std=c++17 -shared -fPIC
//        (captra_tpu_torch/ops/cuda_build.py, at first use)
// ABI: plain C, consumed via ctypes (captra_tpu_torch/data/native.py).

#include <cstdint>
#include <vector>

extern "C" {

// Iterative farthest-point sampling: xyz [n, 3] row-major, first pick
// `start`, running minimum initialised to 1e10, each pick the smallest
// index attaining the max; writes `npoint` indices.
void captra_host_fps(const float* xyz, int64_t n, int64_t npoint,
                     int64_t start, int64_t* out) {
    if (n <= 0 || npoint <= 0) return;
    std::vector<float> dist(n, 1e10f);
    int64_t farthest = start < n ? start : 0;
    for (int64_t i = 0; i < npoint; ++i) {
        out[i] = farthest;
        const float cx = xyz[farthest * 3 + 0];
        const float cy = xyz[farthest * 3 + 1];
        const float cz = xyz[farthest * 3 + 2];
        float best = -1.0f;
        int64_t best_idx = 0;
        for (int64_t j = 0; j < n; ++j) {
            const float dx = xyz[j * 3 + 0] - cx;
            const float dy = xyz[j * 3 + 1] - cy;
            const float dz = xyz[j * 3 + 2] - cz;
            const float d = dx * dx + dy * dy + dz * dz;
            if (d < dist[j]) dist[j] = d;
            if (dist[j] > best) { best = dist[j]; best_idx = j; }
        }
        farthest = best_idx;
    }
}

// PNG scanline unfiltering (the PNG specification's filters 0-4: None,
// Sub, Up, Average, Paeth) of a decompressed image: raw [h, 1 + stride],
// each row its filter byte and then its bytes; bpp the bytes a pixel (at
// least 1).  Writes out [h, stride].  Returns -1, or the first row whose
// filter byte is not 0-4 (out is then written up to that row).
int64_t captra_host_png_unfilter(const uint8_t* raw, int64_t h,
                                 int64_t stride, int64_t bpp, uint8_t* out) {
    for (int64_t r = 0; r < h; ++r) {
        const uint8_t kind = raw[r * (stride + 1)];
        const uint8_t* line = raw + r * (stride + 1) + 1;
        uint8_t* cur = out + r * stride;
        const uint8_t* prev = r > 0 ? cur - stride : nullptr;
        if (kind > 4) return r;
        for (int64_t i = 0; i < stride; ++i) {
            const int a = i >= bpp ? cur[i - bpp] : 0;
            const int b = prev ? prev[i] : 0;
            const int c = prev && i >= bpp ? prev[i - bpp] : 0;
            int pred = 0;
            if (kind == 1) {
                pred = a;
            } else if (kind == 2) {
                pred = b;
            } else if (kind == 3) {
                pred = (a + b) >> 1;
            } else if (kind == 4) {
                const int p = a + b - c;
                const int pa = p > a ? p - a : a - p;
                const int pb = p > b ? p - b : b - p;
                const int pc = p > c ? p - c : c - p;
                pred = (pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c);
            }
            cur[i] = (uint8_t)(line[i] + pred);
        }
    }
    return -1;
}

}  // extern "C"
