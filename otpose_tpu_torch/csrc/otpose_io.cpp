// Native host-side data pipeline core of the PyTorch port: JPEG decode
// (libjpeg), the batched bilinear affine warp with ImageNet normalisation,
// and the gaussian heatmap targets, OpenMP-parallel and called through
// ctypes (otpose_tpu_torch/data/native.py).
//
// A copy of native/otpose_io.cpp, the JAX package's library, with the same
// arithmetic, so that the two packages' native paths give the same bits.
// It replaces the reference's per-box cv2.imread + cv2.warpAffine +
// gaussian target loop (ref: dataset/PoseTrackDataset.py:228-425).
//
// Built at first use by otpose_tpu_torch/data/native.py with the JAX
// package's Makefile flags (g++ -O3 -march=native -fopenmp -fPIC -shared
// -ljpeg) into build/otpose_tpu_torch/.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>

#include <jpeglib.h>
#include <setjmp.h>

extern "C" {

// ---------------------------------------------------------------------------
// JPEG decode
// ---------------------------------------------------------------------------

struct ErrMgr {
  jpeg_error_mgr pub;
  jmp_buf jump;
};

static void err_exit(j_common_ptr cinfo) {
  ErrMgr* mgr = reinterpret_cast<ErrMgr*>(cinfo->err);
  longjmp(mgr->jump, 1);
}

// Decode one JPEG file to RGB into caller buffer (max_h*max_w*3, row-major,
// top-left anchored; rest left untouched). Returns 0 on success and writes
// the true dims to *h/*w; nonzero on failure.
int decode_jpeg(const char* path, uint8_t* out, int* h, int* w, int max_h,
                int max_w) {
  FILE* f = fopen(path, "rb");
  if (!f) return 1;
  jpeg_decompress_struct cinfo;
  ErrMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = err_exit;
  if (setjmp(jerr.jump)) {
    jpeg_destroy_decompress(&cinfo);
    fclose(f);
    return 2;
  }
  jpeg_create_decompress(&cinfo);
  jpeg_stdio_src(&cinfo, f);
  jpeg_read_header(&cinfo, TRUE);
  cinfo.out_color_space = JCS_RGB;
  jpeg_start_decompress(&cinfo);
  const int W = static_cast<int>(cinfo.output_width);
  const int H = static_cast<int>(cinfo.output_height);
  if (H > max_h || W > max_w) {
    jpeg_abort_decompress(&cinfo);
    jpeg_destroy_decompress(&cinfo);
    fclose(f);
    return 3;
  }
  *h = H;
  *w = W;
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* row = out + static_cast<size_t>(cinfo.output_scanline) * max_w * 3;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  fclose(f);
  return 0;
}

// Parallel batch decode. paths: n C strings; out: (n, max_h, max_w, 3) u8.
// Returns number of failures; hs/ws get per-image dims (0 on failure).
int decode_jpeg_batch(const char** paths, int n, uint8_t* out, int max_h,
                      int max_w, int* hs, int* ws) {
  int failures = 0;
#pragma omp parallel for schedule(dynamic) reduction(+ : failures)
  for (int i = 0; i < n; i++) {
    size_t stride = static_cast<size_t>(max_h) * max_w * 3;
    int rc = decode_jpeg(paths[i], out + i * stride, &hs[i], &ws[i], max_h,
                         max_w);
    if (rc != 0) {
      hs[i] = 0;
      ws[i] = 0;
      failures += 1;
    }
  }
  return failures;
}

// ---------------------------------------------------------------------------
// Batched affine warp + ImageNet normalization
// ---------------------------------------------------------------------------

// imgs: (n, in_h_max, in_w_max, 3) u8 with valid dims hs/ws; inv_mats:
// (n, 6) row-major 2x3 dst->src; out: (n, out_h, out_w, 3) f32 normalized.
// Matches cv2.warpAffine INTER_LINEAR + BORDER_CONSTANT(0) then
// (x/255 - mean)/std (ref: utils/transform.py:7-17).
void warp_normalize_batch(const uint8_t* imgs, const int* hs, const int* ws,
                          int n, int in_h_max, int in_w_max,
                          const double* inv_mats, float* out, int out_h,
                          int out_w) {
  const float mean[3] = {0.485f, 0.456f, 0.406f};
  const float stdv[3] = {0.229f, 0.224f, 0.225f};
#pragma omp parallel for schedule(dynamic)
  for (int i = 0; i < n; i++) {
    const uint8_t* img =
        imgs + static_cast<size_t>(i) * in_h_max * in_w_max * 3;
    const double* m = inv_mats + i * 6;
    float* dst = out + static_cast<size_t>(i) * out_h * out_w * 3;
    const int H = hs[i], W = ws[i];
    for (int y = 0; y < out_h; y++) {
      for (int x = 0; x < out_w; x++) {
        const double sx = m[0] * x + m[1] * y + m[2];
        const double sy = m[3] * x + m[4] * y + m[5];
        const int x0 = static_cast<int>(std::floor(sx));
        const int y0 = static_cast<int>(std::floor(sy));
        const float fx = static_cast<float>(sx - x0);
        const float fy = static_cast<float>(sy - y0);
        float px[3] = {0.f, 0.f, 0.f};
        for (int dy = 0; dy < 2; dy++) {
          for (int dx = 0; dx < 2; dx++) {
            const int yy = y0 + dy, xx = x0 + dx;
            if (yy < 0 || yy >= H || xx < 0 || xx >= W) continue;
            const float wgt = (dy ? fy : 1.f - fy) * (dx ? fx : 1.f - fx);
            const uint8_t* p = img + (static_cast<size_t>(yy) * in_w_max + xx) * 3;
            px[0] += wgt * p[0];
            px[1] += wgt * p[1];
            px[2] += wgt * p[2];
          }
        }
        float* q = dst + (static_cast<size_t>(y) * out_w + x) * 3;
        for (int c = 0; c < 3; c++)
          q[c] = (px[c] / 255.f - mean[c]) / stdv[c];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Gaussian heatmap targets
// ---------------------------------------------------------------------------

// joints: (n, j, 2) f64 in input-image coords; vis: (n, j) f32;
// target: (n, j, hm_h, hm_w) f32; weight: (n, j) f32.
// Semantics match utils/heatmap.py:48-105 (trunc rounding, clipped 3-sigma
// window, unnormalized peak 1).
void generate_targets_batch(const double* joints, const float* vis, int n,
                            int num_joints, double sigma, double stride_x,
                            double stride_y, int hm_w, int hm_h, float* target,
                            float* weight) {
  const double tmp = sigma * 3.0;
  const int itmp = static_cast<int>(tmp);
#pragma omp parallel for schedule(static)
  for (int i = 0; i < n * num_joints; i++) {
    const double jx = joints[i * 2 + 0];
    const double jy = joints[i * 2 + 1];
    const int mu_x = static_cast<int>(jx / stride_x + 0.5);
    const int mu_y = static_cast<int>(jy / stride_y + 0.5);
    float wgt = vis[i];
    const int ulx = mu_x - itmp, uly = mu_y - itmp;
    const int brx = mu_x + itmp + 1, bry = mu_y + itmp + 1;
    if (ulx >= hm_w || uly >= hm_h || brx < 0 || bry < 0) wgt = 0.f;
    weight[i] = wgt;
    float* t = target + static_cast<size_t>(i) * hm_h * hm_w;
    std::memset(t, 0, sizeof(float) * hm_h * hm_w);
    if (wgt <= 0.5f) continue;
    const int y0 = std::max(0, uly), y1 = std::min(bry, hm_h);
    const int x0 = std::max(0, ulx), x1 = std::min(brx, hm_w);
    const double inv = 1.0 / (2.0 * sigma * sigma);
    for (int y = y0; y < y1; y++) {
      const double dy = y - mu_y;
      for (int x = x0; x < x1; x++) {
        const double dx = x - mu_x;
        t[y * hm_w + x] = static_cast<float>(std::exp(-(dx * dx + dy * dy) * inv));
      }
    }
  }
}

}  // extern "C"
