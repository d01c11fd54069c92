// JPEG decode on the card with nvJPEG, into a uint8 staging buffer, with
// libjpeg's chroma upsampling and colour conversion.
//
// Not the port of a TPU kernel: the JAX package decodes frames with libjpeg
// on the host (otpose_tpu/data/device_loader.py, native/otpose_io.cpp) and
// ships the raw pixels; here the host reads only the files' bytes and
// headers, and the card decodes each frame into row i of the
// (n, max_h, max_w, 3) buffer that DeviceLoader's full mode warps from
// (pitch max_w * 3, the frame at the top left over zeros).
//
// nvJPEG decodes each frame's planes (Y, and Cb and Cr at their sampled
// size) into a scratch buffer the caller allocates (otp_nvjpeg_plan says
// how large); ycc_to_rgb_kernel then does what libjpeg(-turbo) does after
// its IDCT, with its integer arithmetic: "fancy" triangle upsampling of
// 4:2:0 and 4:2:2 chroma (jdsample.c h2v2_fancy_upsample, biases 8 and 7;
// h2v1_fancy_upsample, biases 1 and 2; edges replicated) and the
// fixed-point YCbCr -> RGB tables of jdcolor.c, or grey replicated to RGB.
// So nvJPEG's pixels differ from libjpeg's only where the two IDCTs round
// differently.  nvJPEG's own upsampling (its RGBI output) differed by up to
// 70 uint8 steps at colour edges, so it is not used: a frame of any other
// sampling (4:4:0, 4:1:1, ...) is refused (kUnsupportedSampling).
//
// What bounds it: the entropy (Huffman) decode, which the hardware backend
// runs on the card's JPEG engines and the default backend on the host's
// CPU; the kernel reads w*h + 2*cw*ch bytes and writes 3*w*h a frame.  The
// batch goes to nvjpegDecodeBatched on the hardware backend when
// nvjpegCreateEx gives one and the engine takes the file
// (nvjpegDecodeBatchedSupported); every other file, or every file under
// force_default, goes through nvjpegDecode on the default backend, one
// frame after another (each waits for the one before: they share the
// decoder state's buffers).  Each
// frame reports the backend that decoded it and the conversion that made
// its RGB.  The call synchronises its stream before it returns, so the
// caller may free the file bytes and the scratch.  The hardware branch has
// not run on a card yet: CUDA 12.9's nvJPEG refused NVJPEG_BACKEND_HARDWARE
// on the H100 (status 7, arch mismatch).
//
// Plain C interface, loaded with ctypes (otpose_tpu_torch/data/nvjpeg.py).

#include <cuda_runtime.h>
#include <nvjpeg.h>

#include <algorithm>
#include <cstddef>
#include <cstdint>
#include <vector>

namespace {

constexpr int kTooLarge = 1000;   // a frame larger than the staging buffer
constexpr int kUnsupportedSampling = 1001;  // chroma sampling the kernel lacks
constexpr int kCudaBase = 10000;  // 10000 + a CUDA error
constexpr int kBackendHardware = 1;
constexpr int kBackendDefault = 2;
// how a frame's RGB is made: the kernel's mode
constexpr int kGrey = 0;          // Y replicated
constexpr int kFull = 1;          // 4:4:4: colour conversion only
constexpr int kFancy420 = 2;      // 4:2:0: libjpeg's h2v2 fancy upsampling, then colour
constexpr int kFancy422 = 3;      // 4:2:2: libjpeg's h2v1 fancy upsampling, then colour
constexpr int kThreads = 256;

struct Ctx {
  nvjpegHandle_t hw = nullptr;             // hardware backend, where the card has one
  nvjpegJpegState_t hw_state = nullptr;
  nvjpegJpegStream_t hw_stream = nullptr;  // parsed header for the support query
  int hw_batch = 0;                        // the batch size hw_state was set up for
  nvjpegHandle_t gpu = nullptr;            // the default backend
  nvjpegJpegState_t gpu_state = nullptr;
};

struct Frame {
  int h = 0, w = 0, ch = 0, cw = 0, mode = kGrey;
  size_t scratch = 0;                      // offset of its planes in the scratch buffer
};

void destroy(Ctx* c) {
  if (c == nullptr) return;
  if (c->hw_stream) nvjpegJpegStreamDestroy(c->hw_stream);
  if (c->hw_state) nvjpegJpegStateDestroy(c->hw_state);
  if (c->hw) nvjpegDestroy(c->hw);
  if (c->gpu_state) nvjpegJpegStateDestroy(c->gpu_state);
  if (c->gpu) nvjpegDestroy(c->gpu);
  delete c;
}

size_t plane_bytes(const Frame& f) {
  if (f.mode == kGrey) return static_cast<size_t>(f.h) * f.w;
  return static_cast<size_t>(f.h) * f.w + 2 * static_cast<size_t>(f.ch) * f.cw;
}

// Sizes and conversion of every frame, and the scratch they need.
int plan_frames(Ctx* c, const unsigned char* const* data, const size_t* lengths, int n,
                int max_h, int max_w, std::vector<Frame>& frames, size_t* scratch,
                int* hs, int* ws, int* failed) {
  frames.assign(n, Frame());
  *scratch = 0;
  for (int i = 0; i < n; i++) {
    int comps = 0;
    nvjpegChromaSubsampling_t sub;
    int widths[NVJPEG_MAX_COMPONENT] = {0};
    int heights[NVJPEG_MAX_COMPONENT] = {0};
    nvjpegStatus_t st = nvjpegGetImageInfo(c->gpu, data[i], lengths[i], &comps, &sub,
                                           widths, heights);
    if (st != NVJPEG_STATUS_SUCCESS) {
      *failed = i;
      return st;
    }
    Frame& f = frames[i];
    f.h = hs[i] = heights[0];
    f.w = ws[i] = widths[0];
    if (f.h > max_h || f.w > max_w) {
      *failed = i;
      return kTooLarge;
    }
    if (comps == 1) {
      f.mode = kGrey;
    } else if (comps == 3 && sub == NVJPEG_CSS_444) {
      f.mode = kFull;
      f.ch = f.h;
      f.cw = f.w;
    } else if (comps == 3 && (sub == NVJPEG_CSS_420 || sub == NVJPEG_CSS_422)) {
      f.mode = sub == NVJPEG_CSS_420 ? kFancy420 : kFancy422;
      f.ch = heights[1];
      f.cw = widths[1];
    } else {
      *failed = i;
      return kUnsupportedSampling;
    }
    f.scratch = *scratch;
    *scratch += (plane_bytes(f) + 255) / 256 * 256;
  }
  return 0;
}

nvjpegImage_t planes_of(const Frame& f, uint8_t* scratch) {
  nvjpegImage_t img = {};
  uint8_t* y = scratch + f.scratch;
  img.channel[0] = y;
  img.pitch[0] = f.w;
  if (f.mode != kGrey) {
    img.channel[1] = y + static_cast<size_t>(f.h) * f.w;
    img.channel[2] = img.channel[1] + static_cast<size_t>(f.ch) * f.cw;
    img.pitch[1] = img.pitch[2] = f.cw;
  }
  return img;
}

nvjpegOutputFormat_t format_of(const Frame& f) {
  return f.mode == kGrey ? NVJPEG_OUTPUT_Y : NVJPEG_OUTPUT_YUV;
}

// libjpeg's h2v2 fancy upsampling of one chroma sample at output (x, y):
// 3/4 of the nearer and 1/4 of the farther chroma row, then of the column,
// with biases 8 (even columns) and 7 (odd); rows and columns past the edges
// repeat the edge.
__device__ __forceinline__ int fancy_sample(const uint8_t* __restrict__ c, int x, int y,
                                            int cw, int ch) {
  const int i = y >> 1;
  const int j = (y & 1) ? min(i + 1, ch - 1) : max(i - 1, 0);
  const uint8_t* nearer = c + static_cast<size_t>(i) * cw;
  const uint8_t* farther = c + static_cast<size_t>(j) * cw;
  const int k = x >> 1;
  const int k2 = (x & 1) ? min(k + 1, cw - 1) : max(k - 1, 0);
  const int col = 3 * nearer[k] + farther[k];
  const int other = 3 * nearer[k2] + farther[k2];
  return (3 * col + other + ((x & 1) ? 7 : 8)) >> 4;
}

// libjpeg's h2v1 fancy upsampling of one chroma sample at output (x, y):
// 3/4 of the nearer and 1/4 of the farther column of row y, biases 1 (even
// columns) and 2 (odd); columns past the edges repeat the edge.
__device__ __forceinline__ int fancy_sample_h2v1(const uint8_t* __restrict__ c, int x, int y,
                                                 int cw) {
  const uint8_t* row = c + static_cast<size_t>(y) * cw;
  const int k = x >> 1;
  const int k2 = (x & 1) ? min(k + 1, cw - 1) : max(k - 1, 0);
  return (3 * row[k] + row[k2] + ((x & 1) ? 2 : 1)) >> 2;
}

__device__ __forceinline__ uint8_t clamp255(int v) {
  return static_cast<uint8_t>(min(max(v, 0), 255));
}

// One output pixel a thread: libjpeg's YCbCr -> RGB (jdcolor.c: FIX(x) =
// x * 2^16 rounded, right shifts that floor) into row y of the frame's
// staging slot.
__global__ void ycc_to_rgb_kernel(const uint8_t* __restrict__ yp, const uint8_t* __restrict__ cbp,
                                  const uint8_t* __restrict__ crp, int w, int h, int cw, int ch,
                                  int mode, uint8_t* __restrict__ out, int pitch) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y;
  if (x >= w || y >= h) return;
  const int lum = yp[static_cast<size_t>(y) * w + x];
  uint8_t* o = out + static_cast<size_t>(y) * pitch + 3 * x;
  if (mode == kGrey) {
    o[0] = o[1] = o[2] = static_cast<uint8_t>(lum);
    return;
  }
  int cb, cr;
  if (mode == kFull) {
    cb = cbp[static_cast<size_t>(y) * cw + x];
    cr = crp[static_cast<size_t>(y) * cw + x];
  } else if (mode == kFancy420) {
    cb = fancy_sample(cbp, x, y, cw, ch);
    cr = fancy_sample(crp, x, y, cw, ch);
  } else {
    cb = fancy_sample_h2v1(cbp, x, y, cw);
    cr = fancy_sample_h2v1(crp, x, y, cw);
  }
  cb -= 128;
  cr -= 128;
  constexpr int kHalf = 1 << 15;
  const int r = (91881 * cr + kHalf) >> 16;             // FIX(1.40200)
  const int b = (116130 * cb + kHalf) >> 16;            // FIX(1.77200)
  const int g = (-22554 * cb + kHalf - 46802 * cr) >> 16;  // FIX(0.34414), FIX(0.71414)
  o[0] = clamp255(lum + r);
  o[1] = clamp255(lum + g);
  o[2] = clamp255(lum + b);
}

}  // namespace

extern "C" {

const char* otp_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

const char* otp_nvjpeg_status_string(int st) {
  switch (st) {
    case NVJPEG_STATUS_SUCCESS: return "success";
    case NVJPEG_STATUS_NOT_INITIALIZED: return "not initialized";
    case NVJPEG_STATUS_INVALID_PARAMETER: return "invalid parameter";
    case NVJPEG_STATUS_BAD_JPEG: return "bad JPEG";
    case NVJPEG_STATUS_JPEG_NOT_SUPPORTED: return "JPEG not supported";
    case NVJPEG_STATUS_ALLOCATOR_FAILURE: return "allocator failure";
    case NVJPEG_STATUS_EXECUTION_FAILED: return "execution failed";
    case NVJPEG_STATUS_ARCH_MISMATCH: return "arch mismatch";
    case NVJPEG_STATUS_INTERNAL_ERROR: return "internal error";
    case NVJPEG_STATUS_IMPLEMENTATION_NOT_SUPPORTED: return "implementation not supported";
    case kTooLarge: return "frame larger than the staging buffer";
    case kUnsupportedSampling: return "chroma sampling other than 4:2:0, 4:2:2, 4:4:4 or grey";
    default: return "unknown status";
  }
}

// A decoder context: the default backend always, the hardware backend when
// want_hardware and the card has one (*hardware = 1; *hw_status is what
// nvjpegCreateEx said for it).  Returns an nvJPEG status.
int otp_nvjpeg_create(int want_hardware, void** out, int* hardware, int* hw_status) {
  Ctx* c = new Ctx();
  *hardware = 0;
  *hw_status = -1;
  *out = nullptr;
  if (want_hardware) {
    *hw_status = nvjpegCreateEx(NVJPEG_BACKEND_HARDWARE, nullptr, nullptr,
                                NVJPEG_FLAGS_DEFAULT, &c->hw);
    if (*hw_status == NVJPEG_STATUS_SUCCESS &&
        nvjpegJpegStateCreate(c->hw, &c->hw_state) == NVJPEG_STATUS_SUCCESS &&
        nvjpegJpegStreamCreate(c->hw, &c->hw_stream) == NVJPEG_STATUS_SUCCESS) {
      *hardware = 1;
    } else {
      if (c->hw_state) nvjpegJpegStateDestroy(c->hw_state);
      if (*hw_status == NVJPEG_STATUS_SUCCESS) nvjpegDestroy(c->hw);
      c->hw = nullptr;
      c->hw_state = nullptr;
      c->hw_stream = nullptr;
    }
  }
  nvjpegStatus_t st = nvjpegCreateEx(NVJPEG_BACKEND_DEFAULT, nullptr, nullptr,
                                     NVJPEG_FLAGS_DEFAULT, &c->gpu);
  if (st == NVJPEG_STATUS_SUCCESS) st = nvjpegJpegStateCreate(c->gpu, &c->gpu_state);
  if (st != NVJPEG_STATUS_SUCCESS) {
    destroy(c);
    return st;
  }
  *out = c;
  return 0;
}

void otp_nvjpeg_destroy(void* ctx) { destroy(static_cast<Ctx*>(ctx)); }

// The scratch bytes a decode of these files needs (their planes), and each
// frame's size.  Returns 0, an nvJPEG status, kTooLarge or
// kUnsupportedSampling (*failed: the frame).
int otp_nvjpeg_plan(void* ctx, const unsigned char* const* data, const size_t* lengths, int n,
                    int max_h, int max_w, size_t* scratch_bytes, int* hs, int* ws,
                    int* failed) {
  std::vector<Frame> frames;
  *failed = -1;
  return plan_frames(static_cast<Ctx*>(ctx), data, lengths, n, max_h, max_w, frames,
                     scratch_bytes, hs, ws, failed);
}

// Decode n JPEGs (data[i], lengths[i] bytes, on the host) into out, a
// device buffer of n * max_h * max_w * 3 bytes zeroed by the caller, through
// scratch (scratch_bytes on the device, as otp_nvjpeg_plan asked).  Writes
// each frame's size to hs / ws, its backend to backend_used and its
// conversion to conversion (0 grey, 1 4:4:4, 2 4:2:0, 3 4:2:2, each with
// libjpeg's upsampling); *launches counts the conversion kernel's
// launches.  Returns 0, an nvJPEG status, kTooLarge, kUnsupportedSampling
// or kCudaBase + a CUDA error; *failed is the frame at fault (-1: no one
// frame).
int otp_nvjpeg_decode_batch(void* ctx, const unsigned char* const* data,
                            const size_t* lengths, int n, uint8_t* out, int max_h,
                            int max_w, uint8_t* scratch, size_t scratch_bytes,
                            int force_default, int* hs, int* ws, int* backend_used,
                            int* conversion, int* launches, int* failed, void* stream_ptr) {
  Ctx* c = static_cast<Ctx*>(ctx);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  *failed = -1;
  *launches = 0;
  std::vector<Frame> frames;
  size_t need = 0;
  int st = plan_frames(c, data, lengths, n, max_h, max_w, frames, &need, hs, ws, failed);
  if (st != 0) return st;
  if (need > scratch_bytes) return NVJPEG_STATUS_INVALID_PARAMETER;
  const size_t frame_bytes = static_cast<size_t>(max_h) * max_w * 3;
  std::vector<int> hw_idx, gpu_idx;
  for (int i = 0; i < n; i++) {
    conversion[i] = frames[i].mode;
    int unsupported = 1;
    // the hardware batch shares one output format: the planes (YUV)
    if (c->hw != nullptr && !force_default &&
        frames[i].mode != kGrey &&
        nvjpegJpegStreamParse(c->hw, data[i], lengths[i], 0, 0, c->hw_stream) ==
            NVJPEG_STATUS_SUCCESS &&
        nvjpegDecodeBatchedSupported(c->hw, c->hw_stream, &unsupported) !=
            NVJPEG_STATUS_SUCCESS) {
      unsupported = 1;
    }
    if (unsupported == 0) {
      hw_idx.push_back(i);
      backend_used[i] = kBackendHardware;
    } else {
      gpu_idx.push_back(i);
      backend_used[i] = kBackendDefault;
    }
  }
  if (!hw_idx.empty()) {
    const int m = static_cast<int>(hw_idx.size());
    if (c->hw_batch != m) {
      nvjpegStatus_t s = nvjpegDecodeBatchedInitialize(c->hw, c->hw_state, m, 1,
                                                       NVJPEG_OUTPUT_YUV);
      if (s != NVJPEG_STATUS_SUCCESS) return s;
      c->hw_batch = m;
    }
    std::vector<const unsigned char*> ptrs(m);
    std::vector<size_t> lens(m);
    std::vector<nvjpegImage_t> dst(m);
    for (int k = 0; k < m; k++) {
      const int i = hw_idx[k];
      ptrs[k] = data[i];
      lens[k] = lengths[i];
      dst[k] = planes_of(frames[i], scratch);
    }
    nvjpegStatus_t s = nvjpegDecodeBatched(c->hw, c->hw_state, ptrs.data(), lens.data(),
                                           dst.data(), stream);
    if (s != NVJPEG_STATUS_SUCCESS) {
      if (m == 1) *failed = hw_idx[0];
      return s;
    }
  }
  for (int i : gpu_idx) {
    nvjpegImage_t img = planes_of(frames[i], scratch);
    nvjpegStatus_t s = nvjpegDecode(c->gpu, c->gpu_state, data[i], lengths[i],
                                    format_of(frames[i]), &img, stream);
    if (s != NVJPEG_STATUS_SUCCESS) {
      *failed = i;
      return s;
    }
    // the state's host buffers are reused by the next frame's Huffman
    // decode: let this frame's copies and kernels finish first (without
    // this wait a batch's third frame came out wrong on the H100)
    cudaError_t err = cudaStreamSynchronize(stream);
    if (err != cudaSuccess) {
      *failed = i;
      return kCudaBase + static_cast<int>(err);
    }
  }
  for (int i = 0; i < n; i++) {
    const Frame& f = frames[i];
    const uint8_t* y = scratch + f.scratch;
    const uint8_t* cb = y + static_cast<size_t>(f.h) * f.w;
    const uint8_t* cr = cb + static_cast<size_t>(f.ch) * f.cw;
    dim3 grid((f.w + kThreads - 1) / kThreads, f.h);
    ycc_to_rgb_kernel<<<grid, kThreads, 0, stream>>>(
        y, cb, cr, f.w, f.h, f.cw, f.ch, f.mode, out + static_cast<size_t>(i) * frame_bytes,
        max_w * 3);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) {
      *failed = i;
      return kCudaBase + static_cast<int>(err);
    }
    *launches += 1;
  }
  cudaError_t err = cudaStreamSynchronize(stream);
  if (err == cudaSuccess) err = cudaGetLastError();
  return err == cudaSuccess ? 0 : kCudaBase + static_cast<int>(err);
}

}  // extern "C"
