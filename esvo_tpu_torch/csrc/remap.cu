// K3: bilinear remap of an (H, W) f32 image through a fixed (H, W, 2) map,
// cv::remap BORDER_CONSTANT semantics with fill 0 applied per tap.
//
// Replaces the TPU kernel esvo_tpu/ops/pallas_remap.py:_kernel /
// _remap_with_plan (entry remap_fixed_map), whose host-side RemapPlan
// banding exists only for the TPU's aligned vector loads.
//
// What bounds it on the card: bytes. Per output pixel it reads one float2
// map entry (8 B) and writes one float (4 B); the four image taps hit L2
// (the image is at most 1.2 MB at 640x480), so the image is read from
// device memory about once (4 B/pixel): 16 B/pixel in all.
//
// Design: one thread per output pixel. Neighbouring threads read
// neighbouring map entries (coalesced 8-byte loads) and write neighbouring
// outputs. Each tap is masked by its own in-bounds test and the four
// weighted taps are summed in the same order as the plain twin
// (ops/remap.py::remap_plain), so a sample whose 2x2 window lies wholly
// outside the image is exactly 0. Every product and sum is an explicit
// round-to-nearest intrinsic, which nvcc never contracts into an FMA, so
// the kernel is bit-exact with the twin.
#include <cuda_runtime.h>

__device__ __forceinline__ float tap(const float* __restrict__ img, int H,
                                     int W, int yi, int xi, float w) {
  const bool inb = (xi >= 0) && (xi < W) && (yi >= 0) && (yi < H);
  const float v = inb ? __ldg(img + (size_t)yi * W + xi) : 0.0f;
  return __fmul_rn(v, w);
}

__global__ void remap_kernel(const float* __restrict__ img,
                             const float2* __restrict__ map,
                             float* __restrict__ out, int H, int W) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= H * W) return;
  const float2 m = map[i];
  const float x0 = floorf(m.x);
  const float y0 = floorf(m.y);
  const float fx = __fsub_rn(m.x, x0);
  const float fy = __fsub_rn(m.y, y0);
  const int xi = (int)x0;
  const int yi = (int)y0;
  const float gx = __fsub_rn(1.0f, fx);
  const float gy = __fsub_rn(1.0f, fy);
  float acc = tap(img, H, W, yi, xi, __fmul_rn(gx, gy));
  acc = __fadd_rn(acc, tap(img, H, W, yi, xi + 1, __fmul_rn(fx, gy)));
  acc = __fadd_rn(acc, tap(img, H, W, yi + 1, xi, __fmul_rn(gx, fy)));
  acc = __fadd_rn(acc, tap(img, H, W, yi + 1, xi + 1, __fmul_rn(fx, fy)));
  out[i] = acc;
}

extern "C" int esvo_remap(const void* img, const void* map, void* out, int H,
                          int W, void* stream) {
  const int n = H * W;
  if (n > 0) {
    const int threads = 256;
    remap_kernel<<<(n + threads - 1) / threads, threads, 0,
                   (cudaStream_t)stream>>>(
        (const float*)img, (const float2*)map, (float*)out, H, W);
  }
  return (int)cudaGetLastError();
}
