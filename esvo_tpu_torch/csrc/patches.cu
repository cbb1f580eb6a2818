// K1: batched window copy out of one image.
//
// Replaces the TPU kernel esvo_tpu/ops/pallas_patches.py:_kernel /
// pallas_slice_patches (an aligned slab load plus two on-chip rolls per
// window, starts scalar-prefetched).
//
// What bounds it on the card: bytes. Each window is read once and written
// once (at the depth solve's 24x32 windows, 3 KB out per window); the
// image itself (at most 1.2 MB) stays in L2. There is no arithmetic.
//
// Design: one block per window, 256 threads striding over its h*w floats.
// With w = 32 a warp reads one 128-byte image row segment and writes one
// 128-byte output row, both coalesced. The start is clamped exactly as
// lax.dynamic_slice / the TPU kernel clamp it (to [0, H-h] x [0, W-w]),
// so the copy is bit-exact against the plain twin.
#include <cuda_runtime.h>

__global__ void slice_patches_kernel(const float* __restrict__ img,
                                     const int* __restrict__ ul_y,
                                     const int* __restrict__ ul_x,
                                     float* __restrict__ out,
                                     int H, int W, int h, int w) {
  const int i = blockIdx.x;
  const int y0 = min(max(ul_y[i], 0), H - h);
  const int x0 = min(max(ul_x[i], 0), W - w);
  const int hw = h * w;
  float* dst = out + (size_t)i * hw;
  for (int k = threadIdx.x; k < hw; k += blockDim.x) {
    const int r = k / w;
    const int c = k - r * w;
    dst[k] = img[(size_t)(y0 + r) * W + (x0 + c)];
  }
}

extern "C" int esvo_slice_patches(const void* img, const void* ul_y,
                                  const void* ul_x, void* out, int n, int H,
                                  int W, int h, int w, void* stream) {
  if (n > 0) {
    slice_patches_kernel<<<n, 256, 0, (cudaStream_t)stream>>>(
        (const float*)img, (const int*)ul_y, (const int*)ul_x, (float*)out,
        H, W, h, w);
  }
  return (int)cudaGetLastError();
}
