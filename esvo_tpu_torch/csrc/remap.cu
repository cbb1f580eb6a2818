// K3: bilinear remap of an (H, W) f32 image through a fixed (H, W, 2) map,
// cv::remap BORDER_CONSTANT semantics with fill 0 applied per tap, for
// one camera or for both cameras of a rig in one launch.
//
// Replaces the TPU kernel esvo_tpu/ops/pallas_remap.py:_kernel (:122) /
// _remap_with_plan (:161, entry remap_fixed_map :267).
//
// What bounds it on the card: bytes. Per output pixel it reads one float2
// map entry (8 B) and writes one float (4 B); the four image taps hit L2
// (the image is at most 1.2 MB at 640x480), so the image is read from
// device memory about once (4 B/pixel): 16 B/pixel in all. At rpg
// (240x180) that is 0.21 us a camera, below the time any launch takes
// (a one-element fill_ takes about 1 us), so there only fewer launches
// help.
//
// Design (what each element does about the limits):
// - Both cameras in one launch: blockIdx.y picks the camera, so a render
//   tick pays one launch (and one host call) for its two surfaces.
//   remap_kernel is templated on NCAM, the cameras in its parameters, so
//   a one-camera launch carries one camera and selects nothing.
// - Pixels a thread, chosen from the input. While one pixel a thread
//   fits on the card at once (ncam * H * W threads at most the SMs'
//   resident threads: rpg, DAVIS346), each thread runs one chain (an
//   8-byte map load, 4 taps, a 4-byte store) and the kernel takes one
//   launch plus one chain; more pixels a thread only lengthen it. Beyond
//   one wave (DSEC), two consecutive pixels a thread over the flat index
//   halve the blocks: one 16-byte map load, 8 independent taps in flight,
//   one 8-byte store; the last thread takes an odd H * W's last pixel
//   alone. The map and output bases must be 16-byte aligned (the wrapper
//   checks and raises). Four pixels a thread was slower at both shapes.
// - One camera in one wave runs remap_one_kernel, whose pointers are
//   plain arguments. That launch is the launch floor plus one chain, so
//   its first instructions decide it: this form compiles to the shortest
//   start (the thread index on the uniform datapath), and every templated
//   form of the same body measured 4-70 ns slower on the H100 (PERF.md
//   section 6).
// - Bit-exact with the plain twin (ops/remap.py::remap_plain): each tap is
//   masked by its own in-bounds test and the four weighted taps are summed
//   in the twin's order, so a sample whose 2x2 window lies wholly outside
//   the image is exactly 0. Every product and sum is an explicit
//   round-to-nearest intrinsic, which nvcc never contracts into an FMA.
// - Not a shared-memory band. The TPU's RemapPlan band exists for its
//   aligned vector loads; here neighbouring threads tap neighbouring
//   pixels of an L2-resident image, and L1 serves that reuse.
#include <cuda_runtime.h>

#define REMAP_THREADS 256

struct RemapCamera {
  const float* img;   // (H, W)
  const float2* map;  // (H, W) of (x, y)
  float* out;         // (H, W)
};

template <int NCAM>
struct RemapParams {
  RemapCamera cam[NCAM];
  int H, W;
};

__device__ __forceinline__ float tap(const float* __restrict__ img, int H,
                                     int W, int yi, int xi, float w) {
  const bool inb = (xi >= 0) && (xi < W) && (yi >= 0) && (yi < H);
  const float v = inb ? __ldg(img + (size_t)yi * W + xi) : 0.0f;
  return __fmul_rn(v, w);
}

__device__ __forceinline__ float sample(const float* __restrict__ img, int H,
                                        int W, float mx, float my) {
  const float x0 = floorf(mx);
  const float y0 = floorf(my);
  const float fx = __fsub_rn(mx, x0);
  const float fy = __fsub_rn(my, y0);
  const int xi = (int)x0;
  const int yi = (int)y0;
  const float gx = __fsub_rn(1.0f, fx);
  const float gy = __fsub_rn(1.0f, fy);
  float acc = tap(img, H, W, yi, xi, __fmul_rn(gx, gy));
  acc = __fadd_rn(acc, tap(img, H, W, yi, xi + 1, __fmul_rn(fx, gy)));
  acc = __fadd_rn(acc, tap(img, H, W, yi + 1, xi, __fmul_rn(gx, fy)));
  acc = __fadd_rn(acc, tap(img, H, W, yi + 1, xi + 1, __fmul_rn(fx, fy)));
  return acc;
}

// One camera, one pixel a thread.
__global__ void remap_one_kernel(const float* __restrict__ img,
                                 const float2* __restrict__ map,
                                 float* __restrict__ out, int H, int W) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= H * W) return;
  const float2 m = map[i];
  out[i] = sample(img, H, W, m.x, m.y);
}

// This thread's PPT (1 or 2) consecutive output pixels of one camera.
template <int PPT>
__device__ __forceinline__ void remap_pixels(const float* __restrict__ img,
                                             const float2* __restrict__ map,
                                             float* __restrict__ out, int H,
                                             int W) {
  const int n = H * W;
  const int t = blockIdx.x * REMAP_THREADS + threadIdx.x;
  if (PPT == 1) {
    if (t >= n) return;
    const float2 m = __ldg(map + t);
    out[t] = sample(img, H, W, m.x, m.y);
  } else {
    const int i = 2 * t;
    if (i + 1 < n) {  // two pixels' (x, y) a 16-byte load
      const float4 m = __ldg(reinterpret_cast<const float4*>(map) + t);
      float2 o;
      o.x = sample(img, H, W, m.x, m.y);
      o.y = sample(img, H, W, m.z, m.w);
      reinterpret_cast<float2*>(out)[t] = o;
    } else if (i < n) {
      const float2 m = __ldg(map + i);
      out[i] = sample(img, H, W, m.x, m.y);
    }
  }
}

// NCAM (1 or 2) cameras; blockIdx.y picks one.
template <int PPT, int NCAM>
__global__ void __launch_bounds__(REMAP_THREADS)
    remap_kernel(const RemapParams<NCAM> p) {
  const RemapCamera c = (NCAM == 2 && blockIdx.y) ? p.cam[NCAM - 1]
                                                  : p.cam[0];
  remap_pixels<PPT>(c.img, c.map, c.out, p.H, p.W);
}

template <int PPT, int NCAM>
static cudaError_t launch(const RemapParams<NCAM>& p, cudaStream_t stream) {
  const int threads = (p.H * p.W + PPT - 1) / PPT;
  const dim3 grid((threads + REMAP_THREADS - 1) / REMAP_THREADS, NCAM);
  void* args[] = {(void*)&p};
  return cudaLaunchKernel((const void*)remap_kernel<PPT, NCAM>, grid,
                          dim3(REMAP_THREADS), args, 0, stream);
}

// Remap ncam (1 or 2) cameras' images of one (H, W) through their maps;
// pass null pointers for the second camera when ncam = 1.
extern "C" int esvo_remap(const void* img0, const void* map0, void* out0,
                          const void* img1, const void* map1, void* out1,
                          int ncam, int H, int W, void* stream) {
  if (ncam < 1 || ncam > 2 || H < 0 || W < 0)
    return (int)cudaErrorInvalidValue;
  const int n = H * W;
  if (n > 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(
          &per_sm, cudaDevAttrMaxThreadsPerMultiProcessor, dev);
    if (err != cudaSuccess) return (int)err;
    // one pixel a thread while the grid fits on the card at once
    const bool one_wave = (long long)ncam * n <= (long long)sms * per_sm;
    const RemapCamera a{(const float*)img0, (const float2*)map0,
                        (float*)out0};
    const RemapCamera b{(const float*)img1, (const float2*)map1,
                        (float*)out1};
    const cudaStream_t s = (cudaStream_t)stream;
    if (ncam == 2) {
      const RemapParams<2> p{{a, b}, H, W};
      err = one_wave ? launch<1>(p, s) : launch<2>(p, s);
    } else if (one_wave) {
      remap_one_kernel<<<(n + REMAP_THREADS - 1) / REMAP_THREADS,
                         REMAP_THREADS, 0, s>>>(a.img, a.map, a.out, H, W);
      err = cudaGetLastError();
    } else {
      err = launch<2>(RemapParams<1>{{a}, H, W}, s);
    }
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaGetLastError();
}
