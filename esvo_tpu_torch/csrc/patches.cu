// K1: batched window copy out of one or two images of one shape.
//
// Replaces the TPU kernel esvo_tpu/ops/pallas_patches.py:_kernel (:23) /
// pallas_slice_patches (:48): an aligned slab load plus two on-chip rolls
// per window, starts scalar-prefetched. Each start is clamped to
// [0, H-h] x [0, W-w] (lax.dynamic_slice's rule), so the copy is
// bit-exact with the plain twin (ops/patches.py::slice_patches_plain).
//
// What bounds it on the card: bytes. Each window is written once (3 KB at
// the depth solve's 24x32) and each start read once; the image (at most
// 1.2 MB) is read from device memory about once and then served by L2.
// There is no arithmetic. At DSEC (10,000 windows a surface) the 30.7 MB
// of output a surface is the whole bound.
//
// Design, one warp per window (what each element does about the limits):
// - Persistent warps. The grid is at most what the card holds at once
//   (the occupancy calculator's blocks an SM, esvo_patches_kernel_info)
//   and never more warps than windows; each warp walks windows with a
//   grid stride. Starting and retiring a 256-thread block for each 3 KB
//   window, most of the old grid's cost, is gone. The windows are in a
//   fixed order and each output element is written once by one lane, so
//   the result does not depend on scheduling.
// - Runs of four columns. Where w % 4 == 0 (the presets' 24x32), a lane
//   owns runs of VEC = 4 consecutive columns: four loads at immediate
//   offsets from one address and one 16-byte store, so a warp writes four
//   128-byte lines an instruction and spends one address add on four
//   loads. (One element a lane, one address add a load, ran the load side
//   30% slower at rpg in this kernel's exploratory builds.) Other widths
//   take VEC = 1.
// - Loads in flight. Lane l owns the runs l, l+32, ... of a band of
//   band_rows rows (the whole window where it fits, as at the presets'
//   24x32: 6 runs, 24 floats a lane). The kernel is templated on RPL, the
//   runs a lane owns in a band, and VEC, so the presets' shape is fully
//   unrolled: a lane issues all its independent loads (24) before its
//   first store, 3 KB a warp in flight.
// - No division per element. Each lane computes its RPL offsets into the
//   image once per launch, by row and column increments. The warp loads
//   its next window's two starts while it copies the current window, so
//   the index fetch is off the chain.
// - Stores. The output stays (N, h, w) contiguous (K2 bulk-copies each
//   window from it), and every row a warp writes is whole 128-byte lines.
// - Both surfaces in one launch. The launcher takes two (image, ul_y,
//   ul_x, out, n) groups of one (H, W, h, w); the window index runs over
//   n0 + n1. A single image is the same launch with n1 = 0.
// - Not TMA tensor tiles: a 2-D tensor map needs a 16-byte row pitch,
//   which a DAVIS346 surface (346 px, 1,384 B rows) does not have, and
//   the image sits in L2, so a copy engine buys nothing that 24
//   independent loads a lane do not.
#include <cuda_runtime.h>
#include <stdint.h>

#define PATCH_WARPS 4        // warps a block
#define PATCH_MAX_FLOATS 32  // floats a lane holds: rpl * vec

struct PatchGroup {
  const float* img;  // (H, W)
  const int* ul_y;   // (n,)
  const int* ul_x;   // (n,)
  float* out;        // (n, h, w)
  int n;
};

struct PatchParams {
  PatchGroup a, b;
  int H, W, h, w;
  int band_rows;  // rows one pass of a warp copies
};

__device__ __forceinline__ void load_start(const PatchParams& p, int i,
                                           int& y, int& x) {
  if (i < p.a.n) {
    y = __ldg(p.a.ul_y + i);
    x = __ldg(p.a.ul_x + i);
  } else {
    y = __ldg(p.b.ul_y + (i - p.a.n));
    x = __ldg(p.b.ul_x + (i - p.a.n));
  }
}

template <int VEC>
struct Run;
template <>
struct Run<1> {
  typedef float T;
  static __device__ __forceinline__ T load(const float* q) { return __ldg(q); }
};
template <>
struct Run<4> {
  typedef float4 T;
  static __device__ __forceinline__ T load(const float* q) {
    return make_float4(__ldg(q), __ldg(q + 1), __ldg(q + 2), __ldg(q + 3));
  }
};

// RPL runs of VEC consecutive columns a lane in one band of a window.
template <int RPL, int VEC>
__global__ void __launch_bounds__(PATCH_WARPS * 32)
    slice_patches_kernel(const PatchParams p) {
  typedef typename Run<VEC>::T T;
  const int lane = threadIdx.x & 31;
  const int nwarps = gridDim.x * PATCH_WARPS;
  const int total = p.a.n + p.b.n;
  const int wr = p.w / VEC;            // runs a window row
  const int hw = p.h * wr;             // runs a window
  const int band = p.band_rows * wr;   // runs a full band
  // This lane's runs of a band (r = lane, lane + 32, ...) as image
  // offsets from the band's first pixel: start at row lane / wr, then
  // step 32 runs at a time by the row and column increments of 32.
  int off[RPL];
  {
    int r = lane / wr;
    int c = lane - r * wr;
    const int dr = 32 / wr;
    const int dc = 32 - dr * wr;
#pragma unroll
    for (int k = 0; k < RPL; ++k) {
      off[k] = r * p.W + c * VEC;
      r += dr;
      c += dc;
      if (c >= wr) {
        c -= wr;
        ++r;
      }
    }
  }
  int i = blockIdx.x * PATCH_WARPS + (threadIdx.x >> 5);
  int ny = 0, nx = 0;
  if (i < total) load_start(p, i, ny, nx);
  while (i < total) {
    const bool first = i < p.a.n;
    const float* src = first ? p.a.img : p.b.img;
    T* dst = reinterpret_cast<T*>(first ? p.a.out + (size_t)i * hw * VEC
                                        : p.b.out +
                                              (size_t)(i - p.a.n) * hw * VEC);
    const int y0 = min(max(ny, 0), p.H - p.h);
    const int x0 = min(max(nx, 0), p.W - p.w);
    const int next = i + nwarps;
    if (next < total) load_start(p, next, ny, nx);
    src += (size_t)y0 * p.W + x0;
    for (int r0 = 0; r0 < p.h; r0 += p.band_rows) {
      const int lim = min(p.band_rows, p.h - r0) * wr;
      T v[RPL];
#pragma unroll
      for (int k = 0; k < RPL; ++k)
        if (lane + 32 * k < lim) v[k] = Run<VEC>::load(src + off[k]);
#pragma unroll
      for (int k = 0; k < RPL; ++k)
        if (lane + 32 * k < lim) dst[lane + 32 * k] = v[k];
      src += (size_t)p.band_rows * p.W;
      dst += band;
    }
    i = next;
  }
}

typedef void (*PatchKernelFn)(const PatchParams);

// How a warp copies one (h, w) window: runs of vec consecutive columns (4
// where w % 4 == 0, else 1), in bands of band_rows rows (the whole window
// where a lane's share of it fits in PATCH_MAX_FLOATS floats), of which
// each lane owns rpl = ceil(band_rows * w / vec / 32) runs; (rpl, vec) is
// the kernel's instantiation. False where the kernel cannot take the shape.
struct WindowPlan {
  int rpl, vec, band_rows;
};

static bool window_plan(int h, int w, WindowPlan* plan) {
  const int vec = w % 4 == 0 ? 4 : 1;
  const int runs_a_row = w / vec;
  const int max_runs = 32 * (PATCH_MAX_FLOATS / vec);  // a warp at once
  if (h < 1 || runs_a_row < 1 || runs_a_row > max_runs) return false;
  plan->vec = vec;
  plan->band_rows = h < max_runs / runs_a_row ? h : max_runs / runs_a_row;
  plan->rpl = (plan->band_rows * runs_a_row + 31) / 32;
  return true;
}

template <int VEC, int RPL>
static PatchKernelFn kernel_upto(int rpl) {
  if (rpl == RPL) return slice_patches_kernel<RPL, VEC>;
  if constexpr (RPL > 1) return kernel_upto<VEC, RPL - 1>(rpl);
  return nullptr;
}

static PatchKernelFn kernel_for(const WindowPlan& plan) {
  return plan.vec == 4 ? kernel_upto<4, PATCH_MAX_FLOATS / 4>(plan.rpl)
                       : kernel_upto<1, PATCH_MAX_FLOATS>(plan.rpl);
}

// The instantiation for (h, w) windows as the CUDA runtime reports it.
// info: [0] blocks an SM holds, [1] registers a thread, [2] local memory
// bytes a thread (spills), [3] warps a block, [4] rpl, [5] vec,
// [6] band_rows.
extern "C" int esvo_patches_kernel_info(int h, int w, int* info) {
  WindowPlan plan;
  if (!window_plan(h, w, &plan)) return (int)cudaErrorInvalidValue;
  PatchKernelFn fn = kernel_for(plan);
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, (const void*)fn);
  if (err != cudaSuccess) return (int)err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, (const void*)fn, PATCH_WARPS * 32, 0);
  if (err != cudaSuccess) return (int)err;
  info[0] = blocks;
  info[1] = attr.numRegs;
  info[2] = (int)attr.localSizeBytes;
  info[3] = PATCH_WARPS;
  info[4] = plan.rpl;
  info[5] = plan.vec;
  info[6] = plan.band_rows;
  return (int)cudaSuccess;
}

// Windows of (h, w) out of image a (n0 of them) and image b (n1), both
// (H, W); pass n1 = 0 (and null pointers) for one image. grid comes from
// the wrapper's launch plan (ops/patches.py::patches_launch_plan).
extern "C" int esvo_slice_patches(const void* img0, const void* ul_y0,
                                  const void* ul_x0, void* out0, int n0,
                                  const void* img1, const void* ul_y1,
                                  const void* ul_x1, void* out1, int n1,
                                  int H, int W, int h, int w, int grid,
                                  void* stream) {
  WindowPlan plan;
  if (n0 < 0 || n1 < 0 || h > H || w > W || !window_plan(h, w, &plan) ||
      (n0 + n1 > 0 && grid < 1))
    return (int)cudaErrorInvalidValue;
  if (plan.vec == 4 && (((uintptr_t)out0 | (uintptr_t)out1) % 16 != 0))
    return (int)cudaErrorMisalignedAddress;
  if (n0 + n1 > 0) {
    PatchParams p;
    p.a = PatchGroup{(const float*)img0, (const int*)ul_y0,
                     (const int*)ul_x0, (float*)out0, n0};
    p.b = PatchGroup{(const float*)img1, (const int*)ul_y1,
                     (const int*)ul_x1, (float*)out1, n1};
    p.H = H;
    p.W = W;
    p.h = h;
    p.w = w;
    p.band_rows = plan.band_rows;
    void* args[] = {&p};
    const cudaError_t err = cudaLaunchKernel(
        (const void*)kernel_for(plan), dim3(grid), dim3(PATCH_WARPS * 32),
        args, 0, (cudaStream_t)stream);
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaGetLastError();
}
