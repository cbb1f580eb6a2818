// K5: inverse-depth map regularization in one launch.
//
// Replaces the fused XLA scan of esvo_tpu/mapping/regularization.py:
// regularize (:56, its lax.scan over the window offsets at :118), not a
// Pallas kernel. It computes what mapping/regularization.py::
// regularize_plain computes, one thread a pixel: over the (2r+1)^2 window
// offsets in window row-major order (the Student-t fold depends on the
// order), with the padded fills outside the image (valid false, invD 0,
// var 1, scale2 1, nu 1),
// - n_count (valid neighbours, the centre included) and close_count
//   (valid neighbours within 2 sigma of the centre or of themselves);
// - l2: the inverse-variance weighted mean over the close neighbours;
//   Tdist: the left fold of the pairwise Student-t posterior
//   (_reg_tdist_posterior: nu = min(nu_a, nu_b), nu = inf the Gaussian
//   limit) over the close neighbours, the first one starting it;
// - the output: the smoothed value where the centre is valid and
//   n_count > min_neighbours and close_count > min_close_neighbours,
//   EMPTY (-1) where it is valid otherwise, the input elsewhere.
//
// What bounds it on the card: operations. A valid centre does ~8 float32
// operations an offset and ~12 more (three divisions) for each close
// neighbour of the Tdist fold; at the DSEC radius of 20 that is 1,681
// offsets a pixel, against five (H, W) planes read once.
//
// Design (what each element does about the limits):
// - A block is a 32x8 tile of pixels (one warp a row); it stages the tile
//   and its r-pixel halo of four float planes and the valid bytes in
//   shared memory once (72x48 pixels, 58.8 KB at r = 20, dynamic shared
//   memory above 48 KB), with the padded fills written where the halo
//   leaves the image. Each offset then reads five shared words a thread,
//   consecutive across a warp: no bank conflicts.
// - Per-neighbour terms that do not depend on the centre are computed
//   once a halo pixel when it is staged: 2 sqrt(max(var, 0)), and for l2
//   the weight 1 / max(var, 1e-20) (Tdist stages scale2 and nu instead).
// - A thread whose centre is not valid writes its input and stops.
// - Bit for bit the plain twin on the card: each operation is the one the
//   twin's eager kernels run, in the twin's order, as an explicit
//   round-to-nearest intrinsic (__fadd_rn, __fmul_rn, __fdiv_rn,
//   __fsqrt_rn), which nvcc never contracts into an FMA; the l2 sums add
//   the zero weight of a far neighbour as the twin does, and clamps keep
//   a NaN as torch.clamp does. The discrete gates then flip no pixel.
#include <cuda_runtime.h>
#include <stdint.h>

#define REG_TX 32
#define REG_TY 8
#define REG_THREADS (REG_TX * REG_TY)
#define REG_EMPTY -1.0f

struct RegParams {
  const uint8_t* valid;  // (H, W)
  const float* invD;     // (H, W)
  const float* var;      // (H, W)
  const float* scale2;   // (H, W)
  const float* nu;       // (H, W)
  float* out;            // (H, W)
  int H, W, r, min_neighbours, min_close_neighbours;
  float var_floor;       // 1e-20 as float32 (the l2 weight's clamp)
};

// torch.clamp(x, min=lo): a NaN stays NaN
__device__ __forceinline__ float clamp_min(float x, float lo) {
  return x < lo ? lo : x;
}

// torch.minimum: NaN if either is NaN
__device__ __forceinline__ float nan_min(float a, float b) {
  if (a != a) return a;
  if (b != b) return b;
  return fminf(a, b);
}

__device__ __forceinline__ float two_sigma(float var) {
  return __fmul_rn(2.0f, __fsqrt_rn(clamp_min(var, 0.0f)));
}

template <bool TDIST>
__global__ void __launch_bounds__(REG_THREADS)
    regularize_kernel(const RegParams p) {
  extern __shared__ float smem[];
  const int r = p.r;
  const int SW = REG_TX + 2 * r, SH = REG_TY + 2 * r, n = SW * SH;
  float* s_d = smem;           // invD
  float* s_sig = smem + n;     // 2 sqrt(max(var, 0))
  float* s_a = smem + 2 * n;   // Tdist: scale2; l2: 1 / max(var, 1e-20)
  float* s_nu = smem + 3 * n;  // Tdist: nu
  uint8_t* s_v = reinterpret_cast<uint8_t*>(smem + 4 * n);

  const int x0 = blockIdx.x * REG_TX - r, y0 = blockIdx.y * REG_TY - r;
  for (int i = threadIdx.x; i < n; i += REG_THREADS) {
    const int yy = y0 + i / SW, xx = x0 + i % SW;
    if (yy >= 0 && yy < p.H && xx >= 0 && xx < p.W) {
      const size_t g = (size_t)yy * p.W + xx;
      const float var = __ldg(p.var + g);
      s_v[i] = __ldg(p.valid + g) != 0;
      s_d[i] = __ldg(p.invD + g);
      s_sig[i] = two_sigma(var);
      if (TDIST) {
        s_a[i] = __ldg(p.scale2 + g);
        s_nu[i] = __ldg(p.nu + g);
      } else {
        s_a[i] = __fdiv_rn(1.0f, clamp_min(var, p.var_floor));
      }
    } else {  // the twin's padding: valid false, invD 0, var 1, s2 1, nu 1
      s_v[i] = 0;
      s_d[i] = 0.0f;
      s_sig[i] = two_sigma(1.0f);
      s_a[i] = 1.0f;  // scale2 1; the l2 weight 1 / max(1, 1e-20) is 1
      s_nu[i] = 1.0f;
    }
  }
  __syncthreads();

  const int tx = threadIdx.x % REG_TX, ty = threadIdx.x / REG_TX;
  const int x = blockIdx.x * REG_TX + tx, y = blockIdx.y * REG_TY + ty;
  if (x >= p.W || y >= p.H) return;
  const int c = (ty + r) * SW + tx + r;
  const float invD = s_d[c];
  if (!s_v[c]) {
    p.out[(size_t)y * p.W + x] = invD;
    return;
  }
  const float sig = s_sig[c];
  int n_count = 0, close_count = 0;
  float wsum = 0.0f, wmean = 0.0f;                       // l2
  bool started = false;                                  // Tdist
  float t_invD = 0.0f, t_s2 = 1.0f, t_nu = 0.0f;
  for (int dy = 0; dy <= 2 * r; ++dy) {
    const int row = (ty + dy) * SW + tx;
    for (int dx = 0; dx <= 2 * r; ++dx) {
      const int j = row + dx;
      const bool v = s_v[j];
      const float d = s_d[j];
      n_count += v;
      const float diff = fabsf(__fsub_rn(invD, d));
      const bool close = v && ((diff < sig) || (diff < s_sig[j]));
      close_count += close;
      if (!TDIST) {
        const float w = close ? s_a[j] : 0.0f;
        wsum = __fadd_rn(wsum, w);
        wmean = __fadd_rn(wmean, __fmul_rn(w, d));
      } else if (close) {
        const float s2 = s_a[j], nu = s_nu[j];
        if (!started) {
          t_invD = d;
          t_s2 = s2;
          t_nu = nu;
          started = true;
        } else {
          const float nu_u = nan_min(t_nu, nu);
          const float s_sum = __fadd_rn(t_s2, s2);
          const float f_invD = __fdiv_rn(
              __fadd_rn(__fmul_rn(s2, t_invD), __fmul_rn(t_s2, d)), s_sum);
          const float e = __fsub_rn(t_invD, d);
          const float d2 = __fmul_rn(e, e);
          const float gauss = __fdiv_rn(__fmul_rn(t_s2, s2), s_sum);
          float f_s2 = gauss;
          if (isfinite(nu_u)) {
            f_s2 = __fmul_rn(
                __fdiv_rn(__fadd_rn(nu_u, __fdiv_rn(d2, s_sum)),
                          __fadd_rn(nu_u, 1.0f)),
                gauss);
          }
          t_invD = f_invD;
          t_s2 = f_s2;
          t_nu = nu_u;
        }
      }
    }
  }
  const bool enough = n_count > p.min_neighbours &&
                      close_count > p.min_close_neighbours;
  float smoothed = t_invD;
  if (!TDIST) smoothed = __fdiv_rn(wmean, clamp_min(wsum, p.var_floor));
  p.out[(size_t)y * p.W + x] = enough ? smoothed : REG_EMPTY;
}

static size_t smem_bytes(int r) {
  const size_t n = (size_t)(REG_TX + 2 * r) * (REG_TY + 2 * r);
  return n * (4 * sizeof(float) + 1);
}

extern "C" int esvo_regularize(const void* valid, const void* invD,
                               const void* var, const void* scale2,
                               const void* nu, void* out, int H, int W, int r,
                               int tdist, int min_neighbours,
                               int min_close_neighbours, float var_floor,
                               void* stream) {
  if (H < 0 || W < 0 || r < 0) return (int)cudaErrorInvalidValue;
  if (H == 0 || W == 0) return (int)cudaSuccess;
  RegParams p;
  p.valid = (const uint8_t*)valid;
  p.invD = (const float*)invD;
  p.var = (const float*)var;
  p.scale2 = (const float*)scale2;
  p.nu = (const float*)nu;
  p.out = (float*)out;
  p.H = H;
  p.W = W;
  p.r = r;
  p.min_neighbours = min_neighbours;
  p.min_close_neighbours = min_close_neighbours;
  p.var_floor = var_floor;
  const void* fn = tdist ? (const void*)regularize_kernel<true>
                         : (const void*)regularize_kernel<false>;
  const size_t smem = smem_bytes(r);
  // raise the instantiation's dynamic shared-memory limit once to what
  // this launch needs (never during a graph capture: the warm-up launch
  // of the same radius comes first)
  static size_t allowed[2] = {0, 0};
  cudaError_t err = cudaSuccess;
  if (smem > allowed[tdist ? 1 : 0]) {
    err = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    allowed[tdist ? 1 : 0] = smem;
  }
  const dim3 grid((W + REG_TX - 1) / REG_TX, (H + REG_TY - 1) / REG_TY);
  void* args[] = {(void*)&p};
  err = cudaLaunchKernel(fn, grid, dim3(REG_THREADS), args, smem,
                         (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
