// K7: the fusion fold in one launch.
//
// Replaces the fused XLA program of esvo_tpu/mapping/fusion.py:fuse_frame
// (:242) from the slot scatter to the end of its K-step fold. Not a
// Pallas kernel. It computes what mapping/fusion.py::fold_slots_plain
// computes, one thread a pixel: for slot k = 0 to K - 1 (the candidates
// in variance-ascending order, slots[k, pixel] naming one or -1), the
// reference's per-pixel rules on the grid cell g and the candidate c:
// - insert into an empty cell (g.invD <= -1e-6): c's values, its
//   variance clamped to >= 1e-6, g's pixel coordinate, and the point
//   back-projected from that coordinate at c's inverse depth;
// - fuse a compatible one (Tdist: |c - g| < 2 sigma of either; l2: the
//   chi-square test < 5.99): the Student-t posterior (_student_t_update)
//   or the l2 product, residual min, age + 2 (Tdist) or + 1 (l2);
// - replace an incompatible, unoccluded one that has a lower variance
//   and residual: c's values, its sub-pixel coordinate and point;
// - count the fuses of the pixel into num_fused.
// A slot whose candidate is empty or has invD <= 0 changes nothing.
//
// What bounds it on the card: bytes. Each pixel reads its 11 grid words
// (x and p_cam interleaved) and K slot ids, each taken slot 8 candidate
// words, and writes 11 words; the arithmetic is a few dozen operations a
// taken slot.
//
// Design (what each element does about the limits):
// - One thread a pixel, 256 a block: the grid planes and slot planes are
//   read and written coalesced; candidates are gathered by id.
// - The camera's inverse (Ainv, 3x3) and offset (b) come from device
//   memory, never through the host, so a CUDA graph captures the launch.
// - Bit for bit the plain twin on the card: every gate here is discrete,
//   so each operation is the one the twin's eager kernels run, in the
//   twin's order, as an explicit round-to-nearest intrinsic (no FMA);
//   torch.minimum and torch.clamp keep NaN; nu = inf takes torch.where's
//   Gaussian branch; the candidate's age goes through float as the
//   twin's float slot plane does, then truncates to int32.
#include <cuda_runtime.h>
#include <stdint.h>

#define FUSE_THREADS 256
#define OCC_EPS -1e-6f

struct FuseParams {
  // the grid: (H, W) planes, x (H, W, 2), p (H, W, 3)
  const float *invD, *var, *s2, *nu, *res, *x, *p;
  const int* age;
  // the candidates: (M,) channels, x (M, 2)
  const float *c_invD, *c_var, *c_s2, *c_nu, *c_res, *c_x;
  const int* c_age;
  const int* slots;  // (K, H, W) candidate id, or -1 for an empty slot
  const float* cam;  // Ainv row-major (9), then b (3)
  float *o_invD, *o_var, *o_s2, *o_nu, *o_res, *o_x, *o_p;
  int* o_age;
  unsigned long long* num_fused;
  int HW, K, tdist;
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

// fusion.py's back_project_planes: Ainv (z x - b) with z = 1 / invD
__device__ __forceinline__ void back_project(const float* A, const float* b,
                                             float x0, float x1, float invD,
                                             float* out) {
  const float z = __fdiv_rn(1.0f, invD);
  const float r0 = __fsub_rn(__fmul_rn(z, x0), b[0]);
  const float r1 = __fsub_rn(__fmul_rn(z, x1), b[1]);
  const float r2 = __fsub_rn(z, b[2]);
  for (int i = 0; i < 3; ++i)
    out[i] = __fadd_rn(__fadd_rn(__fmul_rn(A[3 * i], r0),
                                 __fmul_rn(A[3 * i + 1], r1)),
                       __fmul_rn(A[3 * i + 2], r2));
}

__global__ void __launch_bounds__(FUSE_THREADS)
    fuse_fold_kernel(const FuseParams p) {
  __shared__ float s_cam[12];
  __shared__ unsigned int s_count;
  if (threadIdx.x < 12) s_cam[threadIdx.x] = p.cam[threadIdx.x];
  if (threadIdx.x == 0) s_count = 0;
  __syncthreads();
  const float* A = s_cam;
  const float* b = s_cam + 9;

  const int i = blockIdx.x * FUSE_THREADS + threadIdx.x;
  unsigned int fused = 0;
  if (i < p.HW) {
    float g_invD = p.invD[i], g_var = p.var[i], g_s2 = p.s2[i];
    float g_nu = p.nu[i], g_res = p.res[i];
    int g_age = p.age[i];
    float g_x0 = p.x[2 * i], g_x1 = p.x[2 * i + 1];
    float g_p[3] = {p.p[3 * i], p.p[3 * i + 1], p.p[3 * i + 2]};
    for (int k = 0; k < p.K; ++k) {
      const int id = p.slots[(size_t)k * p.HW + i];
      if (id < 0) continue;                 // an empty slot reads as zeros
      const float c_invD = p.c_invD[id];
      if (!(c_invD > 0.0f)) continue;       // c_ok is false: no rule fires
      const float c_var = p.c_var[id], c_s2 = p.c_s2[id];
      const float c_nu = p.c_nu[id], c_res = p.c_res[id];
      const int c_age = (int)(float)p.c_age[id];
      const float c_x0 = p.c_x[2 * id], c_x1 = p.c_x[2 * id + 1];
      const float inv_c = clamp_min(c_invD, 1e-12f);
      const bool occ = g_invD > OCC_EPS;
      bool compat;
      if (p.tdist) {
        const float std_g = __fsqrt_rn(clamp_min(g_var, 0.0f));
        const float std_c = __fsqrt_rn(clamp_min(c_var, 0.0f));
        const float diff = fabsf(__fsub_rn(c_invD, g_invD));
        compat = (diff < __fmul_rn(2.0f, std_g)) ||
                 (diff < __fmul_rn(2.0f, std_c));
      } else {
        const float e = __fsub_rn(c_invD, g_invD);
        const float d2 = __fmul_rn(e, e);
        compat = __fadd_rn(__fdiv_rn(d2, clamp_min(c_var, 1e-20f)),
                           __fdiv_rn(d2, clamp_min(g_var, 1e-20f))) < 5.99f;
      }
      const bool occluded =
          __fsub_rn(g_invD,
                    __fmul_rn(2.0f, __fsqrt_rn(clamp_min(g_var, 0.0f)))) >
          c_invD;
      if (!occ) {                                        // insert
        back_project(A, b, g_x0, g_x1, inv_c, g_p);
        g_invD = c_invD;
        g_var = clamp_min(c_var, 1e-6f);
        g_s2 = c_s2;
        g_nu = c_nu;
        g_res = c_res;
        g_age = c_age;
      } else if (compat) {                               // fuse
        float f_invD, f_var, f_s2, f_nu;
        int f_age;
        if (p.tdist) {
          // _student_t_update(g, c)
          const float nu_u = nan_min(g_nu, c_nu);
          const float s_sum = __fadd_rn(g_s2, c_s2);
          f_invD = __fdiv_rn(
              __fadd_rn(__fmul_rn(c_s2, g_invD), __fmul_rn(g_s2, c_invD)),
              s_sum);
          const float e = __fsub_rn(g_invD, c_invD);
          const float d2 = __fmul_rn(e, e);
          const float gauss = __fdiv_rn(__fmul_rn(g_s2, c_s2), s_sum);
          if (isfinite(nu_u)) {
            f_s2 = __fmul_rn(__fdiv_rn(__fadd_rn(nu_u, __fdiv_rn(d2, s_sum)),
                                       __fadd_rn(nu_u, 1.0f)),
                             gauss);
            f_nu = __fadd_rn(nu_u, 1.0f);
            f_var = __fmul_rn(
                __fdiv_rn(f_nu, clamp_min(__fsub_rn(f_nu, 2.0f), 1e-6f)),
                f_s2);
          } else {
            f_s2 = gauss;
            f_nu = nu_u;
            f_var = gauss;
          }
          f_age = g_age + 2;
        } else {
          const float vsum = __fadd_rn(g_var, c_var);
          f_invD = __fdiv_rn(
              __fadd_rn(__fmul_rn(g_var, c_invD), __fmul_rn(c_var, g_invD)),
              vsum);
          f_var = __fdiv_rn(__fmul_rn(g_var, c_var), vsum);
          f_s2 = f_var;
          f_nu = g_nu;
          f_age = g_age + 1;
        }
        back_project(A, b, g_x0, g_x1, inv_c, g_p);
        g_invD = f_invD;
        g_var = clamp_min(f_var, 1e-6f);
        g_s2 = f_s2;
        g_nu = f_nu;
        g_res = nan_min(g_res, c_res);
        g_age = f_age;
        ++fused;
      } else if (!occluded && c_var < g_var && c_res < g_res) {  // replace
        back_project(A, b, c_x0, c_x1, inv_c, g_p);
        g_invD = c_invD;
        g_var = c_var;
        g_s2 = c_s2;
        g_nu = c_nu;
        g_res = c_res;
        g_age = c_age;
        g_x0 = c_x0;
        g_x1 = c_x1;
      }
    }
    p.o_invD[i] = g_invD;
    p.o_var[i] = g_var;
    p.o_s2[i] = g_s2;
    p.o_nu[i] = g_nu;
    p.o_res[i] = g_res;
    p.o_age[i] = g_age;
    p.o_x[2 * i] = g_x0;
    p.o_x[2 * i + 1] = g_x1;
    p.o_p[3 * i] = g_p[0];
    p.o_p[3 * i + 1] = g_p[1];
    p.o_p[3 * i + 2] = g_p[2];
  }
  // the block's fuses, then one add to the total (an integer sum: the
  // same whatever order the blocks add in)
  for (int off = 16; off > 0; off >>= 1)
    fused += __shfl_down_sync(0xffffffffu, fused, off);
  if ((threadIdx.x & 31) == 0 && fused) atomicAdd(&s_count, fused);
  __syncthreads();
  if (threadIdx.x == 0 && s_count)
    atomicAdd(p.num_fused, (unsigned long long)s_count);
}

extern "C" int esvo_fuse(const void* invD, const void* var, const void* s2,
                         const void* nu, const void* res, const void* age,
                         const void* x, const void* pc, const void* c_invD,
                         const void* c_var, const void* c_s2,
                         const void* c_nu, const void* c_res,
                         const void* c_age, const void* c_x,
                         const void* slots, const void* cam, void* o_invD,
                         void* o_var, void* o_s2, void* o_nu, void* o_res,
                         void* o_age, void* o_x, void* o_p, void* num_fused,
                         int HW, int K, int tdist, void* stream) {
  if (HW < 0 || K < 0) return (int)cudaErrorInvalidValue;
  if (HW == 0) return (int)cudaSuccess;
  FuseParams p;
  p.invD = (const float*)invD;
  p.var = (const float*)var;
  p.s2 = (const float*)s2;
  p.nu = (const float*)nu;
  p.res = (const float*)res;
  p.age = (const int*)age;
  p.x = (const float*)x;
  p.p = (const float*)pc;
  p.c_invD = (const float*)c_invD;
  p.c_var = (const float*)c_var;
  p.c_s2 = (const float*)c_s2;
  p.c_nu = (const float*)c_nu;
  p.c_res = (const float*)c_res;
  p.c_age = (const int*)c_age;
  p.c_x = (const float*)c_x;
  p.slots = (const int*)slots;
  p.cam = (const float*)cam;
  p.o_invD = (float*)o_invD;
  p.o_var = (float*)o_var;
  p.o_s2 = (float*)o_s2;
  p.o_nu = (float*)o_nu;
  p.o_res = (float*)o_res;
  p.o_age = (int*)o_age;
  p.o_x = (float*)o_x;
  p.o_p = (float*)o_p;
  p.num_fused = (unsigned long long*)num_fused;
  p.HW = HW;
  p.K = K;
  p.tdist = tdist;
  void* args[] = {(void*)&p};
  const dim3 grid((HW + FUSE_THREADS - 1) / FUSE_THREADS);
  cudaError_t err = cudaLaunchKernel((const void*)fuse_fold_kernel, grid,
                                     dim3(FUSE_THREADS), args, 0,
                                     (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
