// K7: the fusion fold, with its slot placement, in one launch.
//
// Replaces the fused XLA program of esvo_tpu/mapping/fusion.py:fuse_frame
// (:242) from the slot rank (_assign_slots_sort's segment rank, :177) and
// the slot scatter (:193) to the end of its K-step fold. Not a Pallas
// kernel. Its input is the candidates' lexicographic (pixel, variance,
// original index) order, which mapping/fusion.py::_sort_slots makes with
// two stable torch.sort calls: `order` (tiled candidate ids) and
// `pix_sorted` (their pixels, ascending; hw for an invalid one). A
// pixel's candidates are one run of that order, already in slot order,
// and its first min(run, K) are slots 0..K-1. It computes what
// mapping/fusion.py::_assign_slots + fold_slots_plain compute, one thread
// a pixel: for each of those slots (tiled id i is candidate i / Kt), the
// reference's per-pixel rules on the grid cell g and the candidate c:
// - insert into an empty cell (g.invD <= -1e-6): c's values, its
//   variance clamped to >= 1e-6, g's pixel coordinate, and the point
//   back-projected from that coordinate at c's inverse depth;
// - fuse a compatible one (Tdist: |c - g| < 2 sigma of either; l2: the
//   chi-square test < 5.99): the Student-t posterior (_student_t_update)
//   or the l2 product, residual min, age + 2 (Tdist) or + 1 (l2);
// - replace an incompatible, unoccluded one that has a lower variance
//   and residual: c's values, its sub-pixel coordinate and point;
// - count the fuses into num_fused, and the run's candidates past K into
//   num_dropped.
// A slot whose candidate has invD <= 0 changes nothing.
//
// What bounds it on the card: bytes. Each pixel reads its 11 grid words
// (x and p_cam interleaved) and writes 11; the sorted pixel ids inside
// the grid are read once, each taken slot's order entry once, and each
// candidate that some slot takes its 8 words once (its Kt tiles share
// them); the arithmetic is a few dozen operations a taken slot.
//
// Design (what each element does about the limits): at the DSEC size the
// launch is about one wave (2,400 blocks of 128; an SM holds 16), so a
// thread's chain of dependent loads sets the time, and the design
// shortens it.
// - One thread a pixel, 128 a block: the grid planes are read and written
//   coalesced.
// - No rank, no slot plane. A block's pixels q0 .. q0 + 127 own one
//   stretch [lo, hi) of pix_sorted: two warps find its ends, each by a
//   32-way search (32 lanes probe 32 evenly spaced entries, a ballot
//   keeps one stretch: 4 dependent loads over 450k entries instead of
//   19). The block copies the stretch into shared memory (up to
//   FUSE_RANGE entries; a longer one is searched in L2) and each thread
//   finds its pixel's run [start, end) there by two binary searches.
// - The candidates are read untiled (the Kt tiles of a candidate carry
//   the same values), so the gathers touch M candidates, not M * Kt; a
//   slot's 8 words load while the slot before it folds, and its order
//   entry one slot earlier still.
// - num_fused and num_dropped: integer sums, a warp's by shuffles, a
//   block's in shared memory, then one 64-bit atomic each a block: exact
//   in any order.
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

#define FUSE_THREADS 128
#define OCC_EPS -1e-6f
// the block's sorted pixel ids held in shared memory (a block's range
// longer than this is searched in global memory)
#define FUSE_RANGE 2048

struct FuseParams {
  // the grid: (H, W) planes, x (H, W, 2), p (H, W, 3)
  const float *invD, *var, *s2, *nu, *res, *x, *p;
  const int* age;
  // the candidates, untiled: (M,) channels, x (M, 2)
  const float *c_invD, *c_var, *c_s2, *c_nu, *c_res, *c_x;
  const int* c_age;
  const int64_t* order;       // (n,) tiled candidate ids in slot order
  const int64_t* pix_sorted;  // (n,) their pixel ids, ascending
  const float* cam;  // Ainv row-major (9), then b (3)
  float *o_invD, *o_var, *o_s2, *o_nu, *o_res, *o_x, *o_p;
  int* o_age;
  unsigned long long* counts;  // num_fused, num_dropped
  int HW, K, Kt, n, tdist;
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

// The first index of pix_sorted[lo, hi) whose pixel is >= key (hi if
// none), by one warp: each step the 32 lanes probe 32 evenly spaced
// entries and a ballot keeps the one stretch that holds the answer, so
// ~log32(hi - lo) dependent loads instead of log2. Every lane returns it.
__device__ __forceinline__ int warp_lower_bound(const int64_t* ps, int lo,
                                                int hi, long long key) {
  const int lane = threadIdx.x & 31;
  while (hi - lo >= 32) {
    const int step = (hi - lo + 31) / 32;
    const int pos = lo + (lane + 1) * step - 1;
    const unsigned below =
        __ballot_sync(0xffffffffu, pos < hi && __ldg(ps + pos) < key);
    const int c = __popc(below);
    hi = min(hi, lo + (c + 1) * step - 1);
    lo += c * step;
  }
  const int pos = lo + lane;
  return lo + __popc(__ballot_sync(0xffffffffu,
                                   pos < hi && __ldg(ps + pos) < key));
}

// The first index of a[0, n) (ascending) whose value is >= key, on
// shared memory
__device__ __forceinline__ int lower_bound_shared(const int* a, int n,
                                                  int key) {
  int lo = 0;
  while (n > 0) {
    const int half = n >> 1;
    if (a[lo + half] < key) {
      lo += half + 1;
      n -= half + 1;
    } else {
      n = half;
    }
  }
  return lo;
}

// the same on global memory, within [lo, hi)
__device__ __forceinline__ int lower_bound_global(const int64_t* ps, int lo,
                                                  int hi, long long key) {
  int n = hi - lo;
  while (n > 0) {
    const int half = n >> 1;
    if (__ldg(ps + lo + half) < key) {
      lo += half + 1;
      n -= half + 1;
    } else {
      n = half;
    }
  }
  return lo;
}

// a grid cell and a candidate, as the fold reads them
struct Cell {
  float invD, var, s2, nu, res, x0, x1, p[3];
  int age;
};
struct Cand {
  float invD, var, s2, nu, res, x0, x1;
  int age;
};

// the candidate of sorted entry j (its tiled id over the tiles a
// candidate), and its 8 words
__device__ __forceinline__ int slot_candidate(const FuseParams& p, int j) {
  return (int)__ldg(p.order + j) / p.Kt;
}
__device__ __forceinline__ Cand load_candidate(const FuseParams& p, int id) {
  Cand c;
  c.invD = __ldg(p.c_invD + id);
  c.var = __ldg(p.c_var + id);
  c.s2 = __ldg(p.c_s2 + id);
  c.nu = __ldg(p.c_nu + id);
  c.res = __ldg(p.c_res + id);
  c.age = (int)(float)__ldg(p.c_age + id);
  c.x0 = __ldg(p.c_x + 2 * id);
  c.x1 = __ldg(p.c_x + 2 * id + 1);
  return c;
}

// one slot of the fold: the reference's rules on cell g and candidate c
// (c.invD > 0); returns whether c fused into g
__device__ __forceinline__ bool fold_slot(Cell& g, const Cand& c,
                                          const float* A, const float* b,
                                          bool tdist) {
  const float inv_c = clamp_min(c.invD, 1e-12f);
  const bool occ = g.invD > OCC_EPS;
  bool compat;
  if (tdist) {
    const float std_g = __fsqrt_rn(clamp_min(g.var, 0.0f));
    const float std_c = __fsqrt_rn(clamp_min(c.var, 0.0f));
    const float diff = fabsf(__fsub_rn(c.invD, g.invD));
    compat = (diff < __fmul_rn(2.0f, std_g)) ||
             (diff < __fmul_rn(2.0f, std_c));
  } else {
    const float e = __fsub_rn(c.invD, g.invD);
    const float d2 = __fmul_rn(e, e);
    compat = __fadd_rn(__fdiv_rn(d2, clamp_min(c.var, 1e-20f)),
                       __fdiv_rn(d2, clamp_min(g.var, 1e-20f))) < 5.99f;
  }
  const bool occluded =
      __fsub_rn(g.invD, __fmul_rn(2.0f, __fsqrt_rn(clamp_min(g.var, 0.0f)))) >
      c.invD;
  if (!occ) {                                        // insert
    back_project(A, b, g.x0, g.x1, inv_c, g.p);
    g.invD = c.invD;
    g.var = clamp_min(c.var, 1e-6f);
    g.s2 = c.s2;
    g.nu = c.nu;
    g.res = c.res;
    g.age = c.age;
    return false;
  }
  if (compat) {                                      // fuse
    float f_invD, f_var, f_s2, f_nu;
    int f_age;
    if (tdist) {
      // _student_t_update(g, c)
      const float nu_u = nan_min(g.nu, c.nu);
      const float s_sum = __fadd_rn(g.s2, c.s2);
      f_invD = __fdiv_rn(
          __fadd_rn(__fmul_rn(c.s2, g.invD), __fmul_rn(g.s2, c.invD)), s_sum);
      const float e = __fsub_rn(g.invD, c.invD);
      const float d2 = __fmul_rn(e, e);
      const float gauss = __fdiv_rn(__fmul_rn(g.s2, c.s2), s_sum);
      if (isfinite(nu_u)) {
        f_s2 = __fmul_rn(__fdiv_rn(__fadd_rn(nu_u, __fdiv_rn(d2, s_sum)),
                                   __fadd_rn(nu_u, 1.0f)),
                         gauss);
        f_nu = __fadd_rn(nu_u, 1.0f);
        f_var = __fmul_rn(
            __fdiv_rn(f_nu, clamp_min(__fsub_rn(f_nu, 2.0f), 1e-6f)), f_s2);
      } else {
        f_s2 = gauss;
        f_nu = nu_u;
        f_var = gauss;
      }
      f_age = g.age + 2;
    } else {
      const float vsum = __fadd_rn(g.var, c.var);
      f_invD = __fdiv_rn(
          __fadd_rn(__fmul_rn(g.var, c.invD), __fmul_rn(c.var, g.invD)), vsum);
      f_var = __fdiv_rn(__fmul_rn(g.var, c.var), vsum);
      f_s2 = f_var;
      f_nu = g.nu;
      f_age = g.age + 1;
    }
    back_project(A, b, g.x0, g.x1, inv_c, g.p);
    g.invD = f_invD;
    g.var = clamp_min(f_var, 1e-6f);
    g.s2 = f_s2;
    g.nu = f_nu;
    g.res = nan_min(g.res, c.res);
    g.age = f_age;
    return true;
  }
  if (!occluded && c.var < g.var && c.res < g.res) {  // replace
    back_project(A, b, c.x0, c.x1, inv_c, g.p);
    g.invD = c.invD;
    g.var = c.var;
    g.s2 = c.s2;
    g.nu = c.nu;
    g.res = c.res;
    g.age = c.age;
    g.x0 = c.x0;
    g.x1 = c.x1;
  }
  return false;
}

__global__ void __launch_bounds__(FUSE_THREADS)
    fuse_runs_kernel(const FuseParams p) {
  __shared__ float s_cam[12];
  __shared__ unsigned int s_count[2];
  __shared__ int s_range[2];
  __shared__ int s_pix[FUSE_RANGE];
  if (threadIdx.x < 12) s_cam[threadIdx.x] = p.cam[threadIdx.x];
  if (threadIdx.x < 2) s_count[threadIdx.x] = 0;
  // the block's pixels q0 .. q0 + FUSE_THREADS - 1 own the sorted
  // entries [lo, hi): warp 0 finds lo, warp 1 hi
  const int q0 = blockIdx.x * FUSE_THREADS;
  if (threadIdx.x < 64) {
    const long long key = q0 + (threadIdx.x < 32 ? 0 : FUSE_THREADS);
    const int at = warp_lower_bound(p.pix_sorted, 0, p.n, key);
    if ((threadIdx.x & 31) == 0) s_range[threadIdx.x >> 5] = at;
  }
  __syncthreads();
  const int lo = s_range[0], hi = s_range[1];
  const bool staged = hi - lo <= FUSE_RANGE;
  if (staged) {
    for (int e = threadIdx.x; e < hi - lo; e += FUSE_THREADS)
      s_pix[e] = (int)(__ldg(p.pix_sorted + lo + e) - q0);
  }
  __syncthreads();
  const float* A = s_cam;
  const float* b = s_cam + 9;

  const int i = q0 + threadIdx.x;
  unsigned int fused = 0, dropped = 0;
  if (i < p.HW) {
    Cell g;
    g.invD = p.invD[i];
    g.var = p.var[i];
    g.s2 = p.s2[i];
    g.nu = p.nu[i];
    g.res = p.res[i];
    g.age = p.age[i];
    g.x0 = p.x[2 * i];
    g.x1 = p.x[2 * i + 1];
    g.p[0] = p.p[3 * i];
    g.p[1] = p.p[3 * i + 1];
    g.p[2] = p.p[3 * i + 2];
    // the pixel's run [start, end): its candidates, in slot order
    int start, end;
    if (staged) {
      start = lo + lower_bound_shared(s_pix, hi - lo, threadIdx.x);
      end = lo + lower_bound_shared(s_pix, hi - lo, threadIdx.x + 1);
    } else {
      start = lower_bound_global(p.pix_sorted, lo, hi, i);
      end = lower_bound_global(p.pix_sorted, start, hi, i + 1);
    }
    const int run = end - start;
    const int taken = run < p.K ? run : p.K;
    dropped = run - taken;
    // slots in order; slot k + 1's words load while slot k folds, and
    // slot k + 2's id with them
    Cand c{};
    if (taken > 0) c = load_candidate(p, slot_candidate(p, start));
    int id_next = taken > 1 ? slot_candidate(p, start + 1) : 0;
    for (int k = 0; k < taken; ++k) {
      Cand next = c;
      if (k + 1 < taken) {
        const int id_after = k + 2 < taken
                                 ? slot_candidate(p, start + k + 2) : 0;
        next = load_candidate(p, id_next);
        id_next = id_after;
      }
      // c_ok is false (invD <= 0 or NaN): no rule fires
      if (c.invD > 0.0f && fold_slot(g, c, A, b, p.tdist)) ++fused;
      c = next;
    }
    p.o_invD[i] = g.invD;
    p.o_var[i] = g.var;
    p.o_s2[i] = g.s2;
    p.o_nu[i] = g.nu;
    p.o_res[i] = g.res;
    p.o_age[i] = g.age;
    p.o_x[2 * i] = g.x0;
    p.o_x[2 * i + 1] = g.x1;
    p.o_p[3 * i] = g.p[0];
    p.o_p[3 * i + 1] = g.p[1];
    p.o_p[3 * i + 2] = g.p[2];
  }
  // the block's fuses and drops, then one add each to the totals
  // (integer sums: the same whatever order the blocks add in)
  for (int off = 16; off > 0; off >>= 1) {
    fused += __shfl_down_sync(0xffffffffu, fused, off);
    dropped += __shfl_down_sync(0xffffffffu, dropped, off);
  }
  if ((threadIdx.x & 31) == 0) {
    if (fused) atomicAdd(&s_count[0], fused);
    if (dropped) atomicAdd(&s_count[1], dropped);
  }
  __syncthreads();
  if (threadIdx.x < 2 && s_count[threadIdx.x])
    atomicAdd(p.counts + threadIdx.x,
              (unsigned long long)s_count[threadIdx.x]);
}

extern "C" int esvo_fuse(const void* invD, const void* var, const void* s2,
                         const void* nu, const void* res, const void* age,
                         const void* x, const void* pc, const void* c_invD,
                         const void* c_var, const void* c_s2,
                         const void* c_nu, const void* c_res,
                         const void* c_age, const void* c_x,
                         const void* order, const void* pix_sorted,
                         const void* cam, void* o_invD, void* o_var,
                         void* o_s2, void* o_nu, void* o_res, void* o_age,
                         void* o_x, void* o_p, void* counts, int HW, int K,
                         int Kt, int n, int tdist, void* stream) {
  if (HW < 0 || K < 0 || Kt < 1 || n < 0) return (int)cudaErrorInvalidValue;
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
  p.order = (const int64_t*)order;
  p.pix_sorted = (const int64_t*)pix_sorted;
  p.cam = (const float*)cam;
  p.o_invD = (float*)o_invD;
  p.o_var = (float*)o_var;
  p.o_s2 = (float*)o_s2;
  p.o_nu = (float*)o_nu;
  p.o_res = (float*)o_res;
  p.o_age = (int*)o_age;
  p.o_x = (float*)o_x;
  p.o_p = (float*)o_p;
  p.counts = (unsigned long long*)counts;
  p.HW = HW;
  p.K = K;
  p.Kt = Kt;
  p.n = n;
  p.tdist = tdist;
  void* args[] = {(void*)&p};
  const dim3 grid((HW + FUSE_THREADS - 1) / FUSE_THREADS);
  cudaError_t err = cudaLaunchKernel((const void*)fuse_runs_kernel, grid,
                                     dim3(FUSE_THREADS), args, 0,
                                     (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
