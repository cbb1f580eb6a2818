// K4: the tracker's whole Levenberg-Marquardt scan in one launch.
//
// Replaces the fused XLA scan of esvo_tpu/tracking/registration.py:solve
// (:283, its lax.scan at :339), not a Pallas kernel. It computes what
// tracking/registration.py::solve_plain computes for the analytic
// Jacobian (1x1 patches): max_iteration one-step LM rounds over rotating
// batches of B = min(batch_size, M) map points. Each round
// - takes the batch at start = min((it % num_batches) * batch_size, M - B)
//   (JAX's dynamic_slice clamping);
// - evaluates the cost at the current (R, t): the warp at x = 0
//   (R_cur_ref = two Newton-Schulz steps on R^T, t_cur_ref = -R_cur_ref t),
//   the pinhole projection with the bounds / depth / valid-pixel-mask
//   test, the bilinear sample of the negative surface with
//   patch_interpolate's validity rule, 255 where a reprojection is not
//   ok, the Huber weight sqrt(w) * r (or l2), the batch's sum of f^2 and
//   the rms over its valid reprojections;
// - builds the analytic Jacobian at x = 0 (the Sobel gradients sampled
//   bilinearly and divided by 8, dPi, 2 R^T [p]x and -R^T; zero rows for
//   invalid points) and g = J^T f, H = J^T J;
// - solves (H + lambda diag(H) + 1e-12 I) dx = -g by Cholesky and two
//   triangular solves (a pivot that is not positive gives NaN, and a
//   non-finite element of dx becomes 0, as solve_spd + isfinite do);
// - folds dx in (Cayley -> dR, R <- two Newton-Schulz steps on dR R,
//   t <- dx[3:] + dR t), evaluates the trial cost, accepts when
//   cost_try < cost, and scales lambda by 0.3 or 5, clamped to
//   [1e-9, 1e6]; rms[it] is the accepted or the current rms.
// Then it writes R, t, T_world_cur = [R_wr R, R_wr t + t_wr] and rms.
//
// What bounds it on the card: neither bytes nor operations. A round reads
// B points and a few taps of three surfaces a point (~20 KB at B = 300)
// and does ~250 flops a point; the bound is well under a microsecond.
// The scan is a chain of 2 * max_iteration dependent passes over the
// batch, each ending in a block-wide reduction, and a serial 6x6 solve
// between them: its time is that chain's latency.
//
// Design (what each element does about the limits):
// - One block of TRACK_THREADS (10 warps) a solve. The threads stride
//   over the batch (one point a thread at B = 300); thread 0 runs the
//   serial algebra (warp, Cholesky, update, accept) and broadcasts the
//   poses through shared memory. One launch replaces ~5,250 eager ops.
// - The cost at the current pose and the Jacobian share one pass: each
//   thread adds its points' f^2, r^2, valid count, J f and the 21 entries
//   of J J^T into 30 running sums; the trial pass adds 3.
// - One fixed reduction order: the thread's own points in index order,
//   a __shfl_down_sync tree in each warp, then the warps' partials in
//   warp order through shared memory. Two launches on the same inputs
//   give the same bits, so a CUDA graph replay equals the eager roll.
// - No fast math. The sums' order differs from cuBLAS's and torch.sum's,
//   so K4 agrees with the plain twin to float32 rounding, and on a round
//   whose accept test (cost_try < cost) lands within that rounding the
//   two may take different sides.
#include <cuda_runtime.h>
#include <stdint.h>

#define TRACK_THREADS 320
#define TRACK_WARPS (TRACK_THREADS / 32)
#define NLIN 30  // cost, sum r^2, valid count, g[6], H[21] (upper, row-major)
#define NTRY 3   // cost, sum r^2, valid count
#define FULL 0xffffffffu

struct TrackParams {
  const float* R0;           // (3, 3) initial R of T_ref_left
  const float* t0;           // (3,)
  const float* T_world_ref;  // (4, 4)
  const float* points;       // (M, 3) in the ref frame
  const uint8_t* valid;      // (M,)
  const float* ts_neg;       // (H, W)
  const float* grad_u;       // (H, W)
  const float* grad_v;       // (H, W)
  const float* P;            // (3, 4)
  const uint8_t* mask;       // (H, W)
  float* R_out;              // (3, 3)
  float* t_out;              // (3,)
  float* T_out;              // (4, 4)
  float* rms_out;            // (max_iteration,)
  int M, H, W, batch_size, max_iteration, huber;
  float huber_threshold, lm_damping;
};

// c = a b, 3x3 row-major
__device__ void mat3_mul(const float* a, const float* b, float* c) {
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j)
      c[3 * i + j] = a[3 * i] * b[j] + a[3 * i + 1] * b[3 + j] +
                     a[3 * i + 2] * b[6 + j];
}

__device__ void transpose3(const float* a, float* b) {
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) b[3 * i + j] = a[3 * j + i];
}

// Two Newton-Schulz polar steps R <- 0.5 R (3I - R^T R), in place
// (geometry/se3.py::orthonormalize_rotation_fast).
__device__ void newton_schulz2(float* R) {
  for (int s = 0; s < 2; ++s) {
    float Rt[9], RtR[9], A[9], B[9];
    transpose3(R, Rt);
    mat3_mul(Rt, R, RtR);
    for (int i = 0; i < 9; ++i) A[i] = ((i % 4 == 0) ? 3.0f : 0.0f) - RtR[i];
    mat3_mul(R, A, B);
    for (int i = 0; i < 9; ++i) R[i] = 0.5f * B[i];
  }
}

// Cayley parameters -> rotation (geometry/se3.py::cayley_to_rot).
__device__ void cayley_to_rot(const float* c, float* R) {
  const float c1 = c[0], c2 = c[1], c3 = c[2];
  const float s = 1.0f + c1 * c1 + c2 * c2 + c3 * c3;
  R[0] = 1.0f + c1 * c1 - c2 * c2 - c3 * c3;
  R[1] = 2.0f * (c1 * c2 - c3);
  R[2] = 2.0f * (c1 * c3 + c2);
  R[3] = 2.0f * (c1 * c2 + c3);
  R[4] = 1.0f - c1 * c1 + c2 * c2 - c3 * c3;
  R[5] = 2.0f * (c2 * c3 - c1);
  R[6] = 2.0f * (c1 * c3 - c2);
  R[7] = 2.0f * (c2 * c3 + c1);
  R[8] = 1.0f - c1 * c1 - c2 * c2 + c3 * c3;
  for (int i = 0; i < 9; ++i) R[i] = R[i] / s;
}

// The residual warp at x = 0 for the pose (R, t): Rw = NS2(R^T),
// tw = -Rw t (registration.py::warping_transformation).
__device__ void residual_warp(const float* R, const float* t, float* Rw,
                              float* tw) {
  transpose3(R, Rw);
  newton_schulz2(Rw);
  for (int i = 0; i < 3; ++i)
    tw[i] = -(Rw[3 * i] * t[0] + Rw[3 * i + 1] * t[1] + Rw[3 * i + 2] * t[2]);
}

// Pinhole projection of p_left and the 1x1-patch validity test (image
// bounds, depth, the valid-pixel mask): _project_and_check.
__device__ __forceinline__ bool project(const TrackParams& p, const float* P,
                                        const float* pl, float& u, float& v) {
  const float h0 = P[0] * pl[0] + P[1] * pl[1] + P[2] * pl[2] + P[3];
  const float h1 = P[4] * pl[0] + P[5] * pl[1] + P[6] * pl[2] + P[7];
  const float h2 = P[8] * pl[0] + P[9] * pl[1] + P[10] * pl[2] + P[11];
  u = h0 / h2;
  v = h1 / h2;
  bool ok = (u >= 0.0f) && (u <= (float)(p.W - 1)) && (v >= 0.0f) &&
            (v <= (float)(p.H - 1)) && (h2 > 1e-9f);
  if (ok) {  // u, v in the image: floor is a valid pixel
    const int ui = (int)floorf(u), vi = (int)floorf(v);
    ok = __ldg(p.mask + (size_t)vi * p.W + ui) != 0;
  }
  return ok;
}

// patch_interpolate's 1x1 rule: the 2x2 source window at floor(loc)
// must lie inside the image. Returns the bilinear weights' anchor.
__device__ __forceinline__ bool window(const TrackParams& p, float u, float v,
                                       size_t& at, float& fx, float& fy) {
  const float x0 = floorf(u), y0 = floorf(v);
  const int ux = (int)x0, uy = (int)y0;
  if (!(ux >= 0 && uy >= 0 && ux + 1 < p.W && uy + 1 < p.H)) return false;
  at = (size_t)uy * p.W + ux;
  fx = u - x0;
  fy = v - y0;
  return true;
}

__device__ __forceinline__ float bilinear(const float* img, int W, size_t at,
                                          float fx, float fy) {
  const float r0 = (1.0f - fx) * __ldg(img + at) + fx * __ldg(img + at + 1);
  const float r1 =
      (1.0f - fx) * __ldg(img + at + W) + fx * __ldg(img + at + W + 1);
  return (1.0f - fy) * r0 + fy * r1;
}

// One point's raw residual r, weighted residual f and reprojection ok at
// the warp (Rw, tw).
__device__ __forceinline__ void point_residual(const TrackParams& p,
                                               const float* P, const float* Rw,
                                               const float* tw, const float* q,
                                               bool valid, float& r, float& f,
                                               bool& ok) {
  float pl[3];
  for (int i = 0; i < 3; ++i)
    pl[i] = Rw[3 * i] * q[0] + Rw[3 * i + 1] * q[1] + Rw[3 * i + 2] * q[2] +
            tw[i];
  float u, v, fx, fy;
  size_t at;
  ok = valid && project(p, P, pl, u, v) && window(p, u, v, at, fx, fy);
  r = ok ? bilinear(p.ts_neg, p.W, at, fx, fy) : 255.0f;
  if (p.huber) {
    const float w = r > p.huber_threshold
                        ? p.huber_threshold / fmaxf(r, 1e-12f)
                        : 1.0f;
    f = sqrtf(w) * r;
  } else {
    f = r;
  }
}

// The analytic Jacobian row (6,) of the raw residual at x = 0 for the
// pose (R^T = Rt, t); zeros for an invalid point.
__device__ __forceinline__ void point_jacobian(const TrackParams& p,
                                               const float* P, const float* Rt,
                                               const float* t, const float* q,
                                               bool valid, float* J) {
  for (int k = 0; k < 6; ++k) J[k] = 0.0f;
  const float d[3] = {q[0] - t[0], q[1] - t[1], q[2] - t[2]};
  float pl[3];
  for (int i = 0; i < 3; ++i)
    pl[i] = Rt[3 * i] * d[0] + Rt[3 * i + 1] * d[1] + Rt[3 * i + 2] * d[2];
  float u, v, fx, fy;
  size_t at;
  if (!(valid && project(p, P, pl, u, v) && window(p, u, v, at, fx, fy)))
    return;
  const float gu = bilinear(p.grad_u, p.W, at, fx, fy) / 8.0f;
  const float gv = bilinear(p.grad_v, p.W, at, fx, fy) / 8.0f;
  float z = pl[2];
  z = fabsf(z) > 1e-12f ? z : 1e-12f;
  const float u_num = P[0] * pl[0] + P[1] * pl[1] + P[3];
  const float v_num = P[4] * pl[0] + P[5] * pl[1] + P[7];
  // a = grad^T dPi (3,)
  const float a0 = gu * (P[0] / z) + gv * (P[4] / z);
  const float a1 = gu * (P[1] / z) + gv * (P[5] / z);
  const float a2 = gu * (-u_num / (z * z)) + gv * (-v_num / (z * z));
  // b = a^T R^T; d p_left / dc = 2 R^T [q]x, d p_left / dt = -R^T
  float b[3];
  for (int m = 0; m < 3; ++m)
    b[m] = a0 * Rt[m] + a1 * Rt[3 + m] + a2 * Rt[6 + m];
  J[0] = 2.0f * (b[1] * q[2] - b[2] * q[1]);
  J[1] = 2.0f * (b[2] * q[0] - b[0] * q[2]);
  J[2] = 2.0f * (b[0] * q[1] - b[1] * q[0]);
  J[3] = -b[0];
  J[4] = -b[1];
  J[5] = -b[2];
}

// Block-wide sums of v[0..N) in one fixed order: a shuffle tree in each
// warp, then the warps' partials in warp order. `out` (shared) holds the
// sums for every thread afterwards.
template <int N>
__device__ __forceinline__ void block_sum(float* v, float* red, float* out) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < N; ++k)
    for (int off = 16; off > 0; off >>= 1)
      v[k] += __shfl_down_sync(FULL, v[k], off);
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < N; ++k) red[warp * N + k] = v[k];
  }
  __syncthreads();
  if (threadIdx.x < N) {
    float s = 0.0f;
    for (int w = 0; w < TRACK_WARPS; ++w) s += red[w * N + threadIdx.x];
    out[threadIdx.x] = s;
  }
  __syncthreads();
}

// The damped 6x6 step: dx = -(A)^-1 g with A = H + (lam diag(H) + 1e-12 I)
// by Cholesky; a failed pivot makes every element NaN, and each non-finite
// element becomes 0 (ops/linalg.py::solve_spd, then isfinite).
__device__ void damped_step(const float* sums, float lam, float* dx) {
  const float* g = sums + 3;
  const float* Hu = sums + 9;
  float A[36];
  for (int i = 0, k = 0; i < 6; ++i)
    for (int j = i; j < 6; ++j, ++k) A[6 * i + j] = A[6 * j + i] = Hu[k];
  for (int i = 0; i < 6; ++i)
    A[7 * i] = A[7 * i] + (lam * A[7 * i] + 1e-12f);
  float L[36];
  bool ok = true;
  for (int j = 0; j < 6 && ok; ++j) {
    float d = A[7 * j];
    for (int k = 0; k < j; ++k) d -= L[6 * j + k] * L[6 * j + k];
    if (!(d > 0.0f)) {
      ok = false;
      break;
    }
    L[7 * j] = sqrtf(d);
    for (int i = j + 1; i < 6; ++i) {
      float s = A[6 * i + j];
      for (int k = 0; k < j; ++k) s -= L[6 * i + k] * L[6 * j + k];
      L[6 * i + j] = s / L[7 * j];
    }
  }
  if (!ok) {
    for (int i = 0; i < 6; ++i) dx[i] = 0.0f;
    return;
  }
  float y[6], x[6];
  for (int i = 0; i < 6; ++i) {
    float s = g[i];
    for (int k = 0; k < i; ++k) s -= L[6 * i + k] * y[k];
    y[i] = s / L[7 * i];
  }
  for (int i = 5; i >= 0; --i) {
    float s = y[i];
    for (int k = i + 1; k < 6; ++k) s -= L[6 * k + i] * x[k];
    x[i] = s / L[7 * i];
  }
  for (int i = 0; i < 6; ++i) {
    const float v = -x[i];
    dx[i] = isfinite(v) ? v : 0.0f;
  }
}

__global__ void __launch_bounds__(TRACK_THREADS)
    track_solve_kernel(const TrackParams p) {
  __shared__ float sP[12];
  __shared__ float sR[9], st[3];          // the current pose
  __shared__ float sRtry[9], sttry[3];    // the trial pose
  __shared__ float sRw[9], stw[3], sRt[9];
  __shared__ float red[TRACK_WARPS * NLIN];
  __shared__ float lin[NLIN], trial[NTRY];
  __shared__ float cur_cost, cur_rms, lam;

  const int tid = threadIdx.x;
  if (tid < 12) sP[tid] = p.P[tid];
  if (tid < 9) sR[tid] = p.R0[tid];
  if (tid < 3) st[tid] = p.t0[tid];
  if (tid == 0) lam = p.lm_damping;
  __syncthreads();

  const int M = p.M;
  const int B = min(p.batch_size, M);
  const int num_batches = max(M / p.batch_size, 1);
  for (int it = 0; it < p.max_iteration; ++it) {
    const int start = min((it % num_batches) * p.batch_size, M - B);
    if (tid == 0) {
      residual_warp(sR, st, sRw, stw);
      transpose3(sR, sRt);
    }
    __syncthreads();

    // the cost at (R, t) and the normal equations
    float acc[NLIN];
#pragma unroll
    for (int k = 0; k < NLIN; ++k) acc[k] = 0.0f;
    for (int i = tid; i < B; i += TRACK_THREADS) {
      const float q[3] = {__ldg(p.points + 3 * (size_t)(start + i)),
                          __ldg(p.points + 3 * (size_t)(start + i) + 1),
                          __ldg(p.points + 3 * (size_t)(start + i) + 2)};
      const bool valid = __ldg(p.valid + start + i) != 0;
      float r, f, J[6];
      bool ok;
      point_residual(p, sP, sRw, stw, q, valid, r, f, ok);
      point_jacobian(p, sP, sRt, st, q, valid, J);
      acc[0] += f * f;
      if (ok) {
        acc[1] += r * r;
        acc[2] += 1.0f;
      }
      int m = 9;
#pragma unroll
      for (int k = 0; k < 6; ++k) {
        acc[3 + k] += J[k] * f;
#pragma unroll
        for (int l = k; l < 6; ++l, ++m) acc[m] += J[k] * J[l];
      }
    }
    block_sum<NLIN>(acc, red, lin);

    if (tid == 0) {
      cur_cost = lin[0];
      cur_rms = sqrtf(lin[1] / fmaxf(lin[2], 1.0f));
      float dx[6], dR[9], dRR[9];
      damped_step(lin, lam, dx);
      cayley_to_rot(dx, dR);
      mat3_mul(dR, sR, dRR);
      newton_schulz2(dRR);
      for (int i = 0; i < 9; ++i) sRtry[i] = dRR[i];
      for (int i = 0; i < 3; ++i)
        sttry[i] = dx[3 + i] + (dR[3 * i] * st[0] + dR[3 * i + 1] * st[1] +
                                dR[3 * i + 2] * st[2]);
      residual_warp(sRtry, sttry, sRw, stw);
    }
    __syncthreads();

    // the trial cost
    float acc_try[NTRY] = {0.0f, 0.0f, 0.0f};
    for (int i = tid; i < B; i += TRACK_THREADS) {
      const float q[3] = {__ldg(p.points + 3 * (size_t)(start + i)),
                          __ldg(p.points + 3 * (size_t)(start + i) + 1),
                          __ldg(p.points + 3 * (size_t)(start + i) + 2)};
      const bool valid = __ldg(p.valid + start + i) != 0;
      float r, f;
      bool ok;
      point_residual(p, sP, sRw, stw, q, valid, r, f, ok);
      acc_try[0] += f * f;
      if (ok) {
        acc_try[1] += r * r;
        acc_try[2] += 1.0f;
      }
    }
    block_sum<NTRY>(acc_try, red, trial);

    if (tid == 0) {
      const bool accept = trial[0] < cur_cost;
      if (accept) {
        for (int i = 0; i < 9; ++i) sR[i] = sRtry[i];
        for (int i = 0; i < 3; ++i) st[i] = sttry[i];
      }
      const float l = accept ? lam * 0.3f : lam * 5.0f;
      lam = fminf(fmaxf(l, 1e-9f), 1e6f);
      p.rms_out[it] =
          accept ? sqrtf(trial[1] / fmaxf(trial[2], 1.0f)) : cur_rms;
    }
    __syncthreads();
  }

  if (tid == 0) {
    const float* Twr = p.T_world_ref;
    for (int i = 0; i < 9; ++i) p.R_out[i] = sR[i];
    for (int i = 0; i < 3; ++i) p.t_out[i] = st[i];
    for (int i = 0; i < 3; ++i) {
      for (int j = 0; j < 3; ++j)
        p.T_out[4 * i + j] = Twr[4 * i] * sR[j] + Twr[4 * i + 1] * sR[3 + j] +
                             Twr[4 * i + 2] * sR[6 + j];
      p.T_out[4 * i + 3] = (Twr[4 * i] * st[0] + Twr[4 * i + 1] * st[1] +
                            Twr[4 * i + 2] * st[2]) +
                           Twr[4 * i + 3];
    }
    p.T_out[12] = p.T_out[13] = p.T_out[14] = 0.0f;
    p.T_out[15] = 1.0f;
  }
}

// One LM scan of max_iteration rounds; every pointer is a device pointer
// (see TrackParams). Returns the launch's CUDA error.
extern "C" int esvo_track_solve(
    const void* R0, const void* t0, const void* T_world_ref,
    const void* points, const void* valid, const void* ts_neg,
    const void* grad_u, const void* grad_v, const void* P, const void* mask,
    void* R_out, void* t_out, void* T_out, void* rms_out, int M, int H, int W,
    int batch_size, int max_iteration, int huber, float huber_threshold,
    float lm_damping, void* stream) {
  if (M < 0 || H < 2 || W < 2 || batch_size < 1 || max_iteration < 0)
    return (int)cudaErrorInvalidValue;
  TrackParams p;
  p.R0 = (const float*)R0;
  p.t0 = (const float*)t0;
  p.T_world_ref = (const float*)T_world_ref;
  p.points = (const float*)points;
  p.valid = (const uint8_t*)valid;
  p.ts_neg = (const float*)ts_neg;
  p.grad_u = (const float*)grad_u;
  p.grad_v = (const float*)grad_v;
  p.P = (const float*)P;
  p.mask = (const uint8_t*)mask;
  p.R_out = (float*)R_out;
  p.t_out = (float*)t_out;
  p.T_out = (float*)T_out;
  p.rms_out = (float*)rms_out;
  p.M = M;
  p.H = H;
  p.W = W;
  p.batch_size = batch_size;
  p.max_iteration = max_iteration;
  p.huber = huber;
  p.huber_threshold = huber_threshold;
  p.lm_damping = lm_damping;
  track_solve_kernel<<<1, TRACK_THREADS, 0, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}
