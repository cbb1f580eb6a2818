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
// Design (what each element does about the chain):
// - One block of TRACK_THREADS (10 warps) a solve; the threads stride
//   over the batch (one point a thread at B = 300). One launch replaces
//   ~5,250 eager ops.
// - Empty rounds cost one barrier. When no point of a round's batch is
//   valid, every residual is the same sqrt(w) * 255 and every Jacobian
//   row is zero, so the cost and the trial cost are the same sum of the
//   same terms: the step is rejected, (R, t) stay, rms[it] is
//   sqrt(0 / 1) = 0 and lambda is multiplied by 5 (clamped). The block
//   learns whether a round's batch holds a valid point from a
//   __syncthreads_or at the end of the round before, and then does just
//   that.
// - A thread's point of the next round (and its valid byte) is loaded at
//   the start of the current one, so its latency hides behind the round;
//   the end-of-round __syncthreads_or reads it. A point's reprojections
//   issue all their loads at once (the mask bytes and the 4 or 12 taps,
//   at clamped addresses): one round trip to L1 / L2 a pass, not two or
//   four. The three surfaces stay in L1 / L2.
// - The cost at (R, t) and the Jacobian share one pass: each thread adds
//   its points' f^2, r^2, valid count, J f and the 21 entries of J J^T
//   into 30 running sums (32 with two zeros); the trial pass puts its 3
//   sums in the same places. A warp reduces the 32 sums by a transpose
//   (reduce-scatter): five butterfly stages of 16, 8, 4, 2 and 1
//   shuffles, after which lane k holds the warp's sum k (31 shuffles,
//   not 5 x 30). Warp 0 then adds the 10 warps' partials in warp order.
//   One fixed order, and the cost's the same in both passes: two
//   launches on the same inputs give the same bits, so a CUDA graph
//   replay equals the eager roll.
// - Thread 0 runs the serial algebra (the damped 6x6 Cholesky step, the
//   Cayley update, the Newton-Schulz steps, the trial warp, the accept
//   test) with every array fully unrolled into registers; the current
//   pose and lambda stay in its registers. The warp at the next round's
//   (R, t) is the trial warp when the step is accepted and the current
//   one when it is not, so it is never recomputed. IEEE division and
//   sqrt throughout.
// - The order of every operation and sum is fixed on purpose (the
//   transpose pairs the lanes as a __shfl_down_sync tree does; each
//   pivot divides): the accuracy campaign's loop closures are chaotic in
//   the tracker's rounding, and a K4 that rounded otherwise closed a
//   false loop edge there.
// - No fast math. The sums' order differs from cuBLAS's and torch.sum's,
//   so K4 agrees with the plain twin to float32 rounding, and on a round
//   whose accept test (cost_try < cost) lands within that rounding the
//   two may take different sides.
#include <cuda_runtime.h>
#include <stdint.h>

#define TRACK_THREADS 320
#define TRACK_WARPS (TRACK_THREADS / 32)
#define NSUM 32  // cost, sum r^2, valid count, g[6], H[21] (upper), 2 zeros
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
__device__ __forceinline__ void mat3_mul(const float* a, const float* b,
                                         float* c) {
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      c[3 * i + j] = a[3 * i] * b[j] + a[3 * i + 1] * b[3 + j] +
                     a[3 * i + 2] * b[6 + j];
}

__device__ __forceinline__ void transpose3(const float* a, float* b) {
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) b[3 * i + j] = a[3 * j + i];
}

// Two Newton-Schulz polar steps R <- 0.5 R (3I - R^T R), in place
// (geometry/se3.py::orthonormalize_rotation_fast).
__device__ __forceinline__ void newton_schulz2(float* R) {
#pragma unroll
  for (int s = 0; s < 2; ++s) {
    float Rt[9], RtR[9], A[9], B[9];
    transpose3(R, Rt);
    mat3_mul(Rt, R, RtR);
#pragma unroll
    for (int i = 0; i < 9; ++i) A[i] = ((i % 4 == 0) ? 3.0f : 0.0f) - RtR[i];
    mat3_mul(R, A, B);
#pragma unroll
    for (int i = 0; i < 9; ++i) R[i] = 0.5f * B[i];
  }
}

// Cayley parameters -> rotation (geometry/se3.py::cayley_to_rot).
__device__ __forceinline__ void cayley_to_rot(const float* c, float* R) {
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
#pragma unroll
  for (int i = 0; i < 9; ++i) R[i] = R[i] / s;
}

// The residual warp at x = 0 for the pose (R, t), as 12 floats: Rw =
// NS2(R^T) (row-major) then tw = -Rw t (registration.py::
// warping_transformation).
__device__ __forceinline__ void residual_warp(const float* R, const float* t,
                                             float* w) {
  float Rw[9];
  transpose3(R, Rw);
  newton_schulz2(Rw);
#pragma unroll
  for (int i = 0; i < 9; ++i) w[i] = Rw[i];
#pragma unroll
  for (int i = 0; i < 3; ++i)
    w[9 + i] =
        -(Rw[3 * i] * t[0] + Rw[3 * i + 1] * t[1] + Rw[3 * i + 2] * t[2]);
}

// A point's reprojection: the pinhole projection of p_left, the bounds /
// depth test and patch_interpolate's 1x1 rule (the 2x2 source window at
// floor(loc) inside the image) of _project_and_check, and where its
// loads go: the mask pixel floor(u, v) and the window's anchor, both
// clamped into the image, so that every load can be issued before the
// tests are known (a point that fails them never uses what it loaded).
struct Reproj {
  bool in;          // in the image, in front, its 2x2 window inside
  size_t px, at;    // the mask pixel; the window's top-left pixel
  float fx, fy;     // the bilinear weights
};

__device__ __forceinline__ Reproj reproject(const TrackParams& p,
                                            const float* P, const float* pl) {
  const float h0 = P[0] * pl[0] + P[1] * pl[1] + P[2] * pl[2] + P[3];
  const float h1 = P[4] * pl[0] + P[5] * pl[1] + P[6] * pl[2] + P[7];
  const float h2 = P[8] * pl[0] + P[9] * pl[1] + P[10] * pl[2] + P[11];
  const float u = h0 / h2, v = h1 / h2;
  const float x0 = floorf(u), y0 = floorf(v);
  const int ux = (int)x0, uy = (int)y0;  // NaN -> 0, saturating
  Reproj r;
  r.in = (u >= 0.0f) && (u <= (float)(p.W - 1)) && (v >= 0.0f) &&
         (v <= (float)(p.H - 1)) && (h2 > 1e-9f) && ux + 1 < p.W &&
         uy + 1 < p.H;
  const int mx = min(max(ux, 0), p.W - 1), my = min(max(uy, 0), p.H - 1);
  r.px = (size_t)my * p.W + mx;
  r.at = (size_t)min(my, p.H - 2) * p.W + min(mx, p.W - 2);
  r.fx = u - x0;
  r.fy = v - y0;
  return r;
}

struct Taps {
  float a, b, c, d;  // (y0, x0), (y0, x0 + 1), (y0 + 1, x0), (y0 + 1, x0 + 1)
};

__device__ __forceinline__ Taps taps(const float* img, int W, size_t at) {
  return {__ldg(img + at), __ldg(img + at + 1), __ldg(img + at + W),
          __ldg(img + at + W + 1)};
}

__device__ __forceinline__ float bilinear(Taps t, float fx, float fy) {
  const float r0 = (1.0f - fx) * t.a + fx * t.b;
  const float r1 = (1.0f - fx) * t.c + fx * t.d;
  return (1.0f - fy) * r0 + fy * r1;
}

// p_left = Rw q + tw for the residual warp w (Rw row-major, then tw).
__device__ __forceinline__ void warp_point(const float* w, const float* q,
                                           float* pl) {
#pragma unroll
  for (int i = 0; i < 3; ++i)
    pl[i] = w[3 * i] * q[0] + w[3 * i + 1] * q[1] + w[3 * i + 2] * q[2] +
            w[9 + i];
}

// The raw residual r (255 where the reprojection is not ok) and the
// weighted one f (the Huber weight sqrt(w) r, or r).
__device__ __forceinline__ void weigh(const TrackParams& p, bool ok,
                                      float sample, float& r, float& f) {
  r = ok ? sample : 255.0f;
  if (p.huber) {
    const float w = r > p.huber_threshold
                        ? p.huber_threshold / fmaxf(r, 1e-12f)
                        : 1.0f;
    f = sqrtf(w) * r;
  } else {
    f = r;
  }
}

// One point's raw residual r, weighted residual f and reprojection ok at
// the residual warp w: one round of loads (mask byte and taps together).
__device__ __forceinline__ void point_residual(const TrackParams& p,
                                               const float* P, const float* w,
                                               const float* q, bool valid,
                                               float& r, float& f, bool& ok) {
  float pl[3];
  warp_point(w, q, pl);
  const Reproj a = reproject(p, P, pl);
  const uint8_t m = __ldg(p.mask + a.px);
  const Taps t = taps(p.ts_neg, p.W, a.at);
  ok = valid && a.in && m != 0;
  weigh(p, ok, bilinear(t, a.fx, a.fy), r, f);
}

// The residual at the warp w and the analytic Jacobian row J (6,) of the
// raw residual at x = 0 for the pose (R^T = Rt, t), zeros for an invalid
// point: both reprojections first, then all their loads at once (two
// mask bytes, 12 taps), then the arithmetic.
__device__ __forceinline__ void point_residual_jacobian(
    const TrackParams& p, const float* P, const float* w, const float* Rt,
    const float* t, const float* q, bool valid, float& r, float& f, bool& ok,
    float* J) {
  float pr[3], pl[3];
  warp_point(w, q, pr);
  const float d[3] = {q[0] - t[0], q[1] - t[1], q[2] - t[2]};
#pragma unroll
  for (int i = 0; i < 3; ++i)
    pl[i] = Rt[3 * i] * d[0] + Rt[3 * i + 1] * d[1] + Rt[3 * i + 2] * d[2];
  const Reproj a = reproject(p, P, pr), b = reproject(p, P, pl);
  const uint8_t ma = __ldg(p.mask + a.px), mb = __ldg(p.mask + b.px);
  const Taps ta = taps(p.ts_neg, p.W, a.at);
  const Taps tu = taps(p.grad_u, p.W, b.at), tv = taps(p.grad_v, p.W, b.at);
  ok = valid && a.in && ma != 0;
  weigh(p, ok, bilinear(ta, a.fx, a.fy), r, f);

#pragma unroll
  for (int k = 0; k < 6; ++k) J[k] = 0.0f;
  if (!(valid && b.in && mb != 0)) return;
  const float gu = bilinear(tu, b.fx, b.fy) / 8.0f;
  const float gv = bilinear(tv, b.fx, b.fy) / 8.0f;
  float z = pl[2];
  z = fabsf(z) > 1e-12f ? z : 1e-12f;
  const float u_num = P[0] * pl[0] + P[1] * pl[1] + P[3];
  const float v_num = P[4] * pl[0] + P[5] * pl[1] + P[7];
  // a = grad^T dPi (3,)
  const float a0 = gu * (P[0] / z) + gv * (P[4] / z);
  const float a1 = gu * (P[1] / z) + gv * (P[5] / z);
  const float a2 = gu * (-u_num / (z * z)) + gv * (-v_num / (z * z));
  // b = a^T R^T; d p_left / dc = 2 R^T [q]x, d p_left / dt = -R^T
  float bb[3];
#pragma unroll
  for (int m = 0; m < 3; ++m)
    bb[m] = a0 * Rt[m] + a1 * Rt[3 + m] + a2 * Rt[6 + m];
  J[0] = 2.0f * (bb[1] * q[2] - bb[2] * q[1]);
  J[1] = 2.0f * (bb[2] * q[0] - bb[0] * q[2]);
  J[2] = 2.0f * (bb[0] * q[1] - bb[1] * q[0]);
  J[3] = -bb[0];
  J[4] = -bb[1];
  J[5] = -bb[2];
}

// The warp's sums of v[0..32) by a transpose (reduce-scatter): at each of
// five butterfly stages a lane keeps the half of its values that its
// lane bit selects and adds its partner's copy of that half, so that
// after 16 + 8 + 4 + 2 + 1 shuffles lane k holds the warp's sum k. One
// fixed order of additions for every k, whatever the values.
template <int HALF>
__device__ __forceinline__ void transpose_stage(float (&v)[NSUM], int lane) {
  const bool upper = (lane & HALF) != 0;
#pragma unroll
  for (int k = 0; k < HALF; ++k) {
    const float send = upper ? v[k] : v[k + HALF];
    const float keep = upper ? v[k + HALF] : v[k];
    v[k] = keep + __shfl_xor_sync(FULL, send, HALF);
  }
}

__device__ __forceinline__ float warp_sums(float (&v)[NSUM], int lane) {
  transpose_stage<16>(v, lane);
  transpose_stage<8>(v, lane);
  transpose_stage<4>(v, lane);
  transpose_stage<2>(v, lane);
  transpose_stage<1>(v, lane);
  return v[0];
}

// Block-wide sums: each warp's transpose, then warp 0 adds the warps'
// partials in warp order and leaves sum k in out[k]. The caller's
// __syncthreads precedes the read of `red`: call as
//   red[warp * NSUM + lane] = warp_sums(v, lane); __syncthreads();
//   if (warp == 0) block_sums(red, out, lane);
// out is complete for warp 0 after its __syncwarp.
__device__ __forceinline__ void block_sums(const float* red, float* out,
                                           int lane) {
  float s = 0.0f;
#pragma unroll
  for (int w = 0; w < TRACK_WARPS; ++w) s += red[w * NSUM + lane];
  out[lane] = s;
  __syncwarp();
}

// The damped 6x6 step: dx = -(A)^-1 g with A = H + (lam diag(H) + 1e-12 I)
// by Cholesky; a failed pivot makes every element NaN, and each non-finite
// element becomes 0 (ops/linalg.py::solve_spd, then isfinite). Every loop
// has a fixed trip count, so the arrays live in registers: a failed pivot
// clears a flag instead of leaving the loop. Each pivot divides its
// column and both triangular solves (IEEE division).
__device__ __forceinline__ void damped_step(const float* sums, float lam,
                                            float* dx) {
  const float* g = sums + 3;
  const float* Hu = sums + 9;
  float A[36];
#pragma unroll
  for (int i = 0, k = 0; i < 6; ++i)
#pragma unroll
    for (int j = i; j < 6; ++j, ++k) A[6 * i + j] = A[6 * j + i] = Hu[k];
#pragma unroll
  for (int i = 0; i < 6; ++i)
    A[7 * i] = A[7 * i] + (lam * A[7 * i] + 1e-12f);
  float L[36];
  bool ok = true;
#pragma unroll
  for (int j = 0; j < 6; ++j) {
    float d = A[7 * j];
#pragma unroll
    for (int k = 0; k < j; ++k) d -= L[6 * j + k] * L[6 * j + k];
    ok = ok && d > 0.0f;
    L[7 * j] = sqrtf(d);
#pragma unroll
    for (int i = j + 1; i < 6; ++i) {
      float s = A[6 * i + j];
#pragma unroll
      for (int k = 0; k < j; ++k) s -= L[6 * i + k] * L[6 * j + k];
      L[6 * i + j] = s / L[7 * j];
    }
  }
  float y[6], x[6];
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    float s = g[i];
#pragma unroll
    for (int k = 0; k < i; ++k) s -= L[6 * i + k] * y[k];
    y[i] = s / L[7 * i];
  }
#pragma unroll
  for (int i = 5; i >= 0; --i) {
    float s = y[i];
#pragma unroll
    for (int k = i + 1; k < 6; ++k) s -= L[6 * k + i] * x[k];
    x[i] = s / L[7 * i];
  }
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    const float v = -x[i];
    dx[i] = ok && isfinite(v) ? v : 0.0f;
  }
}

__device__ __forceinline__ int batch_start(const TrackParams& p, int it,
                                           int B, int num_batches) {
  return min((it % num_batches) * p.batch_size, p.M - B);
}

// A thread's first point of a batch (index tid), held in registers and
// loaded one round ahead; a batch larger than the block reads its other
// points from global memory when it needs them.
struct Point {
  float q[3];
  bool valid;
};

__device__ __forceinline__ Point load_point(const TrackParams& p, int i) {
  return {{__ldg(p.points + 3 * (size_t)i), __ldg(p.points + 3 * (size_t)i + 1),
           __ldg(p.points + 3 * (size_t)i + 2)},
          __ldg(p.valid + i) != 0};
}

// Whether this thread's points of the batch at `start` hold a valid one
// (`first`: its point tid, already loaded).
__device__ __forceinline__ int any_valid(const TrackParams& p, Point first,
                                         int start, int B, int tid) {
  int any = tid < B && first.valid;
  for (int i = tid + TRACK_THREADS; i < B; i += TRACK_THREADS)
    any |= __ldg(p.valid + start + i);
  return any;
}

__global__ void __launch_bounds__(TRACK_THREADS)
    track_solve_kernel(const TrackParams p) {
  __shared__ float sP[12];
  __shared__ float s_cur[12];   // the residual warp at (R, t)
  __shared__ float s_try[12];   // the residual warp at the trial pose
  __shared__ float s_jac[12];   // R^T (row-major) and t: the Jacobian's pose
  __shared__ float red[TRACK_WARPS * NSUM];
  __shared__ float sums[NSUM];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int M = p.M;
  const int B = min(p.batch_size, M);
  const int num_batches = max(M / p.batch_size, 1);

  // round 0's point of this thread, in flight while thread 0 starts
  Point cur = {{0.0f, 0.0f, 0.0f}, false};
  if (tid < B) cur = load_point(p, batch_start(p, 0, B, num_batches) + tid);

  // thread 0's state: the pose, the trial pose, lambda, the cost
  float R[9], t[3], Rtry[9], ttry[3], lam = p.lm_damping, cost = 0.0f,
        rms_cur = 0.0f;
  if (tid < 12) sP[tid] = __ldg(p.P + tid);
  if (tid == 0) {
#pragma unroll
    for (int i = 0; i < 9; ++i) R[i] = __ldg(p.R0 + i);
#pragma unroll
    for (int i = 0; i < 3; ++i) t[i] = __ldg(p.t0 + i);
    residual_warp(R, t, s_cur);
    transpose3(R, s_jac);
#pragma unroll
    for (int i = 0; i < 3; ++i) s_jac[9 + i] = t[i];
  }
  int nonempty = __syncthreads_or(
      any_valid(p, cur, batch_start(p, 0, B, num_batches), B, tid));

  for (int it = 0; it < p.max_iteration; ++it) {
    const int start = batch_start(p, it, B, num_batches);
    const int next = batch_start(p, it + 1, B, num_batches);
    Point nxt = {{0.0f, 0.0f, 0.0f}, false};
    if (tid < B) nxt = load_point(p, next + tid);  // used a round later
    if (nonempty) {
      // the cost at (R, t) and the normal equations
      float acc[NSUM];
#pragma unroll
      for (int k = 0; k < NSUM; ++k) acc[k] = 0.0f;
      for (int i = tid; i < B; i += TRACK_THREADS) {
        const Point pt = i == tid ? cur : load_point(p, start + i);
        float r, f, J[6];
        bool ok;
        point_residual_jacobian(p, sP, s_cur, s_jac, s_jac + 9, pt.q,
                                pt.valid, r, f, ok, J);
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
      red[warp * NSUM + lane] = warp_sums(acc, lane);
      __syncthreads();
      if (warp == 0) {
        block_sums(red, sums, lane);
        if (lane == 0) {
          float lin[NSUM];
#pragma unroll
          for (int k = 0; k < NSUM; ++k) lin[k] = sums[k];
          cost = lin[0];
          rms_cur = sqrtf(lin[1] / fmaxf(lin[2], 1.0f));
          float dx[6], dR[9];
          damped_step(lin, lam, dx);
          cayley_to_rot(dx, dR);
          mat3_mul(dR, R, Rtry);
          newton_schulz2(Rtry);
#pragma unroll
          for (int i = 0; i < 3; ++i)
            ttry[i] = dx[3 + i] + (dR[3 * i] * t[0] + dR[3 * i + 1] * t[1] +
                                   dR[3 * i + 2] * t[2]);
          residual_warp(Rtry, ttry, s_try);
        }
      }
      __syncthreads();

      // the trial cost, its sums where the cost's were
      float acc_try[NSUM];
#pragma unroll
      for (int k = 0; k < NSUM; ++k) acc_try[k] = 0.0f;
      for (int i = tid; i < B; i += TRACK_THREADS) {
        const Point pt = i == tid ? cur : load_point(p, start + i);
        float r, f;
        bool ok;
        point_residual(p, sP, s_try, pt.q, pt.valid, r, f, ok);
        acc_try[0] += f * f;
        if (ok) {
          acc_try[1] += r * r;
          acc_try[2] += 1.0f;
        }
      }
      red[warp * NSUM + lane] = warp_sums(acc_try, lane);
      __syncthreads();
      if (warp == 0) {
        block_sums(red, sums, lane);
        if (lane == 0) {
          const bool accept = sums[0] < cost;
          if (accept) {
#pragma unroll
            for (int i = 0; i < 9; ++i) R[i] = Rtry[i];
#pragma unroll
            for (int i = 0; i < 3; ++i) t[i] = ttry[i];
#pragma unroll
            for (int i = 0; i < 12; ++i) s_cur[i] = s_try[i];
            transpose3(R, s_jac);
#pragma unroll
            for (int i = 0; i < 3; ++i) s_jac[9 + i] = t[i];
          }
          const float l = accept ? lam * 0.3f : lam * 5.0f;
          lam = fminf(fmaxf(l, 1e-9f), 1e6f);
          p.rms_out[it] =
              accept ? sqrtf(sums[1] / fmaxf(sums[2], 1.0f)) : rms_cur;
        }
      }
    } else if (tid == 0) {  // no valid point: rejected, rms 0
      p.rms_out[it] = 0.0f;
      lam = fminf(fmaxf(lam * 5.0f, 1e-9f), 1e6f);
    }
    // publishes thread 0's updates; whether the next batch holds a point
    nonempty = __syncthreads_or(any_valid(p, nxt, next, B, tid));
    cur = nxt;
  }

  if (tid == 0) {
    const float* Twr = p.T_world_ref;
#pragma unroll
    for (int i = 0; i < 9; ++i) p.R_out[i] = R[i];
#pragma unroll
    for (int i = 0; i < 3; ++i) p.t_out[i] = t[i];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
#pragma unroll
      for (int j = 0; j < 3; ++j)
        p.T_out[4 * i + j] = Twr[4 * i] * R[j] + Twr[4 * i + 1] * R[3 + j] +
                             Twr[4 * i + 2] * R[6 + j];
      p.T_out[4 * i + 3] = (Twr[4 * i] * t[0] + Twr[4 * i + 1] * t[1] +
                            Twr[4 * i + 2] * t[2]) +
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
  void* args[] = {(void*)&p};
  cudaError_t err = cudaLaunchKernel((const void*)track_solve_kernel, dim3(1),
                                     dim3(TRACK_THREADS), args, 0,
                                     (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The kernel as the CUDA runtime reports it: info = {registers a thread,
// local bytes a thread, static shared bytes, threads of its one block,
// blocks an SM could hold}.
extern "C" int esvo_track_kernel_info(int* info) {
  cudaFuncAttributes attr;
  cudaError_t err =
      cudaFuncGetAttributes(&attr, (const void*)track_solve_kernel);
  if (err != cudaSuccess) return (int)err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, (const void*)track_solve_kernel, TRACK_THREADS, 0);
  if (err != cudaSuccess) return (int)err;
  info[0] = attr.numRegs;
  info[1] = (int)attr.localSizeBytes;
  info[2] = (int)attr.sharedSizeBytes;
  info[3] = TRACK_THREADS;
  info[4] = blocks;
  return (int)cudaSuccess;
}
