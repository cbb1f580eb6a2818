// K6: block matching's disparity scan in one launch.
//
// Replaces the fused XLA program of esvo_tpu/mapping/block_matching.py:
// _match_horizontal (:151; its lax.scan over disparities at :239), from
// the dense box sums to the argmin. Not a Pallas kernel. It computes what
// mapping/block_matching.py::best_disparity_plain computes with the
// "slice" volume, for each event pixel (ui, vi) (already clamped to the
// image) and each disparity d in [dmin, dmax]:
// - S_lr, the (2hy+1) x (2hx+1) box of L[y, c] * R[y, c - d], and S_r,
//   S_r2, the boxes of R and R * R at column ui - d; S_l, S_l2 and the
//   count of L < 1 (dark) at the event, all with zeros outside the image;
// - m = S / area, sigma = sqrt(max(S2 / area - m * m, 0)) + 1e-6,
//   ncc = (S_lr / area - m_l * m_r) / (sigma_l * sigma_r) and the cost
//   0.5 * (1 - ncc); 1.0 where (ui - d - hx < 1) | (ui - d + hx >= W - 1);
// - the argmin over the disparities in torch.argmin's order (a NaN wins,
//   the first one; otherwise the lowest index of the minimum), its cost,
//   and dark.
//
// What bounds it on the card: operations. An unmasked (event, disparity)
// pair costs ~2 * wy * wx + 2 * wx + 16 float32 operations (240 at the
// 7x15 patch); the bytes are the event's window and strip, which the
// surfaces' reuse across events keeps in L2.
//
// Design (what each element does about the limits):
// - One block an event. It stages the event's (wy, wx) left window and
//   its (wy, wx + D - 1) right strip (columns ui - dmax - hx to
//   ui - dmin + hx) in shared memory once, zeros outside the image
//   (4.6 KB of strip at the DSEC preset's D = 151).
// - The column sums of R and R * R are the same for every disparity: one
//   thread a strip column computes them once. The left window's column
//   sums likewise, then one thread adds S_l, S_l2 and dark.
// - One thread a disparity (a loop when D exceeds the block): the
//   products' column sums, then the row of them; consecutive threads
//   read consecutive strip words, so no bank conflicts. A masked
//   disparity costs nothing: its cost is 1.0 whatever the sums are.
// - A warp-shuffle argmin, then one across the block's warps, both with
//   torch's comparison.
// - Bit for bit the plain twin on the card: each operation is the one the
//   twin's eager kernels run, in the twin's order (_box adds each column
//   from the top row down starting from 0, then the columns left to
//   right starting from 0), as an explicit round-to-nearest intrinsic,
//   which nvcc never contracts into an FMA. A division by the patch area
//   is a product with the float32 reciprocal of the area, as PyTorch's
//   CUDA division by a Python scalar computes it; a column outside the
//   image adds the twin's zero pad, not a product.
#include <cuda_runtime.h>
#include <stdint.h>
#include <limits.h>

#define BM_MAX_THREADS 256

struct BmParams {
  const float* L;        // (H, W) left surface
  const float* R;        // (H, W) right surface
  const int64_t* ui;     // (N,) event column, in [0, W)
  const int64_t* vi;     // (N,) event row, in [0, H)
  int64_t* best;         // (N,) argmin index into [dmin, dmax]
  float* best_cost;      // (N,)
  float* dark;           // (N,) box of (L < 1) at the event
  int H, W, dmin, dmax, hy, hx;
  float inv_area;        // float32(1 / ((2hy+1) * (2hx+1)))
};

// torch.clamp(x, min=0): a NaN stays NaN
__device__ __forceinline__ float clamp0(float x) { return x < 0.0f ? 0.0f : x; }

// torch.argmin's order (LessOrNan): a NaN comes first, the first NaN
// before later ones; otherwise the smaller value, the lower index on a tie
__device__ __forceinline__ bool before(float a, int ia, float b, int ib) {
  if (a != a) return (b != b) ? ia < ib : true;
  if (b != b) return false;
  return a == b ? ia < ib : a < b;
}

// m and sigma of a box sum pair, in _match_horizontal's order
__device__ __forceinline__ void moments(float S, float S2, float inv,
                                        float* m, float* sigma) {
  const float mm = __fmul_rn(S, inv);
  *m = mm;
  *sigma = __fadd_rn(
      __fsqrt_rn(clamp0(__fsub_rn(__fmul_rn(S2, inv), __fmul_rn(mm, mm)))),
      1e-6f);
}

__global__ void __launch_bounds__(BM_MAX_THREADS)
    block_match_kernel(const BmParams p) {
  extern __shared__ float smem[];
  const int wx = 2 * p.hx + 1, wy = 2 * p.hy + 1;
  const int D = p.dmax - p.dmin + 1;
  const int SW = wx + D - 1;
  float* s_l = smem;               // (wy, wx) left window
  float* s_r = s_l + wy * wx;      // (wy, SW) right strip
  float* s_vr = s_r + wy * SW;     // (SW,) column sums of R
  float* s_vr2 = s_vr + SW;        // (SW,) column sums of R * R
  float* s_vl = s_vr2 + SW;        // (wx,) column sums of L
  float* s_vl2 = s_vl + wx;        // (wx,) of L * L
  float* s_vdk = s_vl2 + wx;       // (wx,) of (L < 1)
  float* s_stat = s_vdk + wx;      // m_l, sigma_l
  float* s_wc = s_stat + 2;        // a warp's best cost (32)
  int* s_wi = reinterpret_cast<int*>(s_wc + 32);   // and its index (32)

  const int n = blockIdx.x;
  const int u = (int)p.ui[n], v = (int)p.vi[n];
  const int x0 = u - p.hx, y0 = v - p.hy;
  const int j0 = u - p.dmax - p.hx;   // image column of strip column 0
  for (int i = threadIdx.x; i < wy * wx; i += blockDim.x) {
    const int y = y0 + i / wx, x = x0 + i % wx;
    s_l[i] = (y >= 0 && y < p.H && x >= 0 && x < p.W)
                 ? __ldg(p.L + (size_t)y * p.W + x) : 0.0f;
  }
  for (int i = threadIdx.x; i < wy * SW; i += blockDim.x) {
    const int y = y0 + i / SW, x = j0 + i % SW;
    s_r[i] = (y >= 0 && y < p.H && x >= 0 && x < p.W)
                 ? __ldg(p.R + (size_t)y * p.W + x) : 0.0f;
  }
  __syncthreads();
  // _box's vertical pass: each column from the top row down, from 0
  for (int c = threadIdx.x; c < SW; c += blockDim.x) {
    float s = 0.0f, s2 = 0.0f;
    for (int r = 0; r < wy; ++r) {
      const float a = s_r[r * SW + c];
      s = __fadd_rn(s, a);
      s2 = __fadd_rn(s2, __fmul_rn(a, a));
    }
    s_vr[c] = s;
    s_vr2[c] = s2;
  }
  for (int c = threadIdx.x; c < wx; c += blockDim.x) {
    float s = 0.0f, s2 = 0.0f, dk = 0.0f;
    const int x = x0 + c;
    for (int r = 0; r < wy; ++r) {
      const int y = y0 + r;
      const float a = s_l[r * wx + c];
      s = __fadd_rn(s, a);
      s2 = __fadd_rn(s2, __fmul_rn(a, a));
      // (L < 1) is padded with 0 outside the image, not computed on 0
      const bool in = y >= 0 && y < p.H && x >= 0 && x < p.W;
      dk = __fadd_rn(dk, (in && a < 1.0f) ? 1.0f : 0.0f);
    }
    s_vl[c] = s;
    s_vl2[c] = s2;
    s_vdk[c] = dk;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    // _box's horizontal pass: the column sums left to right, from 0
    float S = 0.0f, S2 = 0.0f, dk = 0.0f;
    for (int c = 0; c < wx; ++c) {
      S = __fadd_rn(S, s_vl[c]);
      S2 = __fadd_rn(S2, s_vl2[c]);
      dk = __fadd_rn(dk, s_vdk[c]);
    }
    moments(S, S2, p.inv_area, &s_stat[0], &s_stat[1]);
    p.dark[n] = dk;
  }
  __syncthreads();
  const float m_l = s_stat[0], sigma_l = s_stat[1];

  float bc = __int_as_float(0x7f800000);   // +inf with the largest index:
  int bi = INT_MAX;                        // every real entry comes first
  for (int k = threadIdx.x; k < D; k += blockDim.x) {
    const int d = p.dmin + k;
    float cost = 1.0f;
    if (u - d - p.hx >= 1 && u - d + p.hx < p.W - 1) {
      const int j = p.dmax - d;   // strip column of image column u - d - hx
      float Sr = 0.0f, Sr2 = 0.0f, Slr = 0.0f;
      for (int dx = 0; dx < wx; ++dx) {
        Sr = __fadd_rn(Sr, s_vr[j + dx]);
        Sr2 = __fadd_rn(Sr2, s_vr2[j + dx]);
      }
      for (int dx = 0; dx < wx; ++dx) {
        float col = 0.0f;
        const int x = x0 + dx;
        if (x >= 0 && x < p.W) {
          for (int dy = 0; dy < wy; ++dy)
            col = __fadd_rn(col, __fmul_rn(s_l[dy * wx + dx],
                                           s_r[dy * SW + j + dx]));
        }
        Slr = __fadd_rn(Slr, col);
      }
      float m_r, sigma_r;
      moments(Sr, Sr2, p.inv_area, &m_r, &sigma_r);
      const float ncc = __fdiv_rn(
          __fsub_rn(__fmul_rn(Slr, p.inv_area), __fmul_rn(m_l, m_r)),
          __fmul_rn(sigma_l, sigma_r));
      cost = __fmul_rn(0.5f, __fsub_rn(1.0f, ncc));
    }
    if (before(cost, k, bc, bi)) {
      bc = cost;
      bi = k;
    }
  }
  for (int off = 16; off > 0; off >>= 1) {
    const float oc = __shfl_down_sync(0xffffffffu, bc, off);
    const int oi = __shfl_down_sync(0xffffffffu, bi, off);
    if (before(oc, oi, bc, bi)) {
      bc = oc;
      bi = oi;
    }
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n_warps = (blockDim.x + 31) >> 5;
  if (lane == 0) {
    s_wc[warp] = bc;
    s_wi[warp] = bi;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < n_warps; ++w) {
      if (before(s_wc[w], s_wi[w], bc, bi)) {
        bc = s_wc[w];
        bi = s_wi[w];
      }
    }
    p.best[n] = bi;
    p.best_cost[n] = bc;
  }
}

static size_t smem_floats(int wy, int wx, int D) {
  const size_t SW = (size_t)wx + D - 1;
  return (size_t)wy * wx + (size_t)wy * SW + 2 * SW + 3 * (size_t)wx + 2 +
         64;
}

extern "C" int esvo_block_match(const void* L, const void* R, const void* ui,
                                const void* vi, void* best, void* best_cost,
                                void* dark, int H, int W, int N, int dmin,
                                int dmax, int hy, int hx, void* stream) {
  if (H < 1 || W < 1 || N < 0 || dmin < 0 || dmax < dmin || hy < 0 ||
      hx < 0)
    return (int)cudaErrorInvalidValue;
  if (N == 0) return (int)cudaSuccess;
  BmParams p;
  p.L = (const float*)L;
  p.R = (const float*)R;
  p.ui = (const int64_t*)ui;
  p.vi = (const int64_t*)vi;
  p.best = (int64_t*)best;
  p.best_cost = (float*)best_cost;
  p.dark = (float*)dark;
  p.H = H;
  p.W = W;
  p.dmin = dmin;
  p.dmax = dmax;
  p.hy = hy;
  p.hx = hx;
  const int area = (2 * hy + 1) * (2 * hx + 1);
  p.inv_area = 1.0f / (float)area;   // IEEE float division on the host
  const int D = dmax - dmin + 1;
  int threads = ((D + 31) / 32) * 32;
  if (threads > BM_MAX_THREADS) threads = BM_MAX_THREADS;
  const size_t smem = smem_floats(2 * hy + 1, 2 * hx + 1, D) * sizeof(float);
  // within the 48 KB a block takes without the opt-in attribute (the
  // wrapper refuses a wider strip), so nothing is set before a capture
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  void* args[] = {(void*)&p};
  cudaError_t err = cudaLaunchKernel((const void*)block_match_kernel,
                                     dim3(N), dim3(threads), args, smem,
                                     (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
