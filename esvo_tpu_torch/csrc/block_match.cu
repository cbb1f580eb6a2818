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
// pair costs ~2 * wy * wx + 3 * wx + 14 float32 operations (269 at the
// 7x15 patch), none of which may be fused into an FMA (below); the bytes
// are the event's window and strip, which the surfaces' reuse across
// events keeps in L2. With one shared load a product, as a thread a
// disparity reads it, the shared-memory pipe (one warp-wide load an SM a
// clock) would take longer than the arithmetic.
//
// Design (what each element does about the limits):
// - One warp an event, up to 4 events a block (the launch plan,
//   ops/block_match.py::launch_plan). The warp stages the event's (wy, wx)
//   left window and its (wy, wx + D - 1) right strip (columns
//   ui - dmax - hx to ui - dmin + hx), zeros outside the image, in its own
//   slice of shared memory: a lane a column, the rows in a loop
//   (unrolled where the patch is a template argument), so no index is
//   divided. While it stages a column it adds the column's sums of R and
//   R * R (the same for every disparity), and of L, L * L and (L < 1)
//   for the window. Only __syncwarp: no block barrier.
// - Templated on the patch (block_match_kernel<WY, WX, T>: 7x15, both
//   presets, and 15x7, up_down's swapped patch), so every loop over the
//   window unrolls: the left window is read once into WY * WX registers
//   (as float4), and every index into it is a constant.
// - A lane owns T consecutive disparities (T = ceil(D / 32) within 2..5:
//   2 at D = 40, 5 at D = 151; more disparities take more passes). The T
//   windows of a lane overlap in all but T - 1 strip columns, so the lane
//   walks the T + WX - 1 columns once: each column's WY words and two
//   column sums are read from shared memory once and serve up to T
//   products, 34 shared loads a pair at 7x15 and T = 5 instead of 240.
//   S_lr, S_r and S_r2 of the T disparities stay in registers, added in
//   the twin's column order; the T chains are independent. A window
//   column outside the image is a select, not a branch, so the unrolled
//   walk stays one basic block the compiler can interleave.
// - 168 registers a thread (BM_MIN_BLOCKS), so three blocks, 12 warps,
//   share an SM; the window's 105 registers are what sets that. (Copying
//   the next event's words in with cp.async while a warp scans, and a
//   walk over window columns outermost, both ran slower on the H100.)
// - Any other patch runs block_match_kernel<0, 0, 1>: the same staging,
//   one disparity a lane a pass, the window read from shared memory.
// - The argmin: over the lane's disparities in index order, then across
//   the warp by shuffles, all with torch's comparison (a total order of
//   (cost, index), so any reduction order gives the same winner).
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

#define BM_MAX_WARPS 4
#define BM_T_MIN 2
#define BM_T_MAX 5
// blocks an SM must hold: caps a thread at 168 registers, so three
// blocks of four warps fit (the 7x15 kernels take 168-192 without it)
#define BM_MIN_BLOCKS 3

struct BmParams {
  const float* L;        // (H, W) left surface
  const float* R;        // (H, W) right surface
  const int64_t* ui;     // (N,) event column, in [0, W)
  const int64_t* vi;     // (N,) event row, in [0, H)
  int64_t* best;         // (N,) argmin index into [dmin, dmax]
  float* best_cost;      // (N,)
  float* dark;           // (N,) box of (L < 1) at the event
  int H, W, N, dmin, dmax, hy, hx;
  int warp_floats;       // shared floats an event (a warp) stages
  float inv_area;        // float32(1 / ((2hy+1) * (2hx+1)))
};

// A warp's shared slice, in floats (ops/block_match.py::shared_bytes
// mirrors it): the left window row-major, padded to whole float4s; the
// window's column sums of L, L * L and (L < 1); the strip's column sums
// of R and R * R; the strip row-major. Rounded up to whole float4s, so
// every warp's window starts 16-byte aligned.
static __host__ __device__ __forceinline__ int bm_warp_floats(int wy, int wx,
                                                              int D) {
  const int SW = wx + D - 1;
  const int n = ((wy * wx + 3) & ~3) + 3 * wx + 2 * SW + wy * SW;
  return (n + 3) & ~3;
}

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

// the cost of disparity d from its three box sums (1.0 where it leaves
// the image)
__device__ __forceinline__ float zncc_cost(const BmParams& p, int u, int hx,
                                           int d, float Slr, float Sr,
                                           float Sr2, float m_l,
                                           float sigma_l) {
  if (!(u - d - hx >= 1 && u - d + hx < p.W - 1)) return 1.0f;
  float m_r, sigma_r;
  moments(Sr, Sr2, p.inv_area, &m_r, &sigma_r);
  const float ncc = __fdiv_rn(
      __fsub_rn(__fmul_rn(Slr, p.inv_area), __fmul_rn(m_l, m_r)),
      __fmul_rn(sigma_l, sigma_r));
  return __fmul_rn(0.5f, __fsub_rn(1.0f, ncc));
}

template <int WY, int WX, int T>
__global__ void __launch_bounds__(32 * BM_MAX_WARPS, BM_MIN_BLOCKS)
    block_match_kernel(const BmParams p) {
  extern __shared__ float4 bm_smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n = blockIdx.x * (blockDim.x >> 5) + warp;
  if (n >= p.N) return;   // a whole warp: no block barrier follows
  const int wy = WY > 0 ? WY : 2 * p.hy + 1;
  const int wx = WX > 0 ? WX : 2 * p.hx + 1;
  const int hy = (wy - 1) / 2, hx = (wx - 1) / 2;
  const int D = p.dmax - p.dmin + 1;
  const int SW = wx + D - 1;
  float* s_l = reinterpret_cast<float*>(bm_smem) + (size_t)warp * p.warp_floats;
  float* s_vl = s_l + ((wy * wx + 3) & ~3);
  float* s_vl2 = s_vl + wx;
  float* s_vdk = s_vl2 + wx;
  float* s_vr = s_vdk + wx;
  float* s_vr2 = s_vr + SW;
  float* s_r = s_vr2 + SW;

  const int u = (int)p.ui[n], v = (int)p.vi[n];
  const int x0 = u - hx, y0 = v - hy;
  const int j0 = u - p.dmax - hx;   // image column of strip column 0
  // the left window, a lane a column: its sums from the top row down
  for (int c = lane; c < wx; c += 32) {
    const int x = x0 + c;
    const bool in_x = x >= 0 && x < p.W;
    float s = 0.0f, s2 = 0.0f, dk = 0.0f;
#pragma unroll
    for (int r = 0; r < wy; ++r) {
      const int y = y0 + r;
      const bool in = in_x && y >= 0 && y < p.H;
      const float a = in ? __ldg(p.L + (size_t)y * p.W + x) : 0.0f;
      s_l[r * wx + c] = a;
      s = __fadd_rn(s, a);
      s2 = __fadd_rn(s2, __fmul_rn(a, a));
      // (L < 1) is padded with 0 outside the image, not computed on 0
      dk = __fadd_rn(dk, (in && a < 1.0f) ? 1.0f : 0.0f);
    }
    s_vl[c] = s;
    s_vl2[c] = s2;
    s_vdk[c] = dk;
  }
  // the right strip, a lane a column (consecutive lanes, consecutive
  // words of a row): the column sums of R and R * R on the way
  for (int c = lane; c < SW; c += 32) {
    const int x = j0 + c;
    const bool in_x = x >= 0 && x < p.W;
    float s = 0.0f, s2 = 0.0f;
#pragma unroll
    for (int r = 0; r < wy; ++r) {
      const int y = y0 + r;
      const float a = (in_x && y >= 0 && y < p.H)
                          ? __ldg(p.R + (size_t)y * p.W + x) : 0.0f;
      s_r[r * SW + c] = a;
      s = __fadd_rn(s, a);
      s2 = __fadd_rn(s2, __fmul_rn(a, a));
    }
    s_vr[c] = s;
    s_vr2[c] = s2;
  }
  __syncwarp();
  // _box's horizontal pass at the event: the column sums left to right
  float S = 0.0f, S2 = 0.0f, dk = 0.0f;
  for (int c = 0; c < wx; ++c) {
    S = __fadd_rn(S, s_vl[c]);
    S2 = __fadd_rn(S2, s_vl2[c]);
    dk = __fadd_rn(dk, s_vdk[c]);
  }
  float m_l, sigma_l;
  moments(S, S2, p.inv_area, &m_l, &sigma_l);
  if (lane == 0) p.dark[n] = dk;

  float bc = __int_as_float(0x7f800000);   // +inf with the largest index:
  int bi = INT_MAX;                        // every real entry comes first
  if constexpr (WX > 0) {
    // the window in registers; bit dx of xin: column x0 + dx is inside
    float lw[((WY * WX + 3) / 4) * 4];
#pragma unroll
    for (int i = 0; i < (WY * WX + 3) / 4; ++i) {
      const float4 q = reinterpret_cast<const float4*>(s_l)[i];
      lw[4 * i] = q.x;
      lw[4 * i + 1] = q.y;
      lw[4 * i + 2] = q.z;
      lw[4 * i + 3] = q.w;
    }
    unsigned xin = 0u;
#pragma unroll
    for (int dx = 0; dx < WX; ++dx)
      xin |= (x0 + dx >= 0 && x0 + dx < p.W) ? (1u << dx) : 0u;
    for (int k0 = lane * T; k0 < D; k0 += 32 * T) {
      // disparity index k0 + t reads strip columns D-1-k0-t .. +WX-1:
      // column jb + cr serves t where dx = cr - (T - 1 - t) is in [0, WX)
      const int jb = D - T - k0;
      float slr[T], sr[T], sr2[T];
#pragma unroll
      for (int t = 0; t < T; ++t) slr[t] = sr[t] = sr2[t] = 0.0f;
#pragma unroll
      for (int cr = 0; cr < T + WX - 1; ++cr) {
        // a column left of the strip serves only indices >= D (ignored)
        const int c = min(max(jb + cr, 0), SW - 1);
        float rv[WY];
#pragma unroll
        for (int dy = 0; dy < WY; ++dy) rv[dy] = s_r[dy * SW + c];
        const float vr = s_vr[c], vr2 = s_vr2[c];
#pragma unroll
        for (int t = 0; t < T; ++t) {
          const int dx = cr - (T - 1 - t);
          if (dx < 0 || dx >= WX) continue;
          sr[t] = __fadd_rn(sr[t], vr);
          sr2[t] = __fadd_rn(sr2[t], vr2);
          float col = 0.0f;
#pragma unroll
          for (int dy = 0; dy < WY; ++dy)
            col = __fadd_rn(col, __fmul_rn(lw[dy * WX + dx], rv[dy]));
          // a window column outside the image adds the twin's zero pad:
          // a select, not a branch, so the unrolled body stays one block
          slr[t] = __fadd_rn(slr[t], (xin & (1u << dx)) ? col : 0.0f);
        }
      }
#pragma unroll
      for (int t = 0; t < T; ++t) {
        const int k = k0 + t;
        if (k >= D) break;
        const float cost = zncc_cost(p, u, hx, p.dmin + k, slr[t], sr[t],
                                     sr2[t], m_l, sigma_l);
        if (before(cost, k, bc, bi)) {
          bc = cost;
          bi = k;
        }
      }
    }
  } else {
    for (int k = lane; k < D; k += 32) {
      const int j = D - 1 - k;   // strip column of image column u - d - hx
      float Sr = 0.0f, Sr2 = 0.0f, Slr = 0.0f;
      for (int dx = 0; dx < wx; ++dx) {
        Sr = __fadd_rn(Sr, s_vr[j + dx]);
        Sr2 = __fadd_rn(Sr2, s_vr2[j + dx]);
        float col = 0.0f;
        const int x = x0 + dx;
        if (x >= 0 && x < p.W) {
          for (int dy = 0; dy < wy; ++dy)
            col = __fadd_rn(col, __fmul_rn(s_l[dy * wx + dx],
                                           s_r[dy * SW + j + dx]));
        }
        Slr = __fadd_rn(Slr, col);
      }
      const float cost = zncc_cost(p, u, hx, p.dmin + k, Slr, Sr, Sr2, m_l,
                                   sigma_l);
      if (before(cost, k, bc, bi)) {
        bc = cost;
        bi = k;
      }
    }
  }
  for (int off = 16; off > 0; off >>= 1) {
    const float oc = __shfl_xor_sync(0xffffffffu, bc, off);
    const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
    if (before(oc, oi, bc, bi)) {
      bc = oc;
      bi = oi;
    }
  }
  if (lane == 0) {
    p.best[n] = bi;
    p.best_cost[n] = bc;
  }
}

typedef void (*BmKernel)(const BmParams);

// the instantiation for a (wy, wx) patch and T disparities a lane, as
// ops/block_match.py::launch_plan picks it: 7x15 and 15x7 with T in
// BM_T_MIN..BM_T_MAX, any other patch with T = 1; nullptr otherwise
static BmKernel kernel_for(int wy, int wx, int T) {
#define BM_CASES(Y, X)                                   \
  if (wy == Y && wx == X) {                              \
    switch (T) {                                         \
      case 2: return block_match_kernel<Y, X, 2>;        \
      case 3: return block_match_kernel<Y, X, 3>;        \
      case 4: return block_match_kernel<Y, X, 4>;        \
      case 5: return block_match_kernel<Y, X, 5>;        \
      default: return nullptr;                           \
    }                                                    \
  }
  BM_CASES(7, 15)
  BM_CASES(15, 7)
#undef BM_CASES
  return T == 1 ? block_match_kernel<0, 0, 1> : nullptr;
}

extern "C" int esvo_block_match(const void* L, const void* R, const void* ui,
                                const void* vi, void* best, void* best_cost,
                                void* dark, int H, int W, int N, int dmin,
                                int dmax, int hy, int hx, int T, int warps,
                                void* stream) {
  if (H < 1 || W < 1 || N < 0 || dmin < 0 || dmax < dmin || hy < 0 ||
      hx < 0 || warps < 1 || warps > BM_MAX_WARPS)
    return (int)cudaErrorInvalidValue;
  if (N == 0) return (int)cudaSuccess;
  const int wy = 2 * hy + 1, wx = 2 * hx + 1;
  const BmKernel fn = kernel_for(wy, wx, T);
  if (fn == nullptr) return (int)cudaErrorInvalidValue;
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
  p.N = N;
  p.dmin = dmin;
  p.dmax = dmax;
  p.hy = hy;
  p.hx = hx;
  p.warp_floats = bm_warp_floats(wy, wx, dmax - dmin + 1);
  p.inv_area = 1.0f / (float)(wy * wx);   // IEEE float division on the host
  const size_t smem = (size_t)warps * p.warp_floats * sizeof(float);
  // within the 48 KB a block takes without the opt-in attribute (the
  // wrapper refuses a wider strip), so nothing is set before a capture
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  void* args[] = {(void*)&p};
  cudaError_t err = cudaLaunchKernel((const void*)fn, dim3((N + warps - 1) / warps),
                         dim3(32 * warps), args, smem, (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// info: blocks an SM holds (occupancy calculator), registers and local
// (spill) bytes a thread (CUDA runtime), for the plan's instantiation
extern "C" int esvo_block_match_kernel_info(int wy, int wx, int T, int warps,
                                            int n_disp, int* info) {
  const BmKernel fn = kernel_for(wy, wx, T);
  if (fn == nullptr) return (int)cudaErrorInvalidValue;
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, (const void*)fn);
  if (err != cudaSuccess) return (int)err;
  const size_t smem =
      (size_t)warps * bm_warp_floats(wy, wx, n_disp) * sizeof(float);
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, (const void*)fn,
                                                      32 * warps, smem);
  if (err != cudaSuccess) return (int)err;
  info[0] = blocks;
  info[1] = attr.numRegs;
  info[2] = (int)attr.localSizeBytes;
  info[3] = (int)smem;
  return (int)cudaSuccess;
}
