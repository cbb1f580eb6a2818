// K5: inverse-depth map regularization in one launch.
//
// Replaces the fused XLA scan of esvo_tpu/mapping/regularization.py:
// regularize (:56, its lax.scan over the window offsets at :118), not a
// Pallas kernel. It computes what mapping/regularization.py::
// regularize_plain computes for each valid centre: over the (2r+1)^2
// window offsets in window row-major order (the Student-t fold depends on
// the order), with the padded fills outside the image (valid false,
// invD 0, var 1, scale2 1, nu 1),
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
// offsets a centre, against five (H, W) planes read once.
//
// Design (what each element does about the limits):
// - A block is a 32x16 tile of pixels (256 threads, 8 warps). Its
//   threads first copy the input of the tile's pixels that are not valid
//   to the output; a tile with no valid centre then stops, before it
//   stages anything (__syncthreads_or).
// - Otherwise the block stages the tile and its r-pixel halo once in
//   shared memory (four pixels a thread at a time, every load of the four
//   issued before the first is used), with the padded fills where the
//   halo leaves the image:
//   (invD, 2 sigma) as one float2 a pixel, the invD of a pixel that is not
//   valid replaced by NaN, so that the close test alone rejects it; the
//   fold's terms as a second float2 (Tdist: scale2, nu; l2: the weight
//   1 / max(var, 1e-20)); a byte of flags (valid, invD not finite). The
//   float2 rows have an odd pitch, so that centres on different rows
//   spread over the banks.
// - n_count and "some invD in the window is not finite" are box sums of
//   the flag bytes: the block adds each staged column over the 2r+1 rows
//   a tile row needs (a sliding sum), and a centre adds 2r+1 of those
//   column sums. The walk then counts nothing.
// - Every lane gets a valid centre: the tile's valid centres are listed
//   in row-major order (a ballot a tile row), and warp w takes list
//   entries w*32 + lane, + 256, ... A warp's lanes hold neighbouring
//   centres, whose windows overlap.
// - The walk goes over a window row in chunks of 64 offsets (a whole row
//   up to r = 31): each lane builds a 64-bit mask of its close offsets
//   (one shared float2 load, a subtraction and two comparisons an
//   offset), adds its popcount to close_count, then folds the set bits in
//   order (__ffsll, m &= m - 1). A warp pays for the largest of its
//   lanes' close sets in a chunk, not for their union.
// - The l2 sums of the twin add w * d with w = 0 at every offset that is
//   not close. 0 * d is +-0 for a finite d, which leaves both sums as
//   they are (neither is ever -0), and NaN for a d that is not finite
//   (such a neighbour is never close). So the fold adds the close
//   neighbours only, and a centre whose window holds a non-finite invD
//   adds a NaN to its weighted sum at the end, as the twin's walk does.
//   Tdist never touches a neighbour that is not close.
// - Bit for bit the plain twin on the card: each operation is the one the
//   twin's eager kernels run, in the twin's order, as an explicit
//   round-to-nearest intrinsic (__fadd_rn, __fmul_rn, __fdiv_rn,
//   __fsqrt_rn), which nvcc never contracts into an FMA; clamps keep a
//   NaN as torch.clamp does. The discrete gates then flip no pixel.
//   Which warp takes a centre does not change its arithmetic.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define REG_TY 16
#define REG_STAGE 4  // halo pixels a thread loads at once
#define REG_TX 32  // one warp a tile row (the list's ballot)
#define REG_THREADS 256
#define REG_WARPS (REG_THREADS / 32)
#define REG_TILE (REG_TX * REG_TY)
#define REG_EMPTY -1.0f
#define FULL 0xffffffffu

struct RegParams {
  const uint8_t* valid;  // (H, W)
  const float* invD;     // (H, W)
  const float* var;      // (H, W)
  const float* scale2;   // (H, W)
  const float* nu;       // (H, W)
  float* out;            // (H, W)
  int H, W, r, min_neighbours, min_close_neighbours;
  float var_floor;       // 1e-20 as float32 (the l2 weight's clamp)
  float inf;             // +inf, read at run time (0 * inf is the card's NaN)
};

// The shared-memory layout of a block for radius r (host and device).
struct RegLayout {
  int SW, SH, SP;  // staged width and height; float2 row pitch (odd)
  size_t q, f, flags, cols, list, rows, bytes;  // byte offsets, total
};

__host__ __device__ inline RegLayout reg_layout(int r) {
  RegLayout L;
  L.SW = REG_TX + 2 * r;
  L.SH = REG_TY + 2 * r;
  L.SP = L.SW | 1;
  const size_t plane = (size_t)L.SH * L.SP * 8;
  L.q = 0;
  L.f = plane;
  L.flags = 2 * plane;
  L.cols = (L.flags + (size_t)L.SH * L.SW + 3) & ~(size_t)3;
  L.list = L.cols + (size_t)REG_TY * L.SW * 4;
  L.rows = L.list + (size_t)REG_TILE * 2;
  L.bytes = L.rows + (size_t)REG_TY * 4;
  return L;
}

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

// The close offsets among n (<= 64) consecutive ones of a window row, as
// a bit mask (bit k: offset k): the neighbour is valid (its staged invD
// is not NaN) and within 2 sigma of the centre or of itself.
__device__ __forceinline__ bool is_close(float2 nb, float invD, float sig) {
  const float diff = fabsf(__fsub_rn(invD, nb.x));
  return (diff < sig) || (diff < nb.y);
}

__device__ __forceinline__ unsigned long long close_mask(const float2* q,
                                                         int n, float invD,
                                                         float sig) {
  unsigned lo = 0, hi = 0;
  if (n >= 32) {
#pragma unroll
    for (int k = 0; k < 32; ++k)
      if (is_close(q[k], invD, sig)) lo |= 1u << k;
#pragma unroll 4
    for (int k = 32; k < n; ++k)
      if (is_close(q[k], invD, sig)) hi |= 1u << (k - 32);
  } else {
#pragma unroll 4
    for (int k = 0; k < n; ++k)
      if (is_close(q[k], invD, sig)) lo |= 1u << k;
  }
  return (unsigned long long)hi << 32 | lo;
}

template <bool TDIST>
struct Fold {
  // l2
  float wsum = 0.0f, wmean = 0.0f;
  // Tdist
  bool started = false;
  float t_invD = 0.0f, t_s2 = 1.0f, t_nu = 0.0f;

  __device__ __forceinline__ void add(float d, float2 f) {
    if (!TDIST) {
      wsum = __fadd_rn(wsum, f.x);
      wmean = __fadd_rn(wmean, __fmul_rn(f.x, d));
      return;
    }
    const float s2 = f.x, nu = f.y;
    if (!started) {
      t_invD = d;
      t_s2 = s2;
      t_nu = nu;
      started = true;
      return;
    }
    const float nu_u = nan_min(t_nu, nu);
    const float s_sum = __fadd_rn(t_s2, s2);
    const float f_invD = __fdiv_rn(
        __fadd_rn(__fmul_rn(s2, t_invD), __fmul_rn(t_s2, d)), s_sum);
    const float e = __fsub_rn(t_invD, d);
    const float d2 = __fmul_rn(e, e);
    const float gauss = __fdiv_rn(__fmul_rn(t_s2, s2), s_sum);
    float f_s2 = gauss;
    if (isfinite(nu_u)) {
      f_s2 = __fmul_rn(__fdiv_rn(__fadd_rn(nu_u, __fdiv_rn(d2, s_sum)),
                                 __fadd_rn(nu_u, 1.0f)),
                       gauss);
    }
    t_invD = f_invD;
    t_s2 = f_s2;
    t_nu = nu_u;
  }
};

template <bool TDIST>
__global__ void __launch_bounds__(REG_THREADS)
    regularize_kernel(const RegParams p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int r = p.r, RW = 2 * r + 1;
  const RegLayout L = reg_layout(r);
  const int SW = L.SW, SH = L.SH, SP = L.SP;
  float2* s_q = reinterpret_cast<float2*>(smem + L.q);   // invD', 2 sigma
  float2* s_f = reinterpret_cast<float2*>(smem + L.f);   // fold terms
  uint8_t* s_flags = smem + L.flags;  // bit 0 valid, bit 1 invD not finite
  int* s_cols = reinterpret_cast<int*>(smem + L.cols);
  uint16_t* s_list = reinterpret_cast<uint16_t*>(smem + L.list);
  int* s_rows = reinterpret_cast<int*>(smem + L.rows);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tx0 = blockIdx.x * REG_TX, ty0 = blockIdx.y * REG_TY;

  // the tile's pixels that are not valid keep their input
  int any = 0;
  for (int i = tid; i < REG_TILE; i += REG_THREADS) {
    const int x = tx0 + i % REG_TX, y = ty0 + i / REG_TX;
    if (x < p.W && y < p.H) {
      const size_t g = (size_t)y * p.W + x;
      if (__ldg(p.valid + g))
        any = 1;
      else
        p.out[g] = __ldg(p.invD + g);
    }
  }
  if (!__syncthreads_or(any)) return;

  // stage the tile and its halo, REG_STAGE pixels a thread at a time with
  // every load of the batch issued before the first is used
  const float qnan = __int_as_float(0x7fffffff);
  const int x0 = tx0 - r, y0 = ty0 - r;
  for (int i0 = tid; i0 < SW * SH; i0 += REG_STAGE * REG_THREADS) {
    bool in[REG_STAGE], v[REG_STAGE];
    float d[REG_STAGE], var[REG_STAGE], s2[REG_STAGE], nu[REG_STAGE];
#pragma unroll
    for (int k = 0; k < REG_STAGE; ++k) {
      const int i = i0 + k * REG_THREADS;
      const int yy = i / SW, gy = y0 + yy, gx = x0 + i - yy * SW;
      in[k] = i < SW * SH && gy >= 0 && gy < p.H && gx >= 0 && gx < p.W;
      const size_t g = in[k] ? (size_t)gy * p.W + gx : 0;
      v[k] = in[k] && __ldg(p.valid + g) != 0;
      d[k] = __ldg(p.invD + g);
      var[k] = __ldg(p.var + g);
      if (TDIST) {
        s2[k] = __ldg(p.scale2 + g);
        nu[k] = __ldg(p.nu + g);
      }
    }
#pragma unroll
    for (int k = 0; k < REG_STAGE; ++k) {
      const int i = i0 + k * REG_THREADS;
      if (i >= SW * SH) break;
      const int yy = i / SW, xx = i - yy * SW;
      float2 q, f;
      uint8_t flags = 0;
      if (in[k]) {
        q = make_float2(v[k] ? d[k] : qnan, two_sigma(var[k]));
        if (TDIST)
          f = make_float2(s2[k], nu[k]);
        else
          f = make_float2(__fdiv_rn(1.0f, clamp_min(var[k], p.var_floor)),
                          0.0f);
        flags = (uint8_t)(v[k] | (isfinite(d[k]) ? 0 : 2));
      } else {  // the twin's padding: valid false, invD 0 (finite)
        q = make_float2(qnan, two_sigma(1.0f));
        f = make_float2(1.0f, 1.0f);
      }
      s_q[yy * SP + xx] = q;
      s_f[yy * SP + xx] = f;
      s_flags[yy * SW + xx] = flags;
    }
  }
  __syncthreads();

  // the tile's valid centres, counted a row; the flags' column sums over
  // the 2r+1 rows of each tile row, packed: valid + (not finite << 16)
  for (int ty = warp; ty < REG_TY; ty += REG_WARPS) {
    const unsigned b = __ballot_sync(
        FULL, (s_flags[(ty + r) * SW + lane + r] & 1) && tx0 + lane < p.W &&
                  ty0 + ty < p.H);
    if (lane == 0) s_rows[ty] = __popc(b);
  }
  constexpr int SLIDE = 4;  // tile rows a column sum slides over
  for (int i = tid; i < SW * (REG_TY / SLIDE); i += REG_THREADS) {
    const int x = i % SW, ty = (i / SW) * SLIDE;
    int s = 0;
    for (int dy = 0; dy < RW; ++dy) {
      const int c = s_flags[(ty + dy) * SW + x];
      s += (c & 1) + ((c >> 1) << 16);
    }
    s_cols[ty * SW + x] = s;
    for (int k = 1; k < SLIDE; ++k) {
      const int in = s_flags[(ty + k - 1 + RW) * SW + x];
      const int out = s_flags[(ty + k - 1) * SW + x];
      s += (in & 1) + ((in >> 1) << 16) - (out & 1) - ((out >> 1) << 16);
      s_cols[(ty + k) * SW + x] = s;
    }
  }
  __syncthreads();
  int n = 0;
  for (int ty = 0; ty < REG_TY; ++ty) n += s_rows[ty];
  for (int ty = warp; ty < REG_TY; ty += REG_WARPS) {
    int base = 0;
    for (int k = 0; k < ty; ++k) base += s_rows[k];
    const bool v = (s_flags[(ty + r) * SW + lane + r] & 1) &&
                   tx0 + lane < p.W && ty0 + ty < p.H;
    const unsigned b = __ballot_sync(FULL, v);
    if (v) s_list[base + __popc(b & ((1u << lane) - 1))] = ty * REG_TX + lane;
  }
  __syncthreads();

  // the walk: a listed centre a lane
  for (int li = warp * 32 + lane; li < n; li += REG_THREADS) {
    const int c = s_list[li];
    const int tx = c % REG_TX, ty = c / REG_TX;
    const float2 qc = s_q[(ty + r) * SP + tx + r];
    const float invD = qc.x, sig = qc.y;
    int packed = 0;
    for (int dx = 0; dx < RW; ++dx) packed += s_cols[ty * SW + tx + dx];
    const int n_count = packed & 0xffff;
    const bool poisoned = (packed >> 16) != 0;

    int close_count = 0;
    Fold<TDIST> fold;
    for (int dy = 0; dy < RW; ++dy) {
      const int row = (ty + dy) * SP + tx;
      for (int dx0 = 0; dx0 < RW; dx0 += 64) {
        unsigned long long m = close_mask(s_q + row + dx0,
                                          min(64, RW - dx0), invD, sig);
        close_count += __popcll(m);
        while (m) {
          const int j = row + dx0 + __ffsll(m) - 1;
          m &= m - 1;
          fold.add(s_q[j].x, s_f[j]);
        }
      }
    }
    const bool enough = n_count > p.min_neighbours &&
                        close_count > p.min_close_neighbours;
    float smoothed = fold.t_invD;
    if (!TDIST) {
      float wmean = fold.wmean;
      if (poisoned) wmean = __fadd_rn(wmean, __fmul_rn(0.0f, p.inf));
      smoothed = __fdiv_rn(wmean, clamp_min(fold.wsum, p.var_floor));
    }
    p.out[(size_t)(ty0 + ty) * p.W + tx0 + tx] = enough ? smoothed : REG_EMPTY;
  }
}

static const void* kernel_for(int tdist) {
  return tdist ? (const void*)regularize_kernel<true>
               : (const void*)regularize_kernel<false>;
}

// Raise an instantiation's dynamic shared-memory limit once to what a
// radius needs (never during a graph capture: the warm-up launch of the
// same radius, or esvo_regularize_kernel_info, comes first).
static cudaError_t prepare(int tdist, size_t smem) {
  static size_t allowed[2] = {0, 0};
  if (smem <= allowed[tdist ? 1 : 0]) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel_for(tdist), cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err == cudaSuccess) allowed[tdist ? 1 : 0] = smem;
  return err;
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
  p.inf = INFINITY;
  const size_t smem = reg_layout(r).bytes;
  cudaError_t err = prepare(tdist, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((W + REG_TX - 1) / REG_TX, (H + REG_TY - 1) / REG_TY);
  void* args[] = {(void*)&p};
  err = cudaLaunchKernel(kernel_for(tdist), grid, dim3(REG_THREADS), args,
                         smem, (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The instantiation for (tdist, r) as the CUDA runtime reports it, after
// its attribute is set: info = {blocks an SM holds, registers a thread,
// local bytes a thread, dynamic shared bytes a block, threads a block,
// tile width, tile height}.
extern "C" int esvo_regularize_kernel_info(int tdist, int r, int* info) {
  if (r < 0) return (int)cudaErrorInvalidValue;
  const size_t smem = reg_layout(r).bytes;
  cudaError_t err = prepare(tdist, smem);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return (int)err;
  }
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, kernel_for(tdist));
  if (err != cudaSuccess) return (int)err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, kernel_for(tdist), REG_THREADS, smem);
  if (err != cudaSuccess) return (int)err;
  info[0] = blocks;
  info[1] = attr.numRegs;
  info[2] = (int)attr.localSizeBytes;
  info[3] = (int)smem;
  info[4] = REG_THREADS;
  info[5] = REG_TX;
  info[6] = REG_TY;
  return (int)cudaSuccess;
}
