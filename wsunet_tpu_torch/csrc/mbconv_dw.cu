// Kernel B3: the middle of an EfficientNet-B0 MBConv block in one pass,
// f32, NCHW:
//
//     a = silu(bn_exp(x))                       (the prologue; stage 0 has
//                                                none: a = x)
//     y = silu(bn_dw(dwconv_K,S(pad_SAME(a))))  [B, C, Ho, Wo]
//     s = sum over (Ho, Wo) of y                [B, C]
//
// x is the raw output of the block's expand 1x1 conv (or, in stage 0, the
// block's input, already activated), w the depthwise taps [C, 1, K, K],
// both norms eval-mode batch norms given by their raw weight, bias,
// running mean and running variance.  K is 3 or 5, S is 1 or 2.  Padding
// is TensorFlow's SAME (ceil(size / S) outputs, the odd pixel of the
// padding after); padded taps are 0 after the prologue, as in the plain
// composition, which pads the activated tensor.
//
// The JAX package has no Pallas kernel for B0: XLA fuses the norms, SiLU
// and the pad around its depthwise conv on the TPU.  This kernel replaces
// none; it was added because PyTorch runs that middle as seven passes over
// device memory (two norms, two SiLUs, the pad, the depthwise conv and the
// squeeze-excite mean), which no library kernel fuses.
//
// What bounds it on an H100: bytes.  Per element it does at most K*K = 25
// FMAs an output and one norm and SiLU a value, about 6 operations a byte
// against the f32 ridge near 20 (67 TFLOP/s over 3.35 TB/s); the IEEE
// division and expf of each SiLU (some 20 instructions a value) bring the
// instruction issue close to the memory time, so the design keeps both
// streams busy at once.  The bound is x read once, y written once, plus
// the taps, the norms' vectors and the sums: 502.9 MiB an image over the
// 16 blocks of B0 without stem stride at 512^2, 5.03 ms a forward at
// B=32.  What the design does about it:
//
// - A block of THREADS threads walks a sequence of tiles of TR output rows:
//   one band of one (b, c) plane when a cluster of CL blocks splits the
//   plane (the 512^2 planes, where the planes alone are too few blocks to
//   fill the card), else the whole of JOBS consecutive planes (the small
//   late planes, so that each block has tiles enough to keep copies in
//   flight).  ops/fused_mbconv_dw.py, _plan, picks TR, CL and JOBS.
// - Input rows arrive once from device memory by cp.async (16 bytes a copy
//   when W is a multiple of 4 and x is 16-byte aligned, else 4), into a
//   ring of input rows in shared memory: the next tile's copies are issued
//   before a tile is computed and waited for after it, so no register
//   holds a value in flight.  (A ring two tiles deep takes a third of the
//   blocks off an SM and timed slower: scripts/b3_sweep.py.)  Then each
//   thread applies the prologue in place to the values it copied, once a
//   value; rows outside the image are zero-filled by the copy and left
//   so.  Rows two tiles share (K - S) are read once.  Each ring row keeps
//   input column 0 at column OFF = 4 (16-byte aligned) and zeros in its
//   pad columns, written once.
// - A thread computes 4 consecutive outputs of a row: for each of the K
//   input rows it reads its window with 16-byte shared loads into
//   registers, sums the K*K taps (from shared memory) with fmaf in the
//   order (kh, kw) from 0, applies the second norm and SiLU, and stores the
//   4 outputs with one 16-byte store when Wo is a multiple of 4.
// - The squeeze-excite sums: each thread adds its valid outputs as it
//   stores them, the warps by an xor butterfly, the warps in a fixed order
//   in shared memory, then (in a cluster) the blocks in rank order through
//   distributed shared memory after cluster.sync().  No atomics, no
//   scratch, no second kernel: two calls, and a CUDA-graph replay, give
//   bitwise-equal y and s.
// - Norm constants are computed once a plane, at the block's start, from
//   the raw statistics: scale = (1 / sqrtf(var + eps)) * weight, shift =
//   bias - mean * scale, with IEEE sqrtf and division, so no folded copy
//   can go stale.  SiLU is v / (1 + expf(-v)), IEEE division and the
//   accurate expf (no fast math, no TF32 anywhere).
// - Offsets of planes are 64-bit.
//
// The plain C entry point takes device pointers, the sizes, the plan and
// the CUDA stream, launches on that stream, allocates nothing, does not
// synchronise, and returns cudaGetLastError() after the launch.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 256;
constexpr int NWARPS = THREADS / 32;
constexpr int OFF = 4;          // ring column of input column 0
constexpr int DEPTH = 1;        // tiles in flight ahead of the one computed
constexpr int JOBS_MAX = 16;    // planes a block takes without a cluster
constexpr int SMEM_MAX = 200 * 1024;
constexpr int CLUSTER_MAX = 8;

struct Params {
  const float* x;
  const float* w;
  const float* g1;  // the prologue's norm (unused without a prologue)
  const float* b1;
  const float* m1;
  const float* v1;
  const float* g2;  // the depthwise conv's norm
  const float* b2;
  const float* m2;
  const float* v2;
  float* y;
  float* sums;
  long long planes;  // B * C
  int C, H, W, Ho, Wo, padT;
  int tr;       // output rows a tile
  int jobs;     // planes a block (1 in a cluster)
  int rs;       // floats a ring row
  int ring;     // ring rows
  int vec_in;   // 16-byte copies of x
  int vec_out;  // 16-byte stores of y
  float eps1, eps2;
};

// Where a thread's window starts in a ring row: the 16-byte aligned column
// BASE at or before the first input column its 4 outputs need (OFF - PADL
// for output column 0), SHIFT floats before it, NV 16-byte loads long.
template <int K, int S, int PADL>
struct Window {
  static constexpr int BASE = (OFF - PADL) & ~3;
  static constexpr int SHIFT = OFF - PADL - BASE;
  static constexpr int NV = (SHIFT + 3 * S + K + 3) / 4;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// asynchronous copies global -> shared; src_bytes 0 writes zeros
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(src_bytes) : "memory");
}
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(src_bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most N groups of this thread's copies are in flight; the
// landed copies are then visible to this thread
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ float silu(float v) {
  return v / (1.0f + expf(-v));
}

// A thread's share of a walk over rows x cw items: item tid, tid + THREADS,
// ... as (row, column) pairs, stepped without division; ``slot`` follows
// the row around a ring of ``ring`` rows.
struct Stride {
  int r0, c0, dr, dc;
  __device__ Stride(int cw, int tid)
      : r0(tid / cw), c0(tid - (tid / cw) * cw), dr(THREADS / cw),
        dc(THREADS - (THREADS / cw) * cw) {}
  __device__ __forceinline__ void step(int& r, int& c, int cw) const {
    c += dc;
    r += dr;
    if (c >= cw) {
      c -= cw;
      ++r;
    }
  }
  __device__ __forceinline__ void step(int& r, int& c, int cw, int& slot,
                                       int ring) const {
    const int r_was = r;
    step(r, c, cw);
    slot += r - r_was;
    while (slot >= ring) slot -= ring;
  }
};

template <int K, int S, int PADL, bool PRO>
__global__ void __launch_bounds__(THREADS, 4)
    mbconv_dw_kernel(const Params p) {
  using G = Window<K, S, PADL>;
  extern __shared__ __align__(16) float ring[];
  __shared__ float taps[JOBS_MAX][K * K];
  __shared__ float norm[JOBS_MAX][4];   // scale, shift of each norm
  __shared__ float red[2][NWARPS];
  __shared__ float part;

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int CL = static_cast<int>(cluster.num_blocks());
  const int tid = threadIdx.x;
  // this block's work: a band of one plane (in a cluster), or the whole of
  // up to p.jobs consecutive planes
  const long long first =
      CL > 1 ? blockIdx.x / CL : static_cast<long long>(blockIdx.x) * p.jobs;
  const int njobs = CL > 1 ? 1 : static_cast<int>(
      min(static_cast<long long>(p.jobs), p.planes - first));
  const int per = (p.Ho + CL - 1) / CL;
  const int ob = CL > 1 ? min(p.Ho, rank * per) : 0;
  const int oe = CL > 1 ? min(p.Ho, ob + per) : p.Ho;
  const int row0 = ob * S - p.padT;       // a job's first input row
  const int ntile = (oe - ob + p.tr - 1) / p.tr;
  const int total = njobs * ntile;
  const int rpj = (oe - ob - 1) * S + K;  // input rows a job passes through
  // input chunks a row: 16-byte or 4-byte copies
  const int cw = p.vec_in ? p.W >> 2 : p.W;
  const Stride chunk(cw, tid);

  // the new input rows [ra, rb) of tile t (of job j = t / ntile); input
  // row r of job j lives in ring slot (j * rpj + r - row0) % ring
  auto rows_of = [&](int t, int& j, int& ra, int& rb) {
    j = t / ntile;
    const int i = t - j * ntile;
    const int o0 = ob + i * p.tr;
    const int o1 = min(o0 + p.tr, oe);
    ra = i ? (o0 - 1) * S - p.padT + K : row0;
    rb = (o1 - 1) * S - p.padT + K;
  };

  auto issue = [&](int t) {
    if (t < total) {
      int j, ra, rb;
      rows_of(t, j, ra, rb);
      const float* xp = p.x + (first + j) * p.H * p.W;
      int slot = (j * rpj + ra - row0 + chunk.r0) % p.ring;
      for (int dr = chunk.r0, q = chunk.c0; dr < rb - ra;
           chunk.step(dr, q, cw, slot, p.ring)) {
        const int r = ra + dr;
        const bool in = r >= 0 && r < p.H;
        const float* src = in ? xp + static_cast<long long>(r) * p.W : xp;
        float* dst = ring + slot * p.rs + OFF;
        if (p.vec_in)
          cp_async16(dst + 4 * q, src + (in ? 4 * q : 0), in ? 16 : 0);
        else
          cp_async4(dst + q, src + (in ? q : 0), in ? 4 : 0);
      }
    }
    cp_async_commit();
  };

  // the prologue, in place, on the values this thread copied for tile t
  auto transform = [&](int t) {
    if (!PRO || t >= total) return;
    int j, ra, rb;
    rows_of(t, j, ra, rb);
    const float sc = norm[j][0], sh = norm[j][1];
    int slot = (j * rpj + ra - row0 + chunk.r0) % p.ring;
    for (int dr = chunk.r0, q = chunk.c0; dr < rb - ra;
         chunk.step(dr, q, cw, slot, p.ring)) {
      const int r = ra + dr;
      if (r < 0 || r >= p.H) continue;
      float* v = ring + slot * p.rs + OFF;
      if (p.vec_in) {
        float4 a = *reinterpret_cast<float4*>(v + 4 * q);
        a.x = silu(fmaf(a.x, sc, sh));
        a.y = silu(fmaf(a.y, sc, sh));
        a.z = silu(fmaf(a.z, sc, sh));
        a.w = silu(fmaf(a.w, sc, sh));
        *reinterpret_cast<float4*>(v + 4 * q) = a;
      } else {
        v[q] = silu(fmaf(v[q], sc, sh));
      }
    }
  };

  for (int t = 0; t < DEPTH; ++t) issue(t);

  // per plane: both norms' scale and shift, and the taps
  for (int j = tid; j < njobs; j += THREADS) {
    const int c = static_cast<int>((first + j) % p.C);
    float sc1 = 1.0f, sh1 = 0.0f;
    if (PRO) {
      sc1 = (1.0f / sqrtf(p.v1[c] + p.eps1)) * p.g1[c];
      sh1 = p.b1[c] - p.m1[c] * sc1;
    }
    const float sc2 = (1.0f / sqrtf(p.v2[c] + p.eps2)) * p.g2[c];
    norm[j][0] = sc1;
    norm[j][1] = sh1;
    norm[j][2] = sc2;
    norm[j][3] = p.b2[c] - p.m2[c] * sc2;
  }
  for (int i = tid; i < njobs * K * K; i += THREADS) {
    const int j = i / (K * K), k = i - j * (K * K);
    taps[j][k] = p.w[((first + j) % p.C) * K * K + k];
  }
  // the pad columns of every ring row: [0, OFF) and [OFF + W, rs)
  const int padc = p.rs - p.W;
  for (int i = tid; i < p.ring * padc; i += THREADS) {
    const int r = i / padc, q = i - r * padc;
    ring[r * p.rs + (q < OFF ? q : q + p.W)] = 0.0f;
  }
  if (tid == 0) part = 0.0f;
  cp_async_wait<0>();  // tile 0 has landed
  __syncthreads();     // the tables are written
  transform(0);
  __syncthreads();

  const int Q = (p.Wo + 3) >> 2;  // 4-column items of an output row
  const Stride item(Q, tid);
  float ssum = 0.0f;
  for (int t = 0; t < total; ++t) {
    issue(t + DEPTH);

    // tile t: output rows [o0, o0 + nr) of job j; its first input row is
    // in slot s0
    const int j = t / ntile;
    const int i = t - j * ntile;
    const int o0 = ob + i * p.tr;
    const int nr = min(o0 + p.tr, oe) - o0;
    const int s0 = (j * rpj + (o0 - ob) * S) % p.ring;
    const float* tp = taps[j];
    const float sc2 = norm[j][2], sh2 = norm[j][3];
    float* yp = p.y + (first + j) * p.Ho * p.Wo;
    for (int orow = item.r0, q = item.c0; orow < nr; item.step(orow, q, Q)) {
      const int oc = 4 * q;
      float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int kh = 0; kh < K; ++kh) {
        int slot = s0 + orow * S + kh;
        if (slot >= p.ring) slot -= p.ring;
        const float* rp = ring + slot * p.rs + oc * S + G::BASE;
        float win[4 * G::NV];
#pragma unroll
        for (int v = 0; v < G::NV; ++v) {
          const float4 a = *reinterpret_cast<const float4*>(rp + 4 * v);
          win[4 * v] = a.x;
          win[4 * v + 1] = a.y;
          win[4 * v + 2] = a.z;
          win[4 * v + 3] = a.w;
        }
#pragma unroll
        for (int kw = 0; kw < K; ++kw) {
          const float w = tp[kh * K + kw];
#pragma unroll
          for (int e = 0; e < 4; ++e)
            acc[e] = fmaf(win[G::SHIFT + e * S + kw], w, acc[e]);
        }
      }
      float out[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) out[e] = silu(fmaf(acc[e], sc2, sh2));
      float* dst = yp + static_cast<long long>(o0 + orow) * p.Wo + oc;
      if (p.vec_out) {
        *reinterpret_cast<float4*>(dst) =
            make_float4(out[0], out[1], out[2], out[3]);
#pragma unroll
        for (int e = 0; e < 4; ++e) ssum += out[e];
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (oc + e < p.Wo) {
            dst[e] = out[e];
            ssum += out[e];
          }
        }
      }
    }
    cp_async_wait<DEPTH - 1>();  // tile t + 1 has landed
    transform(t + 1);
    const bool last = i == ntile - 1;  // the job's sums are complete
    if (last) {
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        ssum += __shfl_xor_sync(0xffffffffu, ssum, o);
      if ((tid & 31) == 0) red[j & 1][tid >> 5] = ssum;
      ssum = 0.0f;
    }
    __syncthreads();  // tile t + 1 is ready; tile t's slots are free
    if (last && tid == 0) {
      float s = red[j & 1][0];
      for (int w = 1; w < NWARPS; ++w) s += red[j & 1][w];
      if (CL == 1)
        p.sums[first + j] = s;
      else
        part = s;
    }
  }
  cp_async_wait<0>();
  if (CL == 1) return;
  cluster.sync();
  if (rank == 0 && tid == 0) {
    float s = part;
    for (int r = 1; r < CL; ++r) s += *cluster.map_shared_rank(&part, r);
    p.sums[first] = s;
  }
  cluster.sync();  // no block leaves while rank 0 reads its part
}

template <int K, int S, int PADL, bool PRO>
cudaError_t launch(Params p, int cl, cudaStream_t stream) {
  using G = Window<K, S, PADL>;
  const int Q = (p.Wo + 3) / 4;
  const int need = G::BASE + 4 * (Q - 1) * S + 4 * G::NV;
  p.rs = ((OFF + p.W > need ? OFF + p.W : need) + 3) & ~3;
  // a tile's rows and the new rows of the DEPTH tiles after it: at most
  // (TR - 1) * S + K each (a plane's first tile)
  p.ring = (DEPTH + 1) * ((p.tr - 1) * S + K);
  const long long smem = 4LL * p.ring * p.rs;
  if (p.tr < 1 || cl < 1 || cl > CLUSTER_MAX || p.jobs < 1 ||
      p.jobs > JOBS_MAX || (cl > 1 && p.jobs != 1) || smem > SMEM_MAX)
    return cudaErrorInvalidValue;
  const long long blocks =
      cl > 1 ? p.planes * cl : (p.planes + p.jobs - 1) / p.jobs;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  static bool ready = false;
  if (!ready) {
    const cudaError_t err = cudaFuncSetAttribute(
        mbconv_dw_kernel<K, S, PADL, PRO>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
    if (err != cudaSuccess) return err;
    ready = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(blocks));
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = static_cast<size_t>(smem);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cl;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err =
      cudaLaunchKernelEx(&cfg, mbconv_dw_kernel<K, S, PADL, PRO>, p);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <bool PRO>
cudaError_t dispatch(const Params& p, int K, int S, int padl, int cl,
                     cudaStream_t stream) {
  if (K == 3 && S == 1 && padl == 1)
    return launch<3, 1, 1, PRO>(p, cl, stream);
  if (K == 5 && S == 1 && padl == 2)
    return launch<5, 1, 2, PRO>(p, cl, stream);
  if (K == 3 && S == 2 && padl == 0)
    return launch<3, 2, 0, PRO>(p, cl, stream);
  if (K == 3 && S == 2 && padl == 1)
    return launch<3, 2, 1, PRO>(p, cl, stream);
  if (K == 5 && S == 2 && padl == 1)
    return launch<5, 2, 1, PRO>(p, cl, stream);
  if (K == 5 && S == 2 && padl == 2)
    return launch<5, 2, 2, PRO>(p, cl, stream);
  return cudaErrorInvalidValue;
}

// SAME padding of one axis: ceil(size / s) outputs, the padding before
int same_out(int size, int s) { return (size + s - 1) / s; }
int same_before(int size, int k, int s) {
  const int total = (same_out(size, s) - 1) * s + k - size;
  return total > 0 ? total / 2 : 0;
}

}  // namespace

extern "C" {

// x [B, C, H, W], w [C, 1, k, k], y [B, C, Ho, Wo] and sums [B, C], all
// f32 and contiguous; (g1, b1, m1, v1) the prologue's norm, or all null
// for none; (g2, b2, m2, v2) the depthwise conv's norm; the plan (tr
// output rows a tile, cl blocks a plane, jobs planes a block when cl is 1)
// is ops/fused_mbconv_dw.py::_plan's.
int mbconv_dw_f32(const void* x, const void* w, const void* g1,
                  const void* b1, const void* m1, const void* v1, float eps1,
                  const void* g2, const void* b2, const void* m2,
                  const void* v2, float eps2, void* y, void* sums,
                  long long B, int C, int H, int W, int k, int stride, int tr,
                  int cl, int jobs, void* stream) {
  if (B < 1 || C < 1 || H < 1 || W < 1 || (k != 3 && k != 5) ||
      (stride != 1 && stride != 2))
    return cudaErrorInvalidValue;
  Params p = {};
  p.x = static_cast<const float*>(x);
  p.w = static_cast<const float*>(w);
  p.g1 = static_cast<const float*>(g1);
  p.b1 = static_cast<const float*>(b1);
  p.m1 = static_cast<const float*>(m1);
  p.v1 = static_cast<const float*>(v1);
  p.g2 = static_cast<const float*>(g2);
  p.b2 = static_cast<const float*>(b2);
  p.m2 = static_cast<const float*>(m2);
  p.v2 = static_cast<const float*>(v2);
  p.y = static_cast<float*>(y);
  p.sums = static_cast<float*>(sums);
  p.planes = B * C;
  p.C = C;
  p.H = H;
  p.W = W;
  p.Ho = same_out(H, stride);
  p.Wo = same_out(W, stride);
  p.padT = same_before(H, k, stride);
  p.tr = tr;
  p.jobs = jobs;
  p.vec_in = W % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  p.vec_out = p.Wo % 4 == 0 && reinterpret_cast<uintptr_t>(y) % 16 == 0;
  p.eps1 = eps1;
  p.eps2 = eps2;
  const int padl = same_before(W, k, stride);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (g1 != nullptr) return dispatch<true>(p, k, stride, padl, cl, st);
  return dispatch<false>(p, k, stride, padl, cl, st);
}

const char* mbconv_dw_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
