// Kernel B4: the middle of Restormer's gated depthwise feed-forward
// (GDFN) in one pass, f32, NCHW:
//
//     y[b, j] = gelu(dw3x3(u[b, j], w[j])) * dw3x3(u[b, h + j], w[h + j])
//                                                         for j < h
//
// u [B, 2h, H, W] is the output of the block's project_in 1x1 conv, w
// [2h, 1, 3, 3] the depthwise taps, y [B, h, H, W] what project_out reads.
// The conv pads with one row and column of zeros and has stride 1.  The
// GELU is the exact one, as PyTorch's CUDA kernel computes it:
// v * 0.5f * (1.0f + erff(v * M_SQRT1_2)).
//
// The JAX package has no Restormer, so this kernel replaces no TPU kernel.
// It was added because PyTorch runs this middle as four passes over device
// memory (a library depthwise conv over 2h channels, the chunk's strided
// halves through a GELU and a product), 20 bytes of traffic an output on
// top of the conv's own, where one pass needs 12.
//
// What bounds it on an H100: bytes.  An output reads two inputs and writes
// one (12 bytes); its arithmetic is 18 FMAs and an erff, some 50
// instructions, about half of what the card can issue in the time its
// memory moves those 12 bytes.  The bound is u read once, y written once
// and the taps: 12.03 GB an image over the 44 blocks of restormer_gray at
// 512^2, 114.9 ms a forward at B=32.  What the design does about it:
//
// - A tile is a band of ROWS output rows and TW output columns (TW at most
//   128) of one pair of planes (b, j) and (b, h + j).  One thread issues
//   two TMA loads a tile, one box a plane of (ROWS + 2) x (TW + 8) floats
//   over the tensor map [B * 2h, H, W]: from one row before the band and
//   4 columns before the tile (16 bytes, so that every row of the box
//   stays aligned), or from row 0 and column 0 at the plane's top and left
//   edges, because a box that starts before the plane faults on this card
//   (an illegal instruction).  There a thread reads the one zero row or
//   column of the padding as 0 itself; TMA's out-of-bounds fill writes the
//   zeros at the bottom and right and past a ragged edge.  The copies
//   cost the other threads no instruction and no register.  The boxes ask
//   for no L2 promotion: with 256-byte promotion a forward's launches
//   timed 10% slower (PERF.md, section 6).
// - A persistent grid (as many blocks as fit on the card at once, each
//   walking tiles blockIdx.x, + gridDim.x, ...) keeps two stages of boxes
//   under mbarriers: the next tile's boxes are in flight while this one is
//   computed.  Consecutive tiles are the bands of one plane, so the halo
//   rows that two bands share are read from device memory about once.
// - A thread owns 4 adjacent output columns of RS = 4 rows.  Its window
//   of 3 x 6 inputs a plane sits in registers and slides down one row at a
//   time: an output row reads one new row of shared memory a plane (one
//   16-byte load and its two neighbours), not three.  The 18 taps are in
//   registers; each output sums its 9 taps with fmaf in the order (kh, kw)
//   from 0, as the library's depthwise kernels do (the outputs are equal
//   bit for bit), and the product is stored as one float4, each output
//   byte written once.
// - ops/fused_gdfn_gate.py, _plan, takes TW from W and ROWS from the
//   threads a column of tiles leaves: one algorithm, its parameters from
//   the shape.  W must be a multiple of 4 (a TMA row pitch is a multiple of
//   16 bytes); the wrapper pads other widths with zero columns first.
// - No atomics and no scratch: two calls, and a CUDA-graph replay, give
//   bitwise-equal y.  Offsets of planes are 64-bit.
//
// The plain C entry point takes device pointers, the sizes, the plan and
// the CUDA stream, launches on that stream, allocates nothing, does not
// synchronise, and returns cudaGetLastError() after the launch, or minus
// the CUresult with which the CUDA driver refused the tensor map.

#include <cuda.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int THREADS = 128;
constexpr int RS = 4;         // output rows a thread slides down
constexpr int TW_MAX = 128;   // output columns a tile
constexpr int S_MAX = 16;     // threads down a column of a tile
constexpr int STAGES = 2;
constexpr float kAlpha = 0.70710678118654752440f;  // M_SQRT1_2

struct Params {
  const float* w;
  float* y;
  long long tiles;   // pairs * nct * nbt
  int h, H, W;
  int tw, rows;      // a tile: rows x tw outputs
  int nct, nbt;      // column tiles and row bands of a plane
  int slot;          // floats from one box to the next in shared memory
};

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// one box of the tensor map, its corner at (x, y) of plane z, into dst
__device__ __forceinline__ void tma_load(float* dst, const CUtensorMap* map,
                                         int x, int y, int z, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y), "r"(z), "r"(bar)
      : "memory");
}

// the 6 inputs of one box row around the thread's 4 columns: 16 bytes at
// p and a float either side, the left one 0 at the plane's left edge (no
// row before the plane: ``in`` false, all 0)
__device__ __forceinline__ void load_row(float (&r)[6], const float* p,
                                         bool left, bool in) {
  if (!in) {
#pragma unroll
    for (int e = 0; e < 6; ++e) r[e] = 0.0f;
    return;
  }
  const float4 a = *reinterpret_cast<const float4*>(p);
  r[0] = left ? p[-1] : 0.0f;
  r[1] = a.x;
  r[2] = a.y;
  r[3] = a.z;
  r[4] = a.w;
  r[5] = p[4];
}

__device__ __forceinline__ float gelu(float v) {
  return v * 0.5f * (1.0f + erff(v * kAlpha));
}

// Tile t of a launch: the pair pr = b * h + j of planes (b, j) and
// (b, h + j), column tile c, row band r (fastest).
struct Tile {
  long long pr, b;
  int j, c, r;
  __device__ Tile(long long t, const Params& p) {
    const long long per_pair = static_cast<long long>(p.nct) * p.nbt;
    pr = t / per_pair;
    const int rem = static_cast<int>(t - pr * per_pair);
    c = rem / p.nbt;
    r = rem - c * p.nbt;
    b = pr / p.h;
    j = static_cast<int>(pr - b * p.h);
  }
};

// thread 0: tile t's two boxes into stage st, completing on bar
__device__ __forceinline__ void issue(const CUtensorMap* map, const Params& p,
                                      long long t, float* stage,
                                      uint32_t bar) {
  const Tile tl(t, p);
  const int z = static_cast<int>(tl.b * 2 * p.h + tl.j);
  const int x0 = tl.c > 0 ? tl.c * p.tw - 4 : 0;
  const int y0 = tl.r > 0 ? tl.r * p.rows - 1 : 0;
  // the block's generic reads of this stage (ordered by the
  // __syncthreads() before this call) come before the async writes
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  mbar_arrive_tx(bar, 2u * 4u * (p.tw + 8) * (p.rows + 2));
  tma_load(stage, map, x0, y0, z, bar);
  tma_load(stage + p.slot, map, x0, y0, z + p.h, bar);
}

__global__ void __launch_bounds__(THREADS, 5)
    gdfn_gate_kernel(const __grid_constant__ CUtensorMap map, const Params p) {
  __shared__ __align__(8) uint64_t full[STAGES];
  extern __shared__ unsigned char dyn[];
  // boxes start 128-byte aligned
  float* buf = reinterpret_cast<float*>(
      dyn + ((128u - (smem_u32(dyn) & 127u)) & 127u));
  const int tid = threadIdx.x;
  const int G = p.tw >> 2;     // threads across a tile
  const int g = tid % G;
  const int s = tid / G;
  const bool active = s * RS < p.rows;
  const int bw = p.tw + 8;     // floats a box row

  if (tid == 0) {
    for (int i = 0; i < STAGES; ++i) mbar_init(smem_u32(&full[i]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  long long t = blockIdx.x;
  if (tid == 0 && t < p.tiles) issue(&map, p, t, buf, smem_u32(&full[0]));
  for (int k = 0; t < p.tiles; ++k, t += gridDim.x) {
    const int st = k & (STAGES - 1);
    if (tid == 0 && t + gridDim.x < p.tiles)
      issue(&map, p, t + gridDim.x, buf + 2 * (st ^ 1) * p.slot,
            smem_u32(&full[st ^ 1]));
    const Tile tl(t, p);
    float ka[9], kb[9];
    if (active) {
#pragma unroll
      for (int q = 0; q < 9; ++q) {
        ka[q] = __ldg(p.w + tl.j * 9 + q);
        kb[q] = __ldg(p.w + (p.h + tl.j) * 9 + q);
      }
    }
    mbar_wait(smem_u32(&full[st]), (k / STAGES) & 1);
    if (active) {
      const int oc = tl.c * p.tw + 4 * g;
      const int r0 = tl.r * p.rows + s * RS;
      // the box row of input row r0 - 1 (-1 above the plane) and the box
      // column of output column oc
      const int rb = s * RS - (tl.r == 0);
      const float* xa = buf + 2 * st * p.slot + rb * bw +
                        (tl.c > 0 ? 4 : 0) + 4 * g;
      const float* xb = xa + p.slot;
      const bool left = tl.c > 0 || g > 0;
      float* yp = p.y + tl.pr * p.H * p.W + oc;
      const bool col_in = oc < p.W;
      float wa[3][6], wb[3][6];
      load_row(wa[0], xa, left, rb >= 0);
      load_row(wb[0], xb, left, rb >= 0);
      load_row(wa[1], xa + bw, left, true);
      load_row(wb[1], xb + bw, left, true);
#pragma unroll
      for (int i = 0; i < RS; ++i) {
        load_row(wa[(i + 2) % 3], xa + (i + 2) * bw, left, true);
        load_row(wb[(i + 2) % 3], xb + (i + 2) * bw, left, true);
        float o[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float va = 0.0f, vb = 0.0f;
#pragma unroll
          for (int kh = 0; kh < 3; ++kh) {
#pragma unroll
            for (int kw = 0; kw < 3; ++kw) {
              va = fmaf(wa[(i + kh) % 3][e + kw], ka[kh * 3 + kw], va);
              vb = fmaf(wb[(i + kh) % 3][e + kw], kb[kh * 3 + kw], vb);
            }
          }
          o[e] = gelu(va) * vb;
        }
        if (col_in && r0 + i < p.H)
          *reinterpret_cast<float4*>(yp + static_cast<long long>(r0 + i) *
                                              p.W) =
              make_float4(o[0], o[1], o[2], o[3]);
      }
    }
    __syncthreads();  // this stage is free for the tile after next
  }
}

EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* got = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &got, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &got, cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(got);
  }
  return fn;
}

}  // namespace

extern "C" {

// u [B, 2h, H, W], w [2h, 1, 3, 3] and y [B, h, H, W], all f32 and
// contiguous, u 16-byte aligned, W a multiple of 4; the plan (tw output
// columns and rows output rows a tile) is ops/fused_gdfn_gate.py::_plan's.
int gdfn_gate_f32(const void* u, const void* w, void* y, long long B, int h,
                  int H, int W, int tw, int rows, void* stream) {
  if (B < 1 || h < 1 || H < 1 || W < 1 || W % 4 != 0 || tw < 4 ||
      tw > TW_MAX || tw % 4 != 0 || rows < RS || rows % RS != 0 ||
      rows / RS > S_MAX || rows / RS > THREADS / (tw / 4) ||
      reinterpret_cast<uintptr_t>(u) % 16 != 0 ||
      B * 2 * static_cast<long long>(h) > INT_MAX)
    return cudaErrorInvalidValue;
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return cudaErrorNotSupported;
  CUtensorMap map;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(W),
                              static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(B * 2 * h)};
  const cuuint64_t strides[2] = {4ull * W, 4ull * W * H};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(tw + 8),
                             static_cast<cuuint32_t>(rows + 2), 1};
  const cuuint32_t steps[3] = {1, 1, 1};
  const CUresult res = encode(
      &map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<void*>(u), dims,
      strides, box, steps, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_NONE,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (res != CUDA_SUCCESS) return -static_cast<int>(res);
  Params p = {};
  p.w = static_cast<const float*>(w);
  p.y = static_cast<float*>(y);
  p.h = h;
  p.H = H;
  p.W = W;
  p.tw = tw;
  p.rows = rows;
  p.nct = (W + tw - 1) / tw;
  p.nbt = (H + rows - 1) / rows;
  p.tiles = B * h * static_cast<long long>(p.nct) * p.nbt;
  p.slot = ((tw + 8) * (rows + 2) + 31) & ~31;
  const int smem = STAGES * 2 * p.slot * 4 + 128;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, gdfn_gate_kernel, THREADS, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const long long fill = static_cast<long long>(per_sm) * sms;
  const unsigned blocks =
      static_cast<unsigned>(p.tiles < fill ? p.tiles : fill);
  gdfn_gate_kernel<<<blocks, THREADS, smem,
                     static_cast<cudaStream_t>(stream)>>>(map, p);
  return cudaGetLastError();
}

const char* gdfn_gate_error_string(int err) {
  if (err < 0) return "the CUDA driver refused the tensor map (CUresult)";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
