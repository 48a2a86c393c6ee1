// Kernel B1, variant "wgmma": reflect-padded 3x3 convolution of bf16 NHWC
// input as an implicit GEMM on Hopper's tensor cores, bias and optional
// ReLU fused, f32 accumulation:
//
//     out = relu?(conv3x3(reflect_pad_1(x), w) + b)
//
// x [B, H, W, C] and out [B, H, W, Cout] contiguous NHWC, w HWIO
// [3, 3, C, Cout], b [Cout], all bf16; C a multiple of 8 and at least 16
// (the wrapper sends other shapes to the "direct" variant in
// reflect_conv3x3.cu; this entry point refuses them).
//
// Replaces the Pallas TPU kernel
// wsunet_tpu/experiments/pallas_reflect_conv.py::_forward (body _kernel)
// for bf16, where the TPU kernel runs its products on the MXU at DEFAULT
// precision.  What bounds it on an H100: 2*9*C*Cout operations a pixel on
// the tensor cores (989 TFLOP/s dense bf16) at C >= 128, and at C = 64 the
// bytes of one read of x and one write of out as much as the operations.
// At the U-Net's shapes it runs at 32-40% of that bound; what keeps it
// there is that every block re-stages each chunk's weights from L2 and
// waits at a barrier every chunk (TMA multicast of the weights across a
// cluster and warp-specialised persistent blocks are the next steps).
//
// GEMM view.  M = output pixels: a block owns TH rows x TW = 64 columns;
// each of its 4 warpgroups (128 threads each) owns RPW whole rows, one
// wgmma m64 row block each.  N = output channels, BN = 64 or 128 (the
// template parameter; BN = 64 when Cout <= 64).  At BN = 128 a warpgroup
// owns 1 row (TH = 4, 256 pixels, 64 accumulators a thread); at BN = 64 it
// owns 2 (TH = 8, 512 pixels, 2 x 32 accumulators), so the weights staged
// for a chunk serve twice the pixels.  K = 9*C, taken as 9 shifted taps
// over chunks of KC = 16 input channels (one k16 step a tap).
//
// Staging.  For each chunk a stage holds the halo tile, (TH + 2) rows x
// (TW + 2) pixels x KC channels, and the chunk's weights [9][KC][BN].  The
// halo is copied with 16-byte cp.async.cg (8 channels of one pixel) from
// the *reflected* source pixel, so the reflect boundary costs only index
// arithmetic (row -1 reads row 1, row H reads row H-2, the same for
// columns, corners included); positions beyond the reflected range belong
// only to outputs outside the image and are zero-filled (the cp.async
// source size 0), as are channels beyond C and weight columns beyond Cout.
// Four stages form a ring: while chunk k multiplies, chunks k+1 .. k+3 are
// in flight, and the copies of chunk k+3 are issued after chunk k's wgmmas,
// so they overlap the tensor cores' work.  On an H100 (scripts/b1_sweep.py)
// a ring of 2 stages, or tiles of 4 rows at BN = 64, each cost about 13% of
// the U-Net layers' time; 3 stages time the same as 4.  The rows matter
// because each chunk's weights are copied once a block, and they are most
// of a stage's bytes.
//
// One staged tile serves all 9 taps, with no im2col copy.  The halo lies
// in shared memory as [KC/8 channel groups][halo pixel][8 channels], 16
// bytes per pixel per group, no swizzle (each group's plane padded so the
// two planes start 16 banks apart).  64 consecutive halo pixels at any row
// shift di and column shift dj then form a K-major, no-swizzle wgmma A
// operand whose 8-pixel x 16-byte core matrices are contiguous: the
// descriptor's start moves by 16 bytes per column shift and by (TW + 2) *
// 16 bytes per row shift; its stride byte offset (between 8-pixel groups,
// along M) is 128 bytes and its leading byte offset (between the two
// 8-channel halves of a k16 step, along K) is the channel-group plane.  A
// is read from shared memory by this descriptor (not loaded into
// registers with ldmatrix).  The weights are copied as they lie in HWIO,
// Cout contiguous, into N-major ("transposed") B core matrices of 8
// channels x 8 output channels: [tap][channel group][column group][8][8],
// leading byte offset (along K) BN * 16 bytes, stride byte offset (along
// N) 128 bytes.
//
// Products: wgmma.mma_async m64nBNk16 f32.bf16.bf16, accumulating in f32
// registers over all taps and chunks.  The tensor cores multiply bf16
// exactly and sum in f32, as the Pallas kernel's DEFAULT-precision MXU
// pass does; only the order of the sum differs from the plain version.
// Every wgmma that reads a stage is retired (wgmma.wait_group 0) before
// the barrier after which cp.async may overwrite that stage; the copies
// are ordered before the wgmmas that read them by cp.async.wait_group,
// fence.proxy.async and that barrier.
//
// Epilogue: + bias, ReLU, one rounding to bf16 (round to nearest even);
// the tile goes through shared memory and is stored NHWC with 16-byte
// stores (element stores when Cout is not a multiple of 8), masked at the
// ragged W, H and Cout.  Every output is summed by one warpgroup in a fixed
// order: no atomics, the result does not change from run to run.  Offsets
// into x and out are 64-bit.
//
// The plain C entry point takes device pointers, the sizes and the CUDA
// stream, launches on that stream, allocates nothing, does not
// synchronise, and returns cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

using bf16 = __nv_bfloat16;

constexpr int TW = 64;          // output columns of a tile: wgmma's M
constexpr int KC = 16;          // input channels of a stage: one k16 step
constexpr int HP = TW + 2;      // halo pixels of a row
constexpr int GROUP = 16;       // bytes of 8 bf16 channels of one pixel
constexpr int STAGES = 4;       // the ring of stages

// Tile shape and shared memory by BN.  Four warpgroups (512 threads, one
// block an SM), each owning RPW output rows: 1 at BN = 128 (64
// accumulators a thread), 2 at BN = 64 (2 x 32), so a block owns 4 or 8
// rows of 64 pixels and its staged weights serve 256 or 512 pixels.
template <int BN>
struct Tile {
  static constexpr int RPW = BN == 64 ? 2 : 1;      // rows a warpgroup
  static constexpr int TH = 4 * RPW;                // output rows
  static constexpr int NT = 512;                    // threads
  static constexpr int HR = TH + 2;                 // halo rows
  static constexpr int NG = BN / 8;                 // column groups
  // one channel group of the halo, padded so that the two planes start
  // 16 banks apart (cp.async writes without bank conflicts)
  static constexpr int RAW = HR * HP * GROUP;
  static constexpr int PLANE = RAW + (48 - (RAW / 4) % 32) % 32 * 4;
  static constexpr int A_BYTES = (KC / 8) * PLANE;  // halo of a stage
  static constexpr int B_BYTES = 9 * KC * BN * 2;   // weights of a stage
  static constexpr int STAGE = A_BYTES + B_BYTES;
  static constexpr int PITCH = BN + 8;  // bf16 a pixel in the output tile
  static constexpr int SMEM = STAGES * STAGE + BN * 4;  // + the bias
  static_assert(PLANE % 16 == 0 && (PLANE / 4) % 32 == 16, "plane");
  static_assert(TH * TW * PITCH * 2 <= STAGES * STAGE, "output tile");
  static_assert(SMEM <= 232448, "shared memory of a block");
};

// Reflect an index in [-1, n] into [0, n): -1 -> 1, n -> n-2 (needs n >= 2).
__device__ __forceinline__ int reflect(int i, int n) {
  return i < 0 ? -i : (i >= n ? 2 * n - 2 - i : i);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte asynchronous copy global -> shared; src_bytes 0 writes zeros
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(src_bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most N groups of this thread's copies are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// order this thread's writes to shared memory (cp.async and st.shared,
// the generic proxy) before the wgmma reads (the async proxy)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keep the compiler from moving accumulator reads or writes across a
// wgmma fence or wait
template <int N>
__device__ __forceinline__ void fence_acc(float* d) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// shared-memory matrix descriptor, no swizzle: start address, leading and
// stride byte offsets, each in 16-byte units in a 14-bit field
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo & 0x3FFFF) >> 4) << 16) |
         (static_cast<uint64_t>((sbo & 0x3FFFF) >> 4) << 32);
}

// D[64 x N] += A[64 x 16] (K-major) * B[16 x N] (N-major), bf16 in, f32
// accumulators in registers
__device__ __forceinline__ void wgmma_n64(float* d, uint64_t a,
                                          uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31},"
      " %32, %33, p, 1, 1, 0, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_n128(float* d, uint64_t a,
                                           uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63},"
      " %64, %65, p, 1, 1, 0, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(1));
}

template <int BN>
__device__ __forceinline__ void wgmma(float* d, uint64_t a, uint64_t b) {
  if constexpr (BN == 64)
    wgmma_n64(d, a, b);
  else
    wgmma_n128(d, a, b);
}

// Copy chunk [c0, c0 + KC) of the halo tile and the weights into the stage
// at shared address sa (generic pointer sp).
template <int BN>
__device__ __forceinline__ void load_stage(
    uint32_t sa, uint8_t* sp, const bf16* __restrict__ xi,
    const bf16* __restrict__ w, int H, int W, int C, int Cout, int h0,
    int w0, int co0, int c0, int tid) {
  using T = Tile<BN>;
  constexpr int NG = T::NG;
  // halo: [KC/8 channel groups][HR x HP pixels][8 channels]; consecutive
  // threads take consecutive channel groups of one pixel
  for (int e = tid; e < (KC / 8) * T::HR * HP; e += T::NT) {
    const int g = e % (KC / 8);
    const int p = e / (KC / 8);
    const int gh = h0 + p / HP - 1, gw = w0 + p % HP - 1;
    const int c = c0 + g * 8;
    const bool ok = gh <= H && gw <= W && c < C;
    const bf16* src =
        ok ? xi + ((int64_t)reflect(gh, H) * W + reflect(gw, W)) * C + c
           : xi;
    cp_async16(sa + g * T::PLANE + p * GROUP, src, ok ? 16 : 0);
  }
  // weights: [9 taps][KC/8 channel groups][NG column groups][8 channels]
  // [8 columns]; consecutive threads take the 8 channels of one core
  // matrix, so each quarter warp writes 128 contiguous bytes
  const bool vec = Cout % 8 == 0;
  for (int e = tid; e < 9 * KC * NG; e += T::NT) {
    const int cl = e % 8;
    const int n8 = (e / 8) % NG;
    const int r = e / (8 * NG);           // tap * (KC / 8) + channel group
    const int tap = r / (KC / 8);
    const int c = c0 + (r % (KC / 8)) * 8 + cl;
    const int co = co0 + n8 * 8;
    const int off = T::A_BYTES + (r * NG + n8) * 128 + cl * GROUP;
    const bf16* src = w + ((int64_t)tap * C + c) * Cout + co;
    if (vec) {
      const bool ok = c < C && co < Cout;
      cp_async16(sa + off, ok ? src : w, ok ? 16 : 0);
    } else {  // rows of a ragged Cout are not 16-byte aligned
      union { uint4 u; uint16_t h[8]; } v;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        v.h[j] = c < C && co + j < Cout ? __bfloat16_as_ushort(src[j]) : 0;
      *reinterpret_cast<uint4*>(sp + off) = v.u;
    }
  }
}

template <int BN>
__global__ void __launch_bounds__(Tile<BN>::NT)
wgmma_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
             const bf16* __restrict__ bias, bf16* __restrict__ out, int H,
             int W, int C, int Cout, int tiles_w, int tiles_per_img,
             int n_tiles, int relu) {
  using T = Tile<BN>;
  extern __shared__ __align__(128) uint8_t smem[];
  float* bias_s = reinterpret_cast<float*>(smem + STAGES * T::STAGE);
  const uint32_t s0 = smem_addr(smem);

  const int tid = threadIdx.x;
  const int g = tid / 128;  // warpgroup: rows h0 + g * RPW + [0, RPW)
  const int co0 = (blockIdx.x % n_tiles) * BN;
  const int tile_id = blockIdx.x / n_tiles;
  const int64_t img = tile_id / tiles_per_img;
  const int tile = tile_id % tiles_per_img;
  const int h0 = (tile / tiles_w) * T::TH;
  const int w0 = (tile % tiles_w) * TW;
  const bf16* xi = x + img * H * W * C;

  if (tid < BN)
    bias_s[tid] = co0 + tid < Cout ? __bfloat162float(bias[co0 + tid]) : 0.f;

  float acc[T::RPW][BN / 2];
#pragma unroll
  for (int r = 0; r < T::RPW; ++r)
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[r][i] = 0.f;

  // the ring: chunk k lies in stage k % STAGES; STAGES - 1 chunks are in
  // flight ahead of the one being multiplied.  One commit group per chunk
  // (empty past the last), so wait_group STAGES - 2 means chunk k landed.
  const int nchunks = (C + KC - 1) / KC;
#pragma unroll
  for (int k = 0; k < STAGES - 1; ++k) {
    if (k < nchunks)
      load_stage<BN>(s0 + k * T::STAGE, smem + k * T::STAGE, xi, w, H, W, C,
                     Cout, h0, w0, co0, k * KC, tid);
    cp_async_commit();
  }
  for (int k = 0; k < nchunks; ++k) {
    // chunk k has landed and every warpgroup has retired its wgmmas of
    // chunk k-1, so that chunk's stage may be overwritten
    cp_async_wait<STAGES - 2>();
    fence_proxy_async();
    __syncthreads();
    const uint32_t sa = s0 + (k % STAGES) * T::STAGE;
#pragma unroll
    for (int r = 0; r < T::RPW; ++r) fence_acc<BN / 2>(acc[r]);
    wgmma_fence();
#pragma unroll
    for (int di = 0; di < 3; ++di) {
#pragma unroll
      for (int dj = 0; dj < 3; ++dj) {
        const uint64_t b = desc(
            sa + T::A_BYTES + (di * 3 + dj) * (KC / 8) * T::NG * 128,
            BN * 16, 128);
#pragma unroll
        for (int r = 0; r < T::RPW; ++r) {
          const uint64_t a = desc(
              sa + ((g * T::RPW + r + di) * HP + dj) * GROUP, T::PLANE, 128);
          wgmma<BN>(acc[r], a, b);
        }
      }
    }
    wgmma_commit();
    // copy chunk k + STAGES - 1 while the tensor cores work on chunk k
    const int kn = k + STAGES - 1;
    if (kn < nchunks) {
      const int s = kn % STAGES;
      load_stage<BN>(s0 + s * T::STAGE, smem + s * T::STAGE, xi, w, H, W,
                     C, Cout, h0, w0, co0, kn * KC, tid);
    }
    cp_async_commit();
    wgmma_wait_all();
#pragma unroll
    for (int r = 0; r < T::RPW; ++r) fence_acc<BN / 2>(acc[r]);
  }

  // epilogue: + bias, ReLU, one rounding, through an output tile
  // [TH * TW pixels][PITCH] in the stages' memory
  cp_async_wait<0>();
  __syncthreads();  // every warpgroup is done reading the stages
  bf16* ot = reinterpret_cast<bf16*>(smem);
  const int lane = tid % 32;
  const int q = (lane % 4) * 2;
#pragma unroll
  for (int r = 0; r < T::RPW; ++r) {
    const int m0 = (g * T::RPW + r) * TW + ((tid % 128) / 32) * 16 + lane / 4;
#pragma unroll
    for (int j = 0; j < T::NG; ++j) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int n = j * 8 + q;
        float v0 = acc[r][j * 4 + i * 2] + bias_s[n];
        float v1 = acc[r][j * 4 + i * 2 + 1] + bias_s[n + 1];
        if (relu) {
          v0 = fmaxf(v0, 0.f);
          v1 = fmaxf(v1, 0.f);
        }
        *reinterpret_cast<__nv_bfloat162*>(ot + (m0 + 8 * i) * T::PITCH +
                                           n) = __floats2bfloat162_rn(v0, v1);
      }
    }
  }
  __syncthreads();
  const bool vec = Cout % 8 == 0;
  for (int e = tid; e < T::TH * TW * T::NG; e += T::NT) {
    const int p = e / T::NG, n8 = e % T::NG;
    const int oh = h0 + p / TW, ow = w0 + p % TW, co = co0 + n8 * 8;
    if (oh >= H || ow >= W || co >= Cout) continue;
    bf16* o = out + ((img * H + oh) * W + ow) * Cout + co;
    const bf16* s = ot + p * T::PITCH + n8 * 8;
    if (vec) {
      *reinterpret_cast<uint4*>(o) = *reinterpret_cast<const uint4*>(s);
    } else {
      for (int j = 0; j < 8 && co + j < Cout; ++j) o[j] = s[j];
    }
  }
}

template <int BN>
int launch(const bf16* x, const bf16* w, const bf16* b, bf16* out,
           long long B, int H, int W, int C, int Cout, int relu,
           cudaStream_t s) {
  using T = Tile<BN>;
  const int tiles_w = (W + TW - 1) / TW;
  const long long tiles_per_img =
      (long long)((H + T::TH - 1) / T::TH) * tiles_w;
  const int n_tiles = (Cout + BN - 1) / BN;
  const long long blocks = B * tiles_per_img * n_tiles;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidConfiguration;
  cudaError_t e = cudaFuncSetAttribute(
      wgmma_kernel<BN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      T::SMEM);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(wgmma_kernel<BN>,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return (int)e;
  wgmma_kernel<BN><<<(unsigned)blocks, T::NT, T::SMEM, s>>>(
      x, w, b, out, H, W, C, Cout, tiles_w, (int)tiles_per_img, n_tiles,
      relu);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int reflect_conv3x3_wgmma_bf16(const void* x, const void* w, const void* b,
                               void* out, long long B, int H, int W, int C,
                               int Cout, int relu, void* stream) {
  if (B <= 0 || H < 2 || W < 2 || C < 16 || C % 8 != 0 || Cout <= 0)
    return (int)cudaErrorInvalidValue;
  const bf16* xt = static_cast<const bf16*>(x);
  const bf16* wt = static_cast<const bf16*>(w);
  const bf16* bt = static_cast<const bf16*>(b);
  bf16* ot = static_cast<bf16*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Cout <= 64)
    return launch<64>(xt, wt, bt, ot, B, H, W, C, Cout, relu, s);
  return launch<128>(xt, wt, bt, ot, B, H, W, C, Cout, relu, s);
}

}  // extern "C"
