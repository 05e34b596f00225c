// GF(2^8) byte-matrix product over stripes, hand-written for Hopper (sm_90a).
//
//   out[s, i, :] = XOR_j mat[i, j] * in[s, row(j), :]     over GF(2^8)/0x11d
//
// Two entry points share one kernel template:
//   gf_matmul_k1  row(j) = j         data (S, k, N) -> out (S, r, N)
//     replaces ceph_tpu/ec/kernels/bitmatmul.py::_gf_kernel_planar
//     (encode parity rows, staged decode);
//   gf_matmul_k2  row(j) = sel[j]    data (S, n, N) -> out (S, r, N)
//     replaces ceph_tpu/ec/kernels/bitmatmul.py::_gf_kernel_planar_select
//     (staging-free decode straight from the full-width arrival block:
//     rows outside `sel`, the erased slots, are never read).
//
// Design.  The TPU kernels lift the product to a GF(2) bit-plane matmul
// because the MXU only multiplies integers; that layout came from the
// TPU compiler's limits, not from the arithmetic.  Here each coefficient
// c = mat[i, j] gets ISA-L's split-nibble table pair (the pshufb scheme of
// native/gf_avx2.c): lo[x] = c * x and hi[x] = c * (x << 4) for x < 16, so
// c * b = lo[b & 15] ^ hi[b >> 4].  The r*k*32 bytes of tables are built
// on the host once per matrix and copied into shared memory by every
// block.  A warp's lookups into one 32-byte table pair touch at most 8
// words in 8 distinct banks, so they never conflict.
//
// Work split: each thread owns 16 contiguous bytes of one stripe, reads
// them from each of the k input rows (one 16-byte load when the rows are
// 16-byte aligned, bytes with a bound check otherwise, so any N works),
// and keeps its R <= 8 output rows in registers.  More output rows are
// done by further launches of R rows each.  Grid:
// (ceil(N / (16 * threads)), S), stripes above 65535 in further launches.
//
// Bound on the card: bytes.  Encode at k=8, r=4 moves (k + r) bytes per
// byte column and does 2*k*r table lookups for it, so each byte of
// device-memory traffic costs ~5 shared-memory loads; the roofline is
// device memory, the likely limit of this simple form is shared-memory
// load issue.
//
// Plain C interface, bound with ctypes; launches on the caller's stream,
// does not synchronise, allocates nothing.  Each function returns the
// cudaError_t of its launches (0 on success).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBytes = 16;     // bytes of one row a thread owns
constexpr int kMaxRows = 8;    // output rows held in registers per launch
constexpr long long kMaxGridY = 65535;

template <int R>
__device__ __forceinline__ void accumulate(const uint8_t* tab, int k, int j,
                                           const uint32_t (&w)[4],
                                           uint32_t (&acc)[R][4]) {
#pragma unroll
  for (int q = 0; q < 4; ++q) {
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const uint32_t x = (w[q] >> (8 * b)) & 0xffu;
      const uint32_t lo = x & 15u;
      const uint32_t hi = 16u + (x >> 4);
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const uint8_t* t = tab + (i * k + j) * 32;
        acc[i][q] ^= static_cast<uint32_t>(t[lo] ^ t[hi]) << (8 * b);
      }
    }
  }
}

// tables: (R, k, 32) bytes for this launch's R rows.  sel: k row indexes
// into the n_in rows of a stripe (SELECT only).  out rows row0..row0+R-1
// of an (S, r_total, N) array.
template <int R, bool SELECT>
__global__ void __launch_bounds__(kThreads)
gf_matmul_kernel(const uint8_t* __restrict__ tables, int k, int n_in,
                 const int* __restrict__ sel,
                 const uint8_t* __restrict__ data, uint8_t* __restrict__ out,
                 int r_total, int row0, long long stripe0, long long N,
                 int vec) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int tab_words = R * k * 8;
  uint32_t* tab_w = reinterpret_cast<uint32_t*>(smem);
  const uint32_t* src_w = reinterpret_cast<const uint32_t*>(tables);
  for (int t = threadIdx.x; t < tab_words; t += blockDim.x) tab_w[t] = src_w[t];
  int* s_sel = reinterpret_cast<int*>(smem + tab_words * 4);
  if (SELECT) {
    for (int j = threadIdx.x; j < k; j += blockDim.x) s_sel[j] = sel[j];
  }
  __syncthreads();

  const long long base =
      (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) * kBytes;
  if (base >= N) return;
  const long long s = stripe0 + blockIdx.y;
  const uint8_t* in_s = data + s * n_in * N + base;
  uint8_t* out_s = out + (s * r_total + row0) * N + base;

  uint32_t acc[R][4];
#pragma unroll
  for (int i = 0; i < R; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0u;

  if (vec && base + kBytes <= N) {
    for (int j = 0; j < k; ++j) {
      const int row = SELECT ? s_sel[j] : j;
      const uint4 v = __ldg(reinterpret_cast<const uint4*>(in_s + row * N));
      const uint32_t w[4] = {v.x, v.y, v.z, v.w};
      accumulate<R>(smem, k, j, w, acc);
    }
#pragma unroll
    for (int i = 0; i < R; ++i) {
      *reinterpret_cast<uint4*>(out_s + i * N) =
          make_uint4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    }
    return;
  }

  // ragged tail or unaligned rows: byte loads and stores, bounded.  The
  // byte loops are unrolled so that w and acc keep constant indexes and
  // stay in registers.
  const int cnt = static_cast<int>(N - base < kBytes ? N - base : kBytes);
  for (int j = 0; j < k; ++j) {
    const int row = SELECT ? s_sel[j] : j;
    const uint8_t* p = in_s + row * N;
    uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int b = 0; b < kBytes; ++b) {
      if (b < cnt) w[b >> 2] |= static_cast<uint32_t>(p[b]) << (8 * (b & 3));
    }
    accumulate<R>(smem, k, j, w, acc);
  }
#pragma unroll
  for (int i = 0; i < R; ++i) {
#pragma unroll
    for (int b = 0; b < kBytes; ++b) {
      if (b < cnt) {
        out_s[i * N + b] = static_cast<uint8_t>(acc[i][b >> 2] >> (8 * (b & 3)));
      }
    }
  }
}

template <int R, bool SELECT>
cudaError_t launch_rows(dim3 grid, size_t smem, cudaStream_t stream,
                        const uint8_t* tables, int k, int n_in, const int* sel,
                        const uint8_t* data, uint8_t* out, int r_total,
                        int row0, long long stripe0, long long N, int vec) {
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        gf_matmul_kernel<R, SELECT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  gf_matmul_kernel<R, SELECT><<<grid, kThreads, smem, stream>>>(
      tables, k, n_in, sel, data, out, r_total, row0, stripe0, N, vec);
  return cudaGetLastError();
}

template <bool SELECT>
cudaError_t launch(const uint8_t* tables, int r, int k, int n_in,
                   const int* sel, const uint8_t* data, uint8_t* out,
                   long long S, long long N, cudaStream_t stream) {
  if (r <= 0 || k <= 0 || S < 0 || N < 0) return cudaErrorInvalidValue;
  if (S == 0 || N == 0) return cudaSuccess;
  const long long per_block = static_cast<long long>(kThreads) * kBytes;
  const long long gx = (N + per_block - 1) / per_block;
  if (gx > 0x7fffffffLL) return cudaErrorInvalidValue;
  const int vec = (N % kBytes == 0) &&
                  (reinterpret_cast<uintptr_t>(data) % kBytes == 0) &&
                  (reinterpret_cast<uintptr_t>(out) % kBytes == 0);
  for (int row0 = 0; row0 < r; row0 += kMaxRows) {
    const int rows = r - row0 < kMaxRows ? r - row0 : kMaxRows;
    const size_t smem = static_cast<size_t>(rows) * k * 32 +
                        (SELECT ? static_cast<size_t>(k) * 4 : 0);
    const uint8_t* tab = tables + static_cast<size_t>(row0) * k * 32;
    for (long long s0 = 0; s0 < S; s0 += kMaxGridY) {
      const long long gy = S - s0 < kMaxGridY ? S - s0 : kMaxGridY;
      const dim3 grid(static_cast<unsigned>(gx), static_cast<unsigned>(gy));
      cudaError_t err;
      switch (rows) {
#define GF_CASE(RR)                                                          \
  case RR:                                                                   \
    err = launch_rows<RR, SELECT>(grid, smem, stream, tab, k, n_in, sel,     \
                                  data, out, r, row0, s0, N, vec);           \
    break;
        GF_CASE(1) GF_CASE(2) GF_CASE(3) GF_CASE(4)
        GF_CASE(5) GF_CASE(6) GF_CASE(7) GF_CASE(8)
#undef GF_CASE
        default:
          return cudaErrorInvalidValue;
      }
      if (err != cudaSuccess) return err;
    }
  }
  return cudaSuccess;
}

}  // namespace

extern "C" {

int gf_matmul_k1(const void* tables, int r, int k, const void* data, void* out,
                 long long S, long long N, void* stream) {
  return static_cast<int>(launch<false>(
      static_cast<const uint8_t*>(tables), r, k, k, nullptr,
      static_cast<const uint8_t*>(data), static_cast<uint8_t*>(out), S, N,
      static_cast<cudaStream_t>(stream)));
}

int gf_matmul_k2(const void* tables, int r, int k, int n, const void* sel,
                 const void* data, void* out, long long S, long long N,
                 void* stream) {
  return static_cast<int>(launch<true>(
      static_cast<const uint8_t*>(tables), r, k, n,
      static_cast<const int*>(sel), static_cast<const uint8_t*>(data),
      static_cast<uint8_t*>(out), S, N, static_cast<cudaStream_t>(stream)));
}

const char* gf_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
