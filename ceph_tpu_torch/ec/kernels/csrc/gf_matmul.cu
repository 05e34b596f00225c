// GF(2^8) byte-matrix product over stripes, hand-written for Hopper (sm_90a).
//
//   out[s, i, :] = XOR_j mat[i, j] * in[s, row(j), :]     over GF(2^8)/0x11d
//
// Two entry points, one kernel each:
//   gf_matmul_k1  row(j) = j         data (S, k, N) -> out (S, r, N)
//     replaces ceph_tpu/ec/kernels/bitmatmul.py::_gf_kernel_planar
//     (encode parity rows, staged decode);
//   gf_matmul_k2  row(j) = sel[j]    data (S, n, N) -> out (S, r, N)
//     replaces ceph_tpu/ec/kernels/bitmatmul.py::_gf_kernel_planar_select
//     (staging-free decode straight from the full-width arrival block:
//     rows outside `sel`, the erased slots, are never read).
//
// Both use ISA-L's split-nibble tables (the pshufb scheme of
// native/gf_avx2.c): for c = mat[i, j], lo[x] = c * x and hi[x] = c * (x << 4)
// for x < 16, so c * b = lo[b & 15] ^ hi[b >> 4].  The TPU kernels lift the
// product to a GF(2) bit-plane matmul because the MXU only multiplies
// integers; that layout came from the TPU compiler's limits, not from the
// arithmetic.  Tables are built on the host once per matrix and copied
// into shared memory by every block.
//
// Bound on the card: bytes.  Encode at k=8, r=4 moves (k + r) bytes per
// byte column and does one GF multiply-add per output byte per input row;
// the limit of a table kernel is how many shared-memory lookups and
// integer instructions it spends per byte of device-memory traffic.
//
// K1, row-packed.  One table entry holds the products of one input row j
// and one nibble value for ALL output rows of the launch, one byte per
// row: W = 4 bytes for r <= 4, W = 8 (LDS.64) for r <= 8; more rows go to
// further launches of 8.  Per input byte that is 2 lookups for every
// output row at once (16 per byte column at k=8, where a lookup per row
// per nibble would take 2*k*r = 64).  Per input word w the nibble
// offsets come from one shift and one AND, e.g. (w << 2) & 0x3c3c3c3c;
// one prmt then takes a byte of it and adds the input-row group's table
// base (a multiple of 256) in the same instruction, and the row within
// the group and the hi half fold into the LDS immediate, so a byte costs
// 2 prmt, 2 LDS and one 3-input XOR.  A 16-entry table spans 16 (W=4) or
// 32 (W=8) consecutive banks, so a warp's lookups never conflict.  The
// accumulator of a byte column holds its W output bytes; at the end 4x4
// byte transposes (8 prmt per 16 bytes) turn them into per-row 16-byte
// stores.  Each thread owns kK1Bytes columns of one stripe and loads a
// group of kK1Group input rows before looking any of them up, so those
// loads are in flight together.  At k=8 the lookups and the integer work
// each take about half the time the card needs to move the bytes, so K1
// is bytes-bound: on an H100 80GB HBM3 (700 W) it runs about as fast as
// a device-to-device copy of as many bytes (PERF.md,
// scripts/torch_k1_probe.py).
//
// K2 keeps the simpler form of the first port: one 32-byte table pair per
// (output row, input row), two byte lookups per input byte per output row.
//
// Ragged N and unaligned rows stay in both kernels: 16-byte loads and
// stores when N % 16 == 0 and both pointers are 16-byte aligned, byte
// loads and stores with a bound otherwise.  Stripes above 65535 go to
// further launches (grid.y).
//
// Plain C interface, bound with ctypes; launches on the caller's stream,
// does not synchronise, allocates nothing.  Each function returns the
// cudaError_t of its launches (0 on success).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxRows = 8;    // output rows per launch
constexpr long long kMaxGridY = 65535;

// ---------------------------------------------------------------------------
// K1
// ---------------------------------------------------------------------------

constexpr int kK1Bytes = 16;   // bytes of one row a thread owns
constexpr int kK1Group = 4;    // input rows loaded before their lookups
static_assert(kK1Group % 2 == 0,
              "a group's table base must stay a multiple of 256 bytes");

// Each byte of the result is (the lo resp. hi nibble of that byte of w) * W.
template <int W>
__device__ __forceinline__ uint32_t lo_offsets(uint32_t w) {
  return W == 4 ? (w << 2) & 0x3c3c3c3cu : (w << 3) & 0x78787878u;
}
template <int W>
__device__ __forceinline__ uint32_t hi_offsets(uint32_t w) {
  return W == 4 ? (w >> 2) & 0x3c3c3c3cu : (w >> 1) & 0x78787878u;
}

// acc[b] ^= lo entry of byte b of w ^ hi entry of it, for b < 4.  row is
// one input row's table (16 lo entries, then 16 hi entries) minus rel;
// rel is a multiple of 256, so prmt puts it beside a byte offset.
template <int W>
__device__ __forceinline__ void lookup4(const uint8_t* row, uint32_t rel,
                                        uint32_t w, uint32_t (*acc)[W / 4]) {
  const uint32_t lo = lo_offsets<W>(w);
  const uint32_t hi = hi_offsets<W>(w);
#pragma unroll
  for (int b = 0; b < 4; ++b) {
    const uint32_t a = __byte_perm(lo, rel, 0x7650 + b);
    const uint32_t c = __byte_perm(hi, rel, 0x7650 + b);
    if constexpr (W == 4) {
      acc[b][0] ^= *reinterpret_cast<const uint32_t*>(row + a) ^
                   *reinterpret_cast<const uint32_t*>(row + 16 * W + c);
    } else {
      const uint2 x = *reinterpret_cast<const uint2*>(row + a);
      const uint2 y = *reinterpret_cast<const uint2*>(row + 16 * W + c);
      acc[b][0] ^= x.x ^ y.x;
      acc[b][1] ^= x.y ^ y.y;
    }
  }
}

// 4x4 byte transpose: byte i of c[j] goes to byte j of c[i].
__device__ __forceinline__ void transpose4(uint32_t (&c)[4]) {
  const uint32_t t0 = __byte_perm(c[0], c[1], 0x5140);
  const uint32_t t1 = __byte_perm(c[0], c[1], 0x7362);
  const uint32_t t2 = __byte_perm(c[2], c[3], 0x5140);
  const uint32_t t3 = __byte_perm(c[2], c[3], 0x7362);
  c[0] = __byte_perm(t0, t2, 0x5410);
  c[1] = __byte_perm(t0, t2, 0x7632);
  c[2] = __byte_perm(t1, t3, 0x5410);
  c[3] = __byte_perm(t1, t3, 0x7632);
}

// kK1Bytes bytes of one input row; FULL: 16-byte loads, else the first
// cnt bytes one by one (the rest 0).  Unrolled so that w keeps constant
// indexes and stays in registers.
template <bool FULL>
__device__ __forceinline__ void load_row(const uint8_t* p, int cnt,
                                         uint32_t (&w)[kK1Bytes / 4]) {
  if constexpr (FULL) {
#pragma unroll
    for (int v = 0; v < kK1Bytes / 16; ++v) {
      const uint4 x = __ldg(reinterpret_cast<const uint4*>(p) + v);
      w[4 * v] = x.x;
      w[4 * v + 1] = x.y;
      w[4 * v + 2] = x.z;
      w[4 * v + 3] = x.w;
    }
  } else {
#pragma unroll
    for (int q = 0; q < kK1Bytes / 4; ++q) w[q] = 0u;
#pragma unroll
    for (int b = 0; b < kK1Bytes; ++b) {
      if (b < cnt) w[b >> 2] |= static_cast<uint32_t>(p[b]) << (8 * (b & 3));
    }
  }
}

// One thread's byte columns of one stripe through all k input rows, into
// `rows` output rows.  tab: the launch's (k, 2, 16, W) tables in shared
// memory.  in, out: the thread's first column of input row 0 and output
// row 0; rows are N bytes apart.
template <int W, bool FULL>
__device__ __forceinline__ void k1_columns(const uint8_t* tab, int k,
                                           const uint8_t* in, uint8_t* out,
                                           long long N, int rows, int cnt) {
  constexpr int kRow = 32 * W;   // table bytes of one input row
  uint32_t acc[kK1Bytes][W / 4];
#pragma unroll
  for (int b = 0; b < kK1Bytes; ++b) {
#pragma unroll
    for (int h = 0; h < W / 4; ++h) acc[b][h] = 0u;
  }

  for (int j0 = 0; j0 < k; j0 += kK1Group) {
    uint32_t w[kK1Group][kK1Bytes / 4];
#pragma unroll
    for (int jj = 0; jj < kK1Group; ++jj) {
      if (j0 + jj < k) load_row<FULL>(in + (j0 + jj) * N, cnt, w[jj]);
    }
    const uint32_t rel = static_cast<uint32_t>(j0) * kRow;
#pragma unroll
    for (int jj = 0; jj < kK1Group; ++jj) {
      if (j0 + jj < k) {
#pragma unroll
        for (int q = 0; q < kK1Bytes / 4; ++q) {
          lookup4<W>(tab + jj * kRow, rel, w[jj][q], acc + 4 * q);
        }
      }
    }
  }

  if constexpr (FULL) {
    uint32_t o[W][kK1Bytes / 4];   // o[i][q]: row i, columns 4q .. 4q+3
#pragma unroll
    for (int h = 0; h < W / 4; ++h) {
#pragma unroll
      for (int q = 0; q < kK1Bytes / 4; ++q) {
        uint32_t c[4] = {acc[4 * q][h], acc[4 * q + 1][h], acc[4 * q + 2][h],
                         acc[4 * q + 3][h]};
        transpose4(c);
#pragma unroll
        for (int i = 0; i < 4; ++i) o[4 * h + i][q] = c[i];
      }
    }
#pragma unroll
    for (int i = 0; i < W; ++i) {
      if (i < rows) {
#pragma unroll
        for (int v = 0; v < kK1Bytes / 16; ++v) {
          reinterpret_cast<uint4*>(out + i * N)[v] =
              make_uint4(o[i][4 * v], o[i][4 * v + 1], o[i][4 * v + 2],
                         o[i][4 * v + 3]);
        }
      }
    }
  } else {
#pragma unroll
    for (int i = 0; i < W; ++i) {
      if (i < rows) {
#pragma unroll
        for (int b = 0; b < kK1Bytes; ++b) {
          if (b < cnt) {
            out[i * N + b] =
                static_cast<uint8_t>(acc[b][i >> 2] >> (8 * (i & 3)));
          }
        }
      }
    }
  }
}

// tables: (k, 2, 16, W) bytes for this launch's `rows` output rows, which
// are rows row0 .. row0+rows-1 of an (S, r_total, N) output.
template <int W>
__global__ void __launch_bounds__(kThreads)
gf_k1_kernel(const uint8_t* __restrict__ tables, int k,
             const uint8_t* __restrict__ data, uint8_t* __restrict__ out,
             int r_total, int row0, int rows, long long stripe0, long long N,
             int vec) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int tab_vecs = k * 2 * W;   // k * 32 * W bytes
  const uint4* src = reinterpret_cast<const uint4*>(tables);
  uint4* dst = reinterpret_cast<uint4*>(smem);
  for (int t = threadIdx.x; t < tab_vecs; t += kThreads) dst[t] = src[t];
  __syncthreads();

  const long long base =
      (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) * kK1Bytes;
  if (base >= N) return;
  const long long s = stripe0 + blockIdx.y;
  const uint8_t* in_s = data + s * k * N + base;
  uint8_t* out_s = out + (s * r_total + row0) * N + base;
  if (vec && base + kK1Bytes <= N) {
    k1_columns<W, true>(smem, k, in_s, out_s, N, rows, kK1Bytes);
  } else {
    const int cnt = static_cast<int>(N - base < kK1Bytes ? N - base : kK1Bytes);
    k1_columns<W, false>(smem, k, in_s, out_s, N, rows, cnt);
  }
}

template <int W>
cudaError_t launch_k1_rows(dim3 grid, size_t smem, cudaStream_t stream,
                           const uint8_t* tables, int k, const uint8_t* data,
                           uint8_t* out, int r_total, int row0, int rows,
                           long long stripe0, long long N, int vec) {
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        gf_k1_kernel<W>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  gf_k1_kernel<W><<<grid, kThreads, smem, stream>>>(
      tables, k, data, out, r_total, row0, rows, stripe0, N, vec);
  return cudaGetLastError();
}

// tables: ceil(r / 8) blocks of (k, 2, 16, W), W = 4 if r <= 4 else 8.
cudaError_t launch_k1(const uint8_t* tables, int r, int k,
                      const uint8_t* data, uint8_t* out, long long S,
                      long long N, cudaStream_t stream) {
  if (r <= 0 || k <= 0 || S < 0 || N < 0 ||
      reinterpret_cast<uintptr_t>(tables) % 16 != 0) {
    return cudaErrorInvalidValue;
  }
  if (S == 0 || N == 0) return cudaSuccess;
  const long long per_block = static_cast<long long>(kThreads) * kK1Bytes;
  const long long gx = (N + per_block - 1) / per_block;
  if (gx > 0x7fffffffLL) return cudaErrorInvalidValue;
  const int vec = (N % 16 == 0) &&
                  (reinterpret_cast<uintptr_t>(data) % 16 == 0) &&
                  (reinterpret_cast<uintptr_t>(out) % 16 == 0);
  const int W = r <= 4 ? 4 : 8;
  const size_t tab_bytes = static_cast<size_t>(k) * 32 * W;
  for (int row0 = 0; row0 < r; row0 += kMaxRows) {
    const int rows = r - row0 < kMaxRows ? r - row0 : kMaxRows;
    const uint8_t* tab = tables + (row0 / kMaxRows) * tab_bytes;
    for (long long s0 = 0; s0 < S; s0 += kMaxGridY) {
      const long long gy = S - s0 < kMaxGridY ? S - s0 : kMaxGridY;
      const dim3 grid(static_cast<unsigned>(gx), static_cast<unsigned>(gy));
      const cudaError_t err =
          W == 4 ? launch_k1_rows<4>(grid, tab_bytes, stream, tab, k, data,
                                     out, r, row0, rows, s0, N, vec)
                 : launch_k1_rows<8>(grid, tab_bytes, stream, tab, k, data,
                                     out, r, row0, rows, s0, N, vec);
      if (err != cudaSuccess) return err;
    }
  }
  return cudaSuccess;
}

// ---------------------------------------------------------------------------
// K2
// ---------------------------------------------------------------------------

constexpr int kBytes = 16;     // bytes of one row a thread owns

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
// into the n_in rows of a stripe.  out rows row0..row0+R-1 of an
// (S, r_total, N) array.
template <int R>
__global__ void __launch_bounds__(kThreads)
gf_k2_kernel(const uint8_t* __restrict__ tables, int k, int n_in,
             const int* __restrict__ sel,
             const uint8_t* __restrict__ data, uint8_t* __restrict__ out,
             int r_total, int row0, long long stripe0, long long N, int vec) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int tab_words = R * k * 8;
  uint32_t* tab_w = reinterpret_cast<uint32_t*>(smem);
  const uint32_t* src_w = reinterpret_cast<const uint32_t*>(tables);
  for (int t = threadIdx.x; t < tab_words; t += blockDim.x) tab_w[t] = src_w[t];
  int* s_sel = reinterpret_cast<int*>(smem + tab_words * 4);
  for (int j = threadIdx.x; j < k; j += blockDim.x) s_sel[j] = sel[j];
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
      const int row = s_sel[j];
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
    const int row = s_sel[j];
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

template <int R>
cudaError_t launch_k2_rows(dim3 grid, size_t smem, cudaStream_t stream,
                           const uint8_t* tables, int k, int n_in,
                           const int* sel, const uint8_t* data, uint8_t* out,
                           int r_total, int row0, long long stripe0,
                           long long N, int vec) {
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        gf_k2_kernel<R>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  gf_k2_kernel<R><<<grid, kThreads, smem, stream>>>(
      tables, k, n_in, sel, data, out, r_total, row0, stripe0, N, vec);
  return cudaGetLastError();
}

cudaError_t launch_k2(const uint8_t* tables, int r, int k, int n_in,
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
                        static_cast<size_t>(k) * 4;
    const uint8_t* tab = tables + static_cast<size_t>(row0) * k * 32;
    for (long long s0 = 0; s0 < S; s0 += kMaxGridY) {
      const long long gy = S - s0 < kMaxGridY ? S - s0 : kMaxGridY;
      const dim3 grid(static_cast<unsigned>(gx), static_cast<unsigned>(gy));
      cudaError_t err;
      switch (rows) {
#define GF_CASE(RR)                                                          \
  case RR:                                                                   \
    err = launch_k2_rows<RR>(grid, smem, stream, tab, k, n_in, sel, data,    \
                             out, r, row0, s0, N, vec);                      \
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
  return static_cast<int>(launch_k1(
      static_cast<const uint8_t*>(tables), r, k,
      static_cast<const uint8_t*>(data), static_cast<uint8_t*>(out), S, N,
      static_cast<cudaStream_t>(stream)));
}

int gf_matmul_k2(const void* tables, int r, int k, int n, const void* sel,
                 const void* data, void* out, long long S, long long N,
                 void* stream) {
  return static_cast<int>(launch_k2(
      static_cast<const uint8_t*>(tables), r, k, n,
      static_cast<const int*>(sel), static_cast<const uint8_t*>(data),
      static_cast<uint8_t*>(out), S, N, static_cast<cudaStream_t>(stream)));
}

const char* gf_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
