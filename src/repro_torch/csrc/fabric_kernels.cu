// Hand-written CUDA kernels for the fabric simulator's batched sweep:
// the waterfilling allocator family and the busy-segment overlap
// reduction. Built for sm_90a by repro_torch/fabric/backend/cuda_kernels.py
// with
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -fmad=false
//        -shared -Xcompiler -fPIC
//
// -fmad=false and the absence of --use_fast_math are part of the contract:
// the allocators promise bit-identical results to the Python reference
// loops under float64 (the "exact" equivalence tier), and a multiply fused
// into the following subtract or add rounds once where the reference rounds
// twice. Division and square root keep their IEEE defaults
// (-prec-div=true, -ftz=false).
//
// The interface is plain C (extern "C" launchers returning the value of
// cudaGetLastError()), loaded with ctypes. A launcher allocates nothing and
// never synchronises; it enqueues on the stream it is given.
//
// Shape of the allocators: ONE THREAD PER ROW. A row is one (variant,
// link) allocation over n <= MAX_FLOWS flows. Its work is a short, strictly
// sequential, data-dependent chain (sort order, then a fill whose every
// step needs the previous step's carry), so there is nothing inside a row
// to spread across threads without changing the order of the arithmetic;
// the parallelism is across the rows of the sweep. The overlap reduction
// (K3) sums a row of S slots in slot order too, but its rows are long: a
// warp stages tiles of 32 rows through shared memory so that its loads are
// coalesced, and each lane then sums its own row (see its note).

#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>

#define MAX_FLOWS 32
#define BLOCK_THREADS 128

// ---------------------------------------------------------------------------
// The shared fill: one progressive fill of a row's n demands d[] against
// `remaining` capacity with weights w[]; writes alloc[] in flow order.
//
//   rank   stable ascending rank of d/w by O(n^2) comparison, ties broken
//          by flow index (Python sorted()'s order)
//   w_left left-to-right sum of w in flow order
//   fill   for each rank position, in order:
//            fair = w_left > 0 ? remaining * wj / w_left : remaining
//            give = dj < fair ? dj : fair
//            remaining -= give;  w_left -= wj
//
// A thread owns its row, so position p's flow is read by index (order[p]);
// there is no masked-sum selection as a vector machine would need.
// ---------------------------------------------------------------------------
template <typename T>
__device__ __forceinline__ void fill_row(const T* d, const T* w, int n,
                                         T remaining, T* alloc) {
  int order[MAX_FLOWS];
  T key[MAX_FLOWS];
  for (int j = 0; j < n; ++j) {
    key[j] = d[j] / w[j];
    order[j] = j;
  }
  for (int j = 0; j < n; ++j) {
    int rank = 0;
    const T kj = key[j];
    for (int k = 0; k < n; ++k) {
      const T kk = key[k];
      rank += (kk < kj || (kk == kj && k < j)) ? 1 : 0;
    }
    order[rank] = j;
  }
  T w_left = T(0);
  for (int j = 0; j < n; ++j) w_left = w_left + w[j];
  for (int p = 0; p < n; ++p) {
    const int j = order[p];
    const T dj = d[j];
    const T wj = w[j];
    T fair = remaining;
    if (w_left > T(0)) {
      const T num = remaining * wj;
      fair = num / w_left;
    }
    const T give = dj < fair ? dj : fair;
    alloc[j] = give;
    remaining = remaining - give;
    w_left = w_left - wj;
  }
}

// ---------------------------------------------------------------------------
// K1 waterfill — replaces the TPU kernel `_waterfill_kernel`
// (src/repro/fabric/backend/pallas_kernels.py, with `_fill_tile` and
// `_stable_rank`). Serves maxmin_shares (w == nullptr: unit weights) and
// wfq_shares.
//
// Bound on this card: bytes. A row reads n demands, up to n weights and one
// capacity and writes n allocations; at the sweep's shapes (4096*9 rows of
// 4 flows) that is a few MB at 3.35 TB/s, i.e. around a microsecond, so
// the floor in practice is the few microseconds of a kernel launch, not
// bandwidth and not arithmetic. The design therefore keeps everything a row
// needs in the thread's registers/local arrays, makes exactly one pass over
// global memory, needs no row padding (the ragged tail is the bounds check
// below) and no scratch. Weights shared by a group of rows (one weight
// vector per variant against that variant's links) are read through
// `rows_per_w` instead of being expanded in memory: row r uses weight row
// r / rows_per_w. Capacity is an array (cap != nullptr) or one scalar.
// ---------------------------------------------------------------------------
template <typename T>
__global__ void waterfill_kernel(const T* __restrict__ d,
                                 const T* __restrict__ w,
                                 const T* __restrict__ cap, T cap_scalar,
                                 T* __restrict__ out, long long rows, int n,
                                 long long rows_per_w) {
  const long long r = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (r >= rows) return;
  T dr[MAX_FLOWS], wr[MAX_FLOWS], alloc[MAX_FLOWS];
  const T* drow = d + r * n;
  const T* wrow = w ? w + (r / rows_per_w) * n : nullptr;
  for (int j = 0; j < n; ++j) {
    dr[j] = drow[j];
    wr[j] = wrow ? wrow[j] : T(1);
    alloc[j] = T(0);
  }
  fill_row<T>(dr, wr, n, cap ? cap[r] : cap_scalar, alloc);
  T* orow = out + r * n;
  for (int j = 0; j < n; ++j) orow[j] = alloc[j];
}

// ---------------------------------------------------------------------------
// K2 strict priority — replaces the TPU kernel `_strict_priority_kernel`
// (src/repro/fabric/backend/pallas_kernels.py). `masks` is the static
// descending class-mask matrix (C, n) built on the host from the concrete
// priorities. Per class: the shared fill over the full flow vector with
// non-class demands zeroed and unit weights (zero demands rank first and
// take nothing), masked back; the leftover capacity is re-derived by
// subtracting the class's allocations in flow-index order, then clamped at
// zero — the reference's order and rounding. The starved-class floor stays
// with the caller.
//
// Bound on this card: bytes, as K1 (n demands and one capacity in, n
// allocations out per row; the C*n mask bytes are shared by every row and
// stay in cache), and at the sweep's shapes a launch's latency is the floor.
// Design: same thread-per-row shape and the same __device__ fill as K1, the
// class loop inside the thread so that the per-class carry never leaves it.
// ---------------------------------------------------------------------------
template <typename T>
__global__ void strict_priority_kernel(const T* __restrict__ d,
                                       const unsigned char* __restrict__ masks,
                                       const T* __restrict__ cap,
                                       T cap_scalar, T* __restrict__ out,
                                       long long rows, int n, int n_classes) {
  const long long r = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (r >= rows) return;
  T dr[MAX_FLOWS], dm[MAX_FLOWS], ones[MAX_FLOWS], sub[MAX_FLOWS],
      alloc[MAX_FLOWS];
  const T* drow = d + r * n;
  for (int j = 0; j < n; ++j) {
    dr[j] = drow[j];
    ones[j] = T(1);
    alloc[j] = T(0);
  }
  T remaining = cap ? cap[r] : cap_scalar;
  for (int c = 0; c < n_classes; ++c) {
    const unsigned char* m = masks + c * n;
    for (int j = 0; j < n; ++j) {
      dm[j] = m[j] ? dr[j] : T(0);
      sub[j] = T(0);
    }
    fill_row<T>(dm, ones, n, remaining, sub);
    for (int j = 0; j < n; ++j) {
      sub[j] = m[j] ? sub[j] : T(0);
      alloc[j] = alloc[j] + sub[j];
    }
    for (int j = 0; j < n; ++j) remaining = remaining - sub[j];
    remaining = remaining < T(0) ? T(0) : remaining;
  }
  T* orow = out + r * n;
  for (int j = 0; j < n; ++j) orow[j] = alloc[j];
}

// ---------------------------------------------------------------------------
// K3 segment overlap — replaces the TPU kernel `_segment_overlap_kernel`
// (src/repro/fabric/backend/pallas_kernels.py). Per row:
//   sum_k max(0, min(e_i, ends[k]) - max(s_i, starts[k]))
// accumulated left to right over the slots k < n_filled (the reference's
// encounter order). An empty slot carries end = -inf and contributes a
// clamped 0, so the slots at and past n_filled, which the runner has not
// written yet, would each add +0.0 to a non-negative total: skipping them
// changes no bit.
//
// Rows. With a co-tenant index `co` (n_co entries), row r is the store's
// row (r / n_co) * J + co[r % n_co], read where it lies: the runner's
// (V, J, S) busy-segment store and one owner's co-tenants, with no gather.
// Without one, row r is the store's row r. The window of row r is
// s_i[(r / per_s) * stride_s] (e_i likewise): one window per variant, read
// through its stride.
//
// Bound on this card: bytes. On the runner's main path (4,096 variants,
// three co-tenants per owner, S = 400 slots) a call with every slot filled
// reads 2 * 12,288 * 400 float32 values, 39.3 MB: 0.0118 ms at 3.35 TB/s.
// At step t the sweep fills n_filled = t slots, half of them on average.
//
// Design. The first port (one thread per row walking its row in device
// memory) launched 96 blocks of 4 warps at that shape, and a warp's loads
// were a row (1,600 bytes) apart. Here:
//   - a block is one warp that owns 32 rows, so the 12,288-row call is 384
//     blocks;
//   - a pass stages 128 bytes of each of the warp's rows (32 float32 or 16
//     float64 slots) of `starts` and of `ends` into shared memory with
//     cp.async, 16 bytes a lane and 8 lanes a row, so every 128-byte line
//     that is read is used whole; a ring of three buffers keeps the next two
//     passes' loads in flight while this pass is summed;
//   - unit u (16 bytes) of row i is stored at unit u ^ (i & 7), so that a
//     quarter-warp's 16-byte reads of eight rows fall in distinct banks;
//   - each lane then adds its own row's clamped overlaps in slot order,
//     carrying the total across passes. Each overlap is the same three
//     correctly rounded operations as in the plain version, so the sums
//     are the plain version's bits.
// A store whose rows are not a whole number of 16-byte units, or that is
// not 16-byte aligned, is staged a value at a time into the same layout.
// ---------------------------------------------------------------------------
constexpr int OV_ROWS = 32;       // rows per block: one warp, a lane a row
constexpr int OV_BYTES = 128;     // bytes of a row staged per pass and array
constexpr int OV_STAGES = 3;      // passes in flight

template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
                 "l"(src)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(s),
                 "l"(src), "n"(BYTES)
                 : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

template <typename T>
__device__ __forceinline__ T overlap_add(T total, T si, T ei, T s, T e) {
  const T hi = ei < e ? ei : e;
  const T lo = si > s ? si : s;
  const T ov = hi - lo;
  return total + (ov > T(0) ? ov : T(0));
}

template <typename T, bool VEC>
__global__ void __launch_bounds__(OV_ROWS)
segment_overlap_kernel(const T* __restrict__ s_i, const T* __restrict__ e_i,
                       long long per_s, long long stride_s, long long per_e,
                       long long stride_e, const T* __restrict__ starts,
                       const T* __restrict__ ends,
                       const int* __restrict__ co, int n_co, int J,
                       long long row_len, int n_filled, T* __restrict__ out,
                       long long rows) {
  constexpr int NU = 16 / sizeof(T);          // values per 16-byte unit
  constexpr int TS = OV_BYTES / sizeof(T);    // slots per pass
  constexpr int UNITS = OV_BYTES / 16;        // units per row and pass
  __shared__ __align__(16) unsigned char ring[OV_STAGES][2]
                                             [OV_ROWS * OV_BYTES];
  __shared__ long long row_off[OV_ROWS];

  const int lane = threadIdx.x;
  const long long r0 = (long long)blockIdx.x * OV_ROWS;
  const long long r = r0 + lane;
  const bool live = r < rows;
  const int n_live = (int)min((long long)OV_ROWS, rows - r0);
  long long src = r;
  if (co != nullptr && live) src = (r / n_co) * J + co[r % n_co];
  row_off[lane] = src * row_len;
  const T si = live ? s_i[(r / per_s) * stride_s] : T(0);
  const T ei = live ? e_i[(r / per_e) * stride_e] : T(0);
  __syncwarp();

  const int passes = (n_filled + TS - 1) / TS;
  // issue pass p's copies into its ring buffer; one commit group per call,
  // empty past the last pass, so that the wait below counts passes
  auto stage = [&](int p) {
    if (p < passes) {
      const int k0 = p * TS;
      const int lim = n_filled - k0;          // slots of this pass to read
      unsigned char* bs = ring[p % OV_STAGES][0];
      unsigned char* be = ring[p % OV_STAGES][1];
      if constexpr (VEC) {
#pragma unroll
        for (int i = 0; i < OV_ROWS * UNITS / 32; ++i) {
          const int q = i * 32 + lane, row = q / UNITS, u = q % UNITS;
          if (row < n_live && u * NU < lim) {
            const long long g = row_off[row] + k0 + u * NU;
            const int at = row * OV_BYTES + ((u ^ (row & 7)) << 4);
            cp_async<16>(bs + at, starts + g);
            cp_async<16>(be + at, ends + g);
          }
        }
      } else {
#pragma unroll 4
        for (int i = 0; i < OV_ROWS * TS / 32; ++i) {
          const int q = i * 32 + lane, row = q / TS, kk = q % TS;
          if (row < n_live && kk < lim) {
            const long long g = row_off[row] + k0 + kk;
            const int at = row * OV_BYTES + (((kk / NU) ^ (row & 7)) << 4) +
                           (kk % NU) * (int)sizeof(T);
            cp_async<sizeof(T)>(bs + at, starts + g);
            cp_async<sizeof(T)>(be + at, ends + g);
          }
        }
      }
    }
    cp_async_commit();
  };

#pragma unroll
  for (int p = 0; p < OV_STAGES - 1; ++p) stage(p);
  T total = T(0);
  const int mine = lane * OV_BYTES, swz = lane & 7;
  for (int p = 0; p < passes; ++p) {
    stage(p + OV_STAGES - 1);
    cp_async_wait<OV_STAGES - 1>();           // pass p has landed
    __syncwarp();
    if (live) {
      const unsigned char* bs = ring[p % OV_STAGES][0] + mine;
      const unsigned char* be = ring[p % OV_STAGES][1] + mine;
      const int n = min(TS, n_filled - p * TS);
#pragma unroll
      for (int u = 0; u < UNITS; ++u) {
        const int at = (u ^ swz) << 4;
        const uint4 su = *reinterpret_cast<const uint4*>(bs + at);
        const uint4 eu = *reinterpret_cast<const uint4*>(be + at);
        T s[NU], e[NU];
        memcpy(s, &su, 16);
        memcpy(e, &eu, 16);
        if (n == TS) {
#pragma unroll
          for (int j = 0; j < NU; ++j)
            total = overlap_add(total, si, ei, s[j], e[j]);
        } else {
#pragma unroll
          for (int j = 0; j < NU; ++j)
            if (u * NU + j < n) total = overlap_add(total, si, ei, s[j], e[j]);
        }
      }
    }
    __syncwarp();                             // the buffer is free again
  }
  if (live) out[r] = total;
}

// ---------------------------------------------------------------------------
// launchers (plain C)
// ---------------------------------------------------------------------------

static inline unsigned int n_blocks(long long rows) {
  return (unsigned int)((rows + BLOCK_THREADS - 1) / BLOCK_THREADS);
}

template <typename T>
static int launch_waterfill(const void* d, const void* w, const void* cap,
                            double cap_scalar, void* out, long long rows,
                            int n, long long rows_per_w, void* stream) {
  if (rows <= 0 || n <= 0) return (int)cudaSuccess;
  if (n > MAX_FLOWS || rows_per_w <= 0) return (int)cudaErrorInvalidValue;
  waterfill_kernel<T><<<n_blocks(rows), BLOCK_THREADS, 0,
                        (cudaStream_t)stream>>>(
      (const T*)d, (const T*)w, (const T*)cap, (T)cap_scalar, (T*)out, rows,
      n, rows_per_w);
  return (int)cudaGetLastError();
}

template <typename T>
static int launch_strict_priority(const void* d, const void* masks,
                                  const void* cap, double cap_scalar,
                                  void* out, long long rows, int n,
                                  int n_classes, void* stream) {
  if (rows <= 0 || n <= 0) return (int)cudaSuccess;
  if (n > MAX_FLOWS || n_classes < 0) return (int)cudaErrorInvalidValue;
  strict_priority_kernel<T><<<n_blocks(rows), BLOCK_THREADS, 0,
                              (cudaStream_t)stream>>>(
      (const T*)d, (const unsigned char*)masks, (const T*)cap,
      (T)cap_scalar, (T*)out, rows, n, n_classes);
  return (int)cudaGetLastError();
}

template <typename T>
static int launch_segment_overlap(const void* s_i, const void* e_i,
                                  long long per_s, long long stride_s,
                                  long long per_e, long long stride_e,
                                  const void* starts, const void* ends,
                                  const void* co, int n_co, int J,
                                  long long row_len, int n_filled, void* out,
                                  long long rows, void* stream) {
  if (rows <= 0) return (int)cudaSuccess;
  if (n_filled < 0 || n_filled > row_len || per_s <= 0 || per_e <= 0 ||
      (co != nullptr && (n_co <= 0 || J <= 0)))
    return (int)cudaErrorInvalidValue;
  const bool vec = (row_len * (long long)sizeof(T)) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(starts) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(ends) % 16 == 0;
  const unsigned int grid = (unsigned int)((rows + OV_ROWS - 1) / OV_ROWS);
  if (vec)
    segment_overlap_kernel<T, true><<<grid, OV_ROWS, 0,
                                      (cudaStream_t)stream>>>(
        (const T*)s_i, (const T*)e_i, per_s, stride_s, per_e, stride_e,
        (const T*)starts, (const T*)ends, (const int*)co, n_co, J, row_len,
        n_filled, (T*)out, rows);
  else
    segment_overlap_kernel<T, false><<<grid, OV_ROWS, 0,
                                       (cudaStream_t)stream>>>(
        (const T*)s_i, (const T*)e_i, per_s, stride_s, per_e, stride_e,
        (const T*)starts, (const T*)ends, (const int*)co, n_co, J, row_len,
        n_filled, (T*)out, rows);
  return (int)cudaGetLastError();
}

extern "C" {

int fabric_max_flows() { return MAX_FLOWS; }

const char* fabric_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

int fabric_waterfill_f32(const void* d, const void* w, const void* cap,
                         double cap_scalar, void* out, long long rows, int n,
                         long long rows_per_w, void* stream) {
  return launch_waterfill<float>(d, w, cap, cap_scalar, out, rows, n,
                                 rows_per_w, stream);
}

int fabric_waterfill_f64(const void* d, const void* w, const void* cap,
                         double cap_scalar, void* out, long long rows, int n,
                         long long rows_per_w, void* stream) {
  return launch_waterfill<double>(d, w, cap, cap_scalar, out, rows, n,
                                  rows_per_w, stream);
}

int fabric_strict_priority_f32(const void* d, const void* masks,
                               const void* cap, double cap_scalar, void* out,
                               long long rows, int n, int n_classes,
                               void* stream) {
  return launch_strict_priority<float>(d, masks, cap, cap_scalar, out, rows,
                                       n, n_classes, stream);
}

int fabric_strict_priority_f64(const void* d, const void* masks,
                               const void* cap, double cap_scalar, void* out,
                               long long rows, int n, int n_classes,
                               void* stream) {
  return launch_strict_priority<double>(d, masks, cap, cap_scalar, out, rows,
                                        n, n_classes, stream);
}

int fabric_segment_overlap_f32(const void* s_i, const void* e_i,
                               long long per_s, long long stride_s,
                               long long per_e, long long stride_e,
                               const void* starts, const void* ends,
                               const void* co, int n_co, int J,
                               long long row_len, int n_filled, void* out,
                               long long rows, void* stream) {
  return launch_segment_overlap<float>(s_i, e_i, per_s, stride_s, per_e,
                                       stride_e, starts, ends, co, n_co, J,
                                       row_len, n_filled, out, rows, stream);
}

int fabric_segment_overlap_f64(const void* s_i, const void* e_i,
                               long long per_s, long long stride_s,
                               long long per_e, long long stride_e,
                               const void* starts, const void* ends,
                               const void* co, int n_co, int J,
                               long long row_len, int n_filled, void* out,
                               long long rows, void* stream) {
  return launch_segment_overlap<double>(s_i, e_i, per_s, stride_s, per_e,
                                        stride_e, starts, ends, co, n_co, J,
                                        row_len, n_filled, out, rows, stream);
}

}  // extern "C"
