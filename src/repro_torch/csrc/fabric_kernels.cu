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
// Shape of every kernel here: ONE THREAD PER ROW. A row is one (variant,
// link) allocation over n <= MAX_FLOWS flows, or one (variant, co-tenant)
// overlap over S ring slots. The work of a row is a short, strictly
// sequential, data-dependent chain (sort order, then a fill whose every
// step needs the previous step's carry), so there is nothing inside a row
// to spread across threads without changing the order of the arithmetic;
// the parallelism is across the rows of the sweep.

#include <cuda_runtime.h>

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
// accumulated left to right (the reference's encounter order); an empty
// ring slot carries end = -inf and contributes a clamped 0.
//
// Bound on this card: bytes. A row reads 2*S ring values and two window
// bounds and writes one sum: 4096*3 rows of 64 slots in float64 is about
// 12.6 MB, some 4 microseconds at 3.35 TB/s, the same order as a launch.
// Design: one thread per row walking its S slots in order, which keeps the
// summation order and so the bits. A warp's 32 threads therefore read
// addresses S elements apart, which wastes most of every memory
// transaction; the known remedy (stage a tile of rows through shared memory
// with coalesced loads, then let each thread walk its row there) keeps the
// order and is left for the change that makes this kernel fast. The window
// bounds shared by a group of rows (one window per variant against that
// variant's co-tenants) are read through `rows_per_win`.
// ---------------------------------------------------------------------------
template <typename T>
__global__ void segment_overlap_kernel(const T* __restrict__ s_i,
                                       const T* __restrict__ e_i,
                                       const T* __restrict__ starts,
                                       const T* __restrict__ ends,
                                       T* __restrict__ out, long long rows,
                                       int n_segs, long long rows_per_win) {
  const long long r = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (r >= rows) return;
  const T si = s_i[r / rows_per_win];
  const T ei = e_i[r / rows_per_win];
  const T* srow = starts + r * n_segs;
  const T* erow = ends + r * n_segs;
  T total = T(0);
  for (int k = 0; k < n_segs; ++k) {
    const T e = erow[k];
    const T s = srow[k];
    const T hi = ei < e ? ei : e;
    const T lo = si > s ? si : s;
    const T ov = hi - lo;
    total = total + (ov > T(0) ? ov : T(0));
  }
  out[r] = total;
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
                                  const void* starts, const void* ends,
                                  void* out, long long rows, int n_segs,
                                  long long rows_per_win, void* stream) {
  if (rows <= 0) return (int)cudaSuccess;
  if (n_segs < 0 || rows_per_win <= 0) return (int)cudaErrorInvalidValue;
  segment_overlap_kernel<T><<<n_blocks(rows), BLOCK_THREADS, 0,
                              (cudaStream_t)stream>>>(
      (const T*)s_i, (const T*)e_i, (const T*)starts, (const T*)ends,
      (T*)out, rows, n_segs, rows_per_win);
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
                               const void* starts, const void* ends,
                               void* out, long long rows, int n_segs,
                               long long rows_per_win, void* stream) {
  return launch_segment_overlap<float>(s_i, e_i, starts, ends, out, rows,
                                       n_segs, rows_per_win, stream);
}

int fabric_segment_overlap_f64(const void* s_i, const void* e_i,
                               const void* starts, const void* ends,
                               void* out, long long rows, int n_segs,
                               long long rows_per_win, void* stream) {
  return launch_segment_overlap<double>(s_i, e_i, starts, ends, out, rows,
                                        n_segs, rows_per_win, stream);
}

}  // extern "C"
