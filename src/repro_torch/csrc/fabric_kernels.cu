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
#include <type_traits>

#define MAX_FLOWS 32
// flow counts 1..MAX_FIXED_FLOWS have a kernel of their own (the flow count
// a template argument, every loop unrolled, the row in registers); 9..32
// flows take the same kernels' runtime-n form
#define MAX_FIXED_FLOWS 8
// threads per block of the allocators and of their launch floor
#define BLOCK_THREADS 128

// ---------------------------------------------------------------------------
// The allocators' arithmetic. One progressive fill of a row's n demands d[]
// against `remaining` capacity with weights w[] writes alloc[] in flow
// order:
//
//   rank   stable ascending rank of d/w, ties broken by flow index (Python
//          sorted()'s order): flow j's rank counts the flows k < j with
//          key[k] <= key[j] and the flows k > j with key[k] < key[j]
//   w_left left-to-right sum of w in flow order
//   fill   for each rank position p, in order:
//            fair = w_left > 0 ? remaining * wj / w_left : remaining
//            give = dj < fair ? dj : fair
//            remaining -= give;  w_left -= wj
//
// Arrays indexed at run time (a row in arrays of MAX_FLOWS entries,
// position p's flow read as order[p]) live in the thread's local memory,
// its stack, and every step of the chain would go through it. So for
// N <= MAX_FIXED_FLOWS flows the flow count is a template argument and
// every loop is unrolled: every array index is a constant and the row
// stays in registers. Position p's flow is picked by predicated selects
// over the unrolled rank[j] == p (the Pallas kernel's masked selection,
// without the sum) and its allocation is written back the same way.
//
// Unit weights (max-min) are a template flag: w_left at position p is then
// exactly N - p (a sum of ones is exact), remaining * 1 is remaining and
// d / 1 is d, so the fill divides by the constant N - p and no bit moves.
// ---------------------------------------------------------------------------

// flow j's stable ascending rank among the flows whose bit is set in
// `members` (every flow for the waterfill; one priority class for strict
// priority)
template <typename T, int N>
__device__ __forceinline__ void stable_rank(const T (&key)[N],
                                            unsigned members,
                                            int (&rank)[N]) {
#pragma unroll
  for (int j = 0; j < N; ++j) {
    int r = 0;
#pragma unroll
    for (int k = 0; k < N; ++k) {
      if (k == j) continue;
      const bool before = k < j ? key[k] <= key[j] : key[k] < key[j];
      r += (((members >> k) & 1u) && before) ? 1 : 0;
    }
    rank[j] = r;
  }
}

// one row's loads: as 16-byte vectors where the row is a whole number of
// them and `vec` says the base addresses are 16-byte aligned, else a value
// at a time
template <typename T, int N>
__device__ __forceinline__ void load_row(const T* __restrict__ src,
                                         T (&v)[N], bool vec) {
  constexpr int BYTES = N * (int)sizeof(T);
  if constexpr (BYTES % 16 == 0) {
    if (vec) {
#pragma unroll
      for (int u = 0; u < BYTES / 16; ++u) {
        const uint4 q = __ldg(reinterpret_cast<const uint4*>(src) + u);
        memcpy(&v[u * (16 / (int)sizeof(T))], &q, 16);
      }
      return;
    }
  }
#pragma unroll
  for (int j = 0; j < N; ++j) v[j] = __ldg(src + j);
}

template <typename T, int N>
__device__ __forceinline__ void store_row(T* __restrict__ dst,
                                          const T (&v)[N], bool vec) {
  constexpr int BYTES = N * (int)sizeof(T);
  if constexpr (BYTES % 16 == 0) {
    if (vec) {
#pragma unroll
      for (int u = 0; u < BYTES / 16; ++u) {
        uint4 q;
        memcpy(&q, &v[u * (16 / (int)sizeof(T))], 16);
        reinterpret_cast<uint4*>(dst)[u] = q;
      }
      return;
    }
  }
#pragma unroll
  for (int j = 0; j < N; ++j) dst[j] = v[j];
}

// K1's fill of one row of N flows, in registers
template <typename T, int N, bool UNIT>
__device__ __forceinline__ void fill_fixed(const T (&d)[N], const T (&w)[N],
                                           T remaining, T (&alloc)[N]) {
  T key[N];
  int rank[N];
#pragma unroll
  for (int j = 0; j < N; ++j) key[j] = UNIT ? d[j] : d[j] / w[j];
  stable_rank<T, N>(key, ~0u, rank);
  T w_left = T(0);
  if constexpr (!UNIT) {
#pragma unroll
    for (int j = 0; j < N; ++j) w_left = w_left + w[j];
  }
#pragma unroll
  for (int p = 0; p < N; ++p) {
    T dj = T(0), wj = T(0);
#pragma unroll
    for (int j = 0; j < N; ++j)
      if (rank[j] == p) {
        dj = d[j];
        if constexpr (!UNIT) wj = w[j];
      }
    T fair;
    if constexpr (UNIT) {
      fair = remaining / T(N - p);
    } else {
      fair = remaining;
      if (w_left > T(0)) {
        const T num = remaining * wj;
        fair = num / w_left;
      }
    }
    const T give = dj < fair ? dj : fair;
#pragma unroll
    for (int j = 0; j < N; ++j)
      if (rank[j] == p) alloc[j] = give;
    remaining = remaining - give;
    if constexpr (!UNIT) w_left = w_left - wj;
  }
}

// K2's fill of one priority class (the flows whose bit is set in `members`)
// of a row of N flows, in registers: the max-min fill over the class's m
// members only, in their stable order, dividing by m - p; then the outer
// capacity loses the class's allocations in flow-index order and is clamped
// at zero. The Python loop fills the class's members alone; the plain
// PyTorch version and the Pallas kernel fill the whole row with the other
// flows' demands zeroed, which is the same bits: each zeroed flow ranks
// among the zeros, gives +0, leaves `remaining` as it was and lowers
// w_left by exactly 1, so every member sees the same w_left and
// `remaining`; and subtracting their +0 allocations changes no bit.
template <typename T, int N>
__device__ __forceinline__ void class_fill(const T (&d)[N], unsigned members,
                                           T& remaining, T (&alloc)[N]) {
  int rank[N];
  stable_rank<T, N>(d, members, rank);
  const int m = __popc(members);
  T rem = remaining;
#pragma unroll
  for (int p = 0; p < N; ++p) {
    if (p < m) {                              // the same for every thread
      T dj = T(0);
#pragma unroll
      for (int j = 0; j < N; ++j)
        if (((members >> j) & 1u) && rank[j] == p) dj = d[j];
      const T fair = rem / T(m - p);
      const T give = dj < fair ? dj : fair;
#pragma unroll
      for (int j = 0; j < N; ++j)
        if (((members >> j) & 1u) && rank[j] == p) alloc[j] = give;
      rem = rem - give;
    }
  }
#pragma unroll
  for (int j = 0; j < N; ++j)
    if ((members >> j) & 1u) remaining = remaining - alloc[j];
  remaining = remaining < T(0) ? T(0) : remaining;
}

// The runtime-n form of the fill, for 9..MAX_FLOWS flows: the same
// arithmetic over arrays indexed at run time (so in local memory). `w`
// null means unit weights.
template <typename T>
__device__ __forceinline__ void fill_row(const T* d, const T* w, int n,
                                         T remaining, T* alloc) {
  int order[MAX_FLOWS];
  T key[MAX_FLOWS];
  for (int j = 0; j < n; ++j) key[j] = w ? d[j] / w[j] : d[j];
  for (int j = 0; j < n; ++j) {
    int rank = 0;
    const T kj = key[j];
    for (int k = 0; k < n; ++k) {
      const T kk = key[k];
      rank += (k < j ? kk <= kj : kk < kj) ? 1 : 0;
    }
    order[rank] = j;
  }
  T w_left = T(0);
  for (int j = 0; j < n; ++j) w_left = w_left + (w ? w[j] : T(1));
  for (int p = 0; p < n; ++p) {
    const int j = order[p];
    const T dj = d[j];
    const T wj = w ? w[j] : T(1);
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
// `_stable_rank`). Serves maxmin_shares (UNIT: unit weights, w unused) and
// wfq_shares.
//
// Bound on this card: bytes. A row reads n demands, up to n weights and one
// capacity and writes n allocations; at the sweep's shapes (4096*9 rows of
// 4 flows) that is 1.2 MB, 0.35 us at 3.35 TB/s, below the time of a
// kernel launch: the floor in practice is the launch and one row's
// dependent chain, not bandwidth and not arithmetic. So a thread holds its
// row in registers (N a template argument, see above), issues all of the
// row's loads before the chain starts (one 16-byte load per 16 bytes of a
// row where the layout allows), and makes one pass over device memory with
// no row padding and no scratch. Weights shared by a group of rows (one
// weight vector per variant against that variant's links) are read through
// `rows_per_w` instead of being expanded in memory: row r uses weight row
// r / rows_per_w. Capacity is an array (cap != nullptr) or one scalar.
// N == 0 is the runtime-n form, for n > MAX_FIXED_FLOWS.
// ---------------------------------------------------------------------------
template <typename T, int N, bool UNIT>
__global__ void __launch_bounds__(BLOCK_THREADS)
waterfill_kernel(const T* __restrict__ d, const T* __restrict__ w,
                 const T* __restrict__ cap, T cap_scalar,
                 T* __restrict__ out, long long rows, int n,
                 long long rows_per_w, bool vec) {
  const long long r = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (r >= rows) return;
  if constexpr (N > 0) {
    T dr[N], wr[N], alloc[N];
    load_row<T, N>(d + r * N, dr, vec);
    if constexpr (!UNIT) {
      const long long wrow = rows_per_w == 1 ? r : r / rows_per_w;
      load_row<T, N>(w + wrow * N, wr, vec);
    }
    const T remaining = cap ? __ldg(cap + r) : cap_scalar;
    fill_fixed<T, N, UNIT>(dr, wr, remaining, alloc);
    store_row<T, N>(out + r * N, alloc, vec);
  } else {
    T dr[MAX_FLOWS], wr[MAX_FLOWS], alloc[MAX_FLOWS];
    const T* drow = d + r * n;
    const T* wrow = UNIT ? nullptr : w + (r / rows_per_w) * n;
    for (int j = 0; j < n; ++j) {
      dr[j] = drow[j];
      if (!UNIT) wr[j] = wrow[j];
    }
    fill_row<T>(dr, UNIT ? nullptr : wr, n, cap ? cap[r] : cap_scalar,
                alloc);
    T* orow = out + r * n;
    for (int j = 0; j < n; ++j) orow[j] = alloc[j];
  }
}

// ---------------------------------------------------------------------------
// K2 strict priority — replaces the TPU kernel `_strict_priority_kernel`
// (src/repro/fabric/backend/pallas_kernels.py). The class partition comes
// by value in the kernel's arguments: one bit mask of member flows per
// class, in descending priority order, built on the host from the concrete
// priorities. Per class: the max-min fill over the class's members only
// (`class_fill` above, which says why that is the same bits as the full-row
// fill the plain version runs); the outer capacity loses the class's
// allocations in flow-index order and is clamped at zero — the reference's
// order and rounding. The starved-class floor stays with the caller.
//
// Bound on this card: bytes, as K1 (n demands and one capacity in, n
// allocations out per row), and at the sweep's shapes a launch and a row's
// chain are the floor. Design: K1's, the row in registers, the class loop
// inside the thread so that the capacity carry never leaves it. With the
// main path's priorities [2, 1, 0, 0] a row fills 4 positions (a full-row
// fill per class would fill 12) and reads no mask from memory. N == 0 is
// the runtime-n form, for n > MAX_FIXED_FLOWS.
// ---------------------------------------------------------------------------
struct ClassMasks {
  int n;                     // classes
  unsigned int m[MAX_FLOWS]; // member bits of each class, descending
};

template <typename T, int N>
__global__ void __launch_bounds__(BLOCK_THREADS)
strict_priority_kernel(const T* __restrict__ d, const ClassMasks cls,
                       const T* __restrict__ cap, T cap_scalar,
                       T* __restrict__ out, long long rows, int n,
                       bool vec) {
  const long long r = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (r >= rows) return;
  if constexpr (N > 0) {
    T dr[N], alloc[N];
    load_row<T, N>(d + r * N, dr, vec);
    T remaining = cap ? __ldg(cap + r) : cap_scalar;
#pragma unroll
    for (int j = 0; j < N; ++j) alloc[j] = T(0);
#pragma unroll
    for (int c = 0; c < N; ++c)              // at most one class per flow
      if (c < cls.n) class_fill<T, N>(dr, cls.m[c], remaining, alloc);
    store_row<T, N>(out + r * N, alloc, vec);
  } else {
    T dr[MAX_FLOWS], dm[MAX_FLOWS], sub[MAX_FLOWS], alloc[MAX_FLOWS];
    int idx[MAX_FLOWS];
    const T* drow = d + r * n;
    for (int j = 0; j < n; ++j) {
      dr[j] = drow[j];
      alloc[j] = T(0);
    }
    T remaining = cap ? cap[r] : cap_scalar;
    for (int c = 0; c < cls.n; ++c) {
      const unsigned members = cls.m[c];
      int m = 0;
      for (int j = 0; j < n; ++j)
        if ((members >> j) & 1u) {
          dm[m] = dr[j];
          idx[m++] = j;
        }
      fill_row<T>(dm, nullptr, m, remaining, sub);
      for (int k = 0; k < m; ++k) {           // idx ascends: index order
        alloc[idx[k]] = sub[k];
        remaining = remaining - sub[k];
      }
      remaining = remaining < T(0) ? T(0) : remaining;
    }
    T* orow = out + r * n;
    for (int j = 0; j < n; ++j) orow[j] = alloc[j];
  }
}

// The launch floor: an empty kernel, launched with an allocator's grid and
// block, whose device time is the least any launch of that shape takes.
__global__ void launch_floor_kernel() {}

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

static inline bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

static inline unsigned int n_blocks(long long rows) {
  return (unsigned int)((rows + BLOCK_THREADS - 1) / BLOCK_THREADS);
}

// calls f(std::integral_constant<int, N>) with N = n for n in
// 1..MAX_FIXED_FLOWS, else with N = 0 (the runtime-n form)
template <int N = 1, typename F>
static void with_flow_count(int n, F&& f) {
  if constexpr (N <= MAX_FIXED_FLOWS) {
    if (n == N)
      f(std::integral_constant<int, N>{});
    else
      with_flow_count<N + 1>(n, f);
  } else {
    f(std::integral_constant<int, 0>{});
  }
}

template <typename T>
static int launch_waterfill(const void* d, const void* w, const void* cap,
                            double cap_scalar, void* out, long long rows,
                            int n, long long rows_per_w, void* stream) {
  if (rows <= 0 || n <= 0) return (int)cudaSuccess;
  if (n > MAX_FLOWS || rows_per_w <= 0) return (int)cudaErrorInvalidValue;
  const bool vec = aligned16(d) && aligned16(out) && (!w || aligned16(w));
  const unsigned int grid = n_blocks(rows);
  with_flow_count(n, [&](auto nc) {
    constexpr int N = decltype(nc)::value;
    if (w == nullptr)
      waterfill_kernel<T, N, true><<<grid, BLOCK_THREADS, 0,
                                     (cudaStream_t)stream>>>(
          (const T*)d, nullptr, (const T*)cap, (T)cap_scalar, (T*)out, rows,
          n, 1, vec);
    else
      waterfill_kernel<T, N, false><<<grid, BLOCK_THREADS, 0,
                                      (cudaStream_t)stream>>>(
          (const T*)d, (const T*)w, (const T*)cap, (T)cap_scalar, (T*)out,
          rows, n, rows_per_w, vec);
  });
  return (int)cudaGetLastError();
}

template <typename T>
static int launch_strict_priority(const void* d, const unsigned int* masks,
                                  int n_classes, const void* cap,
                                  double cap_scalar, void* out,
                                  long long rows, int n, void* stream) {
  if (rows <= 0 || n <= 0) return (int)cudaSuccess;
  if (n > MAX_FLOWS || n_classes < 1 || n_classes > n)
    return (int)cudaErrorInvalidValue;
  ClassMasks cls;
  cls.n = n_classes;
  for (int c = 0; c < MAX_FLOWS; ++c) cls.m[c] = c < n_classes ? masks[c] : 0u;
  const bool vec = aligned16(d) && aligned16(out);
  const unsigned int grid = n_blocks(rows);
  with_flow_count(n, [&](auto nc) {
    constexpr int N = decltype(nc)::value;
    strict_priority_kernel<T, N><<<grid, BLOCK_THREADS, 0,
                                   (cudaStream_t)stream>>>(
        (const T*)d, cls, (const T*)cap, (T)cap_scalar, (T*)out, rows, n,
        vec);
  });
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
                   aligned16(starts) && aligned16(ends);
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

// `masks`: host memory, n_classes member masks in descending priority
// order; copied into the launch's arguments
int fabric_strict_priority_f32(const void* d, const unsigned int* masks,
                               int n_classes, const void* cap,
                               double cap_scalar, void* out, long long rows,
                               int n, void* stream) {
  return launch_strict_priority<float>(d, masks, n_classes, cap, cap_scalar,
                                       out, rows, n, stream);
}

int fabric_strict_priority_f64(const void* d, const unsigned int* masks,
                               int n_classes, const void* cap,
                               double cap_scalar, void* out, long long rows,
                               int n, void* stream) {
  return launch_strict_priority<double>(d, masks, n_classes, cap, cap_scalar,
                                        out, rows, n, stream);
}

int fabric_launch_floor(long long rows, void* stream) {
  if (rows <= 0) return (int)cudaSuccess;
  launch_floor_kernel<<<n_blocks(rows), BLOCK_THREADS, 0,
                        (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
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
