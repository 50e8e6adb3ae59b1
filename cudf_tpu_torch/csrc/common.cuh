// Helpers shared by the port's CUDA kernels (built for sm_90a by
// cudf_tpu_torch/kernels/_build.py, bound to Python with ctypes).
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace cudf_tpu_torch {

// Value kinds; the numbering is shared with kernels/_build.py VALUE_KINDS.
enum ValueKind : int { kInt32 = 0, kInt64 = 1, kFloat32 = 2, kFloat64 = 3 };

constexpr unsigned long long kSignBit = 0x8000000000000000ull;

// Dynamic shared memory one block may have on sm_90 (227 KB).
constexpr size_t kMaxBlockShared = 232448;

// Order-preserving maps onto uint64, so that min and max are unsigned
// 64-bit atomics whatever the value type.  Wrappers decode with the
// inverse maps in kernels/hash_aggregate.py (_decode_order_key).
__device__ __forceinline__ unsigned long long order_key(long long v) {
  return static_cast<unsigned long long>(v) ^ kSignBit;
}
__device__ __forceinline__ unsigned long long order_key(double v) {
  unsigned long long b = static_cast<unsigned long long>(__double_as_longlong(v));
  return (b & kSignBit) ? ~b : (b | kSignBit);
}

// The order key of the sorted partition route (kernels E, F and G), an
// unsigned int that sorts as the reference's tile sort orders its keys.
// mask_bits 0: the signed key, sign bit flipped.  mask_bits m > 0: the
// key's low m bits plus 1, and 0 for a negative key (the reference sorts
// key & (2^m - 1), with negative keys as SENTINEL = INT32_MIN).
__device__ __forceinline__ unsigned sort_key(int key, int mask_bits) {
  if (mask_bits == 0) return static_cast<unsigned>(key) ^ 0x80000000u;
  return key < 0 ? 0u : (static_cast<unsigned>(key) & ((1u << mask_bits) - 1u)) + 1u;
}
// Significant bits of sort_key: 32, or m + 1 under a mask.
__host__ __device__ __forceinline__ int sort_key_bits(int mask_bits) {
  return mask_bits == 0 ? 32 : mask_bits + 1;
}

// Up to five 4- or 8-byte columns that move together in a partition or
// sort launch: keys first, then the payloads (kernels/_build.py
// MAX_PAYLOADS = kMaxColumns - 1).
constexpr int kMaxColumns = 5;
struct Columns {
  const void* src[kMaxColumns];
  void* dst[kMaxColumns];
  int width[kMaxColumns];
  int count;
};

// Fill Columns from the wrappers' host arrays (keys are column 0); false
// on a count or width the kernels do not take.
inline bool make_columns(Columns* c, const void* keys, void* out_keys, int n_payloads,
                         const void* src, const void* dst, const void* widths) {
  if (n_payloads < 0 || n_payloads > kMaxColumns - 1) return false;
  c->count = n_payloads + 1;
  c->src[0] = keys;
  c->dst[0] = out_keys;
  c->width[0] = 4;
  for (int j = 0; j < n_payloads; ++j) {
    c->src[j + 1] = static_cast<const void* const*>(src)[j];
    c->dst[j + 1] = static_cast<void* const*>(dst)[j];
    c->width[j + 1] = static_cast<const int*>(widths)[j];
    if (c->width[j + 1] != 4 && c->width[j + 1] != 8) return false;
  }
  return true;
}

// ---------------------------------------------------------------------
// Value columns of the aggregation kernels (A and D): each a pointer and
// a ValueKind, read as raw 4- or 8-byte words and summed into 8-byte
// slots: int64 for integer kinds (two's complement wraps like numpy's
// int64), double for float kinds.
// ---------------------------------------------------------------------

__host__ __device__ __forceinline__ bool is_float_kind(int kind) {
  return kind == kFloat32 || kind == kFloat64;
}
__host__ __device__ __forceinline__ bool is_wide_kind(int kind) {
  return kind == kInt64 || kind == kFloat64;
}

__device__ __forceinline__ unsigned long long load_bits(const void* p, long long i, int kind) {
  return is_wide_kind(kind) ? __ldg(static_cast<const unsigned long long*>(p) + i)
                            : __ldg(static_cast<const unsigned*>(p) + i);
}

// The value of raw bits as the slot's type: int64 (sign-extended) or double.
__device__ __forceinline__ long long int_value(unsigned long long bits, int kind) {
  return kind == kInt32 ? static_cast<long long>(static_cast<int>(bits))
                        : static_cast<long long>(bits);
}
__device__ __forceinline__ double float_value(unsigned long long bits, int kind) {
  return kind == kFloat32 ? static_cast<double>(__uint_as_float(static_cast<unsigned>(bits)))
                          : __longlong_as_double(static_cast<long long>(bits));
}

// Sums into an 8-byte shared-memory slot.  sm_90a has no native 64-bit
// shared atomic add: atomicAdd on a shared unsigned long long or double
// compiles to an ATOMS.CAST.SPIN.64 loop (a load, then a compare-and-swap
// that a lane retries until it wins; chip_smoke.py prints the SASS), while
// 32-bit ATOMS.ADD is native.  So an integer slot is a (lo, hi) pair of
// uint32 words: lo takes the value's low word by a native atomic that
// returns the old word, and hi takes the value's high word plus the carry
// out of lo, only when that is not zero (rare for small values of either
// sign).  Exact mod 2^64, as int64 sums wrap.  Float slots keep the CAS
// loop: there is no native float shared atomic add to build on.
__device__ __forceinline__ void shared_add_int(unsigned long long* slot, long long v) {
  unsigned* w = reinterpret_cast<unsigned*>(slot);
  const unsigned lo = static_cast<unsigned>(v);
  const unsigned old = atomicAdd(w, lo);
  const unsigned hi = static_cast<unsigned>(static_cast<unsigned long long>(v) >> 32) +
                      (old + lo < old ? 1u : 0u);
  if (hi != 0u) atomicAdd(w + 1, hi);
}

__device__ __forceinline__ void shared_add(unsigned long long* slot, unsigned long long bits,
                                           int kind) {
  if (is_float_kind(kind)) {
    atomicAdd(reinterpret_cast<double*>(slot), float_value(bits, kind));
  } else {
    shared_add_int(slot, int_value(bits, kind));
  }
}

// slot a + slot b, both of one kind's sum type.
__device__ __forceinline__ unsigned long long slot_sum(unsigned long long a,
                                                       unsigned long long b, bool fp) {
  return fp ? static_cast<unsigned long long>(
                  __double_as_longlong(__longlong_as_double(static_cast<long long>(a)) +
                                       __longlong_as_double(static_cast<long long>(b))))
            : a + b;
}

// Adds a slot into a global int64 or double sum (native REDG on sm_90a).
__device__ __forceinline__ void global_add(unsigned long long* dst, unsigned long long slot,
                                           bool fp) {
  if (fp) {
    atomicAdd(reinterpret_cast<double*>(dst), __longlong_as_double(static_cast<long long>(slot)));
  } else {
    atomicAdd(dst, slot);
  }
}

inline int sm_count() {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms;
}

// Grid for a grid-stride kernel: as many resident blocks as fit, and no
// more blocks than there are rows to cover.
template <typename Kernel>
inline int resident_grid(Kernel kernel, int threads, size_t smem, long long n) {
  int per_sm = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  long long want = (n + threads - 1) / threads;
  long long have = static_cast<long long>(per_sm > 0 ? per_sm : 1) * sm_count();
  long long grid = want < have ? want : have;
  return static_cast<int>(grid > 0 ? grid : 1);
}

}  // namespace cudf_tpu_torch
