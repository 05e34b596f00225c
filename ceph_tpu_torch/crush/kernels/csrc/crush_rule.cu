// CRUSH do_rule over a batch of placement seeds, hand-written for Hopper
// (sm_90a).  K3 of the port.
//
//   out[t, :], counts[t] = do_rule(map, rule, x = xs[t], weight)
//
// Replaces ceph_tpu/crush/batch.py::_do_rule_one (:885), which the
// reference package runs as jit(vmap(_do_rule_one)) over millions of
// seeds (CompiledCrushMap.map_batch, batch.py:373-391).  Under vmap every
// lax.while_loop runs until its slowest lane is done, with masked updates;
// on a GPU the same in PyTorch would need a host sync per loop turn.  Here
// each thread runs its own seed through the rule as a plain state machine
// and stops when its own loops stop.
//
// One thread per seed.  The thread interprets the rule's steps from an
// int32 array of (op, arg1, arg2, take_ok) rows, starting from the map's
// tunables, and keeps its result, working vector and output segments in
// arrays of kMaxResult entries (local memory: they are indexed at run
// time).  The map's tables (items and hash ids (B, I) int32, per-position
// weights (P, B, I) int64, sizes, types, validity) and the 65,536-entry
// int64 ln table (512 KiB) stay in device memory, staged once per compiled
// map; at the 10,000-OSD map they are about 4.6 MB, so they sit in L2, and
// all threads of a warp read the same bucket row at the top of the tree.
//
// straw2 is the direct form of the C core (mapper.c:361-390): for each item
// u = hash3(x, id, r) & 0xffff, draw = (ln16[u] - 2^48) / w with C's
// truncating 64-bit division (S64_MIN where w <= 0), and the first item
// with the highest draw wins.  The reference's weight-class shortcut
// (batch.py:553-586) exists to skip per-item table gathers on the TPU; the
// plain PyTorch version carries it, K3 does not.
//
// Bound on the card: integer operations, not bytes.  At 1,048,576 seeds K3
// reads about 4.6 MB of tables, 8 MB of seeds and writes 16 MB of output,
// while every seed evaluates about 3 x (500 + 20) items of a 10,000-OSD,
// 500-host map, each one rjenkins hash of some 140 integer instructions
// plus a 64-bit division.  The loops of one warp diverge where seeds
// retry.
//
// The semantics follow the reference's vmapped rule line by line
// (descend codes _HIT/_EMPTY/_BAD, the firstn retry cascade, the indep
// rounds and their out2 staleness, segments spliced at osize), so K3 is
// bit-exact with the plain version, which is pinned to the reference
// package on the CPU.
//
// Plain C interface, bound with ctypes; launches on the caller's stream,
// does not synchronise, allocates nothing.  crush_do_rule returns the
// cudaError_t of its launch (0 on success).  The two *_probe kernels are
// never launched: their SASS gives the instruction count of one hash for
// the bound.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kMaxResult = 32;  // CRUSH_MAX_RESULT in batch.py
constexpr int kThreads = 128;
constexpr int kItemNone = 0x7FFFFFFF;
constexpr int kItemUndef = 0x7FFFFFFE;
constexpr long long kS64Min = -(1LL << 62);
constexpr long long kLnBias = 0x1000000000000LL;

enum Code { kHit = 0, kEmpty = 1, kBad = 2 };

enum Op {
  kTake = 1,
  kChooseFirstn = 2,
  kChooseIndep = 3,
  kEmit = 4,
  kChooseleafFirstn = 6,
  kChooseleafIndep = 7,
  kSetChooseTries = 8,
  kSetChooseleafTries = 9,
  kSetChooseLocalTries = 10,
  kSetChooseleafVaryR = 12,
  kSetChooseleafStable = 13,
};

}  // namespace

// Mirrors _CrushArgs in batch.py: same order, same types.
struct CrushArgs {
  const long long* xs;
  long long n;
  const long long* weight;
  int n_weight;
  int n_buckets;
  int n_items;
  int n_positions;
  const int* items;           // (B, I)
  const int* ids;             // (B, I)
  const long long* weights;   // (P, B, I)
  const int* sizes;           // (B,)
  const int* btypes;          // (B,)
  const bool* valid;          // (B,)
  const long long* ln16;      // (65536,)
  const int* steps;           // (n_steps, 4)
  int n_steps;
  int result_max;
  int tries;
  int local_retries;
  int vary_r;
  int stable;
  int descend_once;
  int max_devices;
  int max_depth;
  int* out;                   // (n, result_max)
  int* counts;                // (n,)
};

namespace {

// ---------------------------------------------------------------------------
// rjenkins1 (src/crush/hash.c): unsigned 32-bit arithmetic wraps as in C.

__device__ __forceinline__ void mix(uint32_t& a, uint32_t& b, uint32_t& c) {
  a -= b; a -= c; a ^= c >> 13;
  b -= c; b -= a; b ^= a << 8;
  c -= a; c -= b; c ^= b >> 13;
  a -= b; a -= c; a ^= c >> 12;
  b -= c; b -= a; b ^= a << 16;
  c -= a; c -= b; c ^= b >> 5;
  a -= b; a -= c; a ^= c >> 3;
  b -= c; b -= a; b ^= a << 10;
  c -= a; c -= b; c ^= b >> 15;
}

__device__ __forceinline__ uint32_t jhash2(uint32_t a, uint32_t b) {
  uint32_t h = 1315423911u ^ a ^ b, x = 231232u, y = 1232u;
  mix(a, b, h);
  mix(x, a, h);
  mix(b, y, h);
  return h;
}

__device__ __forceinline__ uint32_t jhash3(uint32_t a, uint32_t b,
                                           uint32_t c) {
  uint32_t h = 1315423911u ^ a ^ b ^ c, x = 231232u, y = 1232u;
  mix(a, b, h);
  mix(c, x, h);
  mix(y, a, h);
  mix(b, x, h);
  mix(y, c, h);
  return h;
}

// ---------------------------------------------------------------------------
// map queries (batch.py:594-613)

__device__ __forceinline__ int bucket_index(const CrushArgs& a, int item) {
  const int b = -1 - item;
  return b < 0 ? 0 : (b >= a.n_buckets ? a.n_buckets - 1 : b);
}

__device__ __forceinline__ int item_type(const CrushArgs& a, int item) {
  return item < 0 ? a.btypes[bucket_index(a, item)] : 0;
}

__device__ __forceinline__ bool bucket_ok(const CrushArgs& a, int item) {
  return item < 0 && -1 - item < a.n_buckets && a.valid[-1 - item];
}

// probabilistic reweight rejection (mapper.c:424-441)
__device__ __forceinline__ bool is_out(const CrushArgs& a, int item,
                                       uint32_t x) {
  if (item >= a.n_weight) return true;
  const long long w = a.weight[item < 0 ? 0 : item];
  if (w >= 0x10000) return false;
  if (w == 0) return true;
  return static_cast<long long>(jhash2(x, static_cast<uint32_t>(item)) &
                                0xFFFFu) >= w;
}

// bucket_straw2_choose (mapper.c:361-390), direct form, non-empty bucket
__device__ __forceinline__ int straw2(const CrushArgs& a, int bidx,
                                      uint32_t x, int r, int position) {
  const int pos = position < a.n_positions - 1 ? position
                                               : a.n_positions - 1;
  const long long row = static_cast<long long>(bidx) * a.n_items;
  const int* ids = a.ids + row;
  const long long* w =
      a.weights + static_cast<long long>(pos) * a.n_buckets * a.n_items + row;
  const int n = a.sizes[bidx];
  int best_i = 0;
  long long best = 0;
  for (int i = 0; i < n; ++i) {
    const long long wi = w[i];
    long long draw = kS64Min;
    if (wi > 0) {
      const uint32_t u =
          jhash3(x, static_cast<uint32_t>(ids[i]), static_cast<uint32_t>(r)) &
          0xFFFFu;
      draw = (a.ln16[u] - kLnBias) / wi;
    }
    if (i == 0 || draw > best) {
      best = draw;
      best_i = i;
    }
  }
  return a.items[row + best_i];
}

struct Descent {
  int item;    // the item of target_type reached (0 unless kHit)
  int parent;  // the bucket it was chosen from
  int code;
};

// walk down from bucket `start` to an item of target_type or a dead end
// (batch.py:616-654)
__device__ __forceinline__ Descent descend(const CrushArgs& a, uint32_t x,
                                           int r, int start, int target_type,
                                           int position) {
  int cur = start;
  for (int depth = 0; depth < a.max_depth; ++depth) {
    const int bidx = bucket_index(a, cur);
    if (a.sizes[bidx] == 0) return {0, cur, kEmpty};
    const int nxt = straw2(a, bidx, x, r, position);
    const int ntype = item_type(a, nxt);
    if (nxt >= a.max_devices ||
        (ntype != target_type && !bucket_ok(a, nxt))) {
      return {0, cur, kBad};
    }
    if (ntype == target_type) return {nxt, cur, kHit};
    cur = nxt;
  }
  return {0, cur, kBad};  // depth exhausted (not on a well-formed map)
}

__device__ __forceinline__ bool among(const int* arr, int upto, int item) {
  for (int i = 0; i < upto; ++i) {
    if (arr[i] == item) return true;
  }
  return false;
}

// inner chooseleaf descent of firstn (batch.py:712-747); returns success
__device__ __forceinline__ bool leaf_firstn(const CrushArgs& a, uint32_t x,
                                            int bucket_item, int rep_eff,
                                            int parent_r, int tries,
                                            int local_retries,
                                            const int* out2, int outpos,
                                            int* leaf) {
  int in_item = bucket_item, ftotal = 0, flocal = 0;
  for (;;) {
    const Descent d = descend(a, x, rep_eff + parent_r + ftotal, in_item, 0,
                              outpos);
    const bool ok = d.code == kHit;
    const bool collide = ok && among(out2, outpos, d.item);
    const bool reject =
        d.code == kEmpty || (ok && !collide && is_out(a, d.item, x));
    const bool fail = reject || collide;
    ftotal += fail;
    flocal += fail;
    const bool local_retry = collide && flocal <= local_retries;
    const bool redescent = fail && !local_retry && ftotal < tries;
    if (ok && !fail) {
      *leaf = d.item;
      return true;
    }
    if (d.code == kBad || (fail && !local_retry && !redescent)) return false;
    in_item = local_retry ? d.parent : bucket_item;
    if (!local_retry) flocal = 0;
  }
}

// crush_choose_firstn over one take segment (batch.py:657-775): out and
// out2 point at the segment; returns the number of items placed
__device__ __forceinline__ int choose_firstn(
    const CrushArgs& a, uint32_t x, int take, int numrep, int target_type,
    int count, int tries, int recurse_tries, int local_retries,
    bool recurse, int vary_r, int stable, int* out, int* out2) {
  int outpos = 0;
  for (int rep = 0; rep < numrep && count > 0; ++rep) {
    int in_item = take, ftotal = 0, flocal = 0;
    for (;;) {
      const int r = rep + ftotal;
      const Descent d = descend(a, x, r, in_item, target_type, outpos);
      const bool ok = d.code == kHit;
      const bool collide = ok && among(out, outpos, d.item);
      int leaf = d.item;
      bool leaf_ok = true;
      if (recurse && ok && !collide && d.item < 0) {
        const int sub_r = vary_r ? (r >> (vary_r - 1)) : 0;
        leaf_ok = leaf_firstn(a, x, d.item, stable ? 0 : outpos, sub_r,
                              recurse_tries, local_retries, out2, outpos,
                              &leaf);
      }
      const bool reject =
          d.code == kEmpty ||
          (ok && !collide &&
           (!leaf_ok ||
            (item_type(a, d.item) == 0 && is_out(a, d.item, x))));
      const bool fail = reject || collide;
      ftotal += fail;
      flocal += fail;
      const bool local_retry = collide && flocal <= local_retries;
      const bool redescent = fail && !local_retry && ftotal < tries;
      if (ok && !fail) {
        out[outpos] = d.item;
        if (recurse) out2[outpos] = leaf;
        ++outpos;
        --count;
        break;
      }
      if (d.code == kBad || (fail && !local_retry && !redescent)) break;
      in_item = local_retry ? d.parent : take;
      if (!local_retry) flocal = 0;
    }
  }
  return outpos;
}

// inner chooseleaf descent of indep (batch.py:778-802): a leaf or NONE
__device__ __forceinline__ int leaf_indep(const CrushArgs& a, uint32_t x,
                                          int bucket_item, int numrep,
                                          int parent_r, int tries, int rep) {
  for (int ft = 0; ft < tries; ++ft) {
    const Descent d =
        descend(a, x, rep + parent_r + numrep * ft, bucket_item, 0, rep);
    if (d.code == kHit && !is_out(a, d.item, x)) return d.item;
    if (d.code == kBad) return kItemNone;
  }
  return kItemNone;
}

// crush_choose_indep over one take segment (batch.py:805-879): slots
// [0, left0) of out and out2, holes NONE
__device__ __forceinline__ void choose_indep(const CrushArgs& a, uint32_t x,
                                             int take, int left0, int numrep,
                                             int target_type, int tries,
                                             int recurse_tries, bool recurse,
                                             int* out, int* out2) {
  for (int i = 0; i < left0; ++i) {
    out[i] = kItemUndef;
    out2[i] = kItemUndef;
  }
  int left = left0;
  for (int ftotal = 0; left > 0 && ftotal < tries; ++ftotal) {
    for (int rep = 0; rep < left0; ++rep) {
      if (out[rep] != kItemUndef) continue;
      const int rr = rep + numrep * ftotal;
      const Descent d = descend(a, x, rr, take, target_type, 0);
      const bool ok = d.code == kHit;
      const bool hard = d.code == kBad;  // NONE at once (mapper.c:731,758)
      const bool collide = ok && among(out, left0, d.item);
      int leaf = d.item;
      bool leaf_fail = false;
      if (recurse && ok && !collide && d.item < 0) {
        leaf = leaf_indep(a, x, d.item, numrep, rr, recurse_tries, rep);
        leaf_fail = leaf == kItemNone;
      }
      const bool reject =
          ok && item_type(a, d.item) == 0 && is_out(a, d.item, x);
      const bool good = ok && !collide && !leaf_fail && !reject;
      if (good) out[rep] = d.item;
      if (hard) out[rep] = kItemNone;
      if (recurse) {
        // C writes out2[rep] before the is_out check, so a rejected device
        // leaves a stale out2 entry, and a failed bucket recursion leaves
        // NONE (mapper.c:791-793)
        if (good) out2[rep] = leaf;
        if (ok && !collide && ((d.item >= 0 && reject) || leaf_fail)) {
          out2[rep] = leaf_fail ? kItemNone : d.item;
        }
        if (hard) out2[rep] = kItemNone;
      }
      if (good || hard) --left;
    }
  }
  for (int i = 0; i < left0; ++i) {
    if (out[i] == kItemUndef) out[i] = kItemNone;
    if (out2[i] == kItemUndef) out2[i] = kItemNone;
  }
}

// do_rule (mapper.c:900-1105) for one seed per thread
__global__ void __launch_bounds__(kThreads)
    crush_do_rule_kernel(const CrushArgs a) {
  const long long t =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (t >= a.n) return;
  const uint32_t x = static_cast<uint32_t>(a.xs[t]);  // the hash's 32 bits
  const int R = a.result_max;
  int result[kMaxResult], w[kMaxResult], o[kMaxResult], c[kMaxResult];
  for (int i = 0; i < R; ++i) result[i] = kItemNone;
  int rcount = 0, wcount = 0;
  int tries = a.tries, leaf_tries = 0, local_retries = a.local_retries;
  int vary_r = a.vary_r, stable = a.stable;
  for (int s = 0; s < a.n_steps; ++s) {
    const int op = a.steps[4 * s], arg1 = a.steps[4 * s + 1];
    const int arg2 = a.steps[4 * s + 2], take_ok = a.steps[4 * s + 3];
    switch (op) {
      case kTake:
        if (take_ok) {
          w[0] = arg1;
          wcount = 1;
        }
        break;
      case kSetChooseTries:
        if (arg1 > 0) tries = arg1;
        break;
      case kSetChooseleafTries:
        if (arg1 > 0) leaf_tries = arg1;
        break;
      case kSetChooseLocalTries:
        if (arg1 >= 0) local_retries = arg1;
        break;
      case kSetChooseleafVaryR:
        if (arg1 >= 0) vary_r = arg1;
        break;
      case kSetChooseleafStable:
        if (arg1 >= 0) stable = arg1;
        break;
      case kChooseFirstn:
      case kChooseIndep:
      case kChooseleafFirstn:
      case kChooseleafIndep: {
        const bool firstn = op == kChooseFirstn || op == kChooseleafFirstn;
        const bool recurse =
            op == kChooseleafFirstn || op == kChooseleafIndep;
        const int numrep = arg1 <= 0 ? arg1 + R : arg1;
        const int recurse_tries =
            leaf_tries ? leaf_tries
                       : (firstn ? (a.descend_once ? 1 : tries) : 1);
        int osize = 0;
        // each take item writes a fresh segment spliced at osize
        // (mapper.c:1038-1070)
        for (int wi = 0; numrep > 0 && wi < wcount; ++wi) {
          if (!bucket_ok(a, w[wi])) continue;
          if (firstn) {
            osize += choose_firstn(a, x, w[wi], numrep, arg2, R - osize,
                                   tries, recurse_tries, local_retries,
                                   recurse, vary_r, stable, o + osize,
                                   c + osize);
          } else {
            const int got = numrep < R - osize ? numrep : R - osize;
            choose_indep(a, x, w[wi], got, numrep, arg2, tries,
                         recurse_tries, recurse, o + osize, c + osize);
            osize += got;
          }
        }
        for (int i = 0; i < osize; ++i) w[i] = recurse ? c[i] : o[i];
        wcount = osize;
        break;
      }
      case kEmit:
        for (int i = 0; i < wcount && rcount < R; ++i) result[rcount++] = w[i];
        wcount = 0;
        break;
      default:
        break;
    }
  }
  int* row = a.out + t * R;
  for (int i = 0; i < R; ++i) row[i] = result[i];
  a.counts[t] = rcount;
}

}  // namespace

extern "C" {

// never launched: disassembled for the instruction count of one hash
__global__ void crush_jhash3_probe(const uint32_t* a, const uint32_t* b,
                                   const uint32_t* c, uint32_t* out, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = jhash3(a[i], b[i], c[i]);
}

__global__ void crush_xor3_probe(const uint32_t* a, const uint32_t* b,
                                 const uint32_t* c, uint32_t* out, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = a[i] ^ b[i] ^ c[i];
}

int crush_do_rule(const CrushArgs* args, void* stream) {
  const CrushArgs& a = *args;
  if (a.n < 0 || a.result_max < 1 || a.result_max > kMaxResult ||
      a.n_weight < 1 || a.n_buckets < 1 || a.n_items < 1 ||
      a.n_positions < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (a.n == 0) return 0;
  const long long blocks = (a.n + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  crush_do_rule_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

const char* crush_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
