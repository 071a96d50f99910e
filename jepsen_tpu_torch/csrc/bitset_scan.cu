// Exact bitset-automaton WGL scan for Hopper (sm_90a).
//
// Replaces: jepsen_tpu/checker/wgl_bitset.py _make_kernel (launched by
// _bitset_scan through pl.pallas_call), with its helpers _or_rows,
// _add_bit and _remove_bit_dyn. Same inputs, outputs and verdicts:
//
//   win    int8  [keys, n*4*W]  per step: occ[W], f[W], a[W], b[W]
//   meta   int32 [keys, n*4]    per step: slot, live, op_index, fresh
//   fr_in  int32 [keys, S, M]   starting frontier, M = max(2^W/32, 128)
//   out    int32 [keys, 1, 8]   alive, taint, died op, rounds total, max
//   fr_out int32 [keys, S, M]   final frontier; on a death, the
//                               pre-filter frontier of the dying step
//
// Bit (s, m) of the frontier is the config (state row s, linearized-slot
// mask m); mask m lives in word m >> 5 at bit m & 31. Per return step:
// closure rounds over the open slots (fast tier: 3 rounds; exact tier:
// to a fixpoint bounded by W+2 rounds, where hitting the bound is
// taint), then the RETURN filter keeps masks holding the returning
// slot's bit and clears it.
//
// What bounds it on this card: neither bytes nor operations but the
// latency of a chain. The scan is sequential in steps, one key is one
// block, and inside a step every slot of a closure round reads what the
// previous slot wrote.
//
// What the design does about it: every barrier is scoped to the owner
// of the word a slot exchanges. Thread (warp g, lane l) owns the mask
// words j = l | c << 5 | g << (5 + log2 C), c < C, of all S rows and of
// the union row U = OR of the rows (kept up to date, so a write slot
// reads one row and the death test reads U alone). Slot w then needs:
//   w < 5                relabels inside the word: no exchange;
//   5 <= w < 10          swaps with lane l ^ 2^(w-5): __shfl_xor_sync;
//   10 <= w < 10+log2 C  swaps with another column of the thread;
//   higher               swaps with another warp: shared memory and one
//                        __syncthreads.
// The words live in registers (rows selected by masks), in shared
// memory under the same ownership, or in place in fr_out (up to 2 MB at
// W=19, S=32); wgl_bitset.geometry() picks the store, the warps and C
// for each (W, S) from the instances below. A slot is a dependent chain
// in every thread, so fewer words a thread wins: on an H100 one column
// a thread (4-16 warps) beats one warp holding the whole W=12 frontier
// (32 words a lane, no block barrier) by about 2x. The step stream is
// staged CHUNK steps at a time with cp.async into a double buffer, and
// all threads decode a chunk's slot transitions into per-step gate
// masks at once, so no step waits on its own load; each slot's
// descriptor is read ahead of the slot before it. Votes (death test,
// exact-tier convergence) are __any_sync within one warp and
// __syncthreads_or only with several. The fast tier skips its third
// round when the second changed nothing (the third would then repeat
// it exactly). Splitting one key over a cluster (DSMEM) is later work.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int OUT_COLS = 8;
constexpr int META_COLS = 4;
constexpr int MAX_W = 32;
constexpr int FAST_ROUNDS = 3;
constexpr int CHUNK = 32;         // steps staged per chunk
constexpr int SMETA = 5;          // decoded per-step: slot, flags, op, g0, g1
constexpr int UNION_ROW = 0xFF;   // descriptor source: the union row
constexpr unsigned FULL = 0xFFFFFFFFu;

enum Store { REGISTERS = 0, SHARED = 1, GLOBAL = 2 };

// in-word mask-bit patterns: C1[k] has bit beta set iff beta & (1 << k)
__constant__ uint32_t C1[5] = {
    0xAAAAAAAAu, 0xCCCCCCCCu, 0xF0F0F0F0u, 0xFF00FF00u, 0xFFFF0000u};

// Slot transition (models.py *_bitset_slot): ids as models.KERNEL_*.
// Returns valid.
__device__ __forceinline__ int slot_decode(int model, int f, int a, int b,
                                           int* is_union, int* src,
                                           int* dst) {
  switch (model) {
    case 0:  // cas-register
      *is_union = (f == 1);
      *src = a + 1;
      *dst = (f == 2 ? b : a) + 1;
      return 1;
    case 1:  // register: cas never linearizes
      *is_union = (f == 1);
      *src = a + 1;
      *dst = a + 1;
      return f != 2;
    case 2:  // mutex
      *is_union = 0;
      *src = (f == 0 ? 0 : 1) + 1;
      *dst = (f == 0 ? 1 : 0) + 1;
      return 1;
    default:
      *is_union = 0;
      *src = 0;
      *dst = 0;
      return 0;
  }
}

// Dynamic shared memory, in 32-bit words (wgl_bitset.geometry() keeps a
// copy of this layout to size the launch).
struct Layout {
  int raw;                 // cp.async targets, two buffers of raw_words:
  int raw_words;           // a chunk's win, then its meta
  int desc;                // [CHUNK][W] decoded src | dst << 8
  int smeta;               // [CHUNK][SMETA]
  int u;                   // [M] union row (shared and global stores)
  int xbuf;                // [2][M/2] cross-warp closure exchange
  int xfil;                // [S+1][M/2] cross-warp filter exchange
  int fr;                  // [S][M] frontier (shared store)
  int total;
};

__host__ __device__ inline Layout make_layout(int W, int S, int M, int store,
                                              int warps) {
  Layout L;
  int o = 0;
  L.raw = o;
  L.raw_words = CHUNK * W + CHUNK * META_COLS;  // CHUNK * 4 * W int8
  o += 2 * L.raw_words;
  L.desc = o;
  o += CHUNK * W;
  L.smeta = o;
  o += CHUNK * SMETA;
  L.u = o;
  if (store != REGISTERS) o += M;
  L.xbuf = o;
  if (warps > 1) o += M;
  L.xfil = o;
  if (warps > 1 && store == REGISTERS) o += (S + 1) * (M / 2);
  L.fr = o;
  if (store == SHARED) o += S * M;
  L.total = o;
  return L;
}

__device__ __forceinline__ void cp_async4(uint32_t* dst, const uint32_t* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_1() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// word index j with bit b squeezed out: the slot of a pair in an
// exchange buffer of M/2 words
__device__ __forceinline__ int squeeze(int j, int b) {
  return ((j >> (b + 1)) << b) | (j & ((1 << b) - 1));
}

// Register store: the thread's C words of each of the S rows and of the
// union row (row S). Loops over rows and columns unroll fully, so every
// index is a constant; a data-dependent row is selected by masks. A
// round that must report a change compares the rows with a snapshot
// taken before it, instead of tracking new bits at every write.
template <int S, int C>
struct RegFrontier {
  static constexpr bool kReg = true;
  static constexpr int kRows = S;
  uint32_t w[S + 1][C];
  uint32_t snap[S][C];
  int jb;
  __device__ __forceinline__ void take_snapshot() {
#pragma unroll
    for (int s = 0; s < S; ++s)
#pragma unroll
      for (int c = 0; c < C; ++c) snap[s][c] = w[s][c];
  }
  __device__ __forceinline__ uint32_t changed_since_snapshot() const {
    uint32_t d = 0;
#pragma unroll
    for (int s = 0; s < S; ++s)
#pragma unroll
      for (int c = 0; c < C; ++c) d |= snap[s][c] ^ w[s][c];
    return d;
  }
  __device__ __forceinline__ uint32_t& at(int s, int c) { return w[s][c]; }
  __device__ __forceinline__ uint32_t& uat(int c) { return w[S][c]; }
  __device__ __forceinline__ uint32_t src(int r, int c) const {
    if (r == UNION_ROW) return w[S][c];
    uint32_t v = 0;
#pragma unroll
    for (int s = 0; s < S; ++s) v |= w[s][c] & (0u - (uint32_t)(s == r));
    return v;
  }
  // row r |= x at column c; the union row follows (changes are found
  // by the snapshot, so ch is left alone)
  __device__ __forceinline__ void orr(int r, int c, uint32_t x, uint32_t&) {
#pragma unroll
    for (int s = 0; s < S; ++s) w[s][c] |= x & (0u - (uint32_t)(s == r));
    w[S][c] |= x;
  }
};

// Shared or global store: rows at f + s*M, the union row at u (shared).
// A write that adds bits sets ch.
template <int C>
struct MemFrontier {
  static constexpr bool kReg = false;
  static constexpr int kRows = 0;
  __device__ __forceinline__ void take_snapshot() {}
  __device__ __forceinline__ uint32_t changed_since_snapshot() const {
    return 0;
  }
  uint32_t* f;
  uint32_t* u;
  int S, M, jb;
  __device__ __forceinline__ uint32_t* row(int s) const {
    return s < S ? f + (size_t)s * M : u;
  }
  __device__ __forceinline__ uint32_t& at(int s, int c) {
    return row(s)[jb + (c << 5)];
  }
  __device__ __forceinline__ uint32_t& uat(int c) { return u[jb + (c << 5)]; }
  __device__ __forceinline__ uint32_t src(int r, int c) const {
    return (r == UNION_ROW ? u : f + (size_t)r * M)[jb + (c << 5)];
  }
  __device__ __forceinline__ void orr(int r, int c, uint32_t x, uint32_t& ch) {
    uint32_t* p = f + (size_t)r * M + jb + (c << 5);
    const uint32_t o = *p, nv = o | x;
    if (nv != o) {
      *p = nv;
      u[jb + (c << 5)] |= x;
      ch = 1;
    }
  }
};

// fn(s) for every row s of the frontier and for the union row (s = S)
template <class FR, class Fn>
__device__ __forceinline__ void each_row(FR& fr, int S, Fn fn) {
  if constexpr (FR::kReg) {
#pragma unroll
    for (int s = 0; s <= FR::kRows; ++s) fn(s);
  } else {
    for (int s = 0; s <= S; ++s) fn(s);
  }
}

__device__ __forceinline__ int block_any(int p, int nw) {
  return nw == 1 ? __any_sync(FULL, p) : __syncthreads_or(p);
}

struct Ctx {
  int lane, warp, cbits, lbits, S, M;  // lbits = log2(M)
  uint32_t* xbuf;
  uint32_t* xfil;
  int par;  // parity of the next cross-warp closure exchange
};

// column-class closure slot: columns with bit K take column c ^ 2^K
template <int K, int C, class FR>
__device__ __forceinline__ void col_slot(FR& fr, int src, int dst,
                                         uint32_t& ch) {
#pragma unroll
  for (int c = 0; c < C; ++c)
    if (c & (1 << K)) fr.orr(dst, c, fr.src(src, c ^ (1 << K)), ch);
}

template <int C, class FR, int K = 0>
__device__ __forceinline__ void col_slot_k(int k, FR& fr, int src, int dst,
                                           uint32_t& ch) {
  if constexpr ((1 << K) < C) {
    if (k == K) {
      col_slot<K, C>(fr, src, dst, ch);
      return;
    }
    col_slot_k<C, FR, K + 1>(k, fr, src, dst, ch);
  }
}

// column-class filter: columns without bit K take column c | 2^K
template <int K, int C, class FR>
__device__ __forceinline__ void col_filter(FR& fr, int S) {
  each_row(fr, S, [&](int s) {
#pragma unroll
    for (int c = 0; c < C; ++c) {
      if (!(c & (1 << K))) {
        fr.at(s, c) = fr.at(s, c | (1 << K));
        fr.at(s, c | (1 << K)) = 0;
      }
    }
  });
}

template <int C, class FR, int K = 0>
__device__ __forceinline__ void col_filter_k(int k, FR& fr, int S) {
  if constexpr ((1 << K) < C) {
    if (k == K) {
      col_filter<K, C>(fr, S);
      return;
    }
    col_filter_k<C, FR, K + 1>(k, fr, S);
  }
}

// Closure slot w: masks without bit w of the source row (or of the
// union) gain the bit and OR into row dst.
template <int C, class FR>
__device__ __forceinline__ void apply_slot(FR& fr, Ctx& x, int w, int src,
                                           int dst, uint32_t& ch) {
  if (w < 5) {
    const uint32_t keep = ~C1[w];
    const int sh = 1 << w;
#pragma unroll
    for (int c = 0; c < C; ++c)
      fr.orr(dst, c, (fr.src(src, c) & keep) << sh, ch);
    return;
  }
  const int b = w - 5;  // bit of the word index
  if (b < 5) {
    const int lb = 1 << b;
    const bool up = x.lane & lb;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const uint32_t p = __shfl_xor_sync(FULL, fr.src(src, c), lb);
      if (up) fr.orr(dst, c, p, ch);
    }
  } else if (b < 5 + x.cbits) {
    col_slot_k<C>(b - 5, fr, src, dst, ch);
  } else if (b < x.lbits) {
    const bool up = (x.warp >> (b - 5 - x.cbits)) & 1;
    uint32_t* xb = x.xbuf + x.par * (x.M >> 1);
    x.par ^= 1;
    if (!up) {
#pragma unroll
      for (int c = 0; c < C; ++c)
        xb[squeeze(fr.jb + (c << 5), b)] = fr.src(src, c);
    }
    __syncthreads();
    if (up) {
#pragma unroll
      for (int c = 0; c < C; ++c)
        fr.orr(dst, c, xb[squeeze(fr.jb + (c << 5), b)], ch);
    }
  }
}

// Does any config hold the returning slot's bit? Read from the union
// row; the caller votes.
template <int C, class FR>
__device__ __forceinline__ int death_test_nz(FR& fr, const Ctx& x, int rs) {
  uint32_t nz = 0;
  if (rs < 0) return 0;
  if (rs < 5) {
#pragma unroll
    for (int c = 0; c < C; ++c) nz |= fr.uat(c) & C1[rs];
    return nz != 0;
  }
  const int b = rs - 5;
  if (b < 5) {
    if (x.lane & (1 << b)) {
#pragma unroll
      for (int c = 0; c < C; ++c) nz |= fr.uat(c);
    }
  } else if (b < 5 + x.cbits) {
#pragma unroll
    for (int c = 0; c < C; ++c)
      if ((c >> (b - 5)) & 1) nz |= fr.uat(c);
  } else if (b < x.lbits) {
    if ((x.warp >> (b - 5 - x.cbits)) & 1) {
#pragma unroll
      for (int c = 0; c < C; ++c) nz |= fr.uat(c);
    }
  }
  return nz != 0;
}

// RETURN filter on a live frontier (the death test passed): masks with
// bit rs move to the mask without it; the others drop. Every row and the
// union row alike (the map commutes with OR).
template <int C, class FR>
__device__ __forceinline__ void filter(FR& fr, const Ctx& x, int rs) {
  const int S = x.S;
  if (rs < 5) {
    const uint32_t c1 = C1[rs];
    const int sh = 1 << rs;
    each_row(fr, S, [&](int s) {
#pragma unroll
      for (int c = 0; c < C; ++c) fr.at(s, c) = (fr.at(s, c) & c1) >> sh;
    });
    return;
  }
  const int b = rs - 5;
  if (b < 5) {
    const int lb = 1 << b;
    const bool up = x.lane & lb;
    each_row(fr, S, [&](int s) {
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const uint32_t p = __shfl_xor_sync(FULL, fr.at(s, c), lb);
        fr.at(s, c) = up ? 0u : p;
      }
    });
  } else if (b < 5 + x.cbits) {
    col_filter_k<C>(b - 5, fr, S);
  } else if (b < x.lbits) {
    // The vote before this call was a block barrier, so every warp's
    // words are final. The upper warp of each pair hands its words down.
    const bool up = (x.warp >> (b - 5 - x.cbits)) & 1;
    const int half = x.M >> 1;
    if constexpr (FR::kReg) {
      if (up) {
        each_row(fr, S, [&](int s) {
#pragma unroll
          for (int c = 0; c < C; ++c) {
            x.xfil[s * half + squeeze(fr.jb + (c << 5), b)] = fr.at(s, c);
            fr.at(s, c) = 0;
          }
        });
      }
      __syncthreads();
      if (!up) {
        each_row(fr, S, [&](int s) {
#pragma unroll
          for (int c = 0; c < C; ++c)
            fr.at(s, c) = x.xfil[s * half + squeeze(fr.jb + (c << 5), b)];
        });
      }
    } else {
      if (!up) {
        each_row(fr, S, [&](int s) {
#pragma unroll
          for (int c = 0; c < C; ++c)
            fr.at(s, c) = fr.row(s)[(fr.jb + (c << 5)) | (1 << b)];
        });
      }
      __syncthreads();
      if (up) {
        each_row(fr, S, [&](int s) {
#pragma unroll
          for (int c = 0; c < C; ++c) fr.at(s, c) = 0;
        });
      }
    }
  }
}

struct Args {
  const int8_t* win;
  const int32_t* meta;
  const uint32_t* fr_in;
  int32_t* out;
  uint32_t* fr_out;
  int n, W, S, M, model, exact, warps, cbits;
};

template <int C, class FR>
__device__ __forceinline__ void scan(FR& fr, const Args& a, uint32_t* smem,
                                     const Layout& L) {
  const int tid = threadIdx.x, T = blockDim.x;
  const int key = blockIdx.x;
  // a compile-time S in the register store
  const int W = a.W, S = FR::kReg ? FR::kRows : a.S, M = a.M, nw = a.warps;
  const size_t SM = (size_t)S * M;
  const uint32_t* fi = a.fr_in + key * SM;
  uint32_t* fo = a.fr_out + key * SM;
  Ctx x;
  x.lane = tid & 31;
  x.warp = tid >> 5;
  x.cbits = a.cbits;
  x.lbits = 31 - __clz(M);
  x.S = S;
  x.M = M;
  x.xbuf = smem + L.xbuf;
  x.xfil = smem + L.xfil;
  x.par = 0;

  // own words of fr_in, and their union
#pragma unroll
  for (int c = 0; c < C; ++c) fr.uat(c) = 0;
  each_row(fr, S, [&](int s) {
    if (s == S) return;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const uint32_t v = fi[(size_t)s * M + fr.jb + (c << 5)];
      fr.at(s, c) = v;
      fr.uat(c) |= v;
    }
  });

  const int8_t* wk = a.win + (size_t)key * a.n * 4 * W;
  const int32_t* mk = a.meta + (size_t)key * a.n * META_COLS;
  const int nchunks = (a.n + CHUNK - 1) / CHUNK;
  // chunk q's win and meta into buffer q & 1; one commit group per chunk
  auto stage = [&](int q) {
    if (q < nchunks) {
      const int s0 = q * CHUNK, ns = min(CHUNK, a.n - s0);
      const uint32_t* gw =
          reinterpret_cast<const uint32_t*>(wk + (size_t)s0 * 4 * W);
      uint32_t* dw = smem + L.raw + (q & 1) * L.raw_words;
      for (int t = tid; t < ns * W; t += T) cp_async4(dw + t, gw + t);
      const uint32_t* gm =
          reinterpret_cast<const uint32_t*>(mk + (size_t)s0 * META_COLS);
      uint32_t* dm = dw + CHUNK * W;
      for (int t = tid; t < ns * META_COLS; t += T) cp_async4(dm + t, gm + t);
    }
    cp_async_commit();
  };
  int* desc = reinterpret_cast<int*>(smem + L.desc);
  int* sm = reinterpret_cast<int*>(smem + L.smeta);

  // block-uniform verdict state
  int alive = 1, taint = 0, died = -1, rtot = 0, rmax = 0;
  stage(0);
  stage(1);
  for (int q = 0; q < nchunks && alive; ++q) {
    cp_async_wait_1();
    __syncthreads();
    const int ns = min(CHUNK, a.n - q * CHUNK);
    {
      // decode: one warp per step, one lane per slot
      const uint32_t* raw = smem + L.raw + (q & 1) * L.raw_words;
      const int8_t* rw = reinterpret_cast<const int8_t*>(raw);
      const int32_t* rm = reinterpret_cast<const int32_t*>(raw + CHUNK * W);
      for (int i = x.warp; i < ns; i += nw) {
        const int8_t* ws = rw + i * 4 * W;
        const int32_t* ms = rm + i * META_COLS;
        const int fresh = ms[3];
        int ok0 = 0, ok1 = 0;
        if (x.lane < W) {
          int isu, src, dst;
          const int valid = slot_decode(a.model, ws[W + x.lane],
                                        ws[2 * W + x.lane],
                                        ws[3 * W + x.lane], &isu, &src, &dst);
          const int rows_ok = valid && dst >= 0 && dst < S &&
                              (isu || (src >= 0 && src < S));
          ok0 = rows_ok && ((fresh >> x.lane) & 1);
          ok1 = rows_ok && ws[x.lane] == 1;
          desc[i * W + x.lane] =
              rows_ok ? ((isu ? UNION_ROW : src) | (dst << 8)) : 0;
        }
        const unsigned g0 = __ballot_sync(FULL, ok0);
        const unsigned g1 = __ballot_sync(FULL, ok1);
        if (x.lane == 0) {
          sm[i * SMETA + 0] = ms[0];
          sm[i * SMETA + 1] = (ms[1] == 1) | ((fresh != 0) << 1);
          sm[i * SMETA + 2] = ms[2];
          sm[i * SMETA + 3] = (int)g0;
          sm[i * SMETA + 4] = (int)g1;
        }
      }
    }
    __syncthreads();
    stage(q + 2);  // the buffer just decoded is free again

    for (int i = 0; i < ns; ++i) {
      const int flags = sm[i * SMETA + 1];
      if (!(flags & 1)) continue;
      if (flags & 2) {
        // Round 0 expands only freshly invoked slots: the frontier
        // arrives closed under every other open op. Steps with no fresh
        // invokes skip the closure entirely.
        const int* dsc = desc + i * W;
        const uint32_t g0 = (uint32_t)sm[i * SMETA + 3];
        const uint32_t g1 = (uint32_t)sm[i * SMETA + 4];
        // Rounds r = 0, 1, ... (one call site keeps the code small). The
        // exact tier votes after every round; the fast tier runs
        // FAST_ROUNDS and votes only before the last, which it skips
        // when the one before changed nothing.
        int nr = 0, changed = 1;
        while (true) {
          const int vote = a.exact || nr + 2 == FAST_ROUNDS;
          if (vote) fr.take_snapshot();
          uint32_t ch = 0;
          uint32_t m = nr == 0 ? g0 : g1;
          int w = m ? __ffs((int)m) - 1 : 0;
          int d = dsc[w];
          while (m) {
            m &= m - 1;
            const int wn = m ? __ffs((int)m) - 1 : 0;
            const int dn = dsc[wn];  // the next slot's, ahead of use
            apply_slot<C>(fr, x, w, d & 0xFF, (d >> 8) & 0xFF, ch);
            w = wn;
            d = dn;
          }
          ++nr;
          if (vote) {
            if constexpr (FR::kReg) ch = fr.changed_since_snapshot();
            changed = block_any(ch != 0, nw);
          }
          if (a.exact ? !changed || nr > W + 2
                      : nr == FAST_ROUNDS || !changed)
            break;
        }
        if (a.exact) {
          rtot += nr;
          rmax = max(rmax, nr);
          if (changed) taint = 1;  // round bound hit without a fixpoint
        }
      }
      const int rs = sm[i * SMETA + 0];
      if (!block_any(death_test_nz<C>(fr, x, rs), nw)) {
        // death: fr_out keeps the pre-filter frontier
        alive = 0;
        died = sm[i * SMETA + 2];
        break;
      }
      filter<C>(fr, x, rs);
    }
  }
  cp_async_wait_all();

  if constexpr (FR::kReg) {
    each_row(fr, S, [&](int s) {
      if (s == S) return;
#pragma unroll
      for (int c = 0; c < C; ++c) fo[(size_t)s * M + fr.jb + (c << 5)] = fr.at(s, c);
    });
  } else {
    if (fr.f != fo) {
      for (int s = 0; s < S; ++s) {
#pragma unroll
        for (int c = 0; c < C; ++c)
          fo[(size_t)s * M + fr.jb + (c << 5)] = fr.at(s, c);
      }
    }
  }
  if (tid == 0) {
    int32_t* o = a.out + (size_t)key * OUT_COLS;
    o[0] = alive;
    o[1] = taint;
    o[2] = died;
    o[3] = rtot;
    o[4] = rmax;
    o[5] = 0;
    o[6] = 0;
    o[7] = 0;
  }
}

template <int C>
__host__ __device__ constexpr int log2c() {
  if constexpr (C <= 1) {
    return 0;
  } else {
    return 1 + log2c<C / 2>();
  }
}

// Threads a block of an instance may have: the register store keeps
// (2S+1) C words a thread (rows, union, snapshot), so those with
// (S+1) C <= 20 get 128 registers (512 threads), wider ones 255 (256).
__host__ __device__ constexpr int max_threads(int store, int rows, int cols) {
  return store != REGISTERS ? 1024 : (rows + 1) * cols <= 20 ? 512 : 256;
}

// STORE: REGISTERS (the frontier rows are SR, a compile-time S), SHARED
// or GLOBAL (SR = 0, S at run time); C columns a thread.
template <int STORE, int SR, int C>
__global__ void __launch_bounds__(max_threads(STORE, SR, C))
    bitset_scan_kernel(const Args a) {
  extern __shared__ uint32_t smem[];
  const Layout L = make_layout(a.W, a.S, a.M, STORE, a.warps);
  const int tid = threadIdx.x;
  const int jb = (tid & 31) | ((tid >> 5) << (5 + log2c<C>()));
  if constexpr (STORE == REGISTERS) {
    RegFrontier<SR, C> fr;
    fr.jb = jb;
    scan<C>(fr, a, smem, L);
  } else {
    MemFrontier<C> fr;
    fr.f = STORE == SHARED ? smem + L.fr : a.fr_out + blockIdx.x * (size_t)a.S * a.M;
    fr.u = smem + L.u;
    fr.S = a.S;
    fr.M = a.M;
    fr.jb = jb;
    scan<C>(fr, a, smem, L);
  }
}

// The instantiated geometries: (store, rows, columns a thread); rows 0
// means any S. wgl_bitset.INSTANCES lists the same table, and
// wgl_bitset.geometry() picks only from it.
#define BITSET_INSTANCES(X) \
  X(0, 8, 1)                \
  X(0, 8, 2)                \
  X(0, 8, 4)                \
  X(0, 16, 1)               \
  X(0, 16, 2)               \
  X(1, 0, 1)                \
  X(1, 0, 2)                \
  X(1, 0, 4)                \
  X(1, 0, 8)                \
  X(2, 0, 4)                \
  X(2, 0, 8)                \
  X(2, 0, 16)

}  // namespace

// Launch on the caller's stream; returns cudaGetLastError() (0 = ok), or
// cudaErrorInvalidValue for a geometry that is not instantiated.
extern "C" int bitset_scan_launch(const void* win, const void* meta,
                                  const void* fr_in, void* out, void* fr_out,
                                  int n_keys, int n, int W, int S, int M,
                                  int model, int exact, int store, int warps,
                                  int cols, void* stream) {
  if (W < 1 || W > MAX_W || warps < 1 || warps > 32 || 32 * warps * cols != M)
    return (int)cudaErrorInvalidValue;
  int cbits = 0;
  while ((1 << cbits) < cols) ++cbits;
  const Args a{static_cast<const int8_t*>(win),
               static_cast<const int32_t*>(meta),
               static_cast<const uint32_t*>(fr_in),
               static_cast<int32_t*>(out),
               static_cast<uint32_t*>(fr_out),
               n, W, S, M, model, exact, warps, cbits};
  const size_t smem =
      (size_t)make_layout(W, S, M, store, warps).total * sizeof(uint32_t);
  const int threads = 32 * warps;
  cudaError_t e = cudaErrorInvalidValue;
#define BITSET_LAUNCH(ST, SR, CC)                                         \
  if (store == ST && (SR == 0 || SR == S) && cols == CC) {                \
    if (threads > max_threads(ST, SR, CC)) return (int)cudaErrorInvalidValue; \
    auto k = bitset_scan_kernel<ST, SR, CC>;                              \
    e = cudaFuncSetAttribute(                                             \
        k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);       \
    if (e != cudaSuccess) return (int)e;                                  \
    k<<<n_keys, threads, smem, (cudaStream_t)stream>>>(a);                \
    return (int)cudaGetLastError();                                       \
  }
  BITSET_INSTANCES(BITSET_LAUNCH)
#undef BITSET_LAUNCH
  return (int)e;
}
