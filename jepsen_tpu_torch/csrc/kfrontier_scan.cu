// K-frontier WGL scan for Hopper (sm_90a).
//
// Replaces: jepsen_tpu/checker/wgl_pallas.py _make_kernel (launched by
// _pallas_scan through pl.pallas_call), with its helper _cumsum_excl.
// Same inputs, outputs and verdicts, including which candidates are
// dropped when the table is full (that decides the overflow taint and
// so the escalation ladder):
//
//   win   int32 [keys, n, 4, W]  per step: occ[W], f[W], a[W], b[W]
//   meta  int32 [keys, n, 1, 8]  slotbit, live, crashed mask, op index,
//                                init state
//   out   int32 [keys, 1, 8]     alive, overflow, died op, 0, 0,
//                                rounds total, rounds max, first
//                                tainted step
//
// The frontier is a table of K (state, mask, valid) configs with one
// mask word (W <= 32). Per return step, closure rounds (bounded by
// 2W+8) expand [W, K] candidates through the model's step, drop those
// the table holds or dominates, insert the rest into free slots by
// exclusive rank (candidates flattened w-major then k: rank r goes to
// the r-th free slot), then prune duplicates (lowest slot wins) and
// dominated configs. A round that drops candidates and changes nothing
// is a capacity overflow (taint). Then the RETURN filter keeps configs
// holding the returning slot's bit and clears it.
//
// What bounds it on this card: the sequential chain of rounds, not
// bytes (a step reads 16*W + 32 bytes) nor operations. One key is one
// block, and a round is a few dependent block-wide phases.
//
// What the design does about it: work follows the live table, which is
// usually about 10 configs of K. Each round first compacts the valid
// entries into a live list (ballot + __popc; the free slots' ranks fall
// out of the same pass as t minus the live entries before t), then
// expands only (occupied slot, live entry) pairs, in that order, which
// is the reference's w-major, k order restricted to the candidates that
// can exist. The hit test and the prune scan the live list, not K. A
// candidate's rank is its warp's __ballot_sync/__popc prefix plus the
// warp totals before it (one shared array, double-buffered, so a scan
// is one barrier), and the candidate is written to its free slot in
// the same pass: no candidate arrays, no separate assignment or valid
// passes. A round is about five barriers. The next step's window is
// loaded into registers while the current step runs.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int META_COLS = 8;
constexpr int OUT_COLS = 8;
constexpr int MAX_W = 32;
constexpr int MAX_WARPS = 32;
constexpr unsigned FULL = 0xFFFFFFFFu;

// Model step (models.py *_step_torch): ids as models.KERNEL_*.
__device__ __forceinline__ void model_step(int model, int state, int f,
                                           int a, int b, int* ok, int* s2) {
  switch (model) {
    case 0: {  // cas-register
      const int is_read = f == 0, is_write = f == 1, is_cas = f == 2;
      *ok = is_write | ((state == a) & (is_read | is_cas));
      *s2 = is_write ? a : (is_cas ? b : state);
      break;
    }
    case 1: {  // register
      const int is_read = f == 0, is_write = f == 1;
      *ok = is_write | (is_read & (state == a));
      *s2 = is_write ? a : state;
      break;
    }
    case 2: {  // mutex
      const int acq = f == 0;
      *ok = (acq & (state == 0)) | (!acq & (state == 1));
      *s2 = acq ? 1 : 0;
      break;
    }
    case 3: {  // packed unordered queue (4-bit counts per value code)
      const int nil = a < 0;
      const int sh = 4 * (a > 0 ? a : 0);
      // shifts past the word: left gives 0, arithmetic right the sign
      const int cnt = sh < 32 ? ((state >> sh) & 15) : (state < 0 ? 15 : 0);
      const int is_enq = f == 0;
      const int okv = !nil & (is_enq | ((f == 1) & (cnt > 0)));
      const int delta =
          sh < 32 ? (int)((uint32_t)(is_enq ? 1 : -1) << sh) : 0;
      *ok = okv;
      *s2 = okv ? (int)((uint32_t)state + (uint32_t)delta) : state;
      break;
    }
    default:
      *ok = 0;
      *s2 = state;
  }
}

// Dynamic shared memory, in 32-bit words (smem_words below; the wrapper
// keeps a copy to check the launch).
struct Layout {
  int fs, fm, fv;     // [K] table: state, mask, valid
  int ls, lm, lidx;   // [K] this round's configs: live, then inserted
  int freel;          // [K] r-th free slot
  int wsum;           // [2][MAX_WARPS] per-warp ballot totals
  int win;            // [2][4][MAX_W] the step's occupied slots: w, f, a, b
  int nocc;           // [2] their count
  int meta;           // [2][META_COLS]
  int total;
};

__host__ __device__ inline Layout make_layout(int K) {
  Layout L;
  int o = 0;
  L.fs = o;
  o += K;
  L.fm = o;
  o += K;
  L.fv = o;
  o += K;
  L.ls = o;
  o += K;
  L.lm = o;
  o += K;
  L.lidx = o;
  o += K;
  L.freel = o;
  o += K;
  L.wsum = o;
  o += 2 * MAX_WARPS;
  L.win = o;
  o += 2 * 4 * MAX_W;
  L.nocc = o;
  o += 2;
  L.meta = o;
  o += 2 * META_COLS;
  L.total = o;
  return L;
}

// Exclusive rank of a flagged thread among the flagged threads of this
// pass, and the pass's total: the warp's ballot prefix plus the totals
// of the warps before it. wsum[0..nw) is this pass's buffer; the caller
// alternates two buffers, so one barrier per pass suffices.
__device__ __forceinline__ int pass_rank(int flag, int* wsum, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = (blockDim.x + 31) >> 5;
  const unsigned bal = __ballot_sync(FULL, flag);
  if (lane == 0) wsum[warp] = __popc(bal);
  __syncthreads();
  int before = 0, all = 0;
  for (int g = 0; g < nw; ++g) {
    const int v = wsum[g];
    before += g < warp ? v : 0;
    all += v;
  }
  *total = all;
  return before + __popc(bal & ((1u << lane) - 1u));
}

__global__ void __launch_bounds__(1024)
    kfrontier_scan_kernel(const int32_t* __restrict__ win,
                          const int32_t* __restrict__ meta,
                          int32_t* __restrict__ out, int n, int W, int K,
                          int model) {
  extern __shared__ int32_t sm[];
  const Layout L = make_layout(K);
  int* fs = sm + L.fs;
  int* fm = sm + L.fm;
  int* fv = sm + L.fv;
  int* ls = sm + L.ls;
  int* lm = sm + L.lm;
  int* lidx = sm + L.lidx;
  int* freel = sm + L.freel;

  const int key = blockIdx.x;
  const int tid = threadIdx.x, T = blockDim.x;
  const int lane = tid & 31;
  const int32_t* wk = win + (size_t)key * n * 4 * W;
  const int32_t* mk = meta + (size_t)key * n * META_COLS;
  const int init_state = mk[4];
  for (int k = tid; k < K; k += T) {
    fs[k] = k == 0 ? init_state : 0;
    fm[k] = 0;
    fv[k] = k == 0;
  }
  // the next step's window (warp 0, lane w) and meta (lanes < 8)
  int r_occ = 0, r_f = 0, r_a = 0, r_b = 0, r_meta = 0;
  auto prefetch = [&](int i) {
    if (tid < W) {
      const int32_t* ws = wk + (size_t)i * 4 * W;
      r_occ = ws[tid];
      r_f = ws[W + tid];
      r_a = ws[2 * W + tid];
      r_b = ws[3 * W + tid];
    }
    if (tid < META_COLS) r_meta = mk[(size_t)i * META_COLS + tid];
  };
  if (n > 0) prefetch(0);
  // block-uniform verdict state
  int alive = 1, ovf_any = 0, died = -1, rtot = 0, rmax = 0, first = -1;
  int par = 0;  // wsum buffer of the next pass

  for (int i = 0; i < n && alive; ++i) {
    // publish step i: its occupied slots in slot order, and its meta
    // (double-buffered by step, so a thread still reading step i-1's
    // copy races nothing)
    const int sb = i & 1;
    int* o_w = sm + L.win + sb * 4 * MAX_W;
    int* o_f = o_w + MAX_W;
    int* o_a = o_f + MAX_W;
    int* o_b = o_a + MAX_W;
    if (tid < 32) {
      const int occ = tid < W && r_occ == 1;
      const unsigned bal = __ballot_sync(FULL, occ);
      if (occ) {
        const int p = __popc(bal & ((1u << lane) - 1u));
        o_w[p] = tid;
        o_f[p] = r_f;
        o_a[p] = r_a;
        o_b[p] = r_b;
      }
      if (tid == 0) sm[L.nocc + sb] = __popc(bal);
    }
    if (tid < META_COLS) sm[L.meta + sb * META_COLS + tid] = r_meta;
    __syncthreads();
    if (i + 1 < n) prefetch(i + 1);
    const int* smeta = sm + L.meta + sb * META_COLS;
    const int slotbit = smeta[0], live = smeta[1], cr = smeta[2];
    const int opidx = smeta[3];
    const int nocc = sm[L.nocc + sb];
    if (live == 1) {
      int go = 1, ovf = 0, r = 0;
      while (go && r <= 2 * W + 8) {
        // 1. live list ls/lm/lidx[0, nl) and free list freel[0, K - nl),
        // both in slot order, from one ballot pass over the table
        int nl = 0;
        for (int base = 0; base < K; base += T) {
          const int t = base + tid;
          const int v = t < K && fv[t] == 1;
          int tot;
          const int p = nl + pass_rank(v, sm + L.wsum + par * MAX_WARPS, &tot);
          par ^= 1;
          if (t < K) {
            if (v) {
              ls[p] = fs[t];
              lm[p] = fm[t];
              lidx[p] = t;
            } else {
              freel[t - p] = t;
            }
          }
          nl += tot;
        }
        const int nfree = K - nl;
        __syncthreads();
        // 2. candidates (occupied slot o, live entry e), o-major: drop
        // what the live table holds or dominates, rank the rest, and
        // write rank r < nfree into the r-th free slot
        const int ncand = nocc * nl;
        int total_new = 0, chg = 0;
        for (int base = 0; base < ncand; base += T) {
          const int c = base + tid;
          int nw = 0, s2 = 0, cmv = 0;
          if (c < ncand) {
            const int o = c / nl, e = c - o * nl;
            const int bit = (int)(1u << o_w[o]);
            const int me = lm[e];
            if ((me & bit) == 0) {
              int ok;
              model_step(model, ls[e], o_f[o], o_a[o], o_b[o], &ok, &s2);
              if (ok) {
                cmv = me | bit;
                int hit = 0;
                for (int t = 0; t < nl && !hit; ++t) {
                  if (ls[t] != s2) continue;
                  const int ft = lm[t];
                  const int cra_t = ft & cr;
                  hit = ft == cmv || (((ft & ~cr) == (cmv & ~cr)) &&
                                      ((cra_t & cmv) == cra_t));
                }
                nw = !hit;
              }
            }
          }
          int tot;
          const int rk =
              total_new + pass_rank(nw, sm + L.wsum + par * MAX_WARPS, &tot);
          par ^= 1;
          if (nw && rk < nfree) {
            const int t = freel[rk];
            if (fs[t] != s2 || fm[t] != cmv) chg = 1;
            fs[t] = s2;
            fm[t] = cmv;
            ls[nl + rk] = s2;
            lm[nl + rk] = cmv;
            lidx[nl + rk] = t;
          }
          total_new += tot;
        }
        const int n2 = nl + min(total_new, nfree);
        __syncthreads();
        // 3. self-prune over the live and inserted configs: duplicates
        // (lowest slot wins) and dominated configs (equal live bits,
        // crashed bits a superset); each thread owns its entries' fv
        for (int j = tid; j < n2; j += T) {
          const int sj = ls[j], mj = lm[j], tj = lidx[j];
          int v3 = 1;
          for (int q = 0; q < n2; ++q) {
            if (ls[q] != sj) continue;
            const int mq = lm[q];
            const int cra_q = mq & cr;
            if (mq == mj) {
              if (lidx[q] < tj) {
                v3 = 0;
                break;
              }
            } else if ((mq & ~cr) == (mj & ~cr) &&
                       (cra_q & (mj & cr)) == cra_q) {
              v3 = 0;
              break;
            }
          }
          fv[tj] = v3;
          if (v3 != (j < nl)) chg = 1;
        }
        const int changed = __syncthreads_or(chg);
        // capacity-with-retry: only a round that drops candidates and
        // changes nothing is a genuine overflow
        if (total_new > nfree && !changed) ovf = 1;
        go = changed;
        ++r;
      }
      rtot += r;
      rmax = max(rmax, r);
      if (go) ovf = 1;  // round bound hit without convergence
      // RETURN filter
      int any = 0;
      for (int t = tid; t < K; t += T) {
        const int has = (fm[t] & slotbit) != 0;
        fv[t] = fv[t] * has;
        fm[t] = fm[t] & ~slotbit;
        any |= fv[t];
      }
      if (!__syncthreads_or(any)) {
        alive = 0;
        died = opidx;
      }
      if (ovf && !ovf_any) first = i;
      if (ovf) ovf_any = 1;
    }
  }
  if (tid == 0) {
    int32_t* o = out + (size_t)key * OUT_COLS;
    o[0] = alive;
    o[1] = ovf_any;
    o[2] = died;
    o[3] = 0;
    o[4] = 0;
    o[5] = rtot;
    o[6] = rmax;
    o[7] = first;
  }
}

}  // namespace

// Launch on the caller's stream; returns cudaGetLastError() (0 = ok).
extern "C" int kfrontier_scan_launch(const void* win, const void* meta,
                                     void* out, int n_keys, int n, int W,
                                     int K, int model, int threads,
                                     void* stream) {
  if (W < 1 || W > MAX_W || threads < 32 || threads > 32 * MAX_WARPS ||
      threads % 32)
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)make_layout(K).total * sizeof(int32_t);
  cudaError_t e = cudaFuncSetAttribute(
      kfrontier_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  kfrontier_scan_kernel<<<n_keys, threads, smem, (cudaStream_t)stream>>>(
      static_cast<const int32_t*>(win), static_cast<const int32_t*>(meta),
      static_cast<int32_t*>(out), n, W, K, model);
  return (int)cudaGetLastError();
}
