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
// dominated configs over [K, K]. A round that drops candidates and
// changes nothing is a capacity overflow (taint). Then the RETURN
// filter keeps configs holding the returning slot's bit and clears it.
//
// What bounds it on this card: the sequential chain of rounds, not
// bytes (a step reads 16*W + 32 bytes) nor operations. One key is one
// block; each round is a handful of dependent block-wide phases
// (expand/filter, two exclusive scans, assignment, prune), each ending
// in __syncthreads, so a round costs a few microseconds of barrier
// latency with most threads idle while the live table stays small.
//
// What the design does about it: the table, the candidates and their
// ranks stay in shared memory for the whole scan (48 KB at K=128,
// W=32); only candidates of live configs, and only live table entries,
// enter the dedup/dominance and prune loops, so their cost follows the
// live frontier (usually ~10 configs) rather than K; the exclusive
// scans are one chunked pass per thread plus a Hillis-Steele scan over
// thread totals.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int META_COLS = 8;
constexpr int OUT_COLS = 8;
constexpr int MAX_W = 32;
constexpr int MAX_THREADS = 1024;

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

// In-place exclusive prefix sum of a[0..n) over the block; returns the
// total. Callers sync before (a written) — it syncs before returning.
__device__ int block_exscan(int* a, int n, int* tmp) {
  const int tid = threadIdx.x, T = blockDim.x;
  const int chunk = (n + T - 1) / T;
  const int lo = min(tid * chunk, n), hi = min(lo + chunk, n);
  int s = 0;
  for (int i = lo; i < hi; ++i) s += a[i];
  tmp[tid] = s;
  __syncthreads();
  for (int off = 1; off < T; off <<= 1) {
    const int v = tid >= off ? tmp[tid - off] : 0;
    __syncthreads();
    tmp[tid] += v;
    __syncthreads();
  }
  int run = tmp[tid] - s;
  const int total = tmp[T - 1];
  for (int i = lo; i < hi; ++i) {
    const int x = a[i];
    a[i] = run;
    run += x;
  }
  __syncthreads();
  return total;
}

__global__ void kfrontier_scan_kernel(const int32_t* __restrict__ win,
                                      const int32_t* __restrict__ meta,
                                      int32_t* __restrict__ out, int n, int W,
                                      int K, int model) {
  extern __shared__ int32_t sm[];
  int* fs = sm;             // [K] states
  int* fm = fs + K;         // [K] masks
  int* fv = fm + K;         // [K] valid
  int* ins = fv + K;        // [K] inserted this round, then pruned valid
  int* fv2 = ins + K;       // [K] valid after insertion
  int* frank = fv2 + K;     // [K] free-slot exclusive ranks
  int* freelist = frank + K;  // [K] r-th free slot
  const int C = W * K;
  int* cs = freelist + K;   // [W*K] candidate states
  int* cm = cs + C;         // [W*K] candidate masks
  int* rank = cm + C;       // [W*K] new flags, then exclusive ranks
  __shared__ int s_occ[MAX_W], s_f[MAX_W], s_a[MAX_W], s_b[MAX_W];
  __shared__ int s_meta[META_COLS];
  __shared__ int scan_tmp[MAX_THREADS];

  const int key = blockIdx.x;
  const int tid = threadIdx.x, T = blockDim.x;
  const int32_t* wk = win + (size_t)key * n * 4 * W;
  const int32_t* mk = meta + (size_t)key * n * META_COLS;
  const int init_state = mk[4];
  for (int k = tid; k < K; k += T) {
    fs[k] = k == 0 ? init_state : 0;
    fm[k] = 0;
    fv[k] = k == 0;
  }
  // block-uniform verdict state
  int alive = 1, ovf_any = 0, died = -1, rtot = 0, rmax = 0, first = -1;
  __syncthreads();

  for (int i = 0; i < n && alive; ++i) {
    if (tid < W) {
      const int32_t* ws = wk + (size_t)i * 4 * W;
      s_occ[tid] = ws[tid];
      s_f[tid] = ws[W + tid];
      s_a[tid] = ws[2 * W + tid];
      s_b[tid] = ws[3 * W + tid];
    }
    if (tid < META_COLS) s_meta[tid] = mk[(size_t)i * META_COLS + tid];
    __syncthreads();
    const int slotbit = s_meta[0], live = s_meta[1], cr = s_meta[2];
    const int opidx = s_meta[3];
    if (live == 1) {
      int go = 1, ovf = 0, r = 0;
      while (go && r <= 2 * W + 8) {
        // Expand [W, K] candidates, flattened c = w*K + k, and drop the
        // ones the table already holds or dominates.
        for (int c = tid; c < C; c += T) {
          const int w = c / K, k = c - (c / K) * K;
          const int bit = (int)(1u << w);
          int nw = 0;
          if (fv[k] == 1 && s_occ[w] == 1 && (fm[k] & bit) == 0) {
            int ok, s2;
            model_step(model, fs[k], s_f[w], s_a[w], s_b[w], &ok, &s2);
            if (ok) {
              const int cmv = fm[k] | bit;
              int hit = 0;
              for (int t = 0; t < K && !hit; ++t) {
                if (fv[t] != 1 || fs[t] != s2) continue;
                const int ft = fm[t];
                const int cra_t = ft & cr;
                hit = ft == cmv ||
                      (((ft & ~cr) == (cmv & ~cr)) && ((cra_t & cmv) == cra_t));
              }
              nw = !hit;
              cs[c] = s2;
              cm[c] = cmv;
            }
          }
          rank[c] = nw;
        }
        for (int t = tid; t < K; t += T) frank[t] = fv[t] != 1;
        __syncthreads();
        // new flag of c = rank[c+1] - rank[c] after the scan
        const int total_new = block_exscan(rank, C, scan_tmp);
        const int nfree = block_exscan(frank, K, scan_tmp);
        for (int t = tid; t < K; t += T) {
          if (fv[t] != 1) freelist[frank[t]] = t;
          ins[t] = 0;
        }
        __syncthreads();
        // Assignment: candidate of rank r -> the r-th free slot.
        int chg = 0;
        for (int c = tid; c < C; c += T) {
          const int next = c + 1 < C ? rank[c + 1] : total_new;
          const int rc = rank[c];
          if (next - rc == 1 && rc < nfree) {
            const int t = freelist[rc];
            if (fs[t] != cs[c] || fm[t] != cm[c]) chg = 1;
            fs[t] = cs[c];
            fm[t] = cm[c];
            ins[t] = 1;
          }
        }
        __syncthreads();
        for (int t = tid; t < K; t += T) fv2[t] = fv[t] | ins[t];
        __syncthreads();
        // Self-prune: duplicates (lowest slot wins) and dominated
        // configs (equal live bits, crashed bits a superset).
        for (int j = tid; j < K; j += T) {
          int v3 = fv2[j];
          if (v3) {
            const int sj = fs[j], mj = fm[j];
            for (int q = 0; q < K; ++q) {
              if (!fv2[q] || fs[q] != sj) continue;
              const int mq = fm[q];
              const int cra_q = mq & cr;
              if (mq == mj) {
                if (q < j) {
                  v3 = 0;
                  break;
                }
              } else if ((mq & ~cr) == (mj & ~cr) &&
                         (cra_q & (mj & cr)) == cra_q) {
                v3 = 0;
                break;
              }
            }
          }
          ins[j] = v3;
          if (v3 != fv[j]) chg = 1;
        }
        __syncthreads();
        for (int t = tid; t < K; t += T) fv[t] = ins[t];
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
    __syncthreads();
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

// dynamic shared memory of one block: seven [K] arrays, three [W*K]
size_t smem_bytes(int W, int K) {
  return (size_t)(7 * K + 3 * W * K) * sizeof(int32_t);
}

}  // namespace

// Launch on the caller's stream; returns cudaGetLastError() (0 = ok).
extern "C" int kfrontier_scan_launch(const void* win, const void* meta,
                                     void* out, int n_keys, int n, int W,
                                     int K, int model, int threads,
                                     void* stream) {
  const size_t smem = smem_bytes(W, K);
  cudaError_t e = cudaFuncSetAttribute(
      kfrontier_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  kfrontier_scan_kernel<<<n_keys, threads, smem, (cudaStream_t)stream>>>(
      static_cast<const int32_t*>(win), static_cast<const int32_t*>(meta),
      static_cast<int32_t*>(out), n, W, K, model);
  return (int)cudaGetLastError();
}
