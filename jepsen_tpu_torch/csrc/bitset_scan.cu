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
// What bounds it on this card: neither bytes nor operations. The scan
// is sequential in steps and one key is one block, so one SM works and
// the rest idle; inside a step every slot of a closure round reads what
// the previous slot wrote, so a step costs a chain of __syncthreads
// (one per active slot per round, plus the filter's two). At W=12,
// S=8 the whole frontier is 4 KB.
//
// What the design does about it: the TPU grid's sequential step axis
// becomes a loop inside one block, the frontier stays on chip across
// all steps (dynamic shared memory when S*M*4 fits, otherwise the
// key's fr_out buffer in global memory, which stays L2-resident: 2 MB
// at W=19, S=32), slots the step gates off are skipped block-uniformly
// instead of computed as zeros, and the exact tier's convergence and
// the death test are single __syncthreads_or reductions. Within one
// slot no thread reads a word another thread writes: for w >= 5 the
// thread owning word j (bit w-5 set) reads word j ^ (1 << (w-5)), which
// the slot never writes; for w < 5 the relabeling stays in the word.
// Splitting one key over a cluster (DSMEM) is later work.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int OUT_COLS = 8;
constexpr int META_COLS = 4;
constexpr int MAX_W = 32;
constexpr int FAST_ROUNDS = 3;

// in-word mask-bit patterns: C1[k] has bit beta set iff beta & (1 << k)
__constant__ uint32_t C1[5] = {
    0xAAAAAAAAu, 0xCCCCCCCCu, 0xF0F0F0F0u, 0xFF00FF00u, 0xFFFF0000u};

// Slot transition (models.py *_bitset_slot): ids as models.KERNEL_*.
__device__ __forceinline__ void slot_decode(int model, int f, int a, int b,
                                            int* is_union, int* src,
                                            int* dst, int* valid) {
  switch (model) {
    case 0:  // cas-register
      *is_union = (f == 1);
      *src = a + 1;
      *dst = (f == 2 ? b : a) + 1;
      *valid = 1;
      break;
    case 1:  // register: cas never linearizes
      *is_union = (f == 1);
      *src = a + 1;
      *dst = a + 1;
      *valid = (f != 2);
      break;
    case 2:  // mutex
      *is_union = 0;
      *src = (f == 0 ? 0 : 1) + 1;
      *dst = (f == 0 ? 1 : 0) + 1;
      *valid = 1;
      break;
    default:
      *is_union = 0;
      *src = 0;
      *dst = 0;
      *valid = 0;
  }
}

struct StepSlots {
  int occ[MAX_W], is_union[MAX_W], src[MAX_W], dst[MAX_W], valid[MAX_W];
  int slot, live, opidx, fresh;
};

// One closure round over all W slots, chained in slot order (slot w+1
// sees what slot w added). Returns, block-uniformly, whether any bit was
// added (the frontier only grows, so that is "changed").
__device__ int closure_round(uint32_t* f, const StepSlots& st, int r,
                             int W, int S, int M) {
  const int tid = threadIdx.x, T = blockDim.x;
  int ch = 0;
  for (int w = 0; w < W; ++w) {
    const int gate = (r == 0) ? ((st.fresh >> w) & 1) : st.occ[w];
    const int dst = st.dst[w], src = st.src[w], isu = st.is_union[w];
    // gated-off slots, and rows outside [0, S), contribute nothing
    if (!(gate == 1 && st.valid[w])) continue;
    if (dst < 0 || dst >= S) continue;
    if (!isu && (src < 0 || src >= S)) continue;
    uint32_t* fd = f + (size_t)dst * M;
    if (w >= 5) {
      // word j with bit (w-5) set takes the source word j ^ (1 << (w-5))
      const int sh = w - 5;
      const int lowmask = (1 << sh) - 1;
      const int half = M >> 1;
      for (int p = tid; p < half; p += T) {
        const int j0 = ((p >> sh) << (sh + 1)) | (p & lowmask);
        const int j1 = j0 | (1 << sh);
        uint32_t v = 0;
        if (isu) {
          for (int s = 0; s < S; ++s) v |= f[(size_t)s * M + j0];
        } else {
          v = f[(size_t)src * M + j0];
        }
        const uint32_t old = fd[j1];
        const uint32_t nv = old | v;
        if (nv != old) {
          fd[j1] = nv;
          ch = 1;
        }
      }
    } else {
      // in-word relabeling: masks without bit w shift up by 2^w
      const uint32_t keep = ~C1[w];
      const int sh = 1 << w;
      for (int j = tid; j < M; j += T) {
        uint32_t v = 0;
        if (isu) {
          for (int s = 0; s < S; ++s) v |= f[(size_t)s * M + j];
        } else {
          v = f[(size_t)src * M + j];
        }
        v = (v & keep) << sh;
        const uint32_t old = fd[j];
        const uint32_t nv = old | v;
        if (nv != old) {
          fd[j] = nv;
          ch = 1;
        }
      }
    }
    __syncthreads();
  }
  return __syncthreads_or(ch);
}

__global__ void bitset_scan_kernel(const int8_t* __restrict__ win,
                                   const int32_t* __restrict__ meta,
                                   const int32_t* __restrict__ fr_in,
                                   int32_t* __restrict__ out,
                                   int32_t* __restrict__ fr_out, int n,
                                   int W, int S, int M, int model, int exact,
                                   int use_smem) {
  extern __shared__ uint32_t smem[];
  __shared__ StepSlots st;
  const int key = blockIdx.x;
  const int tid = threadIdx.x, T = blockDim.x;
  const size_t SM = (size_t)S * M;
  uint32_t* fo = reinterpret_cast<uint32_t*>(fr_out) + key * SM;
  uint32_t* f = use_smem ? smem : fo;
  const uint32_t* fi = reinterpret_cast<const uint32_t*>(fr_in) + key * SM;
  for (size_t i = tid; i < SM; i += T) f[i] = fi[i];

  const int8_t* wk = win + (size_t)key * n * 4 * W;
  const int32_t* mk = meta + (size_t)key * n * META_COLS;
  // block-uniform verdict state
  int alive = 1, taint = 0, died = -1, rtot = 0, rmax = 0;
  __syncthreads();

  for (int i = 0; i < n && alive; ++i) {
    if (tid < W) {
      const int8_t* ws = wk + (size_t)i * 4 * W;
      st.occ[tid] = ws[tid];
      slot_decode(model, ws[W + tid], ws[2 * W + tid], ws[3 * W + tid],
                  &st.is_union[tid], &st.src[tid], &st.dst[tid],
                  &st.valid[tid]);
    }
    if (tid == 0) {
      st.slot = mk[i * META_COLS + 0];
      st.live = mk[i * META_COLS + 1];
      st.opidx = mk[i * META_COLS + 2];
      st.fresh = mk[i * META_COLS + 3];
    }
    __syncthreads();
    if (st.live == 1) {
      // Round 0 expands only freshly invoked slots: the frontier
      // arrives closed under every other open op. Steps with no fresh
      // invokes skip the closure entirely.
      if (st.fresh != 0) {
        if (!exact) {
          for (int r = 0; r < FAST_ROUNDS; ++r)
            closure_round(f, st, r, W, S, M);
        } else {
          int changed = 1, nr = 0;
          while (changed && nr <= W + 2) {
            changed = closure_round(f, st, nr, W, S, M);
            ++nr;
          }
          rtot += nr;
          rmax = max(rmax, nr);
          if (changed) taint = 1;  // round bound hit without a fixpoint
        }
      }
      // RETURN filter, read-only pass first: does any config hold the
      // returning slot's bit?
      const int rs = st.slot;
      int nz = 0;
      if (rs >= 5) {
        const int sh = rs - 5;
        if ((1 << sh) < M) {
          const int lowmask = (1 << sh) - 1;
          const int half = M >> 1;
          for (size_t q = tid; q < (size_t)S * half; q += T) {
            const int s = (int)(q / half), p = (int)(q % half);
            const int j1 = ((p >> sh) << (sh + 1)) | (p & lowmask) | (1 << sh);
            if (f[(size_t)s * M + j1]) nz = 1;
          }
        }
      } else if (rs >= 0) {
        for (size_t q = tid; q < SM; q += T)
          if (f[q] & C1[rs]) nz = 1;
      }
      if (!__syncthreads_or(nz)) {
        // death: fr_out keeps the pre-filter frontier (already there in
        // the global placement)
        alive = 0;
        died = st.opidx;
        if (use_smem)
          for (size_t q = tid; q < SM; q += T) fo[q] = f[q];
      } else if (rs >= 5) {
        // masks with bit (rs-5) of the word index move down to the
        // word without it; each thread owns disjoint word pairs
        const int sh = rs - 5;
        const int lowmask = (1 << sh) - 1;
        const int half = M >> 1;
        for (size_t q = tid; q < (size_t)S * half; q += T) {
          const int s = (int)(q / half), p = (int)(q % half);
          const int j0 = ((p >> sh) << (sh + 1)) | (p & lowmask);
          uint32_t* row = f + (size_t)s * M;
          row[j0] = row[j0 | (1 << sh)];
          row[j0 | (1 << sh)] = 0;
        }
      } else {
        const uint32_t c1 = C1[rs];
        const int sh = 1 << rs;
        for (size_t q = tid; q < SM; q += T) f[q] = (f[q] & c1) >> sh;
      }
    }
    __syncthreads();
  }
  if (alive && use_smem)
    for (size_t q = tid; q < SM; q += T) fo[q] = f[q];
  if (tid == 0) {
    int32_t* o = out + (size_t)key * OUT_COLS;
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

}  // namespace

// Launch on the caller's stream; returns cudaGetLastError() (0 = ok).
extern "C" int bitset_scan_launch(const void* win, const void* meta,
                                  const void* fr_in, void* out, void* fr_out,
                                  int n_keys, int n, int W, int S, int M,
                                  int model, int exact, int use_smem,
                                  int threads, void* stream) {
  const size_t smem = use_smem ? (size_t)S * M * sizeof(uint32_t) : 0;
  cudaError_t e = cudaFuncSetAttribute(
      bitset_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  bitset_scan_kernel<<<n_keys, threads, smem, (cudaStream_t)stream>>>(
      static_cast<const int8_t*>(win), static_cast<const int32_t*>(meta),
      static_cast<const int32_t*>(fr_in), static_cast<int32_t*>(out),
      static_cast<int32_t*>(fr_out), n, W, S, M, model, exact, use_smem);
  return (int)cudaGetLastError();
}
