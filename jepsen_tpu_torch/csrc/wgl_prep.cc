// Native fast path for the events->steps host prep (checker/events.py;
// a copy of the JAX package's resources/wgl_prep.cc): ONE O(n) pass
// over the flat event stream filling the per-return window snapshots
// the WGL kernels consume. Byte-identical to the vectorized numpy path
// (freed window cells zero out); the caller allocates every output and
// passes n_ret-sized buffers. Built with g++ at first use by
// checker/_build.native_library, into the same content-addressed
// directory as wgl_native.cc; without a toolchain callers fall back to
// the numpy path.
//
// Layout contract (all C-contiguous):
//   kind/slot/f/a/b/op_index  int32[n]   (op_index may be NULL)
//   out_occ   uint8[n_ret * W]   (numpy bool rows)
//   out_f/a/b int32[n_ret * W]
//   out_slot  int32[n_ret]
//   out_crashed / out_fresh  int32[n_ret * nw]
//   out_opidx int32[n_ret]       (pre-filled -1 when op_index NULL)
// Returns the number of RETURN events written (must equal n_ret).

#include <cstdint>
#include <cstring>
#include <vector>

namespace {
constexpr int32_t EV_INVOKE = 0;
constexpr int32_t EV_RETURN = 1;
}  // namespace

extern "C" long long wgl_prep_steps(
    const int32_t* kind, const int32_t* slot, const int32_t* f,
    const int32_t* a, const int32_t* b, const int32_t* op_index,
    long long n, int32_t W, int32_t nw, uint8_t* out_occ,
    int32_t* out_f, int32_t* out_a, int32_t* out_b, int32_t* out_slot,
    int32_t* out_crashed, int32_t* out_opidx, int32_t* out_fresh) {
  if (W <= 0 || nw <= 0) return -1;
  // Pass 1: which invokes never return. A slot's open invoke is
  // cleared by the next RETURN on that slot; whatever stays marked is
  // a crashed occupant (crashed slots are never recycled).
  std::vector<long long> open_at(static_cast<size_t>(W), -1);
  std::vector<uint8_t> crashed_inv(static_cast<size_t>(n), 0);
  for (long long i = 0; i < n; i++) {
    int32_t s = slot[i];
    if (s < 0 || s >= W) return -1;
    if (kind[i] == EV_INVOKE) {
      open_at[s] = i;
      crashed_inv[i] = 1;
    } else if (kind[i] == EV_RETURN) {
      if (open_at[s] >= 0) crashed_inv[open_at[s]] = 0;
      open_at[s] = -1;
    }
  }
  // Pass 2: carry the open-op window and emit a snapshot per RETURN.
  std::vector<uint8_t> occ(static_cast<size_t>(W), 0);
  std::vector<int32_t> cf(static_cast<size_t>(W), 0);
  std::vector<int32_t> ca(static_cast<size_t>(W), 0);
  std::vector<int32_t> cb(static_cast<size_t>(W), 0);
  std::vector<int32_t> crash(static_cast<size_t>(nw), 0);
  std::vector<int32_t> fresh(static_cast<size_t>(nw), 0);
  const size_t wb = static_cast<size_t>(W);
  const size_t nwb = static_cast<size_t>(nw) * sizeof(int32_t);
  long long j = 0;
  for (long long i = 0; i < n; i++) {
    int32_t k = kind[i];
    int32_t s = slot[i];
    if (k == EV_INVOKE) {
      occ[s] = 1;
      cf[s] = f[i];
      ca[s] = a[i];
      cb[s] = b[i];
      int32_t bit = static_cast<int32_t>(1u << (s & 31));
      fresh[s >> 5] |= bit;
      if (crashed_inv[i]) crash[s >> 5] |= bit;
    } else if (k == EV_RETURN) {
      std::memcpy(out_occ + j * wb, occ.data(), wb);
      std::memcpy(out_f + j * wb, cf.data(), wb * sizeof(int32_t));
      std::memcpy(out_a + j * wb, ca.data(), wb * sizeof(int32_t));
      std::memcpy(out_b + j * wb, cb.data(), wb * sizeof(int32_t));
      std::memcpy(out_crashed + j * nw, crash.data(), nwb);
      std::memcpy(out_fresh + j * nw, fresh.data(), nwb);
      std::memset(fresh.data(), 0, nwb);
      out_slot[j] = s;
      if (op_index != nullptr) out_opidx[j] = op_index[i];
      j++;
      // Freed cells zero out (the vectorized-path convention — the
      // kernel gates on occ, but byte-identity across prep paths
      // keeps the differential tests exact).
      occ[s] = 0;
      cf[s] = 0;
      ca[s] = 0;
      cb[s] = 0;
    }
  }
  return j;
}
