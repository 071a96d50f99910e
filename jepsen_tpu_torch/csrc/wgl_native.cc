// Native WGL frontier search — the C++ rung of the oracle ladder (a
// copy of the JAX package's resources/wgl_native.cc; host code, built
// with g++ by checker/_build.native_library).
//
// A faithful fast-language implementation of the same set-based
// Wing–Gong / just-in-time-linearization frontier search the Python
// oracle runs (checker/wgl_oracle.py:check_events), which is
// the role knossos.wgl plays for the reference
// (jepsen/src/jepsen/checker.clj:127-158 delegates to knossos on the
// control-node JVM). Configurations are (state, linearized-mask) pairs;
// a RETURN filters to configs with the returning op linearized; crashed
// (:info) ops stay open forever, tamed by the same exactness-preserving
// crashed-bit dominance pruning the Python oracle uses.
//
// Scope: models whose state fits an int32 — register family, mutex,
// and the packed count-vector queue (models.py unordered-queue-packed)
// — with windows up to 64 open slots (one machine word of mask). Wider
// windows and rich-state models (tuple-multiset unordered-queue)
// return UNSUPPORTED and the caller falls back to the Python oracle,
// whose masks and states are unbounded.
//
// This file is both a product component (a fast host-side rung between
// the device engines and the Python oracle in the escalation ladder) and
// the strong CPU baseline: it answers "what would knossos.wgl
// cost on a fast runtime" without needing a JVM in the image.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <unordered_map>
#include <unordered_set>
#include <vector>

namespace {

constexpr int EV_INVOKE = 0;
constexpr int EV_RETURN = 1;
constexpr int EV_NOP = 2;

constexpr int MODEL_CAS_REGISTER = 0;
constexpr int MODEL_REGISTER = 1;
constexpr int MODEL_MUTEX = 2;
constexpr int MODEL_QUEUE_PACKED = 3;

constexpr int F_READ = 0, F_WRITE = 1, F_CAS = 2;
constexpr int F_ACQUIRE = 0, F_RELEASE = 1;
constexpr int F_ENQ = 0, F_DEQ = 1;

struct Config {
  int32_t state;
  uint64_t mask;
  bool operator==(const Config& o) const {
    return state == o.state && mask == o.mask;
  }
};

struct ConfigHash {
  size_t operator()(const Config& c) const {
    // splitmix64 over the packed 96 bits.
    uint64_t x = c.mask ^ (static_cast<uint64_t>(
                               static_cast<uint32_t>(c.state))
                           * 0x9e3779b97f4a7c15ULL);
    x ^= x >> 30;
    x *= 0xbf58476d1ce4e5b9ULL;
    x ^= x >> 27;
    x *= 0x94d049bb133111ebULL;
    x ^= x >> 31;
    return static_cast<size_t>(x);
  }
};

using Frontier = std::unordered_set<Config, ConfigHash>;

struct OpenOp {
  int32_t f, a, b;
  bool open = false;
};

// step(state, f, a, b) -> (ok, state'). Mirrors models.py step_py.
inline bool step(int model, int32_t state, int32_t f, int32_t a,
                 int32_t b, int32_t* out) {
  switch (model) {
    case MODEL_CAS_REGISTER:
      if (f == F_READ) { *out = state; return state == a; }
      if (f == F_WRITE) { *out = a; return true; }
      /* F_CAS */ *out = b; return state == a;
    case MODEL_REGISTER:
      if (f == F_READ) { *out = state; return state == a; }
      if (f == F_WRITE) { *out = a; return true; }
      return false;  // cas is outside the model: never linearizes
    case MODEL_MUTEX:
      if (f == F_ACQUIRE) { *out = 1; return state == 0; }
      /* F_RELEASE */ *out = 0; return state == 1;
    default: {  // MODEL_QUEUE_PACKED: count-vector in nibbles
      if (a < 0) { *out = state; return false; }  // NIL never linearizes
      int shift = 4 * a;
      if (f == F_ENQ) { *out = state + (1 << shift); return true; }
      /* F_DEQ */
      if ((state >> shift) & 15) { *out = state - (1 << shift); return true; }
      *out = state;
      return false;
    }
  }
}

// Crashed-bit dominance pruning, the exact mirror of wgl_oracle._prune:
// within a (state, live-bits) group, keep only crashed-bit sets with no
// kept subset (the dominator can replay any future of the dominated).
void prune(Frontier& frontier, uint64_t crashed_mask) {
  if (!crashed_mask || frontier.size() < 2) return;
  struct Key {
    int32_t state;
    uint64_t live;
    bool operator==(const Key& o) const {
      return state == o.state && live == o.live;
    }
  };
  struct KeyHash {
    size_t operator()(const Key& k) const {
      return ConfigHash()(Config{k.state, k.live});
    }
  };
  std::unordered_map<Key, std::vector<uint64_t>, KeyHash> groups;
  groups.reserve(frontier.size());
  for (const auto& c : frontier) {
    groups[Key{c.state, c.mask & ~crashed_mask}].push_back(
        c.mask & crashed_mask);
  }
  Frontier out;
  out.reserve(frontier.size());
  std::vector<uint64_t> kept;
  for (auto& [key, cbs] : groups) {
    std::sort(cbs.begin(), cbs.end(),
              [](uint64_t x, uint64_t y) {
                int px = __builtin_popcountll(x);
                int py = __builtin_popcountll(y);
                return px != py ? px < py : x < y;
              });
    kept.clear();
    for (uint64_t cb : cbs) {
      bool dominated = false;
      for (uint64_t k : kept) {
        if ((k & cb) == k) { dominated = true; break; }
      }
      if (!dominated) kept.push_back(cb);
    }
    for (uint64_t cb : kept) out.insert(Config{key.state, key.live | cb});
  }
  frontier.swap(out);
}

// BFS closure with per-layer dominance pruning — mirror of _closure.
void closure(Frontier& frontier, const std::vector<OpenOp>& open_ops,
             int model, uint64_t crashed_mask, bool do_prune) {
  std::vector<Config> layer(frontier.begin(), frontier.end());
  std::vector<Config> nxt;
  while (!layer.empty()) {
    nxt.clear();
    for (const auto& cfg : layer) {
      for (size_t s = 0; s < open_ops.size(); ++s) {
        const OpenOp& op = open_ops[s];
        if (!op.open || ((cfg.mask >> s) & 1)) continue;
        int32_t state2;
        if (step(model, cfg.state, op.f, op.a, op.b, &state2)) {
          Config c2{state2, cfg.mask | (1ULL << s)};
          if (frontier.insert(c2).second) nxt.push_back(c2);
        }
      }
    }
    if (do_prune && !nxt.empty() && crashed_mask) {
      prune(frontier, crashed_mask);
      // Keep only next-layer configs that survived the prune.
      std::vector<Config> filtered;
      filtered.reserve(nxt.size());
      for (const auto& c : nxt)
        if (frontier.count(c)) filtered.push_back(c);
      nxt.swap(filtered);
    }
    layer.swap(nxt);
  }
}

}  // namespace

extern "C" {

// Returns 1 valid, 0 invalid, -2 unsupported (window > 64 / model).
// out_stats (optional, int64[2]): [0] max frontier size, [1] failing
// event position (-1 when valid).
long long wgl_native_check(const int32_t* kind, const int32_t* slot,
                           const int32_t* f, const int32_t* a,
                           const int32_t* b,
                           const uint8_t* crashed_inv,  // may be null
                           long long n, int32_t init_state,
                           int32_t model, int32_t window,
                           long long* out_stats) {
  if (window > 64 || window < 0) return -2;
  if (model != MODEL_CAS_REGISTER && model != MODEL_REGISTER &&
      model != MODEL_MUTEX && model != MODEL_QUEUE_PACKED)
    return -2;

  Frontier frontier;
  frontier.insert(Config{init_state, 0});
  std::vector<OpenOp> open_ops(static_cast<size_t>(window));
  uint64_t crashed_mask = 0;
  long long max_frontier = 1;
  const bool do_prune = crashed_inv != nullptr;

  for (long long i = 0; i < n; ++i) {
    int k = kind[i];
    if (k == EV_NOP) continue;
    int s = slot[i];
    if (k == EV_INVOKE) {
      open_ops[s] = OpenOp{f[i], a[i], b[i], true};
      if (do_prune && crashed_inv[i]) crashed_mask |= 1ULL << s;
    } else {  // EV_RETURN of the op in slot s
      closure(frontier, open_ops, model, crashed_mask, do_prune);
      if (static_cast<long long>(frontier.size()) > max_frontier)
        max_frontier = frontier.size();
      Frontier filtered;
      filtered.reserve(frontier.size());
      const uint64_t bit = 1ULL << s;
      for (const auto& c : frontier)
        if (c.mask & bit) filtered.insert(Config{c.state, c.mask & ~bit});
      frontier.swap(filtered);
      open_ops[s].open = false;
      if (frontier.empty()) {
        if (out_stats) { out_stats[0] = max_frontier; out_stats[1] = i; }
        return 0;
      }
    }
  }
  if (out_stats) { out_stats[0] = max_frontier; out_stats[1] = -1; }
  return 1;
}

}  // extern "C"
