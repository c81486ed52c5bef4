// Probe instances of the sm_90a forward template
// (tdc_video_tpu_torch/csrc/flash_fwd_sm90.cuh) for choosing fwd90::Tuned:
// each a Cfg of keys per tile, consumer warpgroups, persistence and the
// consumers' registers, causal at DP = 128 (K1's shapes) and non-causal at
// DP = 64 and 80 (the towers').
// Not one of the port's kernels: scripts/torch_fwd_sm90_probe.py builds it
// (nvcc -I tdc_video_tpu_torch/csrc), checks every instance against the plain
// version and times it.
#include "flash_fwd_sm90.cuh"

namespace {
using tdc::fwd90::Cfg;
template <int DP, bool CAUSAL, class C>
cudaError_t run(const tdc::FwdParams& p, cudaStream_t s) {
  return p.lse != nullptr ? tdc::launch_fwd_sm90<DP, CAUSAL, true, C>(p, s)
                          : tdc::launch_fwd_sm90<DP, CAUSAL, false, C>(p, s);
}
typedef cudaError_t (*RunFn)(const tdc::FwdParams&, cudaStream_t);
struct Probe {
  const char* name;
  int dp, causal;
  RunFn fn;
};
// name: DP, keys per tile, consumer warpgroups, persistent, consumer
// registers by setmaxnreg. "tuned" marks fwd90::Tuned's choice.
const Probe PROBES[] = {
    {"DP128 causal K64 WG2 (tuned)", 128, 1, run<128, true, Cfg<64, 2, false>>},
    {"DP128 causal K64 WG2 persistent", 128, 1, run<128, true, Cfg<64, 2, true>>},
    {"DP64 K64 WG2", 64, 0, run<64, false, Cfg<64, 2, false>>},
    {"DP64 K64 WG2 persistent", 64, 0, run<64, false, Cfg<64, 2, true>>},
    {"DP64 K64 WG3", 64, 0, run<64, false, Cfg<64, 3, false>>},
    {"DP64 K64 WG3 persistent", 64, 0, run<64, false, Cfg<64, 3, true>>},
    {"DP64 K128 WG3 persistent reg160 (tuned)", 64, 0, run<64, false, Cfg<128, 3, true, 160>>},
    {"DP80 K64 WG2", 80, 0, run<80, false, Cfg<64, 2, false>>},
    {"DP80 K64 WG3", 80, 0, run<80, false, Cfg<64, 3, false>>},
    {"DP80 K64 WG3 persistent (tuned)", 80, 0, run<80, false, Cfg<64, 3, true>>},
    {"DP80 K64 WG3 persistent reg160", 80, 0, run<80, false, Cfg<64, 3, true, 160>>},
};
constexpr int N_PROBES = sizeof(PROBES) / sizeof(PROBES[0]);
}  // namespace

extern "C" int tdc_fwd_sm90_probe_count() { return N_PROBES; }
extern "C" const char* tdc_fwd_sm90_probe_name(int i) { return PROBES[i].name; }
extern "C" int tdc_fwd_sm90_probe_dp(int i) { return PROBES[i].dp; }
extern "C" int tdc_fwd_sm90_probe_causal(int i) { return PROBES[i].causal; }

// The forward entry points' arguments, bf16 only, after the probe's index;
// the probe fixes causality.
extern "C" int tdc_fwd_sm90_probe_fwd(int i, const void* q, const void* k, const void* v, void* o,
                                      float* lse, int B, int T, int S, int Hq, int Hkv, int D,
                                      int kv_len, const long long* strides, float scale,
                                      void* stream) {
  if (i < 0 || i >= N_PROBES || D > PROBES[i].dp || D <= PROBES[i].dp - 16)
    return static_cast<int>(cudaErrorInvalidValue);
  const tdc::FwdParams p = tdc::make_params(q, k, v, o, lse, B, T, S, Hq, Hkv, D, kv_len, strides, scale);
  cudaError_t e = tdc::check_fwd(p, 0);
  if (e == cudaSuccess) e = PROBES[i].fn(p, static_cast<cudaStream_t>(stream));
  return static_cast<int>(e);
}
