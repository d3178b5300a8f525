// K10 flag_deltas: one altair participation flag's reward and penalty
// columns over the whole registry, in true uint64, for Hopper (sm_90a).
//
// It replaces consensus_specs_tpu/engine/ops_jax.py:29 `_flag_deltas_jit`,
// the jnp graph (under x64) of get_flag_index_deltas' arithmetic
// (altair/beacon-chain.md:367-389), row by row:
//   base    = increments * brpi
//   reward  = base * weight * upi / (active_increments * wd)
//             where in_mask & eligible, and 0 for every row in a leak
//   penalty = base * weight / wd
//             where ~in_mask & eligible, and 0 for every row unless penalize
// Every product and quotient is uint64, as jnp's: the caller has proved
// that increments * brpi * weight * max(upi, 1) fits 64 bits (the guard in
// engine/stages.py); past it the kernel wraps, as the JAX kernel does. The
// divisor active_increments * wd is the same uint64 product.
//
// What bounds it on this card: bytes. A row reads 8 bytes of increments
// and two 1-byte masks and writes two 8-byte results (26 bytes); its
// arithmetic is three 64-bit products and at most one 64-bit division.
// Hopper has no 64-bit divide instruction, so a division is a software
// routine of some tens of instructions; both divisors are uniform over the
// launch, and a row divides only where its masks ask for the result.
//
// The design: one thread a row, a grid-stride loop over the rows, the
// scalars passed by value; the columns are contiguous, so a warp's loads
// and stores are coalesced.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = 132 * 16;  // H100's 132 SMs, 16 blocks each

__global__ void __launch_bounds__(kThreads) flag_deltas_kernel(
    const uint64_t* __restrict__ increments, const uint8_t* __restrict__ in_mask,
    const uint8_t* __restrict__ eligible, uint64_t brpi, uint64_t weight, uint64_t upi,
    uint64_t reward_divisor, uint64_t wd, bool leak, bool penalize, uint64_t* __restrict__ rewards,
    uint64_t* __restrict__ penalties, int64_t n) {
  for (int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x; i < n; i += (int64_t)gridDim.x * kThreads) {
    const bool in = in_mask[i] != 0, ok = eligible[i] != 0;
    const uint64_t weighted = increments[i] * brpi * weight;
    rewards[i] = (!leak && in && ok) ? weighted * upi / reward_divisor : 0;
    penalties[i] = (penalize && !in && ok) ? weighted / wd : 0;
  }
}

}  // namespace

extern "C" {

// K10 over n rows (each column contiguous): increments uint64, masks one
// byte a row (0 or 1, torch.bool), results uint64.
int flag_deltas_launch(const void* increments, const void* in_mask, const void* eligible, uint64_t brpi,
                       uint64_t weight, uint64_t upi, uint64_t active_increments, uint64_t wd, int leak,
                       int penalize, void* rewards, void* penalties, int64_t n, void* stream) {
  const int64_t need = (n + kThreads - 1) / kThreads;
  const unsigned blocks = (unsigned)(need < kMaxBlocks ? need : kMaxBlocks);
  flag_deltas_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint64_t*)increments, (const uint8_t*)in_mask, (const uint8_t*)eligible, brpi, weight, upi,
      active_increments * wd, wd, leak != 0, penalize != 0, (uint64_t*)rewards, (uint64_t*)penalties, n);
  return (int)cudaGetLastError();
}

const char* flag_deltas_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"
