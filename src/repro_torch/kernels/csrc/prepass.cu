// Prepass lower-star gradient kernel: pairing over a pre-gathered (n, 27)
// neighbour-order tensor.
//
// Replaces the prepass Pallas kernel `_prepass_call` / `_prepass_kernel`
// (src/repro/kernels/lower_star.py:170, entry lower_star_gradient_pallas).
// The TPU kernel tiled the vertex axis (tile 256) and bucket-padded it to a
// power-of-two multiple of the tile so nearby lengths shared one compiled
// program; a CUDA launch takes any n, so the wrapper pads nothing and one
// thread pairs one vertex.
//
// Bounds on an H100 SXM (3.35 TB/s, per vertex): 27 * sizeof(T) + sizeof(T)
// read + 153 B written — 4.4 GB, 1.3 ms at 256^3 with int32 ranks (plus the
// gather that writes the (n, 27) tensor, outside this kernel).  The
// pairing loop is the fused kernel's, so it is bound by operations too
// (4.6 ms at 256^3 on isabel).  Measured by chip_smoke.py on an NVIDIA
// H100 80GB HBM3 at a 700 W power limit: 85.5 ms at 256^3 (isabel).
// ptxas (sm_90a, CUDA 12.8): int32 32 registers, 256 B stack, no spills;
// int64 40 registers, 368 B stack, no spills.

#include <cuda_runtime.h>

#include "lower_star.cuh"

template <typename T>
__global__ void __launch_bounds__(128)
prepass_lower_star(const T* __restrict__ nbrs, const T* __restrict__ ov,
                   long long n, int8_t* __restrict__ status,
                   int8_t* __restrict__ partner, int8_t* __restrict__ vstat,
                   int32_t* __restrict__ vpart) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  T nb[27];
#pragma unroll
  for (int j = 0; j < 27; ++j) nb[j] = nbrs[i * 27 + j];
  ls::pair_lower_star<T>(nb, ov[i], status + i * LS_R, partner + i * LS_R,
                         vstat + i, vpart + i);
}

template <typename T>
static int launch(const T* nbrs, const T* ov, long long n, int8_t* status,
                  int8_t* partner, int8_t* vstat, int32_t* vpart,
                  void* stream) {
  if (n == 0) return 0;
  const int threads = 128;
  const long long blocks = (n + threads - 1) / threads;
  prepass_lower_star<T><<<(unsigned)blocks, threads, 0,
                          (cudaStream_t)stream>>>(nbrs, ov, n, status,
                                                  partner, vstat, vpart);
  return (int)cudaGetLastError();
}

extern "C" int ls_prepass_i32(const int32_t* nbrs, const int32_t* ov,
                              long long n, int8_t* status, int8_t* partner,
                              int8_t* vstat, int32_t* vpart, void* stream) {
  return launch<int32_t>(nbrs, ov, n, status, partner, vstat, vpart, stream);
}

extern "C" int ls_prepass_i64(const int64_t* nbrs, const int64_t* ov,
                              long long n, int8_t* status, int8_t* partner,
                              int8_t* vstat, int32_t* vpart, void* stream) {
  return launch<int64_t>(nbrs, ov, n, status, partner, vstat, vpart, stream);
}
