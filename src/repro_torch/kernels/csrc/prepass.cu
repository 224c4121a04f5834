// Prepass lower-star gradient kernel: pairing over a pre-gathered (n, 27)
// neighbour-order tensor.
//
// Replaces the prepass Pallas kernel `_prepass_call` / `_prepass_kernel`
// (src/repro/kernels/lower_star.py:170, entry lower_star_gradient_pallas).
// The TPU kernel tiled the vertex axis (tile 256) and bucket-padded it to a
// power-of-two multiple of the tile so nearby lengths shared one compiled
// program; a CUDA launch takes any n, so the wrapper pads nothing, a block
// of 128 threads takes 128 consecutive vertices and one thread pairs one.
//
// What bounds it on an H100 SXM (per vertex, 3.35 TB/s): 27 * sizeof(T) +
// sizeof(T) read and 153 B written, 1.3 ms at 256^3 with int32 ranks
// (plus the gather that writes the (n, 27) tensor, outside this kernel).
// The integer operations the pairing needs, the same as the fused
// kernel's, take less, so bytes bind.  How the design meets the card (the
// pairing core is lower_star.cuh, the row staging the fused kernel's):
//
// - Coalesced input: the block's (128 x 27) slab of the neighbour tensor
//   is one contiguous run, loaded into shared memory with 16-byte loads;
//   each thread then takes its 14 star neighbours from there (the slab
//   stride of 27 words is odd, so those reads do not conflict at int32).
// - No per-thread arrays in local memory, keys from local ranks computed
//   once per vertex, the bit-plane argmin, the regrouping of the block's
//   vertices, and coalesced 16-byte row stores, as in fused.cu.
//
// Shared memory per block (static): max(slab, status + partner) = 18944 B
// at int32, 27648 B at int64, plus 2072 B of star tables and 1600 B for
// the regrouping.
// ptxas (sm_90a): 80 registers, 0 bytes of stack, no spills; 6 blocks
// per SM.  On an NVIDIA H100 80GB HBM3 at a 700 W power limit
// (chip_smoke.py): 6.57 ms at 256^3 isabel, 6.65 ms at 256^3 random,
// 52.9 ms at 512^3 random, against a byte bound of 1.33 / 1.33 /
// 10.6 ms.  chip_smoke.py prints its time, bound and ptxas' report on
// every run.

#include <cuda_runtime.h>

#include "lower_star.cuh"

namespace {

constexpr int BLOCK = 128;

template <typename T>
struct Smem {
  static constexpr int kSlab = BLOCK * 27 * (int)sizeof(T);
  static constexpr int kRows = 2 * BLOCK * ls::R;  // status, partner
  static constexpr int kBytes = ((kSlab > kRows ? kSlab : kRows) + 15) / 16 * 16;
};

// At least 6 blocks per SM: left free, ptxas gives this kernel 80
// registers and spills a few bytes; asked for 6 blocks, it spills none.
template <typename T>
__global__ void __launch_bounds__(BLOCK, 6)
prepass_lower_star(const T* __restrict__ nbrs, const T* __restrict__ ov,
                   long long n, int8_t* __restrict__ status,
                   int8_t* __restrict__ partner, int8_t* __restrict__ vstat,
                   int32_t* __restrict__ vpart) {
  __shared__ __align__(16) unsigned char smem[Smem<T>::kBytes];
  __shared__ ls::Tables tb;
  __shared__ ls::Regroup<BLOCK> rg;
  const int t = threadIdx.x;
  const long long g0 = (long long)blockIdx.x * BLOCK;
  const int cnt = (int)(n - g0 < BLOCK ? n - g0 : BLOCK);
  ls::build_tables(tb, t, BLOCK);

  const T* slab = reinterpret_cast<const T*>(smem);
  ls::copy_bytes<BLOCK>(nbrs + g0 * 27, smem, cnt * 27 * (int)sizeof(T));
  __syncthreads();

  const bool live = t < cnt;
  uint64_t ranks = 0;
  if (live) {
    T nb[ls::NE];
#define LS_X(e, j, dx, dy, dz) nb[e] = slab[t * 27 + (j)];
    LS_EDGES(LS_X)
#undef LS_X
    uint32_t rk[ls::NE];
    ls::local_ranks<T>(nb, ov[g0 + t], rk);
    ranks = ls::pack_ranks(rk);
  }
  // the vertex this thread pairs; regroup's first barrier also ends every
  // read of the slab, whose bytes then hold the rows
  const int u = ls::regroup(rg, ranks, live);
  int8_t* st = reinterpret_cast<int8_t*>(smem);
  int8_t* pt = st + BLOCK * ls::R;
  if (u >= 0) {
    uint32_t rk[ls::NE];
    ls::unpack_ranks(ranks, rk);
    int8_t vs;
    int32_t vp;
    ls::pair_lower_star(rk, tb, st + u * ls::R, pt + u * ls::R, vs, vp);
    vstat[g0 + u] = vs;
    vpart[g0 + u] = vp;
  }
  __syncthreads();
  ls::copy_bytes<BLOCK>(st, status + g0 * ls::R, cnt * ls::R);
  ls::copy_bytes<BLOCK>(pt, partner + g0 * ls::R, cnt * ls::R);
}

template <typename T>
int launch(const T* nbrs, const T* ov, long long n, int8_t* status,
           int8_t* partner, int8_t* vstat, int32_t* vpart, void* stream) {
  if (n == 0) return 0;
  const long long blocks = (n + BLOCK - 1) / BLOCK;
  prepass_lower_star<T><<<(unsigned)blocks, BLOCK, 0, (cudaStream_t)stream>>>(
      nbrs, ov, n, status, partner, vstat, vpart);
  return (int)cudaGetLastError();
}

template <typename T>
int attrs(int* out) {
  return ls::kernel_attrs(prepass_lower_star<T>, BLOCK, out);
}

}  // namespace

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

// Launch shape and resources of each instantiation (ls::kernel_attrs).
extern "C" int ls_prepass_attrs_i32(int* out) { return attrs<int32_t>(out); }
extern "C" int ls_prepass_attrs_i64(int* out) { return attrs<int64_t>(out); }
