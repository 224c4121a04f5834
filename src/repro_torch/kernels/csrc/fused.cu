// Fused lower-star gradient kernel: 27-point gather + pairing per vertex.
//
// Replaces the fused Pallas kernel `_fused_call` / `_make_fused_kernel`
// (src/repro/kernels/lower_star.py:255, entries
// fused_lower_star_gradient_pallas and fused_rows_from_halo_volume).  The
// TPU kernel tiled a -1-padded (B, nz+2, ny+2, nx+2) volume with
// halo-overlapping blocks; here a block of 128 threads takes 128
// consecutive vertices of the flattened (B, nz, ny, nx) order tensor, one
// thread per vertex, and neither a padded volume nor an (nv, 27) tensor
// is written to device memory.
//
// What bounds it on an H100 SXM (per vertex, 3.35 TB/s): sizeof(T) read
// and 153 B written (74 + 74 rows, 1 vstat, 4 vpart), 0.79 ms at 256^3
// with int32 ranks.  The integer operations the pairing needs, which
// chip_smoke.py counts from each run's rows whatever the design, take
// less at the card's int32 rate, so bytes bind.  How the design meets
// the card (the pairing core is lower_star.cuh):
//
// - Window in shared memory: the block loads, with coalesced loads, the 9
//   runs of 130 consecutive ranks at (dz, dy) offsets -1..1 around its
//   128 vertices (the (1+2) x (1+2) x (128+2) window of the flattened
//   tensor) and takes each thread's 14 star neighbours from there; a
//   neighbour outside the grid (checked on the vertex's own coordinates,
//   so a window that wraps a row, a plane or a batch member is harmless)
//   is -1, as in the padded TPU volume.
// - No per-thread arrays in local memory: the pairing state and the keys
//   are bitmasks in registers (ptxas: 0 bytes of stack, no spills).
// - Keys from local ranks, computed once per vertex; only the load and
//   the ranking depend on int32 / int64.
// - The argmin of a pop is twelve steps of mask logic over the keys' bit
//   planes, the same for every thread, and the block's vertices are
//   regrouped by their number of lower neighbours before pairing, so a
//   warp's threads run pops of like number.
// - Coalesced output: a block's status rows (and partner rows) are one
//   contiguous 128 x 74-byte run, staged in shared memory and written
//   with 16-byte stores.
//
// Shared memory per block (static): max(window, status + partner) =
// 18944 B, plus 2072 B of star tables and 1600 B for the regrouping.
// ptxas (sm_90a): 90 registers at int32, 88 at int64, 0 bytes of stack,
// no spills; 5 blocks per SM.  On an NVIDIA H100 80GB HBM3 at a 700 W
// power limit (chip_smoke.py): 6.97 ms at 256^3 isabel, 7.02 ms at 256^3
// random, 56.2 ms at 512^3 random, against a byte bound of 0.79 / 0.79 /
// 6.29 ms (PERF.md has the parent's times beside these).
// chip_smoke.py prints the time, the bound, the pops per vertex, the warp
// divergence and ptxas' report on every run.

#include <cuda_runtime.h>

#include "lower_star.cuh"

namespace {

constexpr int BLOCK = 128;
constexpr int WIN = BLOCK + 2;  // one run of the window

template <typename T>
struct Smem {
  static constexpr int kWin = 9 * WIN * (int)sizeof(T);
  static constexpr int kRows = 2 * BLOCK * ls::R;  // status, partner
  static constexpr int kBytes = ((kWin > kRows ? kWin : kRows) + 15) / 16 * 16;
};

template <typename T>
__global__ void __launch_bounds__(BLOCK)
fused_lower_star(const T* __restrict__ order, long long n_total, int nz,
                 int ny, int nx, int8_t* __restrict__ status,
                 int8_t* __restrict__ partner, int8_t* __restrict__ vstat,
                 int32_t* __restrict__ vpart) {
  __shared__ __align__(16) unsigned char smem[Smem<T>::kBytes];
  __shared__ ls::Tables tb;
  __shared__ ls::Regroup<BLOCK> rg;
  const int t = threadIdx.x;
  const long long g0 = (long long)blockIdx.x * BLOCK;
  const int cnt = (int)(n_total - g0 < BLOCK ? n_total - g0 : BLOCK);
  const long long nxy = (long long)nx * ny;
  ls::build_tables(tb, t, BLOCK);

  T* win = reinterpret_cast<T*>(smem);
  for (int q = t; q < 9 * WIN; q += BLOCK) {
    const int s = q / WIN, k = q - s * WIN;
    const long long src = g0 + (s / 3 - 1) * nxy + (s % 3 - 1) * nx + k - 1;
    win[q] = src >= 0 && src < n_total ? order[src] : T(-1);
  }
  __syncthreads();

  const bool live = t < cnt;
  uint64_t ranks = 0;
  if (live) {
    T nb[ls::NE];
    // one 64-bit division for the batch member, the rest in 32 bits
    const unsigned v = (unsigned)((g0 + t) % (nxy * nz));
    const int x = (int)(v % (unsigned)nx);
    const int y = (int)(v / (unsigned)nx % (unsigned)ny);
    const int z = (int)(v / (unsigned)nxy);
    const T ov = win[4 * WIN + t + 1];
#define LS_X(e, j, dx, dy, dz)                                          \
  nb[e] = x + (dx) >= 0 && x + (dx) < nx && y + (dy) >= 0 &&            \
                  y + (dy) < ny && z + (dz) >= 0 && z + (dz) < nz       \
              ? win[((dz) + 1) * 3 * WIN + ((dy) + 1) * WIN + t + 1 + (dx)] \
              : T(-1);
    LS_EDGES(LS_X)
#undef LS_X
    uint32_t rk[ls::NE];
    ls::local_ranks<T>(nb, ov, rk);
    ranks = ls::pack_ranks(rk);
  }
  // the vertex this thread pairs; regroup's first barrier also ends every
  // read of the window, whose bytes then hold the rows
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
int launch(const T* order, long long B, int nz, int ny, int nx,
           int8_t* status, int8_t* partner, int8_t* vstat, int32_t* vpart,
           void* stream) {
  const long long n = B * nz * ny * nx;
  if (n == 0) return 0;
  if ((long long)nz * ny * nx >= (1ll << 31)) return (int)cudaErrorInvalidValue;
  const long long blocks = (n + BLOCK - 1) / BLOCK;
  fused_lower_star<T><<<(unsigned)blocks, BLOCK, 0, (cudaStream_t)stream>>>(
      order, n, nz, ny, nx, status, partner, vstat, vpart);
  return (int)cudaGetLastError();
}

template <typename T>
int attrs(int* out) {
  return ls::kernel_attrs(fused_lower_star<T>, BLOCK, out);
}

}  // namespace

extern "C" int ls_fused_i32(const int32_t* order, long long B, int nz, int ny,
                            int nx, int8_t* status, int8_t* partner,
                            int8_t* vstat, int32_t* vpart, void* stream) {
  return launch<int32_t>(order, B, nz, ny, nx, status, partner, vstat, vpart,
                         stream);
}

extern "C" int ls_fused_i64(const int64_t* order, long long B, int nz, int ny,
                            int nx, int8_t* status, int8_t* partner,
                            int8_t* vstat, int32_t* vpart, void* stream) {
  return launch<int64_t>(order, B, nz, ny, nx, status, partner, vstat, vpart,
                         stream);
}

// Launch shape and resources of each instantiation (ls::kernel_attrs).
extern "C" int ls_fused_attrs_i32(int* out) { return attrs<int32_t>(out); }
extern "C" int ls_fused_attrs_i64(int* out) { return attrs<int64_t>(out); }
