// Fused lower-star gradient kernel: 27-point gather + pairing per vertex.
//
// Replaces the fused Pallas kernel `_fused_call` / `_make_fused_kernel`
// (src/repro/kernels/lower_star.py:255, entries
// fused_lower_star_gradient_pallas and fused_rows_from_halo_volume).  The
// TPU kernel tiled a -1-padded (B, nz+2, ny+2, nx+2) volume with
// halo-overlapping blocks; here one thread per vertex reads its 27
// neighbours straight from the unpadded (B, nz, ny, nx) order tensor and
// treats out-of-range neighbours as -1 itself, so neither a padded volume
// nor an (nv, 27) tensor is ever written to device memory.
//
// Bounds on an H100 SXM (3.35 TB/s, per vertex): the memory floor is
// sizeof(T) read + 153 B written (74 + 74 rows, 1 vstat, 4 vpart) —
// 2.6 GB, 0.79 ms at 256^3 with int32 ranks.  The pairing loop rescans the
// 74 rows once per pop, so the integer work is ~9.2k operations per vertex
// on isabel 256^3 (chip_smoke.py counts them from each run's rows): 4.6 ms
// at 33.5 T int32 ops/s, so the kernel is bound by operations, not bytes.
// Measured by chip_smoke.py on an NVIDIA H100 80GB HBM3 at a 700 W power
// limit: 85.6 ms at 256^3 (isabel), 739 ms at 512^3 (random) — about 5 %
// of the operation bound.  This first version keeps the neighbour orders
// and the status / partner rows in per-thread arrays (ptxas, sm_90a, CUDA
// 12.8: int32 32 registers, 280 B stack, 20 B spilled; int64 40 registers,
// 376 B stack, 4 B spilled); staging the window in shared memory,
// coalescing the row writes and a warp per vertex are left for later.

#include <cuda_runtime.h>

#include "lower_star.cuh"

template <typename T>
__global__ void __launch_bounds__(128)
fused_lower_star(const T* __restrict__ order, long long n_total, int nz,
                 int ny, int nx, int8_t* __restrict__ status,
                 int8_t* __restrict__ partner, int8_t* __restrict__ vstat,
                 int32_t* __restrict__ vpart) {
  const long long gid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (gid >= n_total) return;
  const long long nv = (long long)nz * ny * nx;
  const long long b = gid / nv;
  const long long v = gid - b * nv;
  const int x = (int)(v % nx);
  const long long zy = v / nx;
  const int y = (int)(zy % ny);
  const int z = (int)(zy / ny);
  const T* o = order + b * nv;
  T nb[27];
#pragma unroll
  for (int dz = -1; dz <= 1; ++dz) {
#pragma unroll
    for (int dy = -1; dy <= 1; ++dy) {
#pragma unroll
      for (int dx = -1; dx <= 1; ++dx) {
        const int xx = x + dx, yy = y + dy, zz = z + dz;
        const bool in = xx >= 0 && xx < nx && yy >= 0 && yy < ny && zz >= 0 &&
                        zz < nz;
        nb[(dx + 1) + 3 * (dy + 1) + 9 * (dz + 1)] =
            in ? o[((long long)zz * ny + yy) * nx + xx] : T(-1);
      }
    }
  }
  ls::pair_lower_star<T>(nb, nb[13], status + gid * LS_R,
                         partner + gid * LS_R, vstat + gid, vpart + gid);
}

template <typename T>
static int launch(const T* order, long long B, int nz, int ny, int nx,
                  int8_t* status, int8_t* partner, int8_t* vstat,
                  int32_t* vpart, void* stream) {
  const long long n = B * nz * ny * nx;
  if (n == 0) return 0;
  const int threads = 128;
  const long long blocks = (n + threads - 1) / threads;
  fused_lower_star<T><<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      order, n, nz, ny, nx, status, partner, vstat, vpart);
  return (int)cudaGetLastError();
}

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
