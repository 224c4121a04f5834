// Lower-star discrete gradient pairing for one vertex (ProcessLowerStars).
//
// The routine both kernels share (fused.cu, prepass.cu).  It computes
// what the Pallas pairing core `_pair_block` (src/repro/kernels/
// lower_star.py:59) computes for one vertex: the masked-recomputation form
// of Robins et al.'s ProcessLowerStars over the 74 packed star rows
// (14 edges, 36 triangles, 24 tets).  The TPU form advances a whole block
// of vertices in lock-step inside one while_loop, so every lane waits for
// the slowest vertex of its block; here each thread runs its own vertex's
// queue-free serial loop and leaves as soon as that vertex is done.
//
//   1. in_l:   row r is in the lower star iff every other vertex of r lies
//              in the grid (order >= 0) and below the vertex.
//   2. vertex: the lexicographically smallest lower edge pairs with the
//              vertex (vstat TAIL, vpart = row, partner -2); none -> CRIT.
//   3. loop:   pop the smallest available row with exactly one available
//              face (FID) and pair the two (HEAD / TAIL); else pop the
//              smallest available row with no available face and mark it
//              CRIT; else stop.
//
// A row's key is the other vertices' orders sorted descending, -1 padded.
// Keys are recomputed from the 27 neighbour orders at every scan instead
// of being stored (74 x 3 keys would be 888 B of local memory per thread at
// int32).  Lower-star keys are distinct (distinct vertex sets, injective
// orders), so "first smallest" and any other tie rule give the same rows.
//
// OTH / FID live in __constant__ memory: all threads of a warp scan row r
// together, so each table read is one broadcast.  ls_tables.h is written
// at build time from repro_torch.core.gradient.PACKED.
#pragma once

#include <cstdint>

#include "ls_tables.h"

namespace ls {

enum : int8_t { NOT_L = 0, AVAIL = 1, TAIL = 2, HEAD = 3, CRIT = 4 };

template <typename T>
__device__ __forceinline__ void row_key(const T* nb, int r, T& k0, T& k1,
                                        T& k2) {
  const int o0 = LS_OTH[r][0], o1 = LS_OTH[r][1], o2 = LS_OTH[r][2];
  T a = o0 >= 0 ? nb[o0] : T(-1);
  T b = o1 >= 0 ? nb[o1] : T(-1);
  T c = o2 >= 0 ? nb[o2] : T(-1);
  T t;
  if (a < b) { t = a; a = b; b = t; }
  if (a < c) { t = a; a = c; c = t; }
  if (b < c) { t = b; b = c; c = t; }
  k0 = a; k1 = b; k2 = c;
}

template <typename T>
__device__ __forceinline__ bool key_less(T a0, T a1, T a2, T b0, T b1,
                                         T b2) {
  return a0 < b0 || (a0 == b0 && (a1 < b1 || (a1 == b1 && a2 < b2)));
}

// nb: the 27 neighbour orders (x fastest, -1 outside the grid); ov: the
// vertex order.  Writes 74 status and 74 partner bytes plus vstat/vpart.
template <typename T>
__device__ void pair_lower_star(const T* nb, T ov, int8_t* __restrict__ st_out,
                                int8_t* __restrict__ pt_out,
                                int8_t* __restrict__ vstat_out,
                                int32_t* __restrict__ vpart_out) {
  int8_t st[LS_R];
  int8_t pt[LS_R];
  for (int r = 0; r < LS_R; ++r) {
    bool in = true;
#pragma unroll
    for (int m = 0; m < 3; ++m) {
      const int o = LS_OTH[r][m];
      if (o >= 0) {
        const T v = nb[o];
        in = in && v >= 0 && v < ov;
      }
    }
    st[r] = in ? AVAIL : NOT_L;
    pt[r] = -1;
  }

  // vertex pop: the smallest lower edge pairs with the vertex
  int delta = -1;
  T b0 = 0, b1 = 0, b2 = 0;
  for (int r = 0; r < LS_EDGE_ROWS; ++r) {
    if (st[r] != AVAIL) continue;
    T k0, k1, k2;
    row_key(nb, r, k0, k1, k2);
    if (delta < 0 || key_less(k0, k1, k2, b0, b1, b2)) {
      delta = r; b0 = k0; b1 = k1; b2 = k2;
    }
  }
  if (delta >= 0) {
    *vstat_out = TAIL;
    *vpart_out = delta;
    st[delta] = HEAD;
    pt[delta] = -2;
  } else {
    *vstat_out = CRIT;
    *vpart_out = -1;
  }

  while (true) {
    int alpha = -1, gamma = -1;
    T a0 = 0, a1 = 0, a2 = 0, g0 = 0, g1 = 0, g2 = 0;
    for (int r = 0; r < LS_R; ++r) {
      if (st[r] != AVAIL) continue;
      int nuf = 0;
#pragma unroll
      for (int m = 0; m < 3; ++m) {
        const int f = LS_FID[r][m];
        nuf += (f >= 0 && st[f] == AVAIL) ? 1 : 0;
      }
      if (nuf == 1) {
        T k0, k1, k2;
        row_key(nb, r, k0, k1, k2);
        if (alpha < 0 || key_less(k0, k1, k2, a0, a1, a2)) {
          alpha = r; a0 = k0; a1 = k1; a2 = k2;
        }
      } else if (nuf == 0 && alpha < 0) {
        // a zero-face row only matters while no one-face row exists
        T k0, k1, k2;
        row_key(nb, r, k0, k1, k2);
        if (gamma < 0 || key_less(k0, k1, k2, g0, g1, g2)) {
          gamma = r; g0 = k0; g1 = k1; g2 = k2;
        }
      }
    }
    if (alpha >= 0) {
      int face = -1;
#pragma unroll
      for (int m = 0; m < 3; ++m) {
        const int f = LS_FID[alpha][m];
        if (face < 0 && f >= 0 && st[f] == AVAIL) face = f;
      }
      st[alpha] = HEAD;
      pt[alpha] = (int8_t)face;
      st[face] = TAIL;
      pt[face] = (int8_t)alpha;
    } else if (gamma >= 0) {
      st[gamma] = CRIT;
    } else {
      break;
    }
  }

  for (int r = 0; r < LS_R; ++r) {
    st_out[r] = st[r];
    pt_out[r] = pt[r];
  }
}

}  // namespace ls
