// Lower-star discrete gradient pairing for one vertex (ProcessLowerStars).
//
// The routine both kernels share (fused.cu, prepass.cu).  It computes
// what the Pallas pairing core `_pair_block` (src/repro/kernels/
// lower_star.py:59) computes for one vertex: the masked-recomputation form
// of Robins et al.'s ProcessLowerStars over the 74 packed star rows
// (14 edges, 36 triangles, 24 tets).
//
//   1. in_l:   row r is in the lower star iff every other vertex of r lies
//              in the grid (order >= 0) and below the vertex.
//   2. vertex: the lexicographically smallest lower edge pairs with the
//              vertex (vstat TAIL, vpart = row, partner -2); none -> CRIT.
//   3. loop:   pop the smallest available row with exactly one available
//              face and pair the two (HEAD / TAIL); else pop the smallest
//              available row with no available face and mark it CRIT;
//              else stop.
//
// Design for Hopper (one thread per vertex, nothing dynamically indexed
// in per-thread arrays, so nothing in local memory):
//
// - Local-rank keys.  A row's key is its other vertices' orders sorted
//   descending, -1 padded.  The 74 rows use only the 14 neighbours that
//   the edges reach, so each is replaced by its rank among the vertex's
//   lower neighbours (1..14; 0 when not lower or outside the grid).  The
//   map is monotone on lower values and sends -1 below them, so lower
//   rows compare exactly as before (the plain form is kernels/ref.py::
//   local_rank_keys).  Ranks are computed once per vertex; after
//   local_ranks() nothing depends on the rank type.  The smallest lower
//   edge is the one to rank 1.
// - Bitmask state in registers.  Available rows are two masks (14 edge
//   bits; 36 triangle + 24 tet bits in one 64-bit word), and for every
//   face slot m a 64-bit mask of the triangle and tet rows whose slot-m
//   face is still available.  "Exactly one available face" and "none"
//   are then a few logic operations over whole masks; when a row leaves,
//   the masks of its cofaces lose it through three coface masks indexed
//   by the row (Tables, in shared memory).
// - Keys as bit-planes.  Each key field (a rank, at most 14) takes four
//   bits, and the twelve key bits of all rows are twelve row masks in
//   registers.  The smallest candidate is then found in twelve steps of
//   mask logic (min_row), the same for every thread of a warp whatever
//   its number of candidates.  A loop over the candidates with a key
//   load each runs as long as the warp's most crowded thread.
// - The kernels regroup a block's vertices by their number of lower
//   neighbours before pairing (regroup), so that a warp's threads have
//   stars of like size: a warp runs as many pops as its largest star.
// - Shared memory per thread: the 74 status and 74 partner bytes, laid out
//   exactly as the output rows, which the block then writes to device
//   memory with 16-byte stores.
// - The star's rows come from ls_tables.h as X-macro lists of constants
//   (generated from repro_torch.core.gradient.PACKED), so every loop over
//   rows unrolls with compile-time indices.
//
// Lower-star keys are distinct (distinct vertex sets, injective orders),
// so "first smallest" and any other tie rule give the same rows.
//
// The routines below also compile as plain C++ (no CUDA), which keeps
// their arithmetic testable without a card.
#pragma once

#include <cstdint>

#include "ls_tables.h"

#if defined(__CUDACC__)
#define LS_HD __host__ __device__ __forceinline__
#else
#define LS_HD inline
#endif

namespace ls {

enum : int8_t { NOT_L = 0, AVAIL = 1, TAIL = 2, HEAD = 3, CRIT = 4 };
constexpr int R = LS_R, NE = LS_NE, NT = LS_NT, NQ = LS_NQ;
constexpr int Q0 = NE + NT;  // first tet row

LS_HD int low_bit32(uint32_t x) {  // x != 0
#if defined(__CUDA_ARCH__)
  return __ffs(x) - 1;
#else
  return __builtin_ctz(x);
#endif
}

LS_HD int low_bit64(uint64_t x) {  // x != 0
#if defined(__CUDA_ARCH__)
  return __ffsll((long long)x) - 1;
#else
  return __builtin_ctzll(x);
#endif
}

LS_HD uint32_t umin(uint32_t a, uint32_t b) { return a < b ? a : b; }
LS_HD uint32_t umax(uint32_t a, uint32_t b) { return a < b ? b : a; }

// Row-indexed star tables, kept in shared memory (2072 B per block).
// Row masks over the triangle and tet rows are 64-bit, bit i = row NE + i.
struct Tables {
  uint64_t cof[R][3];  // rows whose slot-m face is row r (0 for tets)
  uint32_t fid[R];     // face rows f0 | f1 << 8 | f2 << 16, in FID order
};

// Fill the tables; thread t of nthreads takes rows t, t + nthreads, ...
LS_HD void build_tables(Tables& tb, int t, int nthreads) {
  for (int r = t; r < R; r += nthreads) {
    uint64_t m0 = 0, m1 = 0, m2 = 0;
    uint32_t f = 0;
#define LS_X(i, ea, eb)                         \
  m0 |= (uint64_t)((ea) == r ? 1 : 0) << (i);   \
  m1 |= (uint64_t)((eb) == r ? 1 : 0) << (i);   \
  f = NE + (i) == r ? (ea) | (eb) << 8 : f;
    LS_TRIS(LS_X)
#undef LS_X
#define LS_X(i, ta, tb_, tc, ea, eb, ec)                                    \
  m0 |= (uint64_t)(NE + (ta) == r ? 1 : 0) << (NT + (i));                  \
  m1 |= (uint64_t)(NE + (tb_) == r ? 1 : 0) << (NT + (i));                 \
  m2 |= (uint64_t)(NE + (tc) == r ? 1 : 0) << (NT + (i));                  \
  f = Q0 + (i) == r ? (NE + (ta)) | (NE + (tb_)) << 8 | (NE + (tc)) << 16  \
                    : f;
    LS_TETS(LS_X)
#undef LS_X
    tb.cof[r][0] = m0;
    tb.cof[r][1] = m1;
    tb.cof[r][2] = m2;
    tb.fid[r] = f;
  }
}

// rk[e]: rank of edge e's neighbour among the vertex's lower neighbours
// (1..14), 0 when that neighbour is not lower (or is -1: outside).
template <typename T>
LS_HD void local_ranks(const T (&nb)[NE], T ov, uint32_t (&rk)[NE]) {
  bool low[NE];
  T v[NE];
#pragma unroll
  for (int e = 0; e < NE; ++e) {
    low[e] = nb[e] >= 0 && nb[e] < ov;
    v[e] = low[e] ? nb[e] : ov;  // not lower: never below a lower value
    rk[e] = 1;
  }
#pragma unroll
  for (int j = 0; j < NE; ++j) {
#pragma unroll
    for (int k = j + 1; k < NE; ++k) {
      const bool c = v[j] < v[k];
      rk[k] += c ? 1u : 0u;
      rk[j] += c ? 0u : 1u;
    }
  }
#pragma unroll
  for (int e = 0; e < NE; ++e) rk[e] = low[e] ? rk[e] : 0u;
}

// The state of one vertex's pairing: the available edge rows, the
// available triangle and tet rows, and for each face slot m the triangle
// and tet rows whose slot-m face is still available (tets alone have a
// slot 2; edges have no faces).
struct State {
  uint32_t av_e;
  uint64_t av, fa0, fa1, fa2;

  // row r leaves the available set; its cofaces lose that face
  LS_HD void take(const Tables& tb, int r) {
    av_e &= ~(r < NE ? 1u << r : 0u);
    av &= ~(r < NE ? 0ull : 1ull << (r - NE));
    fa0 &= ~tb.cof[r][0];
    fa1 &= ~tb.cof[r][1];
    fa2 &= ~tb.cof[r][2];
  }
};

// The rows' keys as bit-planes.  A key is three 4-bit fields (the ranks
// of the row's other vertices sorted descending, 0 padded; ranks are at
// most 14).  Plane j holds bit 3 - j % 4 of field j / 4 of every row:
// over the edge rows in e (fields 1 and 2 of an edge key are 0, so e
// has only the four planes of field 0) and over the triangle and tet
// rows in s.
struct Planes {
  uint32_t e[4];
  uint64_t s[12];
};

// Set bit `bit` of planes p[0..3] to the bits 3..0 of a 4-bit field v.
template <typename W>
LS_HD void put_field(W* p, uint32_t v, int bit) {
  p[0] |= (W)(v >> 3 & 1u) << bit;
  p[1] |= (W)(v >> 2 & 1u) << bit;
  p[2] |= (W)(v >> 1 & 1u) << bit;
  p[3] |= (W)(v & 1u) << bit;
}

// The row with the smallest key among the edge rows set in ce and the
// triangle and tet rows set in cs (not both empty).  From the most to the
// least significant key bit: if some candidate has a 0 there, drop those
// with a 1.  Lower-star keys are distinct, so one row is left.  Twelve
// steps of mask logic whatever the number of candidates.
LS_HD int min_row(const Planes& k, uint32_t ce, uint64_t cs) {
#pragma unroll
  for (int j = 0; j < 12; ++j) {
    const uint32_t te = j < 4 ? ce & ~k.e[j] : ce;
    const uint64_t ts = cs & ~k.s[j];
    const bool any = (te | ts) != 0;
    ce = any ? te : ce;
    cs = any ? ts : cs;
  }
  return ce ? low_bit32(ce) : NE + low_bit64(cs);
}

// Pair one vertex's lower star from its local ranks.  st / pt: its 74
// status / partner bytes (2-byte aligned; in shared memory on the card).
LS_HD void pair_lower_star(const uint32_t (&rk)[NE], const Tables& tb,
                           int8_t* st, int8_t* pt, int8_t& vstat,
                           int32_t& vpart) {
  // lower-star rows and the key planes
  uint32_t low_e = 0;
  uint64_t low_s = 0;
  Planes k = {};
#pragma unroll
  for (int e = 0; e < NE; ++e) {
    low_e |= (rk[e] != 0 ? 1u : 0u) << e;
    put_field(k.e, rk[e], e);
  }
#define LS_X(i, ea, eb)                                       \
  {                                                           \
    const uint32_t a = rk[ea], b = rk[eb];                    \
    put_field(k.s, umax(a, b), i);                            \
    put_field(k.s + 4, umin(a, b), i);                        \
    low_s |= (uint64_t)(umin(a, b) != 0 ? 1u : 0u) << (i);    \
  }
  LS_TRIS(LS_X)
#undef LS_X
#define LS_X(i, ta, tb_, tc, ea, eb, ec)                            \
  {                                                                 \
    const uint32_t a = rk[ea], b = rk[eb], c = rk[ec];              \
    const uint32_t ab = umax(a, b), ba = umin(a, b), mc = umin(ab, c); \
    put_field(k.s, umax(ab, c), NT + (i));                          \
    put_field(k.s + 4, umax(ba, mc), NT + (i));                     \
    put_field(k.s + 8, umin(ba, mc), NT + (i));                     \
    low_s |= (uint64_t)(umin(ba, mc) != 0 ? 1u : 0u) << (NT + (i)); \
  }
  LS_TETS(LS_X)
#undef LS_X
  uint16_t* st2 = reinterpret_cast<uint16_t*>(st);
  uint16_t* pt2 = reinterpret_cast<uint16_t*>(pt);
#pragma unroll
  for (int w = 0; w < R / 2; ++w) {
    const int r = 2 * w;  // rows r, r + 1 are both edges or both not
    const uint32_t two = r < NE ? low_e >> r & 3u
                                : (uint32_t)(low_s >> (r - NE)) & 3u;
    st2[w] = (uint16_t)((two & 1u) | (two & 2u) << 7);  // NOT_L / AVAIL
    pt2[w] = 0xffff;                                    // partner -1
  }

  State s{low_e, low_s, low_s, low_s, low_s >> NT << NT};

  // vertex pop: the smallest lower edge is the one to local rank 1
  int delta = -1;
#pragma unroll
  for (int e = 0; e < NE; ++e) delta = rk[e] == 1 ? e : delta;
  if (delta >= 0) {
    vstat = TAIL;
    vpart = delta;
    st[delta] = HEAD;
    pt[delta] = -2;
    s.take(tb, delta);
  } else {
    vstat = CRIT;
    vpart = -1;
  }

  while (true) {
    const uint64_t one =
        s.av & (s.fa0 ^ s.fa1 ^ s.fa2) & ~(s.fa0 & s.fa1 & s.fa2);
    if (one) {
      // alpha: the smallest row with exactly one available face, paired
      // with that face (the first available one in FID order)
      const int a = min_row(k, 0u, one);
      const int i = a - NE;
      const int m = (s.fa0 >> i) & 1u ? 0 : ((s.fa1 >> i) & 1u ? 8 : 16);
      const int face = (int)((tb.fid[a] >> m) & 255u);
      s.take(tb, a);
      s.take(tb, face);
      st[a] = HEAD;
      pt[a] = (int8_t)face;
      st[face] = TAIL;
      pt[face] = (int8_t)a;
    } else {
      // gamma: the smallest row with no available face
      const uint64_t none = s.av & ~(s.fa0 | s.fa1 | s.fa2);
      if (!(s.av_e | none)) break;
      const int g = min_row(k, s.av_e, none);
      s.take(tb, g);
      st[g] = CRIT;
    }
  }
}

// Where a launch's vertices and their star neighbours lie in its source
// tensor.  Whole grid: vertex g is element g of a (B, nz, ny, nx) tensor,
// and a neighbour outside [0, nx) x [0, ny) x [0, nz) of its own member
// is -1.  Halo: vertex g is owned vertex g of an (nz + 2, ny, nx) ext
// volume whose first and last planes are ghosts, so it lies at g + nx*ny
// there; its z neighbours always lie in the ext volume (a ghost that is
// -1, at the grid's boundary, already reads as outside), so only x and y
// are tested.
struct Addr {
  long long base;   // source index of vertex 0
  long long n_src;  // elements of the source tensor
  int nx, ny, nz;   // nz: planes of one member (whole) or owned (halo)
  bool halo;

  LS_HD static Addr whole(long long B, int nz, int ny, int nx) {
    return Addr{0, B * nz * ny * nx, nx, ny, nz, false};
  }
  LS_HD static Addr ext(int nz_owned, int ny, int nx) {
    const long long nxy = (long long)nx * ny;
    return Addr{nxy, (nz_owned + 2) * nxy, nx, ny, nz_owned, true};
  }
  // (x, y, z) of vertex g within its member (or its owned slab)
  LS_HD void coords(long long g, int& x, int& y, int& z) const {
    const unsigned nxy = (unsigned)nx * (unsigned)ny;
    // one 64-bit division for the batch member, the rest in 32 bits
    const unsigned v = (unsigned)(g % ((long long)nxy * nz));
    x = (int)(v % (unsigned)nx);
    y = (int)(v / (unsigned)nx % (unsigned)ny);
    z = (int)(v / nxy);
  }
  LS_HD bool inside(int x, int y, int z, int dx, int dy, int dz) const {
    return x + dx >= 0 && x + dx < nx && y + dy >= 0 && y + dy < ny &&
           (halo || (z + dz >= 0 && z + dz < nz));
  }
};

// The vertex's order and the orders of its 14 edge neighbours (-1
// outside), read straight from the source tensor.  The fused kernel reads
// the same elements from its shared-memory window; this form keeps the
// addressing testable on the host.
template <typename T>
LS_HD void gather_edges(const T* src, const Addr& a, long long g,
                        T (&nb)[NE], T& ov) {
  int x, y, z;
  a.coords(g, x, y, z);
  const long long nxy = (long long)a.nx * a.ny, s = a.base + g;
  ov = src[s];
#define LS_X(e, j, dx, dy, dz)                                          \
  nb[e] = a.inside(x, y, z, dx, dy, dz)                                 \
              ? src[s + (dz) * nxy + (dy) * (long long)a.nx + (dx)] : T(-1);
  LS_EDGES(LS_X)
#undef LS_X
}

// Ranks packed four bits each (they are at most 14), edge e at bits 4e.
LS_HD uint64_t pack_ranks(const uint32_t (&rk)[NE]) {
  uint64_t p = 0;
#pragma unroll
  for (int e = 0; e < NE; ++e) p |= (uint64_t)rk[e] << (4 * e);
  return p;
}

LS_HD void unpack_ranks(uint64_t p, uint32_t (&rk)[NE]) {
#pragma unroll
  for (int e = 0; e < NE; ++e) rk[e] = (uint32_t)(p >> (4 * e)) & 15u;
}

#if defined(__CUDACC__)
// Regroup a block's vertices by their number of lower neighbours (a
// counting sort, stable within a count up to the order of the atomics),
// so that the threads of a warp pair stars of like size: a warp runs as
// many pops as its largest star needs.  Each thread passes its vertex's
// packed ranks (live: the thread has a vertex) and gets back another
// vertex's, with that vertex's index in the block (-1: none).
template <int BLOCK>
struct Regroup {
  unsigned hist[16];
  uint64_t ranks[BLOCK];
  int src[BLOCK];
};

template <int BLOCK>
__device__ __forceinline__ int regroup(Regroup<BLOCK>& g, uint64_t& ranks,
                                       bool live) {
  const int t = threadIdx.x;
  int c = 15;  // after every live vertex (at most 14 lower neighbours)
  if (live) {
    c = 0;
#pragma unroll
    for (int e = 0; e < NE; ++e) c += (ranks >> (4 * e) & 15u) != 0;
  }
  if (t < 16) g.hist[t] = 0;
  __syncthreads();
  const unsigned pos = atomicAdd(&g.hist[c], 1u);
  __syncthreads();
  if (t == 0) {
    unsigned run = 0;
    for (int i = 0; i < 16; ++i) {
      const unsigned h = g.hist[i];
      g.hist[i] = run;
      run += h;
    }
  }
  __syncthreads();
  const int d = (int)(g.hist[c] + pos);
  g.ranks[d] = ranks;
  g.src[d] = live ? t : -1;
  __syncthreads();
  ranks = g.ranks[t];
  return g.src[t];
}

// n bytes from src to dst by the BLOCK threads of a block: 16-byte moves
// when both ends are 16-byte aligned and n is a multiple of 16 (a whole
// block's rows or input slab), else byte moves (the grid's last block).
template <int BLOCK>
__device__ __forceinline__ void copy_bytes(const void* src, void* dst, int n) {
  if (((uintptr_t)src & 15) == 0 && ((uintptr_t)dst & 15) == 0 &&
      (n & 15) == 0) {
    const uint4* s = reinterpret_cast<const uint4*>(src);
    uint4* d = reinterpret_cast<uint4*>(dst);
    for (int i = threadIdx.x; i < n / 16; i += BLOCK) d[i] = s[i];
  } else {
    const int8_t* s = reinterpret_cast<const int8_t*>(src);
    int8_t* d = reinterpret_cast<int8_t*>(dst);
    for (int i = threadIdx.x; i < n; i += BLOCK) d[i] = s[i];
  }
}

// Launch shape and resources of a kernel: out = {block threads, registers,
// local (stack) bytes, static shared bytes, dynamic shared bytes, resident
// blocks per SM}.  Returns a cudaError_t.
template <typename K>
int kernel_attrs(K kernel, int block, int* out) {
  cudaFuncAttributes a;
  int err = (int)cudaFuncGetAttributes(&a, kernel);
  if (err) return err;
  int per_sm = 0;
  err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                           block, 0);
  out[0] = block;
  out[1] = a.numRegs;
  out[2] = (int)a.localSizeBytes;
  out[3] = (int)a.sharedSizeBytes;
  out[4] = 0;
  out[5] = per_sm;
  return err;
}
#endif

}  // namespace ls
