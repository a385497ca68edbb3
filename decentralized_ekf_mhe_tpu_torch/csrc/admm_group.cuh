// admm_box_solve_group — the box-ADMM window solve, run by a group of
// group_size<S>() threads per instance (16 below s=16, a warp from s=16 to
// 31): in the constrained MHE tick and in K4.
//
// Replaces, inside the constrained tick (csrc/mhe_body.cuh, CON), the TPU
// kernel's whole-window solve: pallas/mhe_replay_kernel.py:787-800 calling
// pallas/admm_core.py::admm_box_solve (factor_chain, sweep_factored,
// t_apply, add_scalar_diag, add_diag); and, as K4's body (admm_solve_group
// below, launched by csrc/admm.cu), the TPU kernel pallas/admm_kernel.py:75.
// It computes what admm_box_solve of admm.cuh computes — the one-thread
// version, which no kernel launches any more and the host harness
// (tests/box_group_host/harness.cpp) keeps as the reference —
// statement for statement: every output element is the same chain
// acc = a0 * v0; acc += a_k * v_k over k = 0, 1, ... (smallmat.cuh's products),
// the Gauss-Jordan inverse runs the statements of gj_inv with the same no-op
// columns skipped, and the epoch-end residuals are maxima, which a reduction
// over the group gives exactly (NaN included: amax and tmax keep it). So the
// iterates, the iteration counts and x are the one-thread version's, as far
// as nvcc contracts the same expressions to the same FMAs.
//
// What bounds it on this card. The solve is a serial chain: per iteration a
// forward and a backward block-Thomas substitution over the N slots, each slot
// two s x s matrix-vector products that wait on the previous slot. With one
// thread per instance every product is s^2 dependent multiply-adds, and every
// slot re-reads its two s x s blocks (Sinv_j, U_j) from global memory, 4 N s^2
// scalars per instance and iteration, although one factorization serves the
// whole tick at the production settings (fixed rho). At B=1024 one thread per
// instance is 32 warps on 32 of the 132 SMs, with nothing to hide the latency
// of those loads (PERF.md §5: 163.5 us per iteration per tick at Go1).
//
// What the group does about it. Lane i (< s) owns row i of every s x s block
// and element i of every vector: a product is s dependent multiply-adds per
// lane, s lanes at once; a vector that a product reads whole goes through
// shared memory between two __syncwarp of the group's lanes (below s=16 16
// lanes, two groups per warp, so B=1024 is 512 warps over all SMs; from s=16
// a whole warp per instance, group_size). Lanes >= s sit out of the
// arithmetic and take part in the syncs and reductions. The Gauss-Jordan
// inverse runs row-parallel: at step i the pivot row is published, lane k
// divides its element k of it, and every lane updates its own row. The
// factorization chain Sinv_j is written straight to shared memory and read
// from there by every iteration and by the polish; the iterates x, z, y, the
// forward-sweep vectors and r stay in shared memory for the whole solve, and
// the z/y ring in global memory is read once before it and written once after
// it. U_j either joins them in shared memory or is read from global memory
// (the scratch the tick's assembly writes, as D_j always is): box_u_shared.
// Cassie (s=15) reads U_j from global memory, layout (a): with the whole chain
// in shared memory, layout (b), a float32 instance takes 41.5 KB and an SM
// holds 4 (5 with blocks of 5), so B=1024 takes a second wave; layout (a)
// takes 24.4 KB, keeps 8 per SM — every instance of B=1024 resident at once —
// and was the faster on the card, 7.49 against 8.71 ms per tick at the best
// block of each (tools/roofline.py --box-layouts; PERF.md §5). At s=9 (Go1,
// PogoX) the whole chain fits 8 float32 instances per block, layout (b),
// which was the faster there (1.04 against 1.26 ms per tick).
//
// Shared memory per instance, in scalars (N slots): Sinv N s^2, U (N-1) s^2
// in layout (b), x, z, y, the forward-sweep vectors and r 5 N s, and 6 s of
// broadcast buffers; padded to 64 mod 128 bytes on groups of 16, so that the
// two groups of a warp touch different banks, and to 16 bytes on a warp per
// instance, where a warp holds one instance (group_stride;
// kernels/_group.py's box_geometry computes the same bytes). At s=21 (Go1
// with its foot positions as states) U_j comes from global memory, layout
// (a), as at s=15.
#pragma once

#include "admm.cuh"

#define DEM_HHD __host__ __device__ __forceinline__

namespace dem {

// Threads per instance of a group at state size S: 16 below s=16 (lane r owns
// row r, and a spare lane s is left for the tails that need one), two
// instances per warp; a whole warp from s=16 to s=31. Every body below takes
// the group size from S, so an instantiation below s=16 compiles as it did
// when 16 was the only size.
template <int S>
DEM_HHD constexpr int group_size() {
  static_assert(S >= 1 && S < 32, "a group runs at most 31 states");
  return S < 16 ? 16 : 32;
}

// this thread's row in its group of G lanes (lanes 0-15 and 16-31 of a warp,
// or the whole warp), its group's instance within the block, and the lanes of
// the warp that its group's syncs and shuffles name
template <int G>
DEM_HD int box_lane() { return (int)threadIdx.x % G; }
template <int G>
DEM_HD int box_slot() { return (int)threadIdx.x / G; }
template <int G>
DEM_HD unsigned group_mask() {
  if constexpr (G == 32) return 0xffffffffu;
  else return ((int)threadIdx.x % 32) < G ? 0x0000ffffu : 0xffff0000u;
}

// Scalars from one instance's shared memory to the next, for `scalars` of
// them: on groups of 16 padded to 16 mod 32 four-byte words, so that the two
// groups of a warp touch different banks; on a warp per instance rounded up
// to 16 bytes (a warp holds one instance: there is nothing to separate)
template <typename T, int G>
DEM_HHD constexpr int group_stride(int scalars) {
  constexpr int wpe = (int)sizeof(T) / 4;
  const int words = scalars * wpe;
  if constexpr (G == 32) return (words + 3) / 4 * 4 / wpe;
  else return (words + (48 - words % 32) % 32) / wpe;
}

// U in shared memory (layout (b)) or read from global memory (layout (a))
template <int S>
DEM_HHD constexpr bool box_u_shared() { return S <= 9; }

// offsets of one instance's arrays in its shared memory, in scalars
template <typename T, int S, bool USH>
struct BoxLayout {
  static constexpr int SS = S * S;
  DEM_HHD static int u(int N) { return N * SS; }
  DEM_HHD static int x(int N) { return u(N) + (USH ? (N - 1) * SS : 0); }
  DEM_HHD static int z(int N) { return x(N) + N * S; }
  DEM_HHD static int y(int N) { return z(N) + N * S; }
  DEM_HHD static int ys(int N) { return y(N) + N * S; }
  DEM_HHD static int r(int N) { return ys(N) + N * S; }
  DEM_HHD static int buf(int N) { return r(N) + N * S; }   // 6 S: vb, xb, pivot row, divided row
  // scalars from one instance to the next (group_stride)
  DEM_HHD static int stride(int N) { return group_stride<T, group_size<S>()>(buf(N) + 6 * S); }
};

extern __shared__ __align__(16) unsigned char dem_box_smem[];

// One instance's group: its lane (the row it owns), the group's lanes in the
// warp, its shared memory and its place in the lanes layout.
template <typename T>
struct BoxGroup {
  int ln;
  unsigned mask;
  T* sm;
  int N, B, b;
};

template <typename T, int S, bool USH>
DEM_HD BoxGroup<T> box_group(int N, int B, int b) {
  constexpr int G = group_size<S>();
  BoxGroup<T> g;
  g.ln = box_lane<G>();
  g.mask = group_mask<G>();
  g.sm = reinterpret_cast<T*>(dem_box_smem) +
         (size_t)box_slot<G>() * BoxLayout<T, S, USH>::stride(N);
  g.N = N; g.B = B; g.b = b;
  return g;
}

// the largest of the G lanes' values, NaN if any lane's is (tmax keeps a
// NaN, as the one-thread fold amax does; each lane's value is a fold of amax
// from +0, so on values without NaN the order of the comparisons does not
// matter)
template <int G, typename T>
DEM_HD T group_max(T v, unsigned mask) {
  DEM_UNROLL
  for (int o = G / 2; o > 0; o >>= 1) v = tmax(v, __shfl_xor_sync(mask, v, o, G));
  return v;
}

// U_j[row][col]: from shared memory (layout (b)) or the assembly's scratch
template <typename T, int S, bool USH>
struct BoxU {
  const T* g;   // (N-1,s,s,B) global
  const T* sh;  // (N-1,s,s) shared
  int B, b;
  DEM_HD T operator()(int j, int row, int col) const {
    if constexpr (USH) return sh[j * S * S + row * S + col];
    else return ld(g, (size_t)j * (S * S) + row * S + col, B, b);
  }
};

// D_j[row][col] of the assembly's scratch
template <typename T, int S>
DEM_HD T box_d(const T* D, int j, int row, int col, int B, int b) {
  return ld(D, (size_t)j * (S * S) + row * S + col, B, b);
}

// Row-parallel Gauss-Jordan (gj_inv's statements, one row per lane): lane r
// (< S) hands in row r of A and gets row r of A^-1. pb, db: 2 S scalars each
// of shared memory, the pivot row and its division by the pivot.
template <typename T, int S>
DEM_HD void gj_inv_rows(const T* A, T* Inv, T* pb, T* db, int ln, unsigned mask) {
  T L[S], R[S];
  DEM_UNROLL
  for (int k = 0; k < S; ++k) { L[k] = A[k]; R[k] = k == ln ? T(1) : T(0); }
  DEM_UNROLL
  for (int i = 0; i < S; ++i) {
    if (ln == i) {
      DEM_UNROLL
      for (int k = i; k < S; ++k) pb[k] = L[k];
      DEM_UNROLL
      for (int k = 0; k <= i; ++k) pb[S + k] = R[k];
    }
    __syncwarp(mask);
    const T piv = pb[i];
    if (ln >= i && ln < S) db[ln] = pb[ln] / piv;       // rowL[ln]
    if (ln <= i) db[S + ln] = pb[S + ln] / piv;         // rowR[ln]
    __syncwarp(mask);
    if (ln == i) {
      DEM_UNROLL
      for (int k = i; k < S; ++k) L[k] = db[k];
      DEM_UNROLL
      for (int k = 0; k <= i; ++k) R[k] = db[S + k];
    } else if (ln < S) {
      const T col = L[i];
      DEM_UNROLL
      for (int k = i; k < S; ++k) L[k] -= col * db[k];
      DEM_UNROLL
      for (int k = 0; k <= i; ++k) R[k] -= col * db[S + k];
    }
  }
  DEM_UNROLL
  for (int k = 0; k < S; ++k) Inv[k] = R[k];
}

// W_j = Sinv_{j-1} U_{j-1} into the slot Sinv_j takes after it (admm_factor's
// and admm_polish's matmul): lane r writes row r
template <typename T, int S, bool USH>
DEM_HD void box_w(const BoxGroup<T>& g, const BoxU<T, S, USH>& U, int j) {
  constexpr int SS = S * S;
  if (g.ln < S) {
    const T* srow = g.sm + (j - 1) * SS + g.ln * S;
    T* W = g.sm + j * SS;
    T sr[S];
    DEM_UNROLL
    for (int k = 0; k < S; ++k) sr[k] = srow[k];
#pragma unroll 1
    for (int c = 0; c < S; ++c) {
      T acc = sr[0] * U(j - 1, 0, c);
      DEM_UNROLL
      for (int k = 1; k < S; ++k) acc += sr[k] * U(j - 1, k, c);
      W[g.ln * S + c] = acc;
    }
  }
  __syncwarp(g.mask);
}

// A (row r) -= row r of U_{j-1}^T W_j (matmul_tn, then the subtraction)
template <typename T, int S, bool USH>
DEM_HD void box_sub_utw(const BoxGroup<T>& g, const BoxU<T, S, USH>& U, int j, T* A) {
  const T* W = g.sm + j * S * S;
  T uc[S];
  DEM_UNROLL
  for (int k = 0; k < S; ++k) uc[k] = U(j - 1, k, g.ln);
  DEM_UNROLL
  for (int c = 0; c < S; ++c) {
    T acc = uc[0] * W[c];
    DEM_UNROLL
    for (int k = 1; k < S; ++k) acc += uc[k] * W[k * S + c];
    A[c] -= acc;
  }
}

// admm_factor: Sinv_j = (D_j + sr I - U_{j-1}^T Sinv_{j-1} U_{j-1})^-1 into
// shared memory
template <typename T, int S, bool USH>
DEM_HD void factor_group(const BoxGroup<T>& g, const T* D, const BoxU<T, S, USH>& U, T sr) {
  using Lay = BoxLayout<T, S, USH>;
  constexpr int SS = S * S;
  T* pb = g.sm + Lay::buf(g.N) + 2 * S;
  T* db = pb + 2 * S;
  for (int j = 0; j < g.N; ++j) {
    if (j > 0) box_w<T, S, USH>(g, U, j);
    T A[S], inv[S];
    if (g.ln < S) {
      DEM_UNROLL
      for (int k = 0; k < S; ++k) A[k] = box_d<T, S>(D, j, g.ln, k, g.B, g.b);
      DEM_UNROLL
      for (int k = 0; k < S; ++k)
        if (k == g.ln) A[k] += sr;
      if (j > 0) box_sub_utw<T, S, USH>(g, U, j, A);
    } else {
      DEM_UNROLL
      for (int k = 0; k < S; ++k) A[k] = T(0);
    }
    gj_inv_rows<T, S>(A, inv, pb, db, g.ln, g.mask);
    if (g.ln < S) {
      DEM_UNROLL
      for (int k = 0; k < S; ++k) g.sm[j * SS + g.ln * S + k] = inv[k];
    }
  }
  __syncwarp(g.mask);
}

// admm_iterate: one substitution sweep with the chain in shared memory, the
// iterate update fused into the backward sweep
template <typename T, int S, bool USH>
DEM_HD void iterate_group(const BoxGroup<T>& g, const BoxU<T, S, USH>& U,
                          const AdmmSettings<T>& a, T rho, T lbi, T ubi) {
  using Lay = BoxLayout<T, S, USH>;
  constexpr int SS = S * S;
  const int N = g.N, ln = g.ln;
  T* x = g.sm + Lay::x(N);
  T* z = g.sm + Lay::z(N);
  T* y = g.sm + Lay::y(N);
  T* ys = g.sm + Lay::ys(N);
  const T* rr = g.sm + Lay::r(N);
  T* vb = g.sm + Lay::buf(N);
  T* xb = vb + S;
  for (int j = 0; j < N; ++j) {
    const int e = j * S + ln;
    T rhs = T(0);
    if (ln < S) rhs = rr[e] + a.sigma * x[e] + rho * z[e] - y[e];
    if (j > 0) {
      if (ln < S) {
        const T* srow = g.sm + (j - 1) * SS + ln * S;
        const T* yv = ys + (j - 1) * S;
        T acc = srow[0] * yv[0];
        DEM_UNROLL
        for (int k = 1; k < S; ++k) acc += srow[k] * yv[k];
        vb[ln] = acc;
      }
      __syncwarp(g.mask);
      if (ln < S) {
        T acc = U(j - 1, 0, ln) * vb[0];
        DEM_UNROLL
        for (int k = 1; k < S; ++k) acc += U(j - 1, k, ln) * vb[k];
        rhs -= acc;
      }
    }
    if (ln < S) ys[e] = rhs;
    __syncwarp(g.mask);
  }
  for (int j = N - 1; j >= 0; --j) {
    const int e = j * S + ln;
    if (ln < S) {
      T rhs;
      if (j == N - 1) {
        rhs = ys[e];
      } else {
        T acc = U(j, ln, 0) * xb[0];
        DEM_UNROLL
        for (int k = 1; k < S; ++k) acc += U(j, ln, k) * xb[k];
        rhs = ys[e] - acc;
      }
      vb[ln] = rhs;
    }
    __syncwarp(g.mask);
    if (ln < S) {
      const T* srow = g.sm + j * SS + ln * S;
      T xt = srow[0] * vb[0];
      DEM_UNROLL
      for (int k = 1; k < S; ++k) xt += srow[k] * vb[k];
      xb[ln] = xt;
      T xj = x[e], zj = z[e], yj = y[e];
      const T ax = a.alpha * xt;
      const T z_r = ax + a.one_m_alpha * zj;
      const T z_n = clip(z_r + yj / rho, lbi, ubi);
      xj = ax + a.one_m_alpha * xj;
      yj = yj + rho * (z_r - z_n);
      zj = z_n;
      x[e] = xj;
      z[e] = zj;
      y[e] = yj;
    }
    __syncwarp(g.mask);
  }
}

// admm_epoch_end: the OSQP residuals over the window, reduced over the group;
// every lane then sets the same `done` and rho
template <typename T, int S, bool USH>
DEM_HD void epoch_end_group(const BoxGroup<T>& g, const T* D, const BoxU<T, S, USH>& U,
                            const AdmmSettings<T>& a, T& rho, bool& done) {
  using Lay = BoxLayout<T, S, USH>;
  const int N = g.N, ln = g.ln;
  const T* x = g.sm + Lay::x(N);
  const T* z = g.sm + Lay::z(N);
  const T* y = g.sm + Lay::y(N);
  const T* rr = g.sm + Lay::r(N);
  T prim = T(0), dual = T(0), mx = T(0), mz = T(0), mTx = T(0), my = T(0), mr = T(0);
  if (ln < S) {
    for (int j = 0; j < N; ++j) {
      const T* xc = x + j * S;
      T o = box_d<T, S>(D, j, ln, 0, g.B, g.b) * xc[0];
      DEM_UNROLL
      for (int k = 1; k < S; ++k) o += box_d<T, S>(D, j, ln, k, g.B, g.b) * xc[k];
      if (j < N - 1) {
        const T* xn = xc + S;
        T t = U(j, ln, 0) * xn[0];
        DEM_UNROLL
        for (int k = 1; k < S; ++k) t += U(j, ln, k) * xn[k];
        o += t;
      }
      if (j > 0) {
        const T* xp = xc - S;
        T t = U(j - 1, 0, ln) * xp[0];
        DEM_UNROLL
        for (int k = 1; k < S; ++k) t += U(j - 1, k, ln) * xp[k];
        o += t;
      }
      const int e = j * S + ln;
      const T xci = xc[ln], zj = z[e], yj = y[e], rj = rr[e];
      prim = amax(prim, xci - zj);
      dual = amax(dual, o - rj + yj);
      mx = amax(mx, xci); mz = amax(mz, zj);
      mTx = amax(mTx, o); my = amax(my, yj); mr = amax(mr, rj);
    }
  }
  constexpr int G = group_size<S>();
  prim = group_max<G>(prim, g.mask); dual = group_max<G>(dual, g.mask);
  mx = group_max<G>(mx, g.mask); mz = group_max<G>(mz, g.mask);
  mTx = group_max<G>(mTx, g.mask); my = group_max<G>(my, g.mask); mr = group_max<G>(mr, g.mask);
  const T ps = tmax(mx, mz);
  const T ds = tmax(tmax(mTx, my), mr);
  if (a.check && prim <= a.abs_tol + a.rel_tol * ps && dual <= a.abs_tol + a.rel_tol * ds)
    done = true;
  if (a.adaptive && !done) {
    const T ratio = sqrt((prim / tmax(ps, T(1e-12))) / tmax(dual / tmax(ds, T(1e-12)), T(1e-12)));
    rho = clip(rho * ratio, T(1e-6), T(1e6));
  }
}

// admm_polish: the active set pinned by a penalty, one exact block-Thomas
// solve; its chain overwrites the iterations' in shared memory
template <typename T, int S, bool USH>
DEM_HD void polish_group(const BoxGroup<T>& g, const T* D, const BoxU<T, S, USH>& U,
                         const AdmmSettings<T>& a, T lbi, T ubi) {
  using Lay = BoxLayout<T, S, USH>;
  constexpr int SS = S * S;
  const int N = g.N, ln = g.ln;
  T* x = g.sm + Lay::x(N);
  const T* z = g.sm + Lay::z(N);
  T* ys = g.sm + Lay::ys(N);
  const T* rr = g.sm + Lay::r(N);
  T* vb = g.sm + Lay::buf(N);
  T* pb = vb + 2 * S;
  T* db = pb + 2 * S;
  const T lb_fin = is_fin(lbi) ? lbi : T(0);
  const T ub_fin = is_fin(ubi) ? ubi : T(0);
  for (int j = 0; j < N; ++j) {
    if (j > 0) box_w<T, S, USH>(g, U, j);
    T A[S], inv[S], rp = T(0);
    if (ln < S) {
      DEM_UNROLL
      for (int k = 0; k < S; ++k) A[k] = box_d<T, S>(D, j, ln, k, g.B, g.b);
      T dmax = box_d<T, S>(D, j, 0, 0, g.B, g.b);
      DEM_UNROLL
      for (int i = 1; i < S; ++i) dmax = tmax(dmax, box_d<T, S>(D, j, i, i, g.B, g.b));
      const int e = j * S + ln;
      const T zj = z[e];
      rp = rr[e];
      const T act_lo = zj <= lbi ? T(1) : T(0);
      const T act_hi = zj >= ubi ? T(1) : T(0);
      const T act = act_lo + act_hi > T(1) ? T(1) : act_lo + act_hi;
      const T target = act_lo * lb_fin + (T(1) - act_lo) * act_hi * ub_fin;
      const T ap = act * (a.penalty * (dmax + box_d<T, S>(D, j, ln, ln, g.B, g.b)));
      rp += ap * target;
      DEM_UNROLL
      for (int k = 0; k < S; ++k)
        if (k == ln) A[k] += ap;
      if (j > 0) {
        box_sub_utw<T, S, USH>(g, U, j, A);
        const T* srow = g.sm + (j - 1) * SS + ln * S;
        const T* yv = ys + (j - 1) * S;
        T acc = srow[0] * yv[0];
        DEM_UNROLL
        for (int k = 1; k < S; ++k) acc += srow[k] * yv[k];
        vb[ln] = acc;
      }
    } else {
      DEM_UNROLL
      for (int k = 0; k < S; ++k) A[k] = T(0);
    }
    if (j > 0) {
      __syncwarp(g.mask);
      if (ln < S) {
        T acc = U(j - 1, 0, ln) * vb[0];
        DEM_UNROLL
        for (int k = 1; k < S; ++k) acc += U(j - 1, k, ln) * vb[k];
        rp -= acc;
      }
    }
    if (ln < S) ys[j * S + ln] = rp;
    gj_inv_rows<T, S>(A, inv, pb, db, ln, g.mask);
    if (ln < S) {
      DEM_UNROLL
      for (int k = 0; k < S; ++k) g.sm[j * SS + ln * S + k] = inv[k];
    }
  }
  __syncwarp(g.mask);
  if (ln < S) {
    const T* srow = g.sm + (N - 1) * SS + ln * S;
    const T* yv = ys + (N - 1) * S;
    T xv = srow[0] * yv[0];
    DEM_UNROLL
    for (int k = 1; k < S; ++k) xv += srow[k] * yv[k];
    x[(N - 1) * S + ln] = xv;
  }
  __syncwarp(g.mask);
  for (int j = N - 2; j >= 0; --j) {
    if (ln < S) {
      const T* xn = x + (j + 1) * S;
      T t1 = U(j, ln, 0) * xn[0];
      DEM_UNROLL
      for (int k = 1; k < S; ++k) t1 += U(j, ln, k) * xn[k];
      vb[ln] = ys[j * S + ln] - t1;
    }
    __syncwarp(g.mask);
    if (ln < S) {
      const T* srow = g.sm + j * SS + ln * S;
      T xv = srow[0] * vb[0];
      DEM_UNROLL
      for (int k = 1; k < S; ++k) xv += srow[k] * vb[k];
      x[j * S + ln] = xv;
    }
    __syncwarp(g.mask);
  }
}

// The whole solve for instance g.b, admm_box_solve's epochs: D, U, r the
// masked window system in global memory (N,s,s,B), (N-1,s,s,B), (N,s,B); z, y
// the warm-start rings (logical slot j at ring slot (zbase + j) % N), read
// before and written after the solve; lbi, ubi this lane's bounds. x ends in
// shared memory (BoxLayout::x). Returns the iterations the instance ran.
template <typename T, int S, bool USH>
DEM_HD int admm_box_solve_group(const BoxGroup<T>& g, const T* D, const T* Ug, const T* rg,
                                T* zg, T* yg, const AdmmSettings<T>& a, T lbi, T ubi,
                                int zbase) {
  using Lay = BoxLayout<T, S, USH>;
  constexpr int SS = S * S;
  const int N = g.N, ln = g.ln;
  T* x = g.sm + Lay::x(N);
  T* z = g.sm + Lay::z(N);
  T* y = g.sm + Lay::y(N);
  T* rr = g.sm + Lay::r(N);
  if (ln < S) {
    for (int j = 0; j < N; ++j) {
      const size_t ez = (size_t)ring_slot(zbase, j, N) * S + ln;
      const T zj = ld(zg, ez, g.B, g.b);
      z[j * S + ln] = zj;
      x[j * S + ln] = zj;
      y[j * S + ln] = ld(yg, ez, g.B, g.b);
      rr[j * S + ln] = ld(rg, (size_t)j * S + ln, g.B, g.b);
    }
    if constexpr (USH) {
      T* Ush = g.sm + Lay::u(N);
      for (int j = 0; j < N - 1; ++j) {
        DEM_UNROLL
        for (int k = 0; k < S; ++k)
          Ush[j * SS + ln * S + k] = ld(Ug, (size_t)j * SS + ln * S + k, g.B, g.b);
      }
    }
  }
  __syncwarp(g.mask);
  BoxU<T, S, USH> U;
  U.g = Ug; U.sh = g.sm + Lay::u(N); U.B = g.B; U.b = g.b;
  T rho = a.rho0;
  bool done = false;
  int itc = 0;
  const int n_full = a.iters / a.E, rem = a.iters % a.E;
  const int n_epochs = n_full + (rem ? 1 : 0);
  for (int e = 0; e < n_epochs && !done; ++e) {
    const int len = e < n_full ? a.E : rem;
    if (e == 0 || a.adaptive) factor_group<T, S, USH>(g, D, U, a.sigma + rho);
    for (int k = 0; k < len; ++k) iterate_group<T, S, USH>(g, U, a, rho, lbi, ubi);
    itc += len;
    if (e < n_full && (a.check || a.adaptive))
      epoch_end_group<T, S, USH>(g, D, U, a, rho, done);
  }
  if (a.polish) polish_group<T, S, USH>(g, D, U, a, lbi, ubi);
  if (ln < S) {
    for (int j = 0; j < N; ++j) {
      const size_t ez = (size_t)ring_slot(zbase, j, N) * S + ln;
      st(zg, ez, g.B, g.b, z[j * S + ln]);
      st(yg, ez, g.B, g.b, y[j * S + ln]);
    }
  }
  return itc;
}

// K4's whole solve for instance b (csrc/admm.cu's admm_kernel), on its group:
// D, U, r the system and lb, ub the (s,B) bounds in global memory in the lanes
// layout; z and y the warm starts in and the final iterates out (slot j at j:
// zbase 0); x (N,s,B) and iters (B,) out. Lane i reads its bounds lb[i],
// ub[i] and writes row i of x from shared memory, lane 0 the iteration count.
template <typename T, int S>
DEM_HD void admm_solve_group(const T* D, const T* U, const T* r, const T* lb, const T* ub,
                             T* x, T* z, T* y, int* iters, const AdmmSettings<T>& a, int N,
                             int B, int b) {
  constexpr bool USH = box_u_shared<S>();
  const BoxGroup<T> g = box_group<T, S, USH>(N, B, b);
  T lbi = T(0), ubi = T(0);
  if (g.ln < S) {
    lbi = ld(lb, g.ln, B, b);
    ubi = ld(ub, g.ln, B, b);
  }
  const int its = admm_box_solve_group<T, S, USH>(g, D, U, r, z, y, a, lbi, ubi, 0);
  if (g.ln < S) {
    const T* xs = g.sm + BoxLayout<T, S, USH>::x(N);
    for (int j = 0; j < N; ++j) st(x, (size_t)j * S + g.ln, B, b, xs[j * S + g.ln]);
  }
  if (g.ln == 0) iters[b] = its;
}

// The dynamic shared memory of a launch of `block` threads that runs the
// solve above, the constrained tick's or K4's (csrc/admm.cu): block /
// group_size instances of BoxLayout::stride scalars (kernels/_group.py's
// box_geometry computes the same bytes).
template <typename T, int S>
DEM_HHD size_t box_shared_bytes(int N, int block) {
  return (size_t)(block / group_size<S>()) * BoxLayout<T, S, box_u_shared<S>()>::stride(N) *
         sizeof(T);
}

#ifdef __CUDACC__

// Check a launch's shape, G threads per instance, and allow its dynamic
// shared memory: 0, or the error of what the card refuses (cleared, so that
// it does not surface at a later launch). *shmem = the bytes to launch with.
template <int G, typename K>
int box_launch_shape(K kern, size_t bytes, int block, size_t* shmem) {
  if (block < G || block > 1024 || block % G) return (int)cudaErrorInvalidValue;
  const cudaError_t e =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) {
    cudaGetLastError();
    return (int)e;
  }
  *shmem = bytes;
  return 0;
}

// The geometry of a launch of `block` threads, G per instance, with `bytes`
// of dynamic shared memory: out[0..5] = instances per block, threads per
// block, dynamic shared bytes, blocks resident per SM
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), registers per thread,
// local bytes per thread. Returns 0 or the CUDA error.
template <int G, typename K>
int group_geometry(K kern, size_t bytes, int block, int* out) {
  size_t shmem = 0;
  int err = box_launch_shape<G>(kern, bytes, block, &shmem);
  if (err) return err;
  int per_sm = 0;
  cudaFuncAttributes fa;
  cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, block, shmem);
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&fa, kern);
  if (e != cudaSuccess) {
    cudaGetLastError();
    return (int)e;
  }
  out[0] = block / G; out[1] = block; out[2] = (int)shmem; out[3] = per_sm;
  out[4] = fa.numRegs; out[5] = (int)fa.localSizeBytes;
  return 0;
}

#endif  // __CUDACC__

}  // namespace dem
