// The batched SPD block-tridiagonal solve (K5): the group body that
// csrc/tridiag.cu launches, on BOX_G = 16 threads per instance, and the
// one-thread body tridiag_body, which no kernel launches any more and the
// host harness (tests/box_group_host/harness.cpp) holds the group against.
//
// Forward block-Thomas sweep with a pivot-free Gauss-Jordan inverse per slot
//     S_j = D_j - U_{j-1}^T S_{j-1}^{-1} U_{j-1},  y_j = r_j - U_{j-1}^T S_{j-1}^{-1} y_{j-1}
// then the backward sweep
//     x_j = S_j^{-1} (y_j - U_j x_{j+1}).
//
// The group computes what tridiag_body computes, statement for statement: lane
// i (< s) owns row i of every s x s block and element i of every vector; each
// output element is the same chain acc = a0 * v0; acc += a_k * v_k over
// k = 0, 1, ... as smallmat.cuh's products, and the inverse is gj_inv_rows
// (admm_group.cuh), gj_inv's statements one row per lane. It is the
// factorization of admm_group.cuh's factor_group without the shift, with the
// forward substitution fused in as polish_group fuses it, then polish_group's
// backward sweep.
//
// Two layouts of the operands, one sweep: a layout policy gives D_j[row][col],
// U_j[row][col] and r_j[i] and stores x_j[i] (TriLanes, the instance-minor
// lanes layout of solve_lanes; TriStd, the standard layout (K,B,s,s) of
// solve_batched, read in place through any strides, with its (K,B) warm-up
// mask applied as the values are loaded:
// ops/tridiag.mask_system's D v + I (1 - v), U (v_j v_{j+1}), r v, the same
// products in the same order). Everything else is the same code.
//
// Where the data lives: everything in shared memory (TriLayout). The
// factorization chain S_j^{-1} (N s^2 per instance) is read back only by the
// lane that wrote each row; W_j = S_{j-1}^{-1} U_{j-1}, the current U block
// (staged with the mask applied, each lane loading every 16th element), the
// forward vectors y_j (N s) and the broadcast buffers are shared by the group.
// A lane holds slot j's operands in registers, loaded a slot ahead.
#pragma once

#include "admm_group.cuh"

namespace dem {

// ---- the one-thread body: D (N,s,s,B), U (N-1,s,s,B), r (N,s,B), x (N,s,B)
// in the lanes layout, S_j^{-1} and y_j in scratch (Sinv_ws (N,s,s,B),
// y_ws (N,s,B)); nothing else leaves the thread
template <typename T, int S>
DEM_HD void tridiag_body(const T* D, const T* U, const T* r, T* x, T* Sinv_ws,
                         T* y_ws, int N, int B, int b) {
  constexpr int SS = S * S;
  T Sinv[SS], y[S], A[SS];

  load<SS>(A, D, 0, B, b);
  gj_inv<S>(A, Sinv);
  load<S>(y, r, 0, B, b);
  store<SS>(Sinv_ws, 0, B, b, Sinv);
  store<S>(y_ws, 0, B, b, y);

  for (int j = 1; j < N; ++j) {
    T Up[SS], W[SS], UtW[SS], t1[S], t2[S];
    load<SS>(Up, U, (size_t)(j - 1) * SS, B, b);
    matmul<S, S, S>(Sinv, Up, W);
    matmul_tn<S, S, S>(Up, W, UtW);
    load<SS>(A, D, (size_t)j * SS, B, b);
    DEM_UNROLL
    for (int i = 0; i < SS; ++i) A[i] -= UtW[i];
    matvec<S, S>(Sinv, y, t1);
    matvec_t<S, S>(Up, t1, t2);
    load<S>(y, r, (size_t)j * S, B, b);
    DEM_UNROLL
    for (int i = 0; i < S; ++i) y[i] -= t2[i];
    gj_inv<S>(A, Sinv);
    store<SS>(Sinv_ws, (size_t)j * SS, B, b, Sinv);
    store<S>(y_ws, (size_t)j * S, B, b, y);
  }

  T xv[S];
  matvec<S, S>(Sinv, y, xv);
  store<S>(x, (size_t)(N - 1) * S, B, b, xv);
  for (int j = N - 2; j >= 0; --j) {
    T Uj[SS], rhs[S], t1[S];
    load<SS>(Uj, U, (size_t)j * SS, B, b);
    matvec<S, S>(Uj, xv, t1);
    load<S>(rhs, y_ws, (size_t)j * S, B, b);
    DEM_UNROLL
    for (int i = 0; i < S; ++i) rhs[i] -= t1[i];
    load<SS>(Sinv, Sinv_ws, (size_t)j * SS, B, b);
    matvec<S, S>(Sinv, rhs, xv);
    store<S>(x, (size_t)j * S, B, b, xv);
  }
}

// ---- the layouts of the group's operands

// instance-minor: D (N,s,s,B), U (N-1,s,s,B), r (N,s,B), x (N,s,B); the
// caller has masked the system
template <typename T, int S>
struct TriLanes {
  const T* D;
  const T* U;
  const T* r;
  T* x;
  int B, b;
  DEM_HD T d(int j, int row, int col) const { return ld(D, (size_t)(j * S + row) * S + col, B, b); }
  DEM_HD T u(int j, int row, int col) const { return ld(U, (size_t)(j * S + row) * S + col, B, b); }
  DEM_HD T rv(int j, int i) const { return ld(r, (size_t)j * S + i, B, b); }
  DEM_HD void put_x(int j, int i, T v) const { st(x, (size_t)j * S + i, B, b, v); }
};

// the element strides of the standard layout's operands, axis by axis: D
// (K,B,s,s), U (K-1,B,s,s), r (K,B,s), valid (K,B)
struct TriStrides {
  long long d[4], u[4], r[3], v[2];
};

// standard: D (K,B,s,s), U (K-1,B,s,s), r (K,B,s) with any strides
// (TriStrides: a view with the slot axis moved to the front, or of another
// layout's storage, is read in place), x (K,B,s) contiguous; valid (K,B) the
// warm-up mask (null: every slot live), applied at load as mask_system
// applies it
template <typename T, int S>
struct TriStd {
  const T* D;
  const T* U;
  const T* r;
  const bool* valid;
  T* x;
  TriStrides st;
  int B, b;
  DEM_HD bool live(int j) const { return valid[j * st.v[0] + b * st.v[1]]; }
  DEM_HD T d(int j, int row, int col) const {
    const T a = D[j * st.d[0] + b * st.d[1] + row * st.d[2] + col * st.d[3]];
    if (!valid) return a;
    const T vj = live(j) ? T(1) : T(0);
    return a * vj + (row == col ? T(1) : T(0)) * (T(1) - vj);
  }
  DEM_HD T u(int j, int row, int col) const {
    const T a = U[j * st.u[0] + b * st.u[1] + row * st.u[2] + col * st.u[3]];
    if (!valid) return a;
    return a * (live(j) && live(j + 1) ? T(1) : T(0));
  }
  DEM_HD T rv(int j, int i) const {
    const T a = r[j * st.r[0] + b * st.r[1] + i * st.r[2]];
    if (!valid) return a;
    return a * (live(j) ? T(1) : T(0));
  }
  DEM_HD void put_x(int j, int i, T val) const { x[((size_t)j * B + b) * S + i] = val; }
};

// ---- the group body

// offsets of one instance's shared memory, in scalars (N slots): the chain
// N s^2, W s^2, the staged U block s^2, y N s, and 6 s of
// broadcast buffers (the product vector, x_{j+1}, the pivot row and its
// division); padded to 16 mod 32 four-byte words as BoxLayout is
// (kernels/_group.py's tridiag_geometry computes the same bytes)
template <typename T, int S>
struct TriLayout {
  static constexpr int SS = S * S;
  DEM_HHD static int w(int N) { return N * SS; }
  DEM_HHD static int u(int N) { return w(N) + SS; }
  DEM_HHD static int ys(int N) { return u(N) + SS; }
  DEM_HHD static int buf(int N) { return ys(N) + N * S; }
  DEM_HHD static int stride(int N) {
    constexpr int wpe = (int)sizeof(T) / 4;
    const int words = (buf(N) + 6 * S) * wpe;
    return (words + (48 - words % 32) % 32) / wpe;
  }
};

// the dynamic shared memory of a launch of `block` threads
template <typename T, int S>
DEM_HHD size_t tri_shared_bytes(int N, int block) {
  return (size_t)(block / BOX_G) * TriLayout<T, S>::stride(N) * sizeof(T);
}

// elements of an s x s block per lane when the group stages it
template <int S>
DEM_HHD constexpr int tri_per_lane() { return (S * S + BOX_G - 1) / BOX_G; }

// this lane's elements ln, ln + 16, ... of U_j into registers u
template <typename T, int S, typename L>
DEM_HD void tri_fetch_u(const L& io, int j, int ln, T* u) {
  DEM_UNROLL
  for (int q = 0; q < tri_per_lane<S>(); ++q) {
    const int e = ln + q * BOX_G;
    if (e < S * S) u[q] = io.u(j, e / S, e % S);
  }
}

// ... and from registers into the staged block Ub in shared memory
template <typename T, int S>
DEM_HD void tri_stage_u(const T* u, T* Ub, int ln) {
  DEM_UNROLL
  for (int q = 0; q < tri_per_lane<S>(); ++q) {
    const int e = ln + q * BOX_G;
    if (e < S * S) Ub[e] = u[q];
  }
}

// The whole solve for instance b on its group: io the operands' layout. Each slot's
// operands (row ln of D_j, r_j[ln], this lane's share of U_{j-1}) are loaded
// into registers one slot ahead, before the previous slot's Gauss-Jordan
// inverse, so that their latency hides behind it; the backward sweep loads
// U_{j-1} while it computes x_j.
template <typename T, int S, typename L>
DEM_HD void tridiag_solve_group(const L& io, int N) {
  using Lay = TriLayout<T, S>;
  const int ln = box_lane();
  const unsigned mask = ((int)threadIdx.x % 32) < BOX_G ? 0x0000ffffu : 0xffff0000u;
  T* sm = reinterpret_cast<T*>(dem_box_smem) + (size_t)box_slot() * Lay::stride(N);
  // row `row` of S_j^{-1}
  auto C = [sm](int j, int row, int col) -> T& { return sm[j * S * S + row * S + col]; };
  T* W = sm + Lay::w(N);
  T* Ub = sm + Lay::u(N);
  T* ys = sm + Lay::ys(N);
  T* vb = sm + Lay::buf(N);
  T* xb = vb + S;
  T* pb = xb + S;
  T* db = pb + 2 * S;
  T dn[S], rn = T(0), un[tri_per_lane<S>()];
  auto fetch = [&](int j) {   // slot j's operands into dn, rn, un
    if (ln < S) {
      DEM_UNROLL
      for (int k = 0; k < S; ++k) dn[k] = io.d(j, ln, k);
      rn = io.rv(j, ln);
    }
    if (j > 0) tri_fetch_u<T, S>(io, j - 1, ln, un);
  };

  // forward: the chain and y_j, slot by slot
  fetch(0);
  for (int j = 0; j < N; ++j) {
    if (j > 0) {
      tri_stage_u<T, S>(un, Ub, ln);
      __syncwarp(mask);
      if (ln < S) {
        T sr[S];
        DEM_UNROLL
        for (int k = 0; k < S; ++k) sr[k] = C(j - 1, ln, k);
        DEM_UNROLL_UPTO(S, S)
        for (int c = 0; c < S; ++c) {   // W_j = S_{j-1}^{-1} U_{j-1} (matmul)
          T acc = sr[0] * Ub[c];
          DEM_UNROLL
          for (int k = 1; k < S; ++k) acc += sr[k] * Ub[k * S + c];
          W[ln * S + c] = acc;
        }
        const T* yv = ys + (j - 1) * S;   // S_{j-1}^{-1} y_{j-1} (matvec)
        T acc = sr[0] * yv[0];
        DEM_UNROLL
        for (int k = 1; k < S; ++k) acc += sr[k] * yv[k];
        vb[ln] = acc;
      }
      __syncwarp(mask);
    }
    T A[S], inv[S];
    if (ln < S) {
      DEM_UNROLL
      for (int k = 0; k < S; ++k) A[k] = dn[k];
      T yj = rn;
      if (j > 0) {
        T uc[S];
        DEM_UNROLL
        for (int k = 0; k < S; ++k) uc[k] = Ub[k * S + ln];
        DEM_UNROLL
        for (int c = 0; c < S; ++c) {   // A -= U_{j-1}^T W_j (matmul_tn)
          T acc = uc[0] * W[c];
          DEM_UNROLL
          for (int k = 1; k < S; ++k) acc += uc[k] * W[k * S + c];
          A[c] -= acc;
        }
        T acc = uc[0] * vb[0];   // y_j = r_j - U_{j-1}^T vb (matvec_t)
        DEM_UNROLL
        for (int k = 1; k < S; ++k) acc += uc[k] * vb[k];
        yj -= acc;
      }
      ys[j * S + ln] = yj;
    } else {
      DEM_UNROLL
      for (int k = 0; k < S; ++k) A[k] = T(0);
    }
    if (j + 1 < N) fetch(j + 1);
    gj_inv_rows<T, S>(A, inv, pb, db, ln, mask);
    if (ln < S) {
      DEM_UNROLL
      for (int k = 0; k < S; ++k) C(j, ln, k) = inv[k];
    }
  }

  // backward: x_{N-1} = S_{N-1}^{-1} y_{N-1}, then x_j = S_j^{-1} (y_j - U_j x_{j+1})
  if (N > 1) tri_fetch_u<T, S>(io, N - 2, ln, un);
  if (ln < S) {
    const T* yv = ys + (N - 1) * S;
    T xv = C(N - 1, ln, 0) * yv[0];
    DEM_UNROLL
    for (int k = 1; k < S; ++k) xv += C(N - 1, ln, k) * yv[k];
    xb[ln] = xv;
    io.put_x(N - 1, ln, xv);
  }
  for (int j = N - 2; j >= 0; --j) {
    tri_stage_u<T, S>(un, Ub, ln);
    __syncwarp(mask);
    if (ln < S) {
      T t1 = Ub[ln * S] * xb[0];
      DEM_UNROLL
      for (int k = 1; k < S; ++k) t1 += Ub[ln * S + k] * xb[k];
      vb[ln] = ys[j * S + ln] - t1;
    }
    __syncwarp(mask);
    if (j > 0) tri_fetch_u<T, S>(io, j - 1, ln, un);
    if (ln < S) {
      T xv = C(j, ln, 0) * vb[0];
      DEM_UNROLL
      for (int k = 1; k < S; ++k) xv += C(j, ln, k) * vb[k];
      xb[ln] = xv;
      io.put_x(j, ln, xv);
    }
    __syncwarp(mask);
  }
}

}  // namespace dem
