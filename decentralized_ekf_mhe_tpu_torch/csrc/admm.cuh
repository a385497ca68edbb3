// admm_box_solve — OSQP-semantics box-ADMM on one block-tridiagonal system,
// a device function run by one thread per instance.
//
// Replaces pallas/admm_core.py::admm_box_solve (with factor_chain,
// sweep_factored, t_apply, add_scalar_diag, add_diag) in csrc/admm.cu (one
// whole solve per launch). The constrained estimator tick (csrc/mhe_body.cuh)
// runs the same solve on a group of 16 threads per instance,
// admm_box_solve_group of csrc/admm_group.cuh, statement for statement.
//
//   min 1/2 x^T T x - r^T x   s.t.  lb <= x <= ub,
//   T block tridiagonal: D (N,s,s), U (N-1,s,s).
//
// Epochs of E iterations share one block-Thomas factorization of
// T + (sigma + rho) I; with a fixed rho one factorization serves the whole
// solve. An iteration is one substitution sweep (forward, then backward with
// the iterate update fused in):
//   rhs = r + sigma x + rho z - y;   x~ = (T + (sigma+rho) I)^-1 rhs
//   x+ = alpha x~ + (1-alpha) x
//   z+ = clip(alpha x~ + (1-alpha) z + y / rho, lb, ub)
//   y+ = y + rho (alpha x~ + (1-alpha) z - z+)
// At the end of a full epoch the OSQP residuals are checked (converged
// instances stop) and rho is adapted. A partial last epoch is not followed by
// a check. The polish pins the dims whose z sits on a bound by a penalty and
// solves once more, exactly. Same arithmetic, in the same order, as
// ops/admm.solve_box_tridiag_lanes.
//
// Where the data lives. The system, the factorization chain, the forward-sweep
// vectors and the iterates are about 6k scalars per instance at N=20, s=9: all
// of it is GLOBAL memory in the instance-minor layout (coalesced across the
// warp), the chain and the sweep vectors in scratch the caller allocates.
// Only one slot's s x s blocks are thread-private at a time. z and y are
// addressed through a ring (slot (zbase + j) % N) so that a caller can hand
// in ring-carried warm starts without a gather.
//
// Early exit. The TPU kernel computes converged lanes and masks their update;
// here a converged thread leaves the loop. A frozen instance changes nothing,
// rho included, so the results are identical; `iters` counts what was run.
//
// No fast-math: +-inf bounds must survive the clip, and the polish zeroes
// non-finite bounds before it multiplies (0 * inf is NaN).
#pragma once

#include "smallmat.cuh"

namespace dem {

template <typename T>
struct AdmmSettings {
  int iters, E, adaptive, check, polish;
  T rho0, sigma, alpha, one_m_alpha, abs_tol, rel_tol, penalty;
};

// ints: iters, E, adaptive, check, polish; reals: rho0, sigma, alpha,
// 1 - alpha, abs_tol, rel_tol, polish penalty (kernels/admm_kernel.py packs them)
template <typename T>
AdmmSettings<T> admm_settings(const int* ints, const double* reals) {
  AdmmSettings<T> a;
  a.iters = ints[0]; a.E = ints[1] < 1 ? 1 : ints[1]; a.adaptive = ints[2];
  a.check = ints[3]; a.polish = ints[4];
  a.rho0 = (T)reals[0]; a.sigma = (T)reals[1]; a.alpha = (T)reals[2];
  a.one_m_alpha = (T)reals[3]; a.abs_tol = (T)reals[4]; a.rel_tol = (T)reals[5];
  a.penalty = (T)reals[6];
  return a;
}

template <typename T>
struct AdmmPtrs {
  const T* D;   // (N,s,s,B) diagonal blocks, warm-up masked
  const T* U;   // (N-1,s,s,B) couplings
  const T* r;   // (N,s,B)
  T* x;         // (N,s,B) out (also the x iterate)
  T* z;         // (N,s,B) in: warm start, out: final iterate; ring-addressed
  T* y;         // (N,s,B) likewise
  T* Sinv;      // (N,s,s,B) scratch: the factorization chain
  T* ys;        // (N,s,B) scratch: forward-sweep vectors
};

template <typename T> DEM_HD T amax(T m, T v) { v = v < T(0) ? -v : v; return v > m ? v : m; }
template <typename T> DEM_HD T tmax(T a, T b) { return a > b ? a : b; }
template <typename T> DEM_HD T clip(T v, T lo, T hi) { v = v < lo ? lo : v; return v > hi ? hi : v; }
template <typename T> DEM_HD bool is_fin(T v) { return v - v == T(0); }
DEM_HD int ring_slot(int base, int j, int N) { const int p = base + j; return p >= N ? p - N : p; }

// Sinv[j] = (D[j] + diag(add_j) - U[j-1]^T Sinv[j-1] U[j-1])^-1 for the scalar
// augmentation add_j = sr * 1 (factor_chain of add_scalar_diag).
template <typename T, int S>
DEM_HD void admm_factor(const AdmmPtrs<T>& w, T sr, int N, int B, int b) {
  constexpr int SS = S * S;
  T Sinv[SS], A[SS];
  load<SS>(A, w.D, 0, B, b);
  DEM_UNROLL
  for (int i = 0; i < S; ++i) A[i * S + i] += sr;
  gj_inv<S>(A, Sinv);
  store<SS>(w.Sinv, 0, B, b, Sinv);
  for (int j = 1; j < N; ++j) {
    T Up[SS], W[SS], UtW[SS];
    load<SS>(Up, w.U, (size_t)(j - 1) * SS, B, b);
    matmul<S, S, S>(Sinv, Up, W);
    matmul_tn<S, S, S>(Up, W, UtW);
    load<SS>(A, w.D, (size_t)j * SS, B, b);
    DEM_UNROLL
    for (int i = 0; i < S; ++i) A[i * S + i] += sr;
    DEM_UNROLL
    for (int i = 0; i < SS; ++i) A[i] -= UtW[i];
    gj_inv<S>(A, Sinv);
    store<SS>(w.Sinv, (size_t)j * SS, B, b, Sinv);
  }
}

// One ADMM iteration: substitution sweep with the chain in w.Sinv, iterate
// update fused into the backward sweep (slot j's update needs only x~_j).
template <typename T, int S>
DEM_HD void admm_iterate(const AdmmPtrs<T>& w, const AdmmSettings<T>& a, T rho,
                         const T* lb, const T* ub, int zbase, int N, int B, int b) {
  constexpr int SS = S * S;
  T yv[S];
  for (int j = 0; j < N; ++j) {
    const size_t e = (size_t)j * S, ez = (size_t)ring_slot(zbase, j, N) * S;
    T rj[S], xj[S], zj[S], yj[S], rhs[S];
    load<S>(rj, w.r, e, B, b);
    load<S>(xj, w.x, e, B, b);
    load<S>(zj, w.z, ez, B, b);
    load<S>(yj, w.y, ez, B, b);
    DEM_UNROLL
    for (int i = 0; i < S; ++i) rhs[i] = rj[i] + a.sigma * xj[i] + rho * zj[i] - yj[i];
    if (j > 0) {
      T Sinv[SS], Up[SS], t1[S], t2[S];
      load<SS>(Sinv, w.Sinv, (size_t)(j - 1) * SS, B, b);
      load<SS>(Up, w.U, (size_t)(j - 1) * SS, B, b);
      matvec<S, S>(Sinv, yv, t1);
      matvec_t<S, S>(Up, t1, t2);
      DEM_UNROLL
      for (int i = 0; i < S; ++i) rhs[i] -= t2[i];
    }
    DEM_UNROLL
    for (int i = 0; i < S; ++i) yv[i] = rhs[i];
    store<S>(w.ys, e, B, b, yv);
  }
  T xt[S];
  for (int j = N - 1; j >= 0; --j) {
    const size_t e = (size_t)j * S, ez = (size_t)ring_slot(zbase, j, N) * S;
    T Sinv[SS], rhs[S];
    if (j == N - 1) {
      DEM_UNROLL
      for (int i = 0; i < S; ++i) rhs[i] = yv[i];
    } else {
      T Uj[SS], t1[S];
      load<SS>(Uj, w.U, (size_t)j * SS, B, b);
      matvec<S, S>(Uj, xt, t1);
      load<S>(rhs, w.ys, e, B, b);
      DEM_UNROLL
      for (int i = 0; i < S; ++i) rhs[i] -= t1[i];
    }
    load<SS>(Sinv, w.Sinv, (size_t)j * SS, B, b);
    matvec<S, S>(Sinv, rhs, xt);
    T xj[S], zj[S], yj[S];
    load<S>(xj, w.x, e, B, b);
    load<S>(zj, w.z, ez, B, b);
    load<S>(yj, w.y, ez, B, b);
    DEM_UNROLL
    for (int i = 0; i < S; ++i) {
      const T ax = a.alpha * xt[i];
      const T z_r = ax + a.one_m_alpha * zj[i];
      const T z_n = clip(z_r + yj[i] / rho, lb[i], ub[i]);
      xj[i] = ax + a.one_m_alpha * xj[i];
      yj[i] = yj[i] + rho * (z_r - z_n);
      zj[i] = z_n;
    }
    store<S>(w.x, e, B, b, xj);
    store<S>(w.z, ez, B, b, zj);
    store<S>(w.y, ez, B, b, yj);
  }
}

// Epoch-boundary residuals (OSQP section 3.4): sets `done`, adapts rho.
template <typename T, int S>
DEM_HD void admm_epoch_end(const AdmmPtrs<T>& w, const AdmmSettings<T>& a, T& rho,
                           bool& done, int zbase, int N, int B, int b) {
  constexpr int SS = S * S;
  T prim = T(0), dual = T(0), mx = T(0), mz = T(0), mTx = T(0), my = T(0), mr = T(0);
  T xp[S], xc[S], xn[S];
  load<S>(xc, w.x, 0, B, b);
  DEM_UNROLL
  for (int i = 0; i < S; ++i) { xp[i] = T(0); xn[i] = T(0); }
  for (int j = 0; j < N; ++j) {
    const size_t e = (size_t)j * S, ez = (size_t)ring_slot(zbase, j, N) * S;
    T M[SS], o[S], t[S], zj[S], yj[S], rj[S];
    load<SS>(M, w.D, (size_t)j * SS, B, b);
    matvec<S, S>(M, xc, o);
    if (j < N - 1) {
      load<S>(xn, w.x, e + S, B, b);
      load<SS>(M, w.U, (size_t)j * SS, B, b);
      matvec<S, S>(M, xn, t);
      DEM_UNROLL
      for (int i = 0; i < S; ++i) o[i] += t[i];
    }
    if (j > 0) {
      load<SS>(M, w.U, (size_t)(j - 1) * SS, B, b);
      matvec_t<S, S>(M, xp, t);
      DEM_UNROLL
      for (int i = 0; i < S; ++i) o[i] += t[i];
    }
    load<S>(zj, w.z, ez, B, b);
    load<S>(yj, w.y, ez, B, b);
    load<S>(rj, w.r, e, B, b);
    DEM_UNROLL
    for (int i = 0; i < S; ++i) {
      prim = amax(prim, xc[i] - zj[i]);
      dual = amax(dual, o[i] - rj[i] + yj[i]);
      mx = amax(mx, xc[i]); mz = amax(mz, zj[i]);
      mTx = amax(mTx, o[i]); my = amax(my, yj[i]); mr = amax(mr, rj[i]);
      xp[i] = xc[i]; xc[i] = xn[i];
    }
  }
  const T ps = tmax(mx, mz);
  const T ds = tmax(tmax(mTx, my), mr);
  if (a.check && prim <= a.abs_tol + a.rel_tol * ps && dual <= a.abs_tol + a.rel_tol * ds)
    done = true;
  if (a.adaptive && !done) {
    const T ratio = sqrt((prim / tmax(ps, T(1e-12))) / tmax(dual / tmax(ds, T(1e-12)), T(1e-12)));
    rho = clip(rho * ratio, T(1e-6), T(1e6));
  }
}

// Active-set polish: D_p = D + diag(act * pen), r_p = r + act * pen * target,
// one exact block-Thomas solve; the forward sweep runs with the factorization.
template <typename T, int S>
DEM_HD void admm_polish(const AdmmPtrs<T>& w, const AdmmSettings<T>& a, const T* lb,
                        const T* ub, int zbase, int N, int B, int b) {
  constexpr int SS = S * S;
  T lb_fin[S], ub_fin[S];
  DEM_UNROLL
  for (int i = 0; i < S; ++i) {
    lb_fin[i] = is_fin(lb[i]) ? lb[i] : T(0);
    ub_fin[i] = is_fin(ub[i]) ? ub[i] : T(0);
  }
  T Sinv[SS], yv[S], Up[SS];
  for (int j = 0; j < N; ++j) {
    const size_t e = (size_t)j * S, ez = (size_t)ring_slot(zbase, j, N) * S;
    T A[SS], zj[S], rp[S];
    load<SS>(A, w.D, (size_t)j * SS, B, b);
    load<S>(zj, w.z, ez, B, b);
    load<S>(rp, w.r, e, B, b);
    T dmax = A[0];
    DEM_UNROLL
    for (int i = 1; i < S; ++i) dmax = tmax(dmax, A[i * S + i]);
    DEM_UNROLL
    for (int i = 0; i < S; ++i) {
      const T act_lo = zj[i] <= lb[i] ? T(1) : T(0);
      const T act_hi = zj[i] >= ub[i] ? T(1) : T(0);
      const T act = act_lo + act_hi > T(1) ? T(1) : act_lo + act_hi;
      const T target = act_lo * lb_fin[i] + (T(1) - act_lo) * act_hi * ub_fin[i];
      const T ap = act * (a.penalty * (dmax + A[i * S + i]));
      rp[i] += ap * target;
      A[i * S + i] += ap;
    }
    if (j > 0) {
      T W[SS], UtW[SS], t1[S], t2[S];
      matmul<S, S, S>(Sinv, Up, W);
      matmul_tn<S, S, S>(Up, W, UtW);
      DEM_UNROLL
      for (int i = 0; i < SS; ++i) A[i] -= UtW[i];
      matvec<S, S>(Sinv, yv, t1);
      matvec_t<S, S>(Up, t1, t2);
      DEM_UNROLL
      for (int i = 0; i < S; ++i) rp[i] -= t2[i];
    }
    DEM_UNROLL
    for (int i = 0; i < S; ++i) yv[i] = rp[i];
    gj_inv<S>(A, Sinv);
    store<SS>(w.Sinv, (size_t)j * SS, B, b, Sinv);
    store<S>(w.ys, e, B, b, yv);
    if (j < N - 1) load<SS>(Up, w.U, (size_t)j * SS, B, b);
  }
  T xv[S];
  matvec<S, S>(Sinv, yv, xv);
  store<S>(w.x, (size_t)(N - 1) * S, B, b, xv);
  for (int j = N - 2; j >= 0; --j) {
    T rhs[S], t1[S];
    load<SS>(Up, w.U, (size_t)j * SS, B, b);
    matvec<S, S>(Up, xv, t1);
    load<S>(rhs, w.ys, (size_t)j * S, B, b);
    DEM_UNROLL
    for (int i = 0; i < S; ++i) rhs[i] -= t1[i];
    load<SS>(Sinv, w.Sinv, (size_t)j * SS, B, b);
    matvec<S, S>(Sinv, rhs, xv);
    store<S>(w.x, (size_t)j * S, B, b, xv);
  }
}

// The whole solve for instance b. lb, ub: this instance's S bounds
// (thread-private). z and y hold the warm start on entry (logical slot j at
// ring slot (zbase + j) % N) and the final iterates on exit; x warm-starts
// from z. Returns the number of iterations this instance ran.
template <typename T, int S>
DEM_HD int admm_box_solve(const AdmmPtrs<T>& w, const AdmmSettings<T>& a, const T* lb,
                          const T* ub, int zbase, int N, int B, int b) {
  for (int j = 0; j < N; ++j) {
    T zj[S];
    load<S>(zj, w.z, (size_t)ring_slot(zbase, j, N) * S, B, b);
    store<S>(w.x, (size_t)j * S, B, b, zj);
  }
  T rho = a.rho0;
  bool done = false;
  int itc = 0;
  const int n_full = a.iters / a.E, rem = a.iters % a.E;
  const int n_epochs = n_full + (rem ? 1 : 0);
  for (int e = 0; e < n_epochs && !done; ++e) {
    const int len = e < n_full ? a.E : rem;
    if (e == 0 || a.adaptive) admm_factor<T, S>(w, a.sigma + rho, N, B, b);
    for (int k = 0; k < len; ++k) admm_iterate<T, S>(w, a, rho, lb, ub, zbase, N, B, b);
    itc += len;
    if (e < n_full && (a.check || a.adaptive))
      admm_epoch_end<T, S>(w, a, rho, done, zbase, N, B, b);
  }
  if (a.polish) admm_polish<T, S>(w, a, lb, ub, zbase, N, B, b);
  return itc;
}

}  // namespace dem
