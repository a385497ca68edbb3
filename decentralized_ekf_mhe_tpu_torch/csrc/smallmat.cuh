// Small dense matrix helpers shared by the three kernels of this package.
//
// Every kernel here runs ONE THREAD PER ESTIMATOR INSTANCE: a matrix is a
// thread-private row-major array T a[R*C] whose loops have compile-time
// bounds, so the compiler keeps it in registers where it can and in
// (L1-cached, per-thread interleaved) local memory where it cannot. Global
// memory is in the "lanes" layout of ops/lanes.py — element e of a tensor
// sits at base[e * B + b] for instance b — so the 32 threads of a warp touch
// 32 neighbouring addresses on every load and store.
//
// No fast-math anywhere: divisions are real divisions (the Gauss-Jordan
// inverse divides the pivot row, like the reference), square roots are
// sqrt(), and the sources are compiled without -use_fast_math.
#pragma once

#include <cstddef>

#define DEM_HD __device__ __forceinline__
#define DEM_UNROLL _Pragma("unroll")

// The loops below over matrix dimensions are fully unrolled: every index is
// then a compile-time constant. A translation unit that sets
// -DDEM_MAX_UNROLL=<n> (the s=15 instantiations, kernels/_build.py) keeps a
// loop rolled where its trips times the scalar operations of one trip exceed
// n: a fully unrolled 15 x 15 x 15 product is thousands of instructions per
// call site, which costs ptxas minutes per unit and overflows the
// instruction cache, while the operands live in local memory anyway.
#ifdef DEM_MAX_UNROLL
#define DEM_STR_(x) #x
#define DEM_PRAGMA_(x) _Pragma(DEM_STR_(x))
#define DEM_UNROLL_UPTO(trips, work) \
  DEM_PRAGMA_(unroll((trips) * (work) > DEM_MAX_UNROLL ? 1 : (trips)))
#else
#define DEM_UNROLL_UPTO(trips, work) DEM_UNROLL
#endif

namespace dem {

// ---- lanes-layout global memory access: element e of instance b ----------
template <typename T>
DEM_HD T ld(const T* p, size_t e, int B, int b) { return p[e * (size_t)B + b]; }
template <typename T>
DEM_HD void st(T* p, size_t e, int B, int b, T v) { p[e * (size_t)B + b] = v; }

template <int n, typename T>
DEM_HD void load(T* dst, const T* src, size_t e0, int B, int b) {
  DEM_UNROLL_UPTO(n, 1)
  for (int i = 0; i < n; ++i) dst[i] = ld(src, e0 + i, B, b);
}
template <int n, typename T>
DEM_HD void store(T* dst, size_t e0, int B, int b, const T* src) {
  DEM_UNROLL_UPTO(n, 1)
  for (int i = 0; i < n; ++i) st(dst, e0 + i, B, b, src[i]);
}
template <int n, typename T>
DEM_HD void fill(T* dst, size_t e0, int B, int b, T v) {
  DEM_UNROLL_UPTO(n, 1)
  for (int i = 0; i < n; ++i) st(dst, e0 + i, B, b, v);
}

// a * b rounded on its own: nvcc never contracts it into a multiply-add
// (__fmul_rn, __dmul_rn). A chain acc = a0 b0; acc += a_k b_k (k = 1, 2, ...)
// that runs as a rolled loop rounds its first product before the loop and
// contracts each later one; fully unrolled, nvcc may contract the first
// product instead of the second. A chain that must round as its rolled twin
// does starts with mul_rn.
template <typename T>
DEM_HD T mul_rn(T a, T b) {
#ifdef __CUDA_ARCH__
  if constexpr (sizeof(T) == 4) return __fmul_rn(a, b);
  else return __dmul_rn(a, b);
#else
  return a * b;
#endif
}

// ---- products; all sums run k = 0, 1, ... like the plain versions --------
// C (I x J) = A (I x K) * Bm (K x J)
template <int I, int K, int J, typename T>
DEM_HD void matmul(const T* A, const T* Bm, T* C) {
  DEM_UNROLL_UPTO(I, J * K)
  for (int i = 0; i < I; ++i) {
    DEM_UNROLL_UPTO(J, K)
    for (int j = 0; j < J; ++j) {
      T acc = A[i * K] * Bm[j];
      DEM_UNROLL_UPTO(K, 1)
      for (int k = 1; k < K; ++k) acc += A[i * K + k] * Bm[k * J + j];
      C[i * J + j] = acc;
    }
  }
}
// C (I x J) = A^T * Bm with A (K x I), Bm (K x J)
template <int K, int I, int J, typename T>
DEM_HD void matmul_tn(const T* A, const T* Bm, T* C) {
  DEM_UNROLL_UPTO(I, J * K)
  for (int i = 0; i < I; ++i) {
    DEM_UNROLL_UPTO(J, K)
    for (int j = 0; j < J; ++j) {
      T acc = A[i] * Bm[j];
      DEM_UNROLL_UPTO(K, 1)
      for (int k = 1; k < K; ++k) acc += A[k * I + i] * Bm[k * J + j];
      C[i * J + j] = acc;
    }
  }
}
// C (I x J) = A * Bm^T with A (I x K), Bm (J x K)
template <int I, int K, int J, typename T>
DEM_HD void matmul_nt(const T* A, const T* Bm, T* C) {
  DEM_UNROLL_UPTO(I, J * K)
  for (int i = 0; i < I; ++i) {
    DEM_UNROLL_UPTO(J, K)
    for (int j = 0; j < J; ++j) {
      T acc = A[i * K] * Bm[j * K];
      DEM_UNROLL_UPTO(K, 1)
      for (int k = 1; k < K; ++k) acc += A[i * K + k] * Bm[j * K + k];
      C[i * J + j] = acc;
    }
  }
}
// w (I) = A (I x K) * v (K)
template <int I, int K, typename T>
DEM_HD void matvec(const T* A, const T* v, T* w) {
  DEM_UNROLL_UPTO(I, K)
  for (int i = 0; i < I; ++i) {
    T acc = A[i * K] * v[0];
    DEM_UNROLL_UPTO(K, 1)
    for (int k = 1; k < K; ++k) acc += A[i * K + k] * v[k];
    w[i] = acc;
  }
}
// w (I) = A^T v with A (K x I), v (K)
template <int K, int I, typename T>
DEM_HD void matvec_t(const T* A, const T* v, T* w) {
  DEM_UNROLL_UPTO(I, K)
  for (int i = 0; i < I; ++i) {
    T acc = A[i] * v[0];
    DEM_UNROLL_UPTO(K, 1)
    for (int k = 1; k < K; ++k) acc += A[k * I + i] * v[k];
    w[i] = acc;
  }
}

// ---- inverses ---------------------------------------------------------------
// Pivot-free Gauss-Jordan inverse of an SPD n x n matrix (ops/lanes.gj_inv).
// Its loops unroll together: all of them, or (past DEM_MAX_UNROLL) none.
// Works on the augmented [A | I]; at elimination step i the left columns < i
// are already unit columns and the right columns > i still are, so their
// updates are exact no-ops and are skipped — the entries that are computed
// see exactly the operations of the full sweep.
template <int n, typename T>
DEM_HD void gj_inv(const T* A, T* Inv) {
  T L[n * n], R[n * n];
  DEM_UNROLL_UPTO(n, n * n)
  for (int i = 0; i < n * n; ++i) { L[i] = A[i]; R[i] = T(0); }
  DEM_UNROLL_UPTO(n, n * n)
  for (int i = 0; i < n; ++i) R[i * n + i] = T(1);
  DEM_UNROLL_UPTO(n, n * n)
  for (int i = 0; i < n; ++i) {
    const T piv = L[i * n + i];
    T rowL[n], rowR[n];
    DEM_UNROLL_UPTO(n, n * n)
    for (int k = i; k < n; ++k) rowL[k] = L[i * n + k] / piv;
    DEM_UNROLL_UPTO(n, n * n)
    for (int k = 0; k <= i; ++k) rowR[k] = R[i * n + k] / piv;
    DEM_UNROLL_UPTO(n, n * n)
    for (int r = 0; r < n; ++r) {
      if (r == i) continue;
      const T col = L[r * n + i];
      DEM_UNROLL_UPTO(n, n * n)
      for (int k = i; k < n; ++k) L[r * n + k] -= col * rowL[k];
      DEM_UNROLL_UPTO(n, n * n)
      for (int k = 0; k <= i; ++k) R[r * n + k] -= col * rowR[k];
    }
    DEM_UNROLL_UPTO(n, n * n)
    for (int k = i; k < n; ++k) L[i * n + k] = rowL[k];
    DEM_UNROLL_UPTO(n, n * n)
    for (int k = 0; k <= i; ++k) R[i * n + k] = rowR[k];
  }
  DEM_UNROLL_UPTO(n, n * n)
  for (int i = 0; i < n * n; ++i) Inv[i] = R[i];
}

// ---- Cholesky factor and triangular solves (the Cholesky tail of the MHE
// tick; the reference's pallas/tridiag_kernel.py _chol, _trsm_l, _trsv_l,
// _trsv_lt). The factor L of an SPD n x n matrix is kept as its lower
// triangle packed by rows, Lp[tri(i) + k] = L[i][k] for k <= i, beside the
// reciprocal pivots rd[i] = 1 / L[i][i], which the solves multiply by. All
// loops unroll together, as gj_inv's do. Sums run m = 0, 1, ... like the
// reference's.
DEM_HD constexpr int tri(int i) { return i * (i + 1) / 2; }

// Lp, rd of A (reads its lower triangle). Each pivot is clamped at 1e-30
// before its square root, in both types, as the reference clamps it: a
// Schur block that rounding has left indefinite gives a tiny pivot, not NaN.
template <int n, typename T>
DEM_HD void chol(const T* A, T* Lp, T* rd) {
  DEM_UNROLL_UPTO(n, n * n)
  for (int k = 0; k < n; ++k) {
    T d = A[k * n + k];
    DEM_UNROLL_UPTO(n, n * n)
    for (int m = 0; m < k; ++m) d -= Lp[tri(k) + m] * Lp[tri(k) + m];
    d = sqrt(d < T(1e-30) ? T(1e-30) : d);   // NaN passes, as jnp.maximum's
    Lp[tri(k) + k] = d;
    rd[k] = T(1) / d;
    DEM_UNROLL_UPTO(n, n * n)
    for (int i = k + 1; i < n; ++i) {
      T e = A[i * n + k];
      DEM_UNROLL_UPTO(n, n * n)
      for (int m = 0; m < k; ++m) e -= Lp[tri(i) + m] * Lp[tri(k) + m];
      Lp[tri(i) + k] = e * rd[k];
    }
  }
}

// X (n x c) = L^-1 Bm (n x c), row by row
template <int n, int c, typename T>
DEM_HD void trsm_l(const T* Lp, const T* rd, const T* Bm, T* X) {
  DEM_UNROLL_UPTO(n, n * n)
  for (int i = 0; i < n; ++i) {
    DEM_UNROLL_UPTO(c, n * n)
    for (int j = 0; j < c; ++j) {
      T acc = Bm[i * c + j];
      DEM_UNROLL_UPTO(n, n * n)
      for (int m = 0; m < i; ++m) acc -= Lp[tri(i) + m] * X[m * c + j];
      X[i * c + j] = acc * rd[i];
    }
  }
}

// z (n) = L^-1 b
template <int n, typename T>
DEM_HD void trsv_l(const T* Lp, const T* rd, const T* b, T* z) {
  trsm_l<n, 1>(Lp, rd, b, z);
}

// x (n) = L^-T z, from the last row up
template <int n, typename T>
DEM_HD void trsv_lt(const T* Lp, const T* rd, const T* z, T* x) {
  DEM_UNROLL_UPTO(n, n * n)
  for (int i = n - 1; i >= 0; --i) {
    T acc = z[i];
    DEM_UNROLL_UPTO(n, n * n)
    for (int m = i + 1; m < n; ++m) acc -= Lp[tri(m) + i] * x[m];
    x[i] = acc * rd[i];
  }
}

// Closed-form adjugate inverse of a 3 x 3 matrix (ops/lanes.inv3).
template <typename T>
DEM_HD void inv3(const T* A, T* Inv) {
  const T a = A[0], b = A[1], c = A[2], d = A[3], e = A[4], f = A[5],
          g = A[6], h = A[7], i = A[8];
  const T A11 = e * i - f * h, A12 = c * h - b * i, A13 = b * f - c * e;
  const T A21 = f * g - d * i, A22 = a * i - c * g, A23 = c * d - a * f;
  const T A31 = d * h - e * g, A32 = b * g - a * h, A33 = a * e - b * d;
  const T det = a * A11 + b * A21 + c * A31;
  Inv[0] = A11 / det; Inv[1] = A12 / det; Inv[2] = A13 / det;
  Inv[3] = A21 / det; Inv[4] = A22 / det; Inv[5] = A23 / det;
  Inv[6] = A31 / det; Inv[7] = A32 / det; Inv[8] = A33 / det;
}

// c = a x b for 3-vectors
template <typename T>
DEM_HD void cross3(const T* a, const T* b, T* c) {
  c[0] = a[1] * b[2] - a[2] * b[1];
  c[1] = a[2] * b[0] - a[0] * b[2];
  c[2] = a[0] * b[1] - a[1] * b[0];
}

// [v]x as a 3 x 3 matrix
template <typename T>
DEM_HD void skew3(const T* v, T* M) {
  M[0] = T(0); M[1] = -v[2]; M[2] = v[1];
  M[3] = v[2]; M[4] = T(0); M[5] = -v[0];
  M[6] = -v[1]; M[7] = v[0]; M[8] = T(0);
}

}  // namespace dem
