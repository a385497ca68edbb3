// tridiag_solve — batched SPD block-tridiagonal solve, one thread per instance.
//
// Replaces the TPU kernel pallas/tridiag_kernel.py::_kernel (reached through
// solve_lanes). Forward block-Thomas sweep
//     S_j = D_j - U_{j-1}^T S_{j-1}^{-1} U_{j-1},  y_j = r_j - U_{j-1}^T S_{j-1}^{-1} y_{j-1}
// with a pivot-free Gauss-Jordan inverse per slot, then the backward sweep
//     x_j = S_j^{-1} (y_j - U_j x_{j+1}).
//
// Layout: D (N,s,s,B), U (N-1,s,s,B), r (N,s,B), x (N,s,B), instance-minor.
// S_j^{-1} and y_j of the forward sweep go to scratch the caller allocates
// (Sinv_ws (N,s,s,B), y_ws (N,s,B)); nothing else leaves the thread.
//
// Bound on this card: bytes (about 5k floating-point operations per slot
// against 2 s^2 + 2 s values moved is ~7 operations per float32 byte, below the
// card's ~20), and in practice the serial dependency chain of one instance,
// since a fleet of B instances only fills B/32 warps. The ragged
// edge (B not a multiple of the block) is masked here; there is no padding.
//
// The state size is a template parameter: s=9 (Go1, PogoX) and s=15
// (Cassie). This file is compiled once per size (-DDEM_TRIDIAG_S=<s>, both
// element types) into a library of its own, libtridiag_s<s>.so
// (kernels/_build.py), built at the first solve of that size.
#include "smallmat.cuh"

namespace dem {

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

template <typename T, int S>
__global__ void tridiag_kernel(const T* D, const T* U, const T* r, T* x,
                               T* Sinv_ws, T* y_ws, int N, int B) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  tridiag_body<T, S>(D, U, r, x, Sinv_ws, y_ws, N, B, b);
}

template <typename T, int S>
int tridiag_launch(const void* D, const void* U, const void* r, void* x,
                   void* Sinv_ws, void* y_ws, int N, int B, int block,
                   void* stream) {
  const int grid = (B + block - 1) / block;
  tridiag_kernel<T, S><<<grid, block, 0, (cudaStream_t)stream>>>(
      (const T*)D, (const T*)U, (const T*)r, (T*)x, (T*)Sinv_ws, (T*)y_ws, N, B);
  return (int)cudaGetLastError();
}

}  // namespace dem

// C interface: returns cudaGetLastError() of the launch, or -1 for a state
// size this library does not instantiate.
extern "C" int dem_tridiag_solve(int is_double, int S, const void* D,
                                 const void* U, const void* r, void* x,
                                 void* Sinv_ws, void* y_ws, int N, int B,
                                 int block, void* stream) {
  if (S != DEM_TRIDIAG_S) return -1;
  if (is_double)
    return dem::tridiag_launch<double, DEM_TRIDIAG_S>(D, U, r, x, Sinv_ws, y_ws, N, B,
                                                      block, stream);
  return dem::tridiag_launch<float, DEM_TRIDIAG_S>(D, U, r, x, Sinv_ws, y_ws, N, B,
                                                   block, stream);
}
