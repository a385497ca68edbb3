// ekf_stage — the whole 500 Hz orientation-EKF stage, one thread per instance.
//
// Replaces the TPU kernel pallas/ekf_kernel.py::_make_kernel (reached through
// replay -> _chunk_call). Per valid substep: push (gyro, accel, q, P) into the
// history ring at slot t % R, run the delayed-VO rewind + replay when the
// shared camera clock says so, gyro-predict, accel-correct with the
// (|a|/g)^2-scaled covariance; after each MHE tick's substeps the fused
// quaternion is written to q_seq. Same arithmetic as ops/ekf_lanes.py.
//
// Where the state lives: q (4) and P (4x4) stay in registers for the whole
// log; the history rings (R slots of 3+3+4+16 scalars) stay in global memory
// in the instance-minor layout and are addressed by the dynamic slot, which
// is the same for every thread (shared clock), so ring traffic is coalesced.
// The shared metadata (valid, vo_active, vo_steps_back) is read by every
// thread from the same address — a broadcast. Time is a loop inside the
// kernel: one launch covers all the ticks handed to it, and the state is
// updated in place so a log split over two launches equals one launch.
//
// Bound on this card: operations (about 1k floating-point operations per
// substep, kernels/_work.py, against 6 streamed inputs; the ring traffic stays
// in cache), but at B = 1024 it is the serial chain of one instance over 32
// warps that sets the time.
#include "smallmat.cuh"

namespace dem {

template <typename T>
struct EkfConsts {
  T dt;
  T C_gyro[9];
  T C_accel[9];
  T C_vo[16];
  T gravity[3];
  T g2;        // GRAVITY^2 of the covariance scaling
  int quirk_W;
};

template <typename T>
struct EkfPtrs {
  const T* gyro;        // (Tn,S,3,B)
  const T* accel;       // (Tn,S,3,B)
  const int* valid;     // (Tn,S)
  const int* vo_active; // (Tn,S)
  const int* vo_sb;     // (Tn,S)
  const T* vo_q;        // (Tn,S,4) shared or (Tn,S,4,B) per lane
  T* q;                 // (4,B)     in/out
  T* P;                 // (4,4,B)   in/out
  T* gh;                // (R,3,B)   in/out
  T* ah;                // (R,3,B)   in/out
  T* qh;                // (R,4,B)   in/out
  T* Ph;                // (R,4,4,B) in/out
  T* q_seq;             // (Tn,4,B)  out
};

template <typename T>
DEM_HD void normalize4(T* q) {
  const T n = sqrt(q[0] * q[0] + q[1] * q[1] + q[2] * q[2] + q[3] * q[3]);
  q[0] /= n; q[1] /= n; q[2] /= n; q[3] /= n;
}

// q+ = norm((I + dt/2 Omega) q), P+ = F P F^T + W C_gyro W^T
template <typename T>
DEM_HD void ekf_predict(T* q, T* P, const T* gyro, const EkfConsts<T>& c) {
  const T h = c.dt / T(2);
  const T wx = h * gyro[0], wy = h * gyro[1], wz = h * gyro[2];
  const T F[16] = {T(1), -wx, -wy, -wz,
                   wx, T(1), wz, -wy,
                   wy, -wz, T(1), wx,
                   wz, wy, -wx, T(1)};
  const T w = q[0], x = q[1], y = q[2], z = q[3];
  const T k = T(0.5) * c.dt;
  T W[12];
  if (c.quirk_W) {
    const T Wq[12] = {-x, -y, -z, w, -z, y, z, x, w, -y, T(0), T(0)};
    DEM_UNROLL
    for (int i = 0; i < 12; ++i) W[i] = k * Wq[i];
  } else {
    const T Wt[12] = {-x, -y, -z, w, -z, y, z, w, -x, -y, x, w};
    DEM_UNROLL
    for (int i = 0; i < 12; ++i) W[i] = k * Wt[i];
  }
  T qn[4];
  matvec<4, 4>(F, q, qn);
  normalize4(qn);
  T FP[16], FPF[16], WC[12], WCW[16];
  matmul<4, 4, 4>(F, P, FP);
  matmul_nt<4, 4, 4>(FP, F, FPF);
  matmul<4, 3, 3>(W, c.C_gyro, WC);
  matmul_nt<4, 3, 4>(WC, W, WCW);
  DEM_UNROLL
  for (int i = 0; i < 16; ++i) P[i] = FPF[i] + WCW[i];
  DEM_UNROLL
  for (int i = 0; i < 4; ++i) q[i] = qn[i];
}

template <typename T>
DEM_HD void ekf_accel_correct(T* q, T* P, const T* accel, const EkfConsts<T>& c) {
  // rotation of the normalized quaternion
  T qn[4] = {q[0], q[1], q[2], q[3]};
  normalize4(qn);
  const T w = qn[0], x = qn[1], y = qn[2], z = qn[3];
  const T xx = x * x, yy = y * y, zz = z * z;
  const T xy = x * y, xz = x * z, yz = y * z;
  const T wx = w * x, wy = w * y, wz = w * z;
  const T Rm[9] = {T(1) - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
                   2 * (xy + wz), T(1) - 2 * (xx + zz), 2 * (yz - wx),
                   2 * (xz - wy), 2 * (yz + wx), T(1) - 2 * (xx + yy)};
  T accel_hat[3];
  matvec_t<3, 3>(Rm, c.gravity, accel_hat);
  // Jacobian of R(q)^T g at the un-normalized q
  const T qw = q[0], qx = q[1], qy = q[2], qz = q[3];
  const T gx = c.gravity[0], gy = c.gravity[1], gz = c.gravity[2];
  const T H[12] = {
      2 * (gx * qw + gy * qz - gz * qy), 2 * (gx * qx + gy * qy + gz * qz),
      2 * (-gx * qy + gy * qx - gz * qw), 2 * (-gx * qz + gy * qw + gz * qx),
      2 * (-gx * qz + gy * qw + gz * qx), 2 * (gx * qy - gy * qx + gz * qw),
      2 * (gx * qx + gy * qy + gz * qz), 2 * (-gx * qw - gy * qz + gz * qy),
      2 * (gx * qy - gy * qx + gz * qw), 2 * (gx * qz - gy * qw - gz * qx),
      2 * (gx * qw + gy * qz - gz * qy), 2 * (gx * qx + gy * qy + gz * qz)};
  const T rel2 = (accel[0] * accel[0] + accel[1] * accel[1] + accel[2] * accel[2]) / c.g2;
  T HP[12], Sm[9], Sinv[9], PHt[12], K[12];
  matmul<3, 4, 4>(H, P, HP);
  matmul_nt<3, 4, 3>(HP, H, Sm);
  DEM_UNROLL
  for (int i = 0; i < 9; ++i) Sm[i] += rel2 * c.C_accel[i];
  inv3(Sm, Sinv);
  matmul_nt<4, 4, 3>(P, H, PHt);
  matmul<4, 3, 3>(PHt, Sinv, K);
  T innov[3] = {accel[0] - accel_hat[0], accel[1] - accel_hat[1], accel[2] - accel_hat[2]};
  T dq[4];
  matvec<4, 3>(K, innov, dq);
  DEM_UNROLL
  for (int i = 0; i < 4; ++i) q[i] += dq[i];
  normalize4(q);
  T KH[16], Pn[16];
  matmul<4, 3, 4>(K, H, KH);
  DEM_UNROLL
  for (int i = 0; i < 16; ++i) KH[i] = ((i % 5 == 0) ? T(1) : T(0)) - KH[i];
  matmul<4, 4, 4>(KH, P, Pn);
  DEM_UNROLL
  for (int i = 0; i < 16; ++i) P[i] = Pn[i];
}

// full-quaternion VO correction, H = I4
template <typename T>
DEM_HD void ekf_vo_correct(T* q, T* P, const T* q_vo, const EkfConsts<T>& c) {
  T Sm[16], Sinv[16], K[16];
  DEM_UNROLL
  for (int i = 0; i < 16; ++i) Sm[i] = P[i] + c.C_vo[i];
  gj_inv<4>(Sm, Sinv);
  matmul<4, 4, 4>(P, Sinv, K);
  T innov[4] = {q_vo[0] - q[0], q_vo[1] - q[1], q_vo[2] - q[2], q_vo[3] - q[3]};
  T dq[4];
  matvec<4, 4>(K, innov, dq);
  DEM_UNROLL
  for (int i = 0; i < 4; ++i) q[i] += dq[i];
  normalize4(q);
  T IK[16], Pn[16];
  DEM_UNROLL
  for (int i = 0; i < 16; ++i) IK[i] = ((i % 5 == 0) ? T(1) : T(0)) - K[i];
  matmul<4, 4, 4>(IK, P, Pn);
  DEM_UNROLL
  for (int i = 0; i < 16; ++i) P[i] = Pn[i];
}

template <typename T>
DEM_HD void ekf_body(const EkfPtrs<T>& p, const EkfConsts<T>& c, int Tn, int S,
                     int R, int B, int t0, int per_lane_vo_q, int b) {
  T q[4], P[16];
  load<4>(q, p.q, 0, B, b);
  load<16>(P, p.P, 0, B, b);
  int t = t0;  // counts VALID substeps; the ring slot is t % R

  for (int i = 0; i < Tn; ++i) {
    for (int j = 0; j < S; ++j) {
      const int ij = i * S + j;
      if (p.valid[ij] == 0) continue;
      const int slot = t % R;
      T gyro[3], accel[3];
      load<3>(gyro, p.gyro, (size_t)ij * 3, B, b);
      load<3>(accel, p.accel, (size_t)ij * 3, B, b);
      // push happens before the VO check
      store<3>(p.gh, (size_t)slot * 3, B, b, gyro);
      store<3>(p.ah, (size_t)slot * 3, B, b, accel);
      store<4>(p.qh, (size_t)slot * 4, B, b, q);
      store<16>(p.Ph, (size_t)slot * 16, B, b, P);

      const int sb = p.vo_sb[ij];
      if (p.vo_active[ij] != 0 && sb >= 1 && sb <= t && sb < R) {
        // delayed-VO rewind + replay: sb == 1 rewinds to the state just
        // pushed and replays nothing, hence applies no VO correction
        T q_vo[4];
        if (per_lane_vo_q) {
          load<4>(q_vo, p.vo_q, (size_t)ij * 4, B, b);
        } else {
          DEM_UNROLL
          for (int k = 0; k < 4; ++k) q_vo[k] = p.vo_q[(size_t)ij * 4 + k];
        }
        const int sync = (t - sb) % R;
        load<4>(q, p.qh, (size_t)sync * 4, B, b);
        load<16>(P, p.Ph, (size_t)sync * 16, B, b);
        for (int k = 0; k < sb - 1; ++k) {
          const int sl = (sync + k) % R;
          T g_k[3], a_k[3];
          load<3>(g_k, p.gh, (size_t)sl * 3, B, b);
          load<3>(a_k, p.ah, (size_t)sl * 3, B, b);
          ekf_predict(q, P, g_k, c);
          ekf_accel_correct(q, P, a_k, c);
          if (k == 0) ekf_vo_correct(q, P, q_vo, c);
        }
      }
      ekf_predict(q, P, gyro, c);
      ekf_accel_correct(q, P, accel, c);
      t += 1;
    }
    store<4>(p.q_seq, (size_t)i * 4, B, b, q);
  }
  store<4>(p.q, 0, B, b, q);
  store<16>(p.P, 0, B, b, P);
}

template <typename T>
__global__ void ekf_kernel(EkfPtrs<T> p, EkfConsts<T> c, int Tn, int S, int R,
                           int B, int t0, int per_lane_vo_q) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  ekf_body<T>(p, c, Tn, S, R, B, t0, per_lane_vo_q, b);
}

// ptrs: the 13 pointers of EkfPtrs in declaration order.
// consts (double): dt, C_gyro[9], C_accel[9], C_vo[16], gravity[3], g2.
template <typename T>
int ekf_launch(void* const* ptrs, const double* consts, int quirk_W, int Tn,
               int S, int R, int B, int t0, int per_lane_vo_q, int block,
               void* stream) {
  EkfPtrs<T> p;
  p.gyro = (const T*)ptrs[0];
  p.accel = (const T*)ptrs[1];
  p.valid = (const int*)ptrs[2];
  p.vo_active = (const int*)ptrs[3];
  p.vo_sb = (const int*)ptrs[4];
  p.vo_q = (const T*)ptrs[5];
  p.q = (T*)ptrs[6];
  p.P = (T*)ptrs[7];
  p.gh = (T*)ptrs[8];
  p.ah = (T*)ptrs[9];
  p.qh = (T*)ptrs[10];
  p.Ph = (T*)ptrs[11];
  p.q_seq = (T*)ptrs[12];
  EkfConsts<T> c;
  int k = 0;
  c.dt = (T)consts[k++];
  for (int i = 0; i < 9; ++i) c.C_gyro[i] = (T)consts[k++];
  for (int i = 0; i < 9; ++i) c.C_accel[i] = (T)consts[k++];
  for (int i = 0; i < 16; ++i) c.C_vo[i] = (T)consts[k++];
  for (int i = 0; i < 3; ++i) c.gravity[i] = (T)consts[k++];
  c.g2 = (T)consts[k++];
  c.quirk_W = quirk_W;
  const int grid = (B + block - 1) / block;
  ekf_kernel<T><<<grid, block, 0, (cudaStream_t)stream>>>(p, c, Tn, S, R, B, t0,
                                                          per_lane_vo_q);
  return (int)cudaGetLastError();
}

}  // namespace dem

extern "C" int dem_ekf_stage(int is_double, void* const* ptrs,
                             const double* consts, int quirk_W, int Tn, int S,
                             int R, int B, int t0, int per_lane_vo_q, int block,
                             void* stream) {
  if (is_double)
    return dem::ekf_launch<double>(ptrs, consts, quirk_W, Tn, S, R, B, t0,
                                   per_lane_vo_q, block, stream);
  return dem::ekf_launch<float>(ptrs, consts, quirk_W, Tn, S, R, B, t0,
                                per_lane_vo_q, block, stream);
}
