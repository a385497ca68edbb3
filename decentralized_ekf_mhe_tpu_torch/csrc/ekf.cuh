// The orientation-EKF stage (K1): the body that csrc/ekf.cu launches, on a
// group of 4 threads per instance, with the instance's history ring and its
// share of the input stream in shared memory.
//
// Per valid substep: push (gyro, accel, q, P) into the history ring at slot
// t % R, run the delayed-VO rewind + replay when the shared camera clock says
// so, gyro-predict, accel-correct with the (|a|/g)^2-scaled covariance; after
// each MHE tick's substeps the fused quaternion goes to q_seq. Same arithmetic
// as ops/ekf_lanes.py: every entry of every product is the chain
// acc = a0 * b0; acc += a_k * b_k over k = 0, 1, ... of smallmat.cuh's matmul,
// matmul_nt and matvec, in the same order.
//
// Where the time went on one thread per instance (this kernel's first design,
// 11.4 ms at T=2000, B=1024, float32 on an H100, about 1.9 us per filter
// step, PERF.md §6): each step's 4 x 4
// algebra was one thread's chain, and the chain waited on global memory at
// the head of every substep (the schedule, then gyro and accel), while the
// history ring lived in global memory and a rewind read it back inside the
// chain. What this body does about it:
//  - the ring, R slots of 3 + 3 + 4 + 16 scalars, sits in shared memory for
//    the whole launch: read once from the carried-in state at entry, written
//    once to the output state at exit. Push, rewind and replay touch shared
//    memory only;
//  - the input stream is staged chunk by chunk (whole ticks, as many as the
//    caller names: kernels/_group.py's EKF_CHUNK) into shared memory with
//    asynchronous copies (cp.async), double buffered: chunk k + 1 is in
//    flight while chunk k's substeps run. The shared schedule (valid,
//    vo_active, vo_steps_back) and the shared VO quaternion come with each
//    chunk, so no global load stays in the chain. A rewind reads ring slots
//    only, never the stream, so chunk edges and replays do not interact;
//  - a group of 4 lanes runs each instance: lane l owns row l of P and of
//    every 4-row product, row l of H P H^T (lane 3 has none), and the entries
//    l, l + 4, ... of every quotient: entry l of each normalize4 (every lane
//    takes the square root, each divides its own entry of q) and of the
//    3 x 3 inverse (every lane the cofactors, each its own entries of
//    cofactor / det). The group gathers what it shares with __shfl_sync: P
//    twice per filter step, q four times, H P H^T + rel2 C_accel and its
//    inverse once. F, W, H, R(q) and the 4 x 4 Gauss-Jordan of the rare VO
//    correction are computed alike in every lane.
//    Why the quotients: an IEEE division (and square root) is a fast path
//    with a branch to its slow path, so nvcc issues the 21 divisions of a
//    filter step one after another; replicated in every lane they were
//    about 45 % of the step (a build with approximate division and square
//    root, PERF.md §6). Each lane now issues 7 divisions and 3 roots.
//    4 lanes per instance and one warp (8 instances) per block were the
//    fastest of the designs measured (1, 2 or 4 lanes; 8 to 32 instances
//    per block; PERF.md §6).
// The camera clock is shared, so every instance of a block takes the same
// branches; an instance past B (the ragged edge) shadows instance B - 1 and
// stores nothing.
#pragma once

#include "smallmat.cuh"

#define DEM_EKF_HHD __host__ __device__ __forceinline__

namespace dem {

constexpr int EKF_G = 4;   // threads per instance: lane l owns row l

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
  const T* q_in;        // (4,B)      the carried-in state
  const T* P_in;        // (4,4,B)
  const T* gh_in;       // (R,3,B)
  const T* ah_in;       // (R,3,B)
  const T* qh_in;       // (R,4,B)
  const T* Ph_in;       // (R,4,4,B)
  T* q_out;             // the state carried out, same shapes
  T* P_out;
  T* gh_out;
  T* ah_out;
  T* qh_out;
  T* Ph_out;
  T* q_seq;             // (Tn,4,B)
};

// The sizes of one launch and the layout of a block's dynamic shared memory,
// in scalars of T from its start (kernels/_group.py's ekf_geometry computes
// the same bytes):
//   ipb instances, each `stride` scalars: the ring gh (R,3), ah (R,3),
//     qh (R,4), Ph (R,16), padded to 4 mod 32 four-byte words, so that the
//     8 instances of a warp start in different banks;
//   two stream buffers of rows x ipb: gyro (CS,3), accel (CS,3) and, with
//     a VO quaternion per lane, vo_q (CS,4), instance-minor;
//   two buffers of the shared VO quaternion (CS,4);
//   then, as ints, two buffers of the schedule: valid, vo_active, vo_sb (CS
//     each).
// CS = CT * S substeps per chunk of CT ticks.
struct EkfDims {
  int Tn, S, R, B, t0, pl, ipb, CT, CS, stride;

  DEM_EKF_HHD static int stride_of(int R, int item) {
    const int words = 26 * R * item / 4;
    return (words + (32 + EKF_G - words % 32) % 32) * 4 / item;
  }
  DEM_EKF_HHD int rows() const { return CS * (6 + 4 * pl); }
  DEM_EKF_HHD int stream() const { return ipb * stride; }            // offset of buffer 0
  DEM_EKF_HHD int voq() const { return stream() + 2 * rows() * ipb; }
  DEM_EKF_HHD int scalars() const { return voq() + 2 * CS * 4; }
  DEM_EKF_HHD size_t bytes(int item) const {
    return (size_t)scalars() * item + (size_t)2 * 3 * CS * sizeof(int);
  }
};

DEM_EKF_HHD EkfDims ekf_dims(int Tn, int S, int R, int B, int t0, int pl, int ipb, int item,
                             int CT) {
  EkfDims d;
  d.Tn = Tn; d.S = S; d.R = R; d.B = B; d.t0 = t0; d.pl = pl; d.ipb = ipb;
  d.CT = CT;
  d.CS = CT * S;
  d.stride = EkfDims::stride_of(R, item);
  return d;
}

extern __shared__ __align__(16) unsigned char dem_ekf_smem[];

// ---- asynchronous copy global -> shared of one element (cp.async; on the
// host a plain copy), a commit of the copies issued so far, and a wait until
// at most N committed groups are in flight
template <typename T>
DEM_HD void ekf_copy(T* dst, const T* src) {
#ifdef __CUDA_ARCH__
  static_assert(sizeof(T) == 4 || sizeof(T) == 8, "cp.async of 4 or 8 bytes");
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  if constexpr (sizeof(T) == 4)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d), "l"(src) : "memory");
#else
  *dst = *src;
#endif
}
DEM_HD void ekf_copy_commit() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.commit_group;\n" ::: "memory");
#endif
}
template <int N>
DEM_HD void ekf_copy_wait() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
#endif
}

// ---- small helpers of the group

// entry r (runtime, < N) of a register array: selects, no local memory
template <int N, typename T>
DEM_HD T pick(const T* v, int r) {
  T x = v[0];
  DEM_UNROLL
  for (int i = 1; i < N; ++i) x = r == i ? v[i] : x;
  return x;
}
// row r (runtime, < NR) of an NR x C register matrix
template <int NR, int C, typename T>
DEM_HD void pick_row(const T* M, int r, T* out) {
  DEM_UNROLL
  for (int j = 0; j < C; ++j) {
    T x = M[j];
    DEM_UNROLL
    for (int i = 1; i < NR; ++i) x = r == i ? M[i * C + j] : x;
    out[j] = x;
  }
}

// One instance's group: its lane (the row it owns), the first lane of the
// group in the warp, its ring in shared memory. Every instance of a block
// takes the same branches (the camera clock is shared, the ragged edge
// shadows), so every shuffle is a whole warp's (blocks are whole warps).
template <typename T>
struct EkfGroup {
  static constexpr unsigned WARP = 0xffffffffu;
  int ln, base;
  T* gh;
  T* ah;
  T* qh;
  T* Ph;
  // orders the lanes' ring pushes against the group's rewind reads
  DEM_HD void sync() const { __syncwarp(WARP); }
};

// all[e] for e < N from the lanes that own them (own[k] is entry ln + 4 k)
template <int N, typename T>
DEM_HD void ekf_gather(const EkfGroup<T>& g, const T* own, T* all) {
  DEM_UNROLL
  for (int e = 0; e < N; ++e)
    all[e] = __shfl_sync(g.WARP, own[e / EKF_G], g.base + e % EKF_G, 32);
}

// all of P from the lanes' rows
template <typename T>
DEM_HD void ekf_gather_P(const EkfGroup<T>& g, const T* Pr, T* Pf) {
  DEM_UNROLL
  for (int k = 0; k < 4; ++k)
    DEM_UNROLL
    for (int j = 0; j < 4; ++j) Pf[k * 4 + j] = __shfl_sync(g.WARP, Pr[j], g.base + k, 32);
}

// normalize4 on the group: n = sqrt(q0 q0 + q1 q1 + q2 q2 + q3 q3) in every
// lane, each lane divides its own entry, the group gathers them
template <typename T>
DEM_HD void ekf_normalize(const EkfGroup<T>& g, T* q) {
  const T n = sqrt(q[0] * q[0] + q[1] * q[1] + q[2] * q[2] + q[3] * q[3]);
  const T own = pick<4>(q, g.ln) / n;
  ekf_gather<4, T>(g, &own, q);
}

// q+ = norm((I + dt/2 Omega) q), P+ = F P F^T + W C_gyro W^T: every lane
// computes its row of P, and its entry of q+
template <typename T>
DEM_HD void ekf_predict_group(const EkfGroup<T>& g, T* q, T* Pr, T* Pf, const T* gyro,
                              const EkfConsts<T>& c) {
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
  const int r = g.ln;
  T Fr[4], Wr[3], FP[4], WC[3];
  pick_row<4, 4>(F, r, Fr);
  pick_row<4, 3>(W, r, Wr);
  DEM_UNROLL
  for (int j = 0; j < 4; ++j) {          // matmul<4,4,4>(F, P)
    T acc = Fr[0] * Pf[j];
    DEM_UNROLL
    for (int m = 1; m < 4; ++m) acc += Fr[m] * Pf[m * 4 + j];
    FP[j] = acc;
  }
  DEM_UNROLL
  for (int j = 0; j < 3; ++j) {          // matmul<4,3,3>(W, C_gyro)
    T acc = Wr[0] * c.C_gyro[j];
    DEM_UNROLL
    for (int m = 1; m < 3; ++m) acc += Wr[m] * c.C_gyro[m * 3 + j];
    WC[j] = acc;
  }
  DEM_UNROLL
  for (int j = 0; j < 4; ++j) {          // matmul_nt<4,4,4>(FP, F) + matmul_nt<4,3,4>(WC, W)
    T a = FP[0] * F[j * 4];
    DEM_UNROLL
    for (int m = 1; m < 4; ++m) a += FP[m] * F[j * 4 + m];
    T b = WC[0] * W[j * 3];
    DEM_UNROLL
    for (int m = 1; m < 3; ++m) b += WC[m] * W[j * 3 + m];
    Pr[j] = a + b;
  }
  T qn[4];
  matvec<4, 4>(F, q, qn);
  ekf_normalize<T>(g, qn);
  DEM_UNROLL
  for (int i = 0; i < 4; ++i) q[i] = qn[i];
  ekf_gather_P<T>(g, Pr, Pf);
}

// the cofactors and determinant of inv3 (smallmat.cuh): Inv[e] = cof[e] / det
template <typename T>
DEM_HD T inv3_cof(const T* A, T* cof) {
  const T a = A[0], b = A[1], c = A[2], d = A[3], e = A[4], f = A[5],
          g = A[6], h = A[7], i = A[8];
  cof[0] = e * i - f * h; cof[1] = c * h - b * i; cof[2] = b * f - c * e;
  cof[3] = f * g - d * i; cof[4] = a * i - c * g; cof[5] = c * d - a * f;
  cof[6] = d * h - e * g; cof[7] = b * g - a * h; cof[8] = a * e - b * d;
  return a * cof[0] + b * cof[3] + c * cof[6];
}

template <typename T>
DEM_HD void ekf_accel_correct_group(const EkfGroup<T>& g, T* q, T* Pr, T* Pf, const T* accel,
                                    const EkfConsts<T>& c) {
  // rotation of the normalized quaternion
  T qn[4] = {q[0], q[1], q[2], q[3]};
  ekf_normalize<T>(g, qn);
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
  // the innovation covariance H P H^T + rel2 C_accel: row a on lane a
  T Sr[3] = {};
  const int r = g.ln;
  if (r < 3) {
    T Ha[4], HP[4], Ca[3];
    pick_row<3, 4>(H, r, Ha);
    pick_row<3, 3>(c.C_accel, r, Ca);
    DEM_UNROLL
    for (int j = 0; j < 4; ++j) {        // matmul<3,4,4>(H, P)
      T acc = Ha[0] * Pf[j];
      DEM_UNROLL
      for (int m = 1; m < 4; ++m) acc += Ha[m] * Pf[m * 4 + j];
      HP[j] = acc;
    }
    DEM_UNROLL
    for (int bb = 0; bb < 3; ++bb) {     // matmul_nt<3,4,3>(HP, H), += rel2 C_accel
      T acc = HP[0] * H[bb * 4];
      DEM_UNROLL
      for (int m = 1; m < 4; ++m) acc += HP[m] * H[bb * 4 + m];
      Sr[bb] = acc;
      Sr[bb] += rel2 * Ca[bb];
    }
  }
  T Sm[9];
  DEM_UNROLL
  for (int a = 0; a < 3; ++a)
    DEM_UNROLL
    for (int bb = 0; bb < 3; ++bb) Sm[a * 3 + bb] = __shfl_sync(g.WARP, Sr[bb], g.base + a, 32);
  // inv3: every lane the cofactors, each its own entries of the quotient
  T cof[9], own[3] = {}, Sinv[9];
  const T det = inv3_cof(Sm, cof);
  DEM_UNROLL
  for (int k = 0; k < 3; ++k)
    if (r + k * EKF_G < 9) own[k] = pick<9>(cof, r + k * EKF_G) / det;
  ekf_gather<9, T>(g, own, Sinv);
  const T w = qn[0], x = qn[1], y = qn[2], z = qn[3];
  const T xx = x * x, yy = y * y, zz = z * z;
  const T xy = x * y, xz = x * z, yz = y * z;
  const T wx = w * x, wy = w * y, wz = w * z;
  const T Rm[9] = {T(1) - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
                   2 * (xy + wz), T(1) - 2 * (xx + zz), 2 * (yz - wx),
                   2 * (xz - wy), 2 * (yz + wx), T(1) - 2 * (xx + yy)};
  T accel_hat[3];
  matvec_t<3, 3>(Rm, c.gravity, accel_hat);
  const T innov[3] = {accel[0] - accel_hat[0], accel[1] - accel_hat[1],
                      accel[2] - accel_hat[2]};
  T PHt[3], K[3], IKH[4];
  DEM_UNROLL
  for (int bb = 0; bb < 3; ++bb) {       // matmul_nt<4,4,3>(P, H)
    T acc = Pr[0] * H[bb * 4];
    DEM_UNROLL
    for (int m = 1; m < 4; ++m) acc += Pr[m] * H[bb * 4 + m];
    PHt[bb] = acc;
  }
  DEM_UNROLL
  for (int j = 0; j < 3; ++j) {          // matmul<4,3,3>(PHt, Sinv)
    T acc = PHt[0] * Sinv[j];
    DEM_UNROLL
    for (int m = 1; m < 3; ++m) acc += PHt[m] * Sinv[m * 3 + j];
    K[j] = acc;
  }
  T dq = K[0] * innov[0];                // matvec<4,3>(K, innov)
  DEM_UNROLL
  for (int m = 1; m < 3; ++m) dq += K[m] * innov[m];
  T qr = pick<4>(q, r);
  qr += dq;
  DEM_UNROLL
  for (int j = 0; j < 4; ++j) {          // I - matmul<4,3,4>(K, H)
    T acc = K[0] * H[j];
    DEM_UNROLL
    for (int m = 1; m < 3; ++m) acc += K[m] * H[m * 4 + j];
    IKH[j] = (r == j ? T(1) : T(0)) - acc;
  }
  DEM_UNROLL
  for (int j = 0; j < 4; ++j) {          // matmul<4,4,4>(I - KH, P)
    T acc = IKH[0] * Pf[j];
    DEM_UNROLL
    for (int m = 1; m < 4; ++m) acc += IKH[m] * Pf[m * 4 + j];
    Pr[j] = acc;
  }
  ekf_gather<4, T>(g, &qr, q);
  ekf_normalize<T>(g, q);
  ekf_gather_P<T>(g, Pr, Pf);
}

// full-quaternion VO correction, H = I4
template <typename T>
DEM_HD void ekf_vo_correct_group(const EkfGroup<T>& g, T* q, T* Pr, T* Pf, const T* q_vo,
                                 const EkfConsts<T>& c) {
  T Sm[16], Sinv[16];
  DEM_UNROLL
  for (int i = 0; i < 16; ++i) Sm[i] = Pf[i] + c.C_vo[i];
  gj_inv<4>(Sm, Sinv);
  const T innov[4] = {q_vo[0] - q[0], q_vo[1] - q[1], q_vo[2] - q[2], q_vo[3] - q[3]};
  const int r = g.ln;
  T K[4], IK[4];
  DEM_UNROLL
  for (int j = 0; j < 4; ++j) {          // matmul<4,4,4>(P, Sinv)
    T acc = Pr[0] * Sinv[j];
    DEM_UNROLL
    for (int m = 1; m < 4; ++m) acc += Pr[m] * Sinv[m * 4 + j];
    K[j] = acc;
  }
  T dq = K[0] * innov[0];                // matvec<4,4>(K, innov)
  DEM_UNROLL
  for (int m = 1; m < 4; ++m) dq += K[m] * innov[m];
  T qr = pick<4>(q, r);
  qr += dq;
  DEM_UNROLL
  for (int j = 0; j < 4; ++j) IK[j] = (r == j ? T(1) : T(0)) - K[j];
  DEM_UNROLL
  for (int j = 0; j < 4; ++j) {          // matmul<4,4,4>(I - K, P)
    T acc = IK[0] * Pf[j];
    DEM_UNROLL
    for (int m = 1; m < 4; ++m) acc += IK[m] * Pf[m * 4 + j];
    Pr[j] = acc;
  }
  ekf_gather<4, T>(g, &qr, q);
  ekf_normalize<T>(g, q);
  ekf_gather_P<T>(g, Pr, Pf);
}

// Stage chunk `ch` (ticks ch*CT .. ch*CT + CT - 1, clipped at Tn) into buffer
// `buf`: every thread of the block issues its share of the copies.
template <typename T>
DEM_HD void ekf_stage_chunk(const EkfPtrs<T>& p, const EkfDims& d, T* sm, int* si, int ch,
                            int buf, int b0, int tid, int nthr) {
  const int i0 = ch * d.CT;
  const int nsub = (d.Tn - i0 < d.CT ? d.Tn - i0 : d.CT) * d.S;
  const size_t u0 = (size_t)i0 * d.S;      // first substep of the chunk
  // the schedule and the shared VO quaternion
  int* sched = si + buf * 3 * d.CS;
  for (int e = tid; e < 3 * nsub; e += nthr) {
    const int which = e / nsub, u = e - which * nsub;
    const int* src = which == 0 ? p.valid : which == 1 ? p.vo_active : p.vo_sb;
    ekf_copy(sched + which * d.CS + u, src + u0 + u);
  }
  if (!d.pl) {
    T* voq = sm + d.voq() + buf * d.CS * 4;
    for (int e = tid; e < 4 * nsub; e += nthr) ekf_copy(voq + e, p.vo_q + u0 * 4 + e);
  }
  // the stream, instance-minor: thread tid copies instance tid % ipb of every
  // (nthr / ipb)-th row
  T* sp = sm + d.stream() + buf * d.rows() * d.ipb;
  const int k = tid % d.ipb, step = nthr / d.ipb;
  const int bb = b0 + k < d.B ? b0 + k : d.B - 1;
  for (int r = tid / d.ipb; r < 3 * nsub; r += step) {
    ekf_copy(sp + r * d.ipb + k, p.gyro + (u0 * 3 + r) * d.B + bb);
    ekf_copy(sp + (3 * d.CS + r) * d.ipb + k, p.accel + (u0 * 3 + r) * d.B + bb);
  }
  if (d.pl)
    for (int r = tid / d.ipb; r < 4 * nsub; r += step)
      ekf_copy(sp + (6 * d.CS + r) * d.ipb + k, p.vo_q + (u0 * 4 + r) * d.B + bb);
  ekf_copy_commit();
}

// the ring between global memory (instance-minor) and each instance's shared
// memory: n scalars per instance at offset off; `in` loads, else stores the
// instances below B
template <typename T>
DEM_HD void ekf_ring_io(bool in, T* sm, const EkfDims& d, const T* src, T* dst, int n, int off,
                        int b0, int tid, int nthr) {
  for (int e = tid; e < n * d.ipb; e += nthr) {
    const int r = e / d.ipb, k = e - r * d.ipb;
    T* s = sm + k * d.stride + off + r;
    if (in) *s = src[(size_t)r * d.B + (b0 + k < d.B ? b0 + k : d.B - 1)];
    else if (b0 + k < d.B) dst[(size_t)r * d.B + b0 + k] = *s;
  }
}

// The whole stage for block `blk`, thread `tid` of its 4 * ipb.
template <typename T>
DEM_HD void ekf_group_body(const EkfPtrs<T>& p, const EkfConsts<T>& c, const EkfDims& d,
                           int blk, int tid) {
  const int nthr = EKF_G * d.ipb, R = d.R, B = d.B;
  const int inst = tid / EKF_G, b0 = blk * d.ipb, b = b0 + inst;
  const bool live = b < B;
  const int bl = live ? b : B - 1;         // the ragged edge shadows instance B - 1
  T* sm = reinterpret_cast<T*>(dem_ekf_smem);
  int* si = reinterpret_cast<int*>(sm + d.scalars());
  T* me = sm + inst * d.stride;
  EkfGroup<T> g;
  g.ln = tid % EKF_G;
  g.base = tid % 32 / EKF_G * EKF_G;
  g.gh = me; g.ah = me + 3 * R; g.qh = me + 6 * R; g.Ph = me + 10 * R;
  const int r = g.ln;

  const int nch = (d.Tn + d.CT - 1) / d.CT;
  if (nch > 0) ekf_stage_chunk(p, d, sm, si, 0, 0, b0, tid, nthr);
  ekf_ring_io(true, sm, d, p.gh_in, (T*)nullptr, 3 * R, 0, b0, tid, nthr);
  ekf_ring_io(true, sm, d, p.ah_in, (T*)nullptr, 3 * R, 3 * R, b0, tid, nthr);
  ekf_ring_io(true, sm, d, p.qh_in, (T*)nullptr, 4 * R, 6 * R, b0, tid, nthr);
  ekf_ring_io(true, sm, d, p.Ph_in, (T*)nullptr, 16 * R, 10 * R, b0, tid, nthr);
  T q[4], Pf[16], Pr[4];
  load<4>(q, p.q_in, 0, B, bl);
  load<16>(Pf, p.P_in, 0, B, bl);
  DEM_UNROLL
  for (int j = 0; j < 4; ++j) Pr[j] = ld(p.P_in, (size_t)r * 4 + j, B, bl);
  int t = d.t0;           // counts VALID substeps
  int slot = d.t0 % R;    // the ring slot, t % R

  for (int ch = 0; ch < nch; ++ch) {
    const int cur = ch & 1;
    if (ch + 1 < nch) {
      ekf_stage_chunk(p, d, sm, si, ch + 1, cur ^ 1, b0, tid, nthr);
      ekf_copy_wait<1>();
    } else {
      ekf_copy_wait<0>();
    }
    __syncthreads();
    const int* valid = si + cur * 3 * d.CS;
    const int* act = valid + d.CS;
    const int* sbs = act + d.CS;
    const T* sp = sm + d.stream() + cur * d.rows() * d.ipb + inst;
    const T* voq = sm + d.voq() + cur * d.CS * 4;
    const int i0 = ch * d.CT, i1 = i0 + d.CT < d.Tn ? i0 + d.CT : d.Tn;
    for (int i = i0; i < i1; ++i) {
      for (int j = 0; j < d.S; ++j) {
        const int u = (i - i0) * d.S + j;
        if (valid[u] == 0) continue;
        T gyro[3], accel[3];
        DEM_UNROLL
        for (int e = 0; e < 3; ++e) {
          gyro[e] = sp[(u * 3 + e) * d.ipb];
          accel[e] = sp[(3 * d.CS + u * 3 + e) * d.ipb];
        }
        // push happens before the VO check: each lane its row
        DEM_UNROLL
        for (int e = 0; e < 4; ++e) g.Ph[slot * 16 + r * 4 + e] = Pr[e];
        g.qh[slot * 4 + r] = pick<4>(q, r);
        if (r < 3) {
          g.gh[slot * 3 + r] = pick<3>(gyro, r);
          g.ah[slot * 3 + r] = pick<3>(accel, r);
        }
        const int sb = sbs[u];
        if (act[u] != 0 && sb >= 1 && sb <= t && sb < R) {
          // delayed-VO rewind + replay: sb == 1 rewinds to the state pushed
          // one substep ago and replays nothing, hence applies no VO
          // correction. The rewind never reads the slot just pushed; it reads
          // rows other lanes pushed, and the next push may overwrite them
          g.sync();
          T q_vo[4];
          DEM_UNROLL
          for (int e = 0; e < 4; ++e)
            q_vo[e] = d.pl ? sp[(6 * d.CS + u * 4 + e) * d.ipb] : voq[u * 4 + e];
          const int sync = slot >= sb ? slot - sb : slot - sb + R;   // (t - sb) % R
          DEM_UNROLL
          for (int e = 0; e < 4; ++e) q[e] = g.qh[sync * 4 + e];
          DEM_UNROLL
          for (int e = 0; e < 16; ++e) Pf[e] = g.Ph[sync * 16 + e];
          DEM_UNROLL
          for (int e = 0; e < 4; ++e) Pr[e] = g.Ph[sync * 16 + r * 4 + e];
          for (int k = 0, sl = sync; k < sb - 1; ++k, sl = sl + 1 == R ? 0 : sl + 1) {
            T g_k[3], a_k[3];
            DEM_UNROLL
            for (int e = 0; e < 3; ++e) { g_k[e] = g.gh[sl * 3 + e]; a_k[e] = g.ah[sl * 3 + e]; }
            ekf_predict_group<T>(g, q, Pr, Pf, g_k, c);
            ekf_accel_correct_group<T>(g, q, Pr, Pf, a_k, c);
            if (k == 0) ekf_vo_correct_group<T>(g, q, Pr, Pf, q_vo, c);
          }
          g.sync();
        }
        ekf_predict_group<T>(g, q, Pr, Pf, gyro, c);
        ekf_accel_correct_group<T>(g, q, Pr, Pf, accel, c);
        t += 1;
        slot = slot + 1 == R ? 0 : slot + 1;
      }
      if (live) st(p.q_seq, (size_t)i * 4 + r, B, b, pick<4>(q, r));
    }
    __syncthreads();   // this buffer is free for chunk ch + 2
  }
  if (live) {
    st(p.q_out, (size_t)r, B, b, pick<4>(q, r));
    DEM_UNROLL
    for (int j = 0; j < 4; ++j) st(p.P_out, (size_t)r * 4 + j, B, b, Pr[j]);
  }
  __syncthreads();
  ekf_ring_io(false, sm, d, (const T*)nullptr, p.gh_out, 3 * R, 0, b0, tid, nthr);
  ekf_ring_io(false, sm, d, (const T*)nullptr, p.ah_out, 3 * R, 3 * R, b0, tid, nthr);
  ekf_ring_io(false, sm, d, (const T*)nullptr, p.qh_out, 4 * R, 6 * R, b0, tid, nthr);
  ekf_ring_io(false, sm, d, (const T*)nullptr, p.Ph_out, 16 * R, 10 * R, b0, tid, nthr);
}

}  // namespace dem
