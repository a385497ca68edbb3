// mhe_tick — the whole MHE replay loop, one thread per instance (the
// constrained tick's prelude; the unconstrained tick runs a group, see
// below): the kernel bodies, included by csrc/mhe.cu, which compiles each
// instantiation in a translation unit of its own (see there). The model shape
// (s, m, L and the leg-odometry form LOT) is a template parameter: Go1 (9, 12,
// 4, 0), Cassie (15, 6, 2, 1: foot positions as states), PogoX (9, 3, 1, 0)
// and Go1 with its foot positions as states (21, 12, 4, 1).
//
// Replaces the TPU kernel pallas/mhe_replay_kernel.py::_make_kernel (reached
// through replay -> _replay_chunk), with the shared camera clock or a clock per
// lane, unconstrained or box-constrained, and with its Gauss-Jordan tail or,
// unconstrained, its Cholesky tail; and its stage ablation (timing only). One loop
// step is one estimator tick:
//   VO ingestion + Bezier carry -> arrival-cost marginalization (t >= N) ->
//   ring shift by base index + assembly of the two changed slots ->
//   incremental Dslot/Ub/routb cache update -> masked normal equations with a
//   streaming forward block-Thomas sweep (no backward sweep: only the newest
//   state is consumed) -> x_{N-1} = S^{-1} y.
// Same arithmetic, in the same order, as ops/mhe_lanes.step.
//
// Where the state lives. The window state is 18 tensors, about 10.3k scalars
// per instance at N=20, s=9, m=12 (41 KB in float32; 42 MB for 1024
// instances; 20.0k scalars and 82 MB at Cassie's s=15) — far beyond
// registers or the 227 KB of shared memory a block may use. So ALL
// ring/window state stays in GLOBAL memory in the instance-minor layout
// (coalesced across the warp; at B=1024 in float32 Go1's fits the 50 MB L2,
// Cassie's does not), addressed by the dynamic physical slot
// (base + logical) % N, and is updated in place. Only the per-slot working
// set (a few s x s matrices; compile-time indices at s=9, while at s=15 the
// long loops stay rolled, smallmat.cuh) is thread-private.
// The cost: every tick re-reads ~5k scalars per instance from L2 and the
// s x s temporaries spill to local memory; occupancy is B/32 warps.
//
// The ring: base_old = (t-1) % N, base_new = t % N; logical slot l of the
// pre-shift window is physical (base_old + l) % N, of the post-shift window
// (base_new + l) % N. A state handed in with tick counter t0-1 must already
// be in that physical order (kernels/mhe_replay_kernel.py does the rolling).
//
// The Bezier schedule (4 waypoint times and the count). With the shared camera
// clock it is fleet-global: each thread keeps a private copy in registers for
// the whole loop and exactly one thread writes the final values to separate
// output buffers. With a camera clock per lane (template parameter PI; the TPU
// kernel with per_instance=True, mhe_replay_kernel.py:456-507) it is per
// lane, (4,B) times and (1,B) counts, loaded and stored by every thread, and
// the VO metadata are (Tn,B): the ingestion becomes a per-thread branch on the
// lane's own event, with the lane's own tick_pre/tick_now, and runs the same
// statements as the shared clock (so a uniform per-lane clock reproduces it
// bit for bit). Lanes without an event are untouched. window_start stays
// t - min(N, t). The one new cost is divergence: in a warp whose lanes follow
// different clocks, the lanes with an event ingest while the others wait.
//
// Bound on this card: operations (about 88k structurally needed floating-point
// operations per tick and instance, kernels/_work.py, against ~100 values that
// must be read), in practice the serial dependency chain. The dense loops here
// do not exploit the zero pattern of A_meas, P_cam, A_dyn and Q_dyn.
//
// The constrained variant (template parameter CON; the TPU kernel with
// admm_ks set, mhe_replay_kernel.py:660-666, 722-731, 787-800). With state box
// constraints the window solve is a box-ADMM, which needs the WHOLE masked
// system at once, not slot by slot. So the assembly loop writes D_j, U_j, r_j
// to per-launch scratch in global memory (same instance-minor layout; the
// wrapper allocates it) where the unconstrained variant runs its Thomas step,
// and the ADMM then works on that scratch. The warm-start iterates z, y are
// two more ring-indexed state tensors: the fresh slot copies the previous
// newest iterate before the solve, and the solve updates them through the
// ring. Per tick it also writes the iterations each instance ran.
// The constrained kernels run a group of group_size<S>() threads per instance
// (csrc/admm_group.cuh; 16 below s=16, two instances per warp, and a whole
// warp per instance from s=16): lane 0 of the group runs
// everything above with the statements of the one-thread tick, the other lanes
// wait at the group's __syncwarp, and then the whole group runs the window
// solve, admm_box_solve_group, with the factorization chain, the iterates and
// the forward-sweep vectors in shared memory (U_j too at s=9; Cassie reads it
// from the scratch, layout (a), which keeps 8 float32 instances per SM) and
// every lane writes its element of x. What bounds the one-thread solve on this
// card — a serial chain of s x s products re-reading its blocks from global
// memory on 32 of the 132 SMs at B=1024 — and what the group does about it:
// admm_group.cuh. The launch (mhe_launch) takes its threads per block in
// multiples of 16 and the shared memory of its instances as dynamic shared
// memory; a launch the card refuses returns its error. The unconstrained
// instantiations compile to what they were: every constrained statement sits
// behind `if constexpr (CON)` or a `lead` that is true without CON, every
// per-lane-clock statement behind `if constexpr (PI)`, and every statement of
// one leg-odometry form behind `if constexpr` on LOT.
//
// The unconstrained tick on a group (template parameter GRP; every
// unconstrained kernel sets it — mhe_kernel, mhe_pi_kernel, mhe_chol_kernel,
// mhe_pi_chol_kernel and the ablated mhe_abl_kernel, mhe_pi_abl_kernel and
// mhe_chol_abl_kernel: K2, K2b, K2d, K2d-PI and K2e at every shape; the
// one-thread body stays the host harness's reference of the group's). At
// s=15 one thread per instance spilled its
// per-slot working set (seven 15 x 15 matrices, 6.3 KB in float32) to local
// memory; at s=9 it ran on registers but as one serial chain of s x s products
// per instance; at either size on 32 of the 132 SMs at B=1024 (three quarters
// of Go1's tick the sweep's inverse chain, PERF.md §5). The group runs
// group_size<S>() threads per instance — 16 below s=16, two instances per
// warp; at s=21 a warp, one instance — lane r (< s) owns row r of
// every s x s block and element r of every vector, so a product is s dependent
// multiply-adds per lane on s lanes at once; a matrix or vector that a product
// reads whole goes through the instance's shared memory (TickLayout) between
// two __syncwarp of the group; the Gauss-Jordan inverses run row-parallel
// (admm_group.cuh's gj_inv_rows); lanes >= S own the rows of the measurement
// blocks beyond S (Go1: M = 12). Lane 0 runs the VO ingestion; build_dynamics
// and build_measurement run into shared memory behind a __syncwarp, in the
// velocity form one lane per leg (shift_group); the marginalization
// (marg_group), the shift with its cache update (shift_group) and the assembly
// with the streaming sweep (sweep_group) run on the group, and every lane
// writes its element of x. With the Cholesky tail (CHOL) the sweep keeps the
// same assembly and runs chol_slot_group in place of the Gauss-Jordan step — W
// = L^-1 U_prev column-parallel, S_j and yv row-parallel, the factor column by
// column with one sync per column — and the spare lane s solves for x (at s=9
// lane 9, which at Go1's shape, m=12, also owns a measurement row in
// shift_group, whose last sync comes before the sweep). Each
// element keeps the one-thread chain (acc = a0 v0; acc += a_k v_k over k = 0,
// 1, ...), so the results are the one-thread body's bit for bit as far as nvcc
// contracts the same expressions alike (tests/test_torch_tick_group.py runs
// both bodies on the host at each shape). What bounds it now: at B=1024 latency
// — at Cassie's shape 16 times the fleet takes 7.6 times the time (PERF.md §5)
// — the chain of the sweep's 20 slots, each the assembly's global loads, two
// row products and s pivot steps of two syncs. The window state is read row by
// row (lane r reads row r of an instance's block), so a warp touches 16 sectors
// where the one-thread body's 32 instances touched one: the blocks are not
// staged through shared memory with loads coalesced across a block's instances
// (PERF.md §7).
//
// Foot positions as states (LOT == 1; the TPU kernel's lot-1 branches,
// mhe_replay_kernel.py:284-319, 349-355): the dynamics gain identity foot
// blocks with process noise R Q_foot R^T / dt^2, the slide gain for a leg in
// contact at the previous tick and the swing gain otherwise; the measurement
// of leg i is y = R p_i with weight R (J_i C_enc_pos J_i^T)^-1 R^T.
//
// The Cholesky tail (template parameter CHOL; the TPU kernel with
// mk_solve='chol', mhe_replay_kernel.py:743-772, 801-802): the same forward
// sweep as a factor-and-substitute chain, chol_step below (on a group:
// chol_slot_group), and x_{N-1} = L^-T L^-1 y. It keeps a packed triangle and
// the reciprocal pivots (s(s+1)/2 + s scalars) where the Gauss-Jordan tail
// keeps S^-1 (s^2), and does about 1.3 s^3 multiplies per slot against about
// 4 s^3. The Gauss-Jordan statements are untouched; the Cholesky ones sit
// behind `if constexpr (CHOL)`.
// With box constraints the tail is never reached (the ADMM solves the
// window), as in the TPU kernel, so CHOL is an unconstrained instantiation
// only: on the shared clock (mhe_chol_kernel) or a clock per lane
// (mhe_pi_chol_kernel; the TPU kernel with per_instance=True and
// mk_solve='chol': the per-lane ingestion above, then this tail).
//
// The stage ablation (template parameter ABL; the TPU kernel's ablate,
// mhe_replay_kernel.py:375-394; driven by tools/roofline.py --ablate) skips one
// stage of the tick so that the time it saves is that stage's share. The output
// is wrong by construction. ABL_INGEST: no VO ingestion and no Bezier carry
// (on either clock: lane 0's per-lane ingestion too); ABL_MARG: no
// marginalization; ABL_BUILD: the fresh slot's dynamics, camera weight and
// measurement are zeros (the caches are still updated from them);
// ABL_ASSEMBLY: no normal equations, each lane writes its element of x = n_p
// after the shift, the cache update and (CON) the z/y warm-start shift, and
// the constrained tick runs no ADMM (0 iterations; z/y stay as shifted);
// ABL_SOLVE: sweep_group assembles the masked system and lane r sums D_j[r,0]
// + r_j[r] + U_j[r,0] over the slots into x[r] in place of the inverse chain,
// with either tail (tested before CHOL, as the reference tests ablate before
// mk_solve; the constrained tick has no such stage: the reference's
// constrained loop never reaches its sum). Unconstrained it runs on the group
// as the tick it ablates (the skips in marg_group's call, shift_group and
// sweep_group), constrained in lane 0's one-thread prelude before the group's
// ADMM, so that full minus ablated subtracts one body from itself. Every skip
// sits behind `if constexpr` on ABL, so ABL == ABL_NONE compiles to the tick
// above. ABL is instantiated at every shape on either clock: unconstrained
// with the Gauss-Jordan tail (mhe_abl_kernel, mhe_pi_abl_kernel) and with the
// Cholesky tail (mhe_chol_abl_kernel, for the stages before the tail — its
// assembly and solve stages never reach the tail, so they are the
// Gauss-Jordan units), and constrained (mhe_box_abl_kernel).
#pragma once
#include "admm.cuh"
#include "admm_group.cuh"
#include "smallmat.cuh"

namespace dem {

template <typename T, int S, int M>
struct MheConsts {
  T dt;
  T H[M * S];        // A_meas (m,s)
  T Pc[3 * S];       // P_cam (3,s)
  T Q_vo_p[9];
  T C_p[9];
  T C_accel[9];
  T Q_accel_bias[9];
  T C_enc_pos[9];
  T C_enc_vel[9];
  T C_gyro[9];
  T Q_foot_swing[9];
  T gravity[3];
};

// The constants of one leg-odometry form: the foot-position form (LOT == 1)
// reads the slide gain of the foot-state noise too. The velocity form keeps
// the layout above, so its kernels compile to what they were (a larger
// parameter block alone moves ptxas' register allocation).
template <typename T, int S, int M, int LOT>
struct MheConstsFor : MheConsts<T, S, M> {};

template <typename T, int S, int M>
struct MheConstsFor<T, S, M, 1> : MheConsts<T, S, M> {
  T Q_foot_slide[9];
};

template <typename T>
struct MhePtrs {
  // VO schedule, one entry per tick of this call: shared (Tn,) or, with a
  // camera clock per lane (PI), (Tn,B); the Bezier schedule likewise (4,) and
  // (1,), or (4,B) and (1,B)
  const int* vo_active;    // (Tn,) | (Tn,B)
  const int* vo_tick_pre;  // (Tn,) | (Tn,B)
  const int* vo_tick_now;  // (Tn,) | (Tn,B)
  const T* bez_times_in;   // (4,)  | (4,B)
  const int* bez_count_in; // (1,)  | (1,B)
  // per-tick inputs
  const T* R;        // (Tn,3,3,B)
  const T* accel;    // (Tn,3,B)
  const T* omega;    // (Tn,3,B)
  const T* pfoot;    // (Tn,L,3,B)
  const T* Jfoot;    // (Tn,L,3,3,B)
  const T* dq;       // (Tn,L,3,B)
  const T* contact;  // (Tn,L,B)
  const T* vo_inc;   // (Tn,3,B)
  // window state, updated in place
  T* y_meas;   // (N,m,B)
  T* Q_meas;   // (N,m,m,B)
  T* A_dyn;    // (N,s,s,B)
  T* b_dyn;    // (N,s,B)
  T* Q_dyn;    // (N,s,s,B)
  T* b_cam;    // (N,3,B)
  T* Q_cam;    // (N,3,3,B)
  T* cam_act;  // (N,B) 0/1
  T* M_p;      // (s,s,B)
  T* n_p;      // (s,B)
  T* bez_pts;  // (4,3,B)
  T* p_accum;  // (3,B)
  T* prev_R;   // (3,3,B)
  T* prev_acc; // (3,B)
  T* prev_ct;  // (L,B)
  T* Dslot;    // (N,s,s,B)  H^T R H + A^T Qd A per slot
  T* Ub;       // (N,s,s,B)  -A^T Qd per slot
  T* routb;    // (N,s,B)    H^T R y + A^T Qd b per slot
  // outputs
  T* x;              // (Tn,s,B)
  T* bez_times_out;  // (4,) | (4,B)
  int* bez_count_out; // (1,) | (1,B)
};

// Operands of the constrained variant beyond MhePtrs.
template <typename T>
struct MheBox {
  const T* lb;   // (s,B) per-lane lower bounds
  const T* ub;   // (s,B)
  T* z_adm;      // (N,s,B) ADMM warm start, ring-indexed state
  T* y_adm;      // (N,s,B)
  int* iters;    // (Tn,B) out: ADMM iterations run per tick and instance
  // per-launch scratch: the masked window system (the solve keeps the rest
  // of its data in shared memory, admm_group.cuh)
  T* Dw;         // (N,s,s,B)
  T* Uw;         // (N-1,s,s,B)
  T* rw;         // (N,s,B)
  AdmmSettings<T> admm;
};

// the stages ABL can skip (csrc/mhe.cu's ablate; kernels/_build.ABLATE_STAGES)
enum : int { ABL_NONE = 0, ABL_INGEST = 1, ABL_MARG = 2, ABL_BUILD = 3, ABL_ASSEMBLY = 4,
             ABL_SOLVE = 5 };

template <typename T>
DEM_HD void bezier_node(const T* pts, T u, T* out) {
  // Bezier_simple.cpp:73-82 on control points pts (4,3)
  const T u2 = u * u, u3 = u2 * u;
  DEM_UNROLL
  for (int k = 0; k < 3; ++k) {
    const T P0 = pts[k], P1 = pts[3 + k], P2 = pts[6 + k], P3 = pts[9 + k];
    out[k] = u3 * (-P0 + 3 * P1 - 3 * P2 + P3) + u2 * (3 * P0 - 6 * P1 + 3 * P2) +
             u * (-3 * P0 + 3 * P1) + P0;
  }
}

// assembly_lanes.build_dynamics (leg_odom_type 0): A (s,s), b (s), Q (s,s)
template <typename T, int S, int M>
DEM_HD void build_dynamics(const MheConsts<T, S, M>& c, const T* R, const T* accel_s,
                           T* A, T* bvec, T* Q) {
  const T dt = c.dt;
  DEM_UNROLL
  for (int i = 0; i < S * S; ++i) { A[i] = T(0); Q[i] = T(0); }
  DEM_UNROLL
  for (int i = 0; i < S; ++i) bvec[i] = T(0);
  const T hdt2 = dt * dt / 2;
  DEM_UNROLL
  for (int i = 0; i < 3; ++i) {
    A[i * S + i] = T(1);
    A[(3 + i) * S + 3 + i] = T(1);
    A[(6 + i) * S + 6 + i] = T(1);
    A[i * S + 3 + i] = dt;
    DEM_UNROLL
    for (int j = 0; j < 3; ++j) {
      A[i * S + 6 + j] = -hdt2 * R[i * 3 + j];
      A[(3 + i) * S + 6 + j] = -dt * R[i * 3 + j];
    }
    bvec[i] = -hdt2 * accel_s[i];
    bvec[3 + i] = -dt * accel_s[i];
  }
  // C_pv = G C G^T with G = [[dt R, dt^2/2 R], [0, dt R]], C = diag(C_p, C_accel)
  T G[36], Cc[36], GC[36], Cpv[36], Qpv[36];
  DEM_UNROLL
  for (int i = 0; i < 36; ++i) { G[i] = T(0); Cc[i] = T(0); }
  const T h2 = T(0.5) * dt * dt;
  DEM_UNROLL
  for (int i = 0; i < 3; ++i) {
    DEM_UNROLL
    for (int j = 0; j < 3; ++j) {
      G[i * 6 + j] = dt * R[i * 3 + j];
      G[i * 6 + 3 + j] = h2 * R[i * 3 + j];
      G[(3 + i) * 6 + 3 + j] = dt * R[i * 3 + j];
      Cc[i * 6 + j] = c.C_p[i * 3 + j];
      Cc[(3 + i) * 6 + 3 + j] = c.C_accel[i * 3 + j];
    }
  }
  matmul<6, 6, 6>(G, Cc, GC);
  matmul_nt<6, 6, 6>(GC, G, Cpv);
  gj_inv<6>(Cpv, Qpv);
  const T inv_dt2 = T(1) / (dt * dt);
  DEM_UNROLL
  for (int i = 0; i < 6; ++i) {
    DEM_UNROLL
    for (int j = 0; j < 6; ++j) Q[i * S + j] = Qpv[i * 6 + j];
  }
  DEM_UNROLL
  for (int i = 0; i < 3; ++i) {
    DEM_UNROLL
    for (int j = 0; j < 3; ++j)
      Q[(6 + i) * S + 6 + j] = inv_dt2 * c.Q_accel_bias[i * 3 + j];
  }
}

// The foot blocks of the dynamics with foot positions as states
// (assembly_lanes.build_dynamics, leg_odom_type 1): identity in A, noise
// R Q_foot R^T / dt^2 in Q — the slide gain for a leg in contact at the
// previous tick (contact (L)), the swing gain otherwise.
template <typename T, int S, int M, int L>
DEM_HD void add_foot_dynamics(const MheConstsFor<T, S, M, 1>& c, const T* R,
                              const T* contact, T* A, T* Q) {
  const T inv_dt2 = T(1) / (c.dt * c.dt);
  DEM_UNROLL
  for (int leg = 0; leg < L; ++leg) {
    const int f = 9 + 3 * leg;
    const bool stance = contact[leg] > T(0);
    T Qf[9], RQ[9], RQR[9];
    DEM_UNROLL
    for (int k = 0; k < 9; ++k) Qf[k] = stance ? c.Q_foot_slide[k] : c.Q_foot_swing[k];
    matmul<3, 3, 3>(R, Qf, RQ);
    matmul_nt<3, 3, 3>(RQ, R, RQR);
    DEM_UNROLL
    for (int i = 0; i < 3; ++i) {
      A[(f + i) * S + f + i] = T(1);
      DEM_UNROLL
      for (int j = 0; j < 3; ++j) Q[(f + i) * S + f + j] = inv_dt2 * RQR[i * 3 + j];
    }
  }
}

// assembly_lanes.build_measurement (leg_odom_type 0): y (m), Q (m,m)
template <typename T, int S, int M, int L>
DEM_HD void build_measurement(const MheConsts<T, S, M>& c, const T* R, const T* omega,
                              const T* pfoot, const T* Jfoot, const T* dq,
                              const T* contact, T* y, T* Q) {
  DEM_UNROLL
  for (int i = 0; i < M * M; ++i) Q[i] = T(0);
  T Cblk[81];
  DEM_UNROLL
  for (int i = 0; i < 81; ++i) Cblk[i] = T(0);
  DEM_UNROLL
  for (int i = 0; i < 3; ++i) {
    DEM_UNROLL
    for (int j = 0; j < 3; ++j) {
      Cblk[i * 9 + j] = c.C_enc_vel[i * 3 + j];
      Cblk[(3 + i) * 9 + 3 + j] = c.C_enc_pos[i * 3 + j];
      Cblk[(6 + i) * 9 + 6 + j] = c.C_gyro[i * 3 + j];
    }
  }
  T wskew[9];
  skew3(omega, wskew);
  for (int leg = 0; leg < L; ++leg) {
    const T* Ji = Jfoot + leg * 9;
    const T* pi = pfoot + leg * 3;
    const T* dqi = dq + leg * 3;
    T RJ[9], t1[3], wxp[3], t2[3];
    matmul<3, 3, 3>(R, Ji, RJ);
    matvec<3, 3>(RJ, dqi, t1);
    cross3(omega, pi, wxp);
    matvec<3, 3>(R, wxp, t2);
    DEM_UNROLL
    for (int k = 0; k < 3; ++k) y[leg * 3 + k] = -t1[k] - t2[k];
    // stance: C = R G diag(C_vel,C_pos,C_gyro) G^T R^T, G = [-J, -w^x J, p^x]
    T wJ[9], pskew[9], G[27], GC[27], inner[9], Rin[9], Cst[9], Qst[9];
    matmul<3, 3, 3>(wskew, Ji, wJ);
    skew3(pi, pskew);
    DEM_UNROLL
    for (int i = 0; i < 3; ++i) {
      DEM_UNROLL
      for (int j = 0; j < 3; ++j) {
        G[i * 9 + j] = -Ji[i * 3 + j];
        G[i * 9 + 3 + j] = -wJ[i * 3 + j];
        G[i * 9 + 6 + j] = pskew[i * 3 + j];
      }
    }
    matmul<3, 9, 9>(G, Cblk, GC);
    matmul_nt<3, 9, 3>(GC, G, inner);
    matmul<3, 3, 3>(R, inner, Rin);
    matmul_nt<3, 3, 3>(Rin, R, Cst);
    inv3(Cst, Qst);
    const bool stance = contact[leg] > T(0);
    DEM_UNROLL
    for (int i = 0; i < 3; ++i) {
      DEM_UNROLL
      for (int j = 0; j < 3; ++j)
        Q[(leg * 3 + i) * M + leg * 3 + j] =
            stance ? Qst[i * 3 + j] : c.Q_foot_swing[i * 3 + j];
    }
  }
}

// assembly_lanes.build_measurement with foot positions as states
// (leg_odom_type 1): y = R p, Q = R (J C_enc_pos J^T)^-1 R^T per leg
template <typename T, int S, int M, int L>
DEM_HD void build_measurement_pos(const MheConsts<T, S, M>& c, const T* R, const T* pfoot,
                                  const T* Jfoot, T* y, T* Q) {
  DEM_UNROLL
  for (int i = 0; i < M * M; ++i) Q[i] = T(0);
  DEM_UNROLL
  for (int leg = 0; leg < L; ++leg) {
    const T* Ji = Jfoot + leg * 9;
    T Rp[3], JC[9], inner[9], Iv[9], RI[9], Qi[9];
    matvec<3, 3>(R, pfoot + leg * 3, Rp);
    matmul<3, 3, 3>(Ji, c.C_enc_pos, JC);
    matmul_nt<3, 3, 3>(JC, Ji, inner);
    inv3(inner, Iv);
    matmul<3, 3, 3>(R, Iv, RI);
    matmul_nt<3, 3, 3>(RI, R, Qi);
    DEM_UNROLL
    for (int i = 0; i < 3; ++i) {
      y[leg * 3 + i] = Rp[i];
      DEM_UNROLL
      for (int j = 0; j < 3; ++j) Q[(leg * 3 + i) * M + leg * 3 + j] = Qi[i * 3 + j];
    }
  }
}

// One slot of the Cholesky tail (CHOL; the TPU kernel with mk_solve='chol',
// mhe_replay_kernel.py:743-772): the oldest slot's block is factored; after
// it W = L^-1 U_prev, S_j = D_j - W^T W (only its lower triangle, which chol
// reads, in place of D_j), z = L^-1 yv, yv = r_j - W^T z, then S_j is
// factored.
template <typename T, int S>
DEM_HD void chol_step(int j, T* D_j, const T* r_j, const T* U_prev, T* Lc, T* rd, T* yv) {
  if (j == 0) {
    chol<S>(D_j, Lc, rd);
    DEM_UNROLL
    for (int k = 0; k < S; ++k) yv[k] = r_j[k];
    return;
  }
  T W[S * S], z[S], wz[S];
  trsm_l<S, S>(Lc, rd, U_prev, W);
  DEM_UNROLL_UPTO(S, S * S)
  for (int a = 0; a < S; ++a) {
    DEM_UNROLL_UPTO(S, S * S)
    for (int c = a; c < S; ++c) {
      T acc = W[a] * W[c];
      DEM_UNROLL_UPTO(S, S * S)
      for (int i = 1; i < S; ++i) acc += W[i * S + a] * W[i * S + c];
      D_j[c * S + a] -= acc;
    }
  }
  trsv_l<S>(Lc, rd, yv, z);
  matvec_t<S, S>(W, z, wz);
  DEM_UNROLL
  for (int k = 0; k < S; ++k) yv[k] = r_j[k] - wz[k];
  chol<S>(D_j, Lc, rd);
}

// ---- the unconstrained Gauss-Jordan tick on a group of group_size<S>()
// threads per instance (GRP; see the note at the top). Lane r (< S) owns row r of every
// s x s block and element r of every vector; lanes >= S take part in the
// syncs and in gj_inv_rows only.

// One instance's shared memory in the group tick, in scalars: A_meas and
// P_cam (copied once per launch), five matrix buffers, four vector buffers
// and gj_inv_rows' pivot buffers (kept apart from the products' buffers);
// padded as BoxLayout pads (group_stride). At s=21, m=12: 2,688 scalars, 21.5
// KB in float64. What each buffer holds in each stage: marg_group,
// shift_group, sweep_group.
template <typename T, int S, int M>
struct TickLayout {
  static constexpr int SS = S * S;
  static constexpr int MX = SS > M * M ? SS : M * M;
  static constexpr int V = S > M ? S : M;
  static constexpr int H = 0;
  static constexpr int PC = H + M * S;
  static constexpr int MAT = PC + 3 * S;
  static constexpr int VEC = MAT + 5 * MX;
  static constexpr int PIV = VEC + 4 * V;
  DEM_HHD static constexpr int mat(int k) { return MAT + k * MX; }
  DEM_HHD static constexpr int vec(int k) { return VEC + k * V; }
  DEM_HHD static constexpr int stride() { return group_stride<T, group_size<S>()>(PIV + 4 * S); }
};

template <typename T, int S, int M>
DEM_HD BoxGroup<T> tick_group_of(int N, int B, int b) {
  constexpr int G = group_size<S>();
  BoxGroup<T> g;
  g.ln = box_lane<G>();
  g.mask = group_mask<G>();
  g.sm = reinterpret_cast<T*>(dem_box_smem) + (size_t)box_slot<G>() * TickLayout<T, S, M>::stride();
  g.N = N; g.B = B; g.b = b;
  return g;
}

// One row of smallmat's products, with each element's chain as there
// (acc = a0 v0; acc += a_k v_k for k = 1, 2, ...). row_mm: out = row a (K)
// times Bm (K x J), a row of matmul. row_mm_tn: row i of matmul_tn<K,I,J>(A,
// Bm), i.e. column i of A (K x I) times Bm. row_dot: a . v, an element of
// matvec (a a row) or of matvec_t (a a column).
template <int K, int J, typename T>
DEM_HD void row_mm(const T* a, const T* Bm, T* out) {
  DEM_UNROLL_UPTO(J, K)
  for (int c = 0; c < J; ++c) {
    T acc = a[0] * Bm[c];
    DEM_UNROLL_UPTO(K, 1)
    for (int k = 1; k < K; ++k) acc += a[k] * Bm[k * J + c];
    out[c] = acc;
  }
}
template <int K, int I, int J, typename T>
DEM_HD void row_mm_tn(const T* A, int i, const T* Bm, T* out) {
  T a[K];
  DEM_UNROLL_UPTO(K, 1)
  for (int k = 0; k < K; ++k) a[k] = A[k * I + i];
  row_mm<K, J>(a, Bm, out);
}
template <int K, typename T>
DEM_HD T row_dot(const T* a, const T* v) {
  T acc = a[0] * v[0];
  DEM_UNROLL_UPTO(K, 1)
  for (int k = 1; k < K; ++k) acc += a[k] * v[k];
  return acc;
}

// The arrival-cost marginalization of the oldest slot p0 on the group
// (mhe_lanes._marginalize; the one-thread statements in mhe_body). Buffers:
// mat 0-2 the slot's A, Q_dyn, Q_meas (then mat 0 Sinv C01), mat 3 C01,
// mat 4 D1 (each lane its own row), vec 0-3 y_meas, b_dyn, l0, Sinv l0.
template <typename T, int S, int M>
DEM_HD void marg_group(const MhePtrs<T>& p, const BoxGroup<T>& g, int p0) {
  using Lay = TickLayout<T, S, M>;
  constexpr int SS = S * S, MM = M * M;
  const int ln = g.ln, B = g.B, b = g.b;
  const T* H = g.sm + Lay::H;
  const T* Pc = g.sm + Lay::PC;
  T *sA = g.sm + Lay::mat(0), *sQ = g.sm + Lay::mat(1), *sR = g.sm + Lay::mat(2);
  T *sC = g.sm + Lay::mat(3), *sD1 = g.sm + Lay::mat(4);
  T *vy = g.sm + Lay::vec(0), *vb = g.sm + Lay::vec(1), *vl = g.sm + Lay::vec(2),
    *vt = g.sm + Lay::vec(3);
  T* pb = g.sm + Lay::PIV;
  if (ln < S) {
    load<S>(sA + ln * S, p.A_dyn, (size_t)p0 * SS + ln * S, B, b);
    load<S>(sQ + ln * S, p.Q_dyn, (size_t)p0 * SS + ln * S, B, b);
    vb[ln] = ld(p.b_dyn, (size_t)p0 * S + ln, B, b);
  }
  if (ln < M) {
    load<M>(sR + ln * M, p.Q_meas, (size_t)p0 * MM + ln * M, B, b);
    vy[ln] = ld(p.y_meas, (size_t)p0 * M + ln, B, b);
  }
  __syncwarp(g.mask);
  T Sm[S], l1 = T(0);
  if (ln < S) {
    T Qc[9], c0[3], PtQc[3], PtQcP[S], AtQd[S], tS[S], HtR[M];
    load<9>(Qc, p.Q_cam, (size_t)p0 * 9, B, b);
    load<3>(c0, p.b_cam, (size_t)p0 * 3, B, b);
    const T act = ld(p.cam_act, (size_t)p0, B, b);
    row_mm_tn<3, S, 3>(Pc, ln, Qc, PtQc);
    row_mm<3, S>(PtQc, Pc, PtQcP);
    row_mm_tn<S, S, S>(sA, ln, sQ, AtQd);       // A^T Qd
    row_mm_tn<M, S, M>(H, ln, sR, HtR);         // H^T R
    row_mm<M, S>(HtR, H, tS);                   // H^T R H
    const T tv2 = row_dot<M>(HtR, vy);          // H^T R y
    row_mm<S, S>(AtQd, sA, Sm);                 // A^T Qd A
    const T tv = row_dot<S>(AtQd, vb);          // A^T Qd b
    const T tv3 = row_dot<3>(PtQc, c0);         // P^T Qc c0
    const T Qdb = row_dot<S>(sQ + ln * S, vb);  // Qd b
    DEM_UNROLL_UPTO(S, 4)
    for (int k = 0; k < S; ++k) {
      const T app = act * PtQcP[k];
      Sm[k] = ld(p.M_p, (size_t)ln * S + k, B, b) + Sm[k] + tS[k] + app;
      sC[ln * S + k] = -(AtQd[k] + app);
      sD1[ln * S + k] = sQ[ln * S + k] + app;
    }
    vl[ln] = ld(p.n_p, ln, B, b) - tv - tv2 - act * tv3;
    l1 = Qdb + act * tv3;
  } else {
    DEM_UNROLL
    for (int k = 0; k < S; ++k) Sm[k] = T(0);
  }
  T Sinv[S];
  gj_inv_rows<T, S>(Sm, Sinv, pb, pb + 2 * S, ln, g.mask);   // its syncs publish C01, l0
  if (ln < S) {
    row_mm<S, S>(Sinv, sC, sA + ln * S);        // Sinv C01
    vt[ln] = row_dot<S>(Sinv, vl);              // Sinv l0
  }
  __syncwarp(g.mask);
  if (ln < S) {
    T Sm2[S], cc[S];
    row_mm_tn<S, S, S>(sC, ln, sA, Sm2);        // C01^T Sinv C01
    DEM_UNROLL_UPTO(S, 1)
    for (int k = 0; k < S; ++k) st(p.M_p, (size_t)ln * S + k, B, b, sD1[ln * S + k] - Sm2[k]);
    DEM_UNROLL_UPTO(S, 1)
    for (int k = 0; k < S; ++k) cc[k] = sC[k * S + ln];
    st(p.n_p, ln, B, b, l1 - row_dot<S>(cc, vt));   // l1 - C01^T Sinv l0
  }
  __syncwarp(g.mask);   // the slot read before the shift overwrites it
}

// The ring shift on the group (mhe_lanes._tick_tail; the one-thread statements
// in mhe_body): build_dynamics and build_measurement of the two changed slots
// run into shared memory (the dynamics of pN2 into mat 0 A, mat 1 Q, vec 0 b;
// the measurement of the fresh slot pN1 into mat 2 Q, vec 1 y) with the scalar
// stores, then each lane writes its rows of both slots and of the
// Dslot/Ub/routb caches. With foot positions as states (LOT == 1) lane 0 runs
// them all. In the velocity form (LEGS) the legs' measurement blocks are
// independent, so lane k (< L) builds leg k's rows (build_measurement of that
// leg alone: each element keeps its chain) and lane L the rest, what lane 0
// runs otherwise. ABL_BUILD: their blocks are zeros.
template <typename T, int S, int M, int L, int LOT, int ABL>
DEM_HD void shift_group(const MhePtrs<T>& p, const MheConstsFor<T, S, M, LOT>& c,
                        const BoxGroup<T>& g, int i, int pN1, int pN2) {
  using Lay = TickLayout<T, S, M>;
  constexpr int SS = S * S, MM = M * M;
  constexpr bool LEGS = LOT == 0;      // a lane per leg
  constexpr int DYN = LEGS ? L : 0;    // the lane of the dynamics and the stores
  static_assert(!LEGS || (M == 3 * L && L < group_size<S>()), "three measurement rows per leg");
  const int ln = g.ln, B = g.B, b = g.b;
  const T* H = g.sm + Lay::H;
  T *sA = g.sm + Lay::mat(0), *sQ = g.sm + Lay::mat(1), *sR = g.sm + Lay::mat(2);
  T *vb = g.sm + Lay::vec(0), *vy = g.sm + Lay::vec(1);
  if constexpr (LEGS) {
    if (ln < L) {   // leg ln's rows 3 ln .. 3 ln + 2 of Q and y
      T Rt[9], om[3], pf[3], Jf[9], dqv[3], ct, yl[M], Ql[MM];
      if constexpr (ABL == ABL_BUILD) {
        DEM_UNROLL
        for (int k = 0; k < 3; ++k) yl[k] = T(0);
        DEM_UNROLL
        for (int k = 0; k < MM; ++k) Ql[k] = T(0);
      } else {
        load<9>(Rt, p.R, (size_t)i * 9, B, b);
        load<3>(om, p.omega, (size_t)i * 3, B, b);
        load<3>(pf, p.pfoot, ((size_t)i * L + ln) * 3, B, b);
        load<9>(Jf, p.Jfoot, ((size_t)i * L + ln) * 9, B, b);
        load<3>(dqv, p.dq, ((size_t)i * L + ln) * 3, B, b);
        ct = ld(p.contact, (size_t)i * L + ln, B, b);
        build_measurement<T, S, M, 1>(c, Rt, om, pf, Jf, dqv, &ct, yl, Ql);
      }
      DEM_UNROLL
      for (int r = 0; r < 3; ++r) {
        T* row = sR + (3 * ln + r) * M;
        DEM_UNROLL
        for (int k = 0; k < M; ++k) row[k] = T(0);
        DEM_UNROLL
        for (int k = 0; k < 3; ++k) row[3 * ln + k] = Ql[r * M + k];
        vy[3 * ln + r] = yl[r];
      }
    }
  }
  if (ln == DYN) {
    T Qcn[9];
    if constexpr (ABL == ABL_BUILD) {
      for (int k = 0; k < SS; ++k) { sA[k] = T(0); sQ[k] = T(0); }
      for (int k = 0; k < S; ++k) vb[k] = T(0);
      DEM_UNROLL
      for (int k = 0; k < 9; ++k) Qcn[k] = T(0);
    } else {
      T Rp[9], accp[3], tmp9[9];
      load<9>(Rp, p.prev_R, 0, B, b);
      load<3>(accp, p.prev_acc, 0, B, b);
      build_dynamics<T, S, M>(c, Rp, accp, sA, vb, sQ);
      if constexpr (LOT == 1) {
        T ctp[L];   // the previous tick's contact gates the foot noise
        load<L>(ctp, p.prev_ct, 0, B, b);
        add_foot_dynamics<T, S, M, L>(c, Rp, ctp, sA, sQ);
      }
      matmul<3, 3, 3>(Rp, c.Q_vo_p, tmp9);
      matmul_nt<3, 3, 3>(tmp9, Rp, Qcn);
    }
    store<9>(p.Q_cam, (size_t)pN2 * 9, B, b, Qcn);
    fill<3>(p.b_cam, (size_t)pN2 * 3, B, b, T(0));
    st(p.cam_act, (size_t)pN2, B, b, T(0));

    T Rt[9], acc[3], ct[L];
    load<9>(Rt, p.R, (size_t)i * 9, B, b);
    load<3>(acc, p.accel, (size_t)i * 3, B, b);
    if constexpr (!LEGS) {
      T om[3], pf[L * 3], Jf[L * 9], dqv[L * 3];
      load<3>(om, p.omega, (size_t)i * 3, B, b);
      load<L * 3>(pf, p.pfoot, (size_t)i * L * 3, B, b);
      load<L * 9>(Jf, p.Jfoot, (size_t)i * L * 9, B, b);
      load<L * 3>(dqv, p.dq, (size_t)i * L * 3, B, b);
      load<L>(ct, p.contact, (size_t)i * L, B, b);
      if constexpr (ABL == ABL_BUILD) {
        for (int k = 0; k < MM; ++k) sR[k] = T(0);
        for (int k = 0; k < M; ++k) vy[k] = T(0);
      } else {
        build_measurement_pos<T, S, M, L>(c, Rt, pf, Jf, vy, sR);
      }
    } else {
      load<L>(ct, p.contact, (size_t)i * L, B, b);
    }
    fill<3>(p.b_cam, (size_t)pN1 * 3, B, b, T(0));
    fill<9>(p.Q_cam, (size_t)pN1 * 9, B, b, T(0));
    st(p.cam_act, (size_t)pN1, B, b, T(0));
    T acc_s[3];
    matvec<3, 3>(Rt, acc, acc_s);
    DEM_UNROLL
    for (int k = 0; k < 3; ++k) acc_s[k] += c.gravity[k];
    store<9>(p.prev_R, 0, B, b, Rt);
    store<3>(p.prev_acc, 0, B, b, acc_s);
    store<L>(p.prev_ct, 0, B, b, ct);
  }
  __syncwarp(g.mask);
  if (ln < S) {
    const size_t r2 = (size_t)pN2 * SS + ln * S, r1 = (size_t)pN1 * SS + ln * S;
    store<S>(p.A_dyn, r2, B, b, sA + ln * S);
    st(p.b_dyn, (size_t)pN2 * S + ln, B, b, vb[ln]);
    store<S>(p.Q_dyn, r2, B, b, sQ + ln * S);
    // pN2's cache gains the fresh dynamics terms (its measurement terms were
    // cached when it was the newest slot)
    T AtQd[S], tS[S], HtR[M];
    row_mm_tn<S, S, S>(sA, ln, sQ, AtQd);
    row_mm<S, S>(AtQd, sA, tS);
    DEM_UNROLL_UPTO(S, 1)
    for (int k = 0; k < S; ++k) {
      st(p.Dslot, r2 + k, B, b, ld(p.Dslot, r2 + k, B, b) + tS[k]);
      st(p.Ub, r2 + k, B, b, -AtQd[k]);
    }
    const size_t e2 = (size_t)pN2 * S + ln;
    st(p.routb, e2, B, b, ld(p.routb, e2, B, b) + row_dot<S>(AtQd, vb));
    // the fresh slot pN1: no dynamics, measurement terms only in the cache
    fill<S>(p.A_dyn, r1, B, b, T(0));
    st(p.b_dyn, (size_t)pN1 * S + ln, B, b, T(0));
    fill<S>(p.Q_dyn, r1, B, b, T(0));
    row_mm_tn<M, S, M>(H, ln, sR, HtR);
    row_mm<M, S>(HtR, H, tS);
    store<S>(p.Dslot, r1, B, b, tS);
    fill<S>(p.Ub, r1, B, b, T(0));
    st(p.routb, (size_t)pN1 * S + ln, B, b, row_dot<M>(HtR, vy));
  }
  if (ln < M) {
    store<M>(p.Q_meas, (size_t)pN1 * MM + ln * M, B, b, sR + ln * M);
    st(p.y_meas, (size_t)pN1 * M + ln, B, b, vy[ln]);
  }
  __syncwarp(g.mask);   // the new slots in global memory before the sweep reads them whole
}

// The Cholesky factor of an S x S SPD matrix on the group (chol's chain per
// element, smallmat.cuh): lane r (< S) holds row r of A (its lower triangle
// is read) and forms row r of L; Lp (packed by rows) and rd (the reciprocal
// pivots) are in shared memory. Column k: lane k finishes its pivot from its
// own row, clamps it at 1e-30 and publishes L_kk and rd_k; after one
// __syncwarp the lanes below form L_ik from row k, which lane k wrote in the
// earlier columns. S syncs; the last one publishes the whole factor.
template <typename T, int S>
DEM_HD void chol_rows(const T* A, T* Lp, T* rd, int ln, unsigned mask) {
  T Lr[S];   // row ln of L
  DEM_UNROLL
  for (int k = 0; k < S; ++k) {
    if (ln == k) {
      T d = A[k];
      DEM_UNROLL
      for (int m = 0; m < k; ++m) d -= Lr[m] * Lr[m];
      d = sqrt(d < T(1e-30) ? T(1e-30) : d);   // NaN passes, as in chol
      Lp[tri(k) + k] = d;
      rd[k] = T(1) / d;
    }
    __syncwarp(mask);
    if (ln > k && ln < S) {
      T e = A[k];
      DEM_UNROLL
      for (int m = 0; m < k; ++m) e -= Lr[m] * Lp[tri(k) + m];
      Lr[k] = e * rd[k];
      Lp[tri(ln) + k] = Lr[k];
    }
  }
}

// One slot of the Cholesky tail on the group (chol_step's statements, each
// element with its one-thread chain): D (lane r: row r of D_j, which becomes
// S_j) and r_j's element r as assembled; Up the previous slot's U in shared
// memory. For j > 0 lane a (< S) forms column a of W = L^-1 U_prev by
// trsm_l's chain, keeps it in registers and writes it to mat 2 by columns, and
// the spare lane S forms z = L^-1 yv (trsv_l) into vec 0; one __syncwarp; then
// lane r forms row r of S_j = D_j - W^T W (lower triangle only; the chain
// starts with mul_rn, as chol_step's rolled loop rounds its first product)
// and yv_r = r_r - (W^T z)_r (matvec_t's chain) from its own column of W; then
// chol_rows. Buffers: mat 3 the packed factor and rd (s(s+1)/2 + s scalars),
// vec 1 yv. The sync after W separates this slot's reads of L from the
// factor that rewrites it; the factor's syncs separate the reads of W, z and
// U_prev from the next slot's writes.
template <typename T, int S, int M>
DEM_HD void chol_slot_group(const BoxGroup<T>& g, int j, T* D, T r, const T* Up) {
  static_assert(S < group_size<S>(), "the spare lane S solves for z");
  using Lay = TickLayout<T, S, M>;
  const int ln = g.ln;
  T* Lp = g.sm + Lay::mat(3);
  T* rd = Lp + S * (S + 1) / 2;
  T* sWc = g.sm + Lay::mat(2);
  T *vz = g.sm + Lay::vec(0), *vyv = g.sm + Lay::vec(1);
  if (j > 0) {
    T w[S];   // column ln of W
    if (ln < S) {
      DEM_UNROLL
      for (int i = 0; i < S; ++i) {
        T acc = Up[i * S + ln];
        DEM_UNROLL
        for (int m = 0; m < i; ++m) acc -= Lp[tri(i) + m] * w[m];
        w[i] = acc * rd[i];
        sWc[ln * S + i] = w[i];
      }
    } else if (ln == S) {
      trsv_l<S>(Lp, rd, vyv, vz);
    }
    __syncwarp(g.mask);
    if (ln < S) {
      DEM_UNROLL
      for (int a = 0; a < S; ++a) {
        if (a <= ln) {
          const T* wa = sWc + a * S;
          T acc = mul_rn(wa[0], w[0]);   // chol_step's rolled chain rounds it first
          DEM_UNROLL
          for (int i = 1; i < S; ++i) acc += wa[i] * w[i];
          D[a] -= acc;
        }
      }
      T wz = w[0] * vz[0];
      DEM_UNROLL
      for (int k = 1; k < S; ++k) wz += w[k] * vz[k];
      vyv[ln] = r - wz;
    }
  } else if (ln < S) {
    vyv[ln] = r;
  }
  chol_rows<T, S>(D, Lp, rd, ln, g.mask);
}

// The masked normal equations and the streaming forward block-Thomas sweep
// on the group, then lane r writes x_{N-1}[r] of tick i (the one-thread
// statements in mhe_body). Each lane assembles its row of D_j, U_j and
// element of r_j; the Gauss-Jordan chain runs row-parallel: W = Sinv U_prev
// (row r of W from row r of Sinv), D_j -= U_prev^T W (row r from column r of
// U_prev), then gj_inv_rows. Buffers: mat 0, 1 U_j for even and odd j (the
// next slot's U_prev), mat 2 W, mat 3 Sinv and mat 4 the previous slot's
// Qd + P^T Qc P (each lane its own row), vec 0 Sinv yv, vec 1 yv. Two
// __syncwarp per slot besides gj_inv_rows' own: after W and Sinv yv are
// written, and after yv is. With the Cholesky tail (CHOL) each slot after
// the assembly is chol_slot_group, and after the last one the spare lane S
// forms x_{N-1} = L^-T L^-1 yv (trsv_l, trsv_lt, through vec 0 and 2) and
// writes it. ABL_SOLVE (before either tail): the assembly alone, and lane r
// sums D_j[r,0] + r_j[r] + U_j[r,0] over the slots into x[r], with no sync.
template <typename T, int S, int M, bool CHOL, int ABL>
DEM_HD void sweep_group(const MhePtrs<T>& p, const BoxGroup<T>& g, int N, int i, int t,
                        int base_new) {
  using Lay = TickLayout<T, S, M>;
  constexpr int SS = S * S;
  const int ln = g.ln, B = g.B, b = g.b;
  const T* Pc = g.sm + Lay::PC;
  T* sW = g.sm + Lay::mat(2);
  T* sinv = g.sm + Lay::mat(3) + ln * S;
  T* prevQ = g.sm + Lay::mat(4) + ln * S;
  T *vt1 = g.sm + Lay::vec(0), *vyv = g.sm + Lay::vec(1);
  T* pb = g.sm + Lay::PIV;
  const int n_states = (t + 1 < N) ? t + 1 : N;
  const int first = N - n_states;
  T prev_rin = T(0);
  T abl_acc = T(0);   // ABL_SOLVE: the sum that stands in for x
  for (int j = 0; j < N; ++j) {
    const int pj = (base_new + j) % N;
    const bool valid = j >= first;
    const bool iv = valid && (j <= N - 2);
    T* Uj = g.sm + Lay::mat(j & 1);
    const T* Up = g.sm + Lay::mat((j + 1) & 1);
    T D[S], r = T(0);
    if (ln < S) {
      const size_t row = (size_t)pj * SS + ln * S;
      T Qd[S], bj[S], Qc[9], c0[3], PtQc[3], PtQcP[S];
      load<S>(Qd, p.Q_dyn, row, B, b);
      load<S>(bj, p.b_dyn, (size_t)pj * S, B, b);
      load<9>(Qc, p.Q_cam, (size_t)pj * 9, B, b);
      load<3>(c0, p.b_cam, (size_t)pj * 3, B, b);
      const T act = iv ? ld(p.cam_act, (size_t)pj, B, b) : T(0);
      row_mm_tn<3, S, 3>(Pc, ln, Qc, PtQc);
      DEM_UNROLL
      for (int k = 0; k < 3; ++k) PtQc[k] *= act;
      row_mm<3, S>(PtQc, Pc, PtQcP);
      if (!iv) {
        DEM_UNROLL
        for (int k = 0; k < S; ++k) Qd[k] = T(0);
      }
      const T Qd_b = row_dot<S>(Qd, bj);
      const T PtQc_c = row_dot<3>(PtQc, c0);
      load<S>(D, p.Dslot, row, B, b);
      r = ld(p.routb, (size_t)pj * S + ln, B, b);
      DEM_UNROLL
      for (int k = 0; k < S; ++k) D[k] += PtQcP[k];
      r += PtQc_c;
      if (j > 0) {
        DEM_UNROLL
        for (int k = 0; k < S; ++k) D[k] += prevQ[k];
        r -= prev_rin;
      }
      if (j == first) {
        DEM_UNROLL_UPTO(S, 1)
        for (int k = 0; k < S; ++k) D[k] += ld(p.M_p, (size_t)ln * S + k, B, b);
        r -= ld(p.n_p, ln, B, b);
      }
      DEM_UNROLL
      for (int k = 0; k < S; ++k) prevQ[k] = Qd[k] + PtQcP[k];
      prev_rin = Qd_b + PtQc_c;
      if (!valid) {
        DEM_UNROLL
        for (int k = 0; k < S; ++k) D[k] = k == ln ? T(1) : T(0);
        r = T(0);
      }
      const bool u_on = iv && (j + 1 >= first);
      DEM_UNROLL_UPTO(S, 1)
      for (int k = 0; k < S; ++k)
        Uj[ln * S + k] = u_on ? (ld(p.Ub, row + k, B, b) - PtQcP[k]) : T(0);
    } else {
      DEM_UNROLL
      for (int k = 0; k < S; ++k) D[k] = T(0);
    }
    if constexpr (ABL == ABL_SOLVE) {
      // keep the assembled system live, skip the inverse chain
      if (ln < S) {
        const T term = D[0] + r + Uj[ln * S];
        abl_acc = j == 0 ? term : abl_acc + term;
      }
      continue;
    } else if constexpr (CHOL) {
      chol_slot_group<T, S, M>(g, j, D, r, Up);
      continue;
    }
    T yvi = r;
    if (j > 0) {
      if (ln < S) {
        T si[S];
        DEM_UNROLL
        for (int k = 0; k < S; ++k) si[k] = sinv[k];
        row_mm<S, S>(si, Up, sW + ln * S);       // W = Sinv U_prev
        vt1[ln] = row_dot<S>(si, vyv);           // Sinv yv
      }
      __syncwarp(g.mask);
      if (ln < S) {
        T uc[S], UtW[S];
        DEM_UNROLL
        for (int k = 0; k < S; ++k) uc[k] = Up[k * S + ln];
        row_mm<S, S>(uc, sW, UtW);               // U_prev^T W
        DEM_UNROLL
        for (int k = 0; k < S; ++k) D[k] -= UtW[k];
        yvi = r - row_dot<S>(uc, vt1);          // r_j - U_prev^T Sinv yv
      }
    }
    T inv[S];
    gj_inv_rows<T, S>(D, inv, pb, pb + 2 * S, ln, g.mask);
    if (ln < S) {
      DEM_UNROLL
      for (int k = 0; k < S; ++k) sinv[k] = inv[k];
      vyv[ln] = yvi;
    }
    __syncwarp(g.mask);
  }
  if constexpr (ABL == ABL_SOLVE) {
    if (ln < S) st(p.x, (size_t)i * S + ln, B, b, abl_acc);
  } else if constexpr (CHOL) {
    if (ln == S) {
      const T *Lp = g.sm + Lay::mat(3), *rd = Lp + S * (S + 1) / 2;
      T *vz = g.sm + Lay::vec(0), *vx = g.sm + Lay::vec(2);
      trsv_l<S>(Lp, rd, vyv, vz);
      trsv_lt<S>(Lp, rd, vz, vx);
      DEM_UNROLL_UPTO(S, 1)
      for (int k = 0; k < S; ++k) st(p.x, (size_t)i * S + k, B, b, vx[k]);
    }
  } else if (ln < S) {   // logical N-1 = newest state
    T si[S];
    DEM_UNROLL
    for (int k = 0; k < S; ++k) si[k] = sinv[k];
    st(p.x, (size_t)i * S + ln, B, b, row_dot<S>(si, vyv));
  }
}

template <typename T, int S, int M, int L, int LOT, bool CON, bool PI, bool CHOL = false,
          int ABL = ABL_NONE, bool GRP = false>
DEM_HD void mhe_body(const MhePtrs<T>& p, const MheConstsFor<T, S, M, LOT>& c,
                     const MheBox<T>* q, int N, int B, int Tn, int t0, int b) {
  static_assert(!GRP || !CON, "the group tick is the unconstrained one, with either tail");
  static_assert(ABL == ABL_NONE || GRP || CON,
                "the stage ablation runs on the group or in the constrained tick");
  static_assert(!CON || ABL != ABL_SOLVE, "the constrained tick has no solve stage to ablate");
  constexpr int SS = S * S;
  constexpr int MM = M * M;
  const T dt = c.dt;
  // CON: this lane's group, row and bounds; lane 0 (`lead`) runs the tick's
  // one-thread statements, the group the window solve. GRP: lane 0 runs the
  // VO ingestion, the group the rest of the tick. Otherwise every thread
  // leads.
  constexpr bool USH = box_u_shared<S>();
  constexpr int G = group_size<S>();
  const bool lead = !(CON || GRP) || box_lane<G>() == 0;
  BoxGroup<T> grp{};
  T lbi = T(0), ubi = T(0);
  if constexpr (CON) {
    grp = box_group<T, S, USH>(N, B, b);
    if (grp.ln < S) {
      lbi = ld(q->lb, grp.ln, B, b);
      ubi = ld(q->ub, grp.ln, B, b);
    }
  }
  if constexpr (GRP) {   // the group's copy of the constant blocks
    using Lay = TickLayout<T, S, M>;
    grp = tick_group_of<T, S, M>(N, B, b);
    for (int e = grp.ln; e < M * S; e += G) grp.sm[Lay::H + e] = c.H[e];
    for (int e = grp.ln; e < 3 * S; e += G) grp.sm[Lay::PC + e] = c.Pc[e];
  }

  // private copy of the Bezier schedule: fleet-global, or this lane's own
  T bt[4];
  int bcount;
  if constexpr (PI) {
    load<4>(bt, p.bez_times_in, 0, B, b);
    bcount = p.bez_count_in[b];
  } else {
    DEM_UNROLL
    for (int k = 0; k < 4; ++k) bt[k] = p.bez_times_in[k];
    bcount = p.bez_count_in[0];
  }

  for (int i = 0; i < Tn; ++i) {
    const int t = t0 + i;  // absolute tick (>= 1)
    const int base_old = (t - 1) % N;
    const int base_new = t % N;

    // ---- VO ingestion (mhe_lanes._apply_vo; per lane: _apply_vo_per_instance)
    // the schedule entry of this tick: the fleet's, or this lane's (PI)
    if constexpr (ABL == ABL_INGEST) {
    } else if (lead && (PI ? p.vo_active[(size_t)i * B + b] != 0 : p.vo_active[i] != 0)) {
      const int tick_pre = PI ? p.vo_tick_pre[(size_t)i * B + b] : p.vo_tick_pre[i];
      const int tick_now = PI ? p.vo_tick_now[(size_t)i * B + b] : p.vo_tick_now[i];
      T p_acc[3], inc[3], pts[12];
      load<3>(p_acc, p.p_accum, 0, B, b);
      load<3>(inc, p.vo_inc, (size_t)i * 3, B, b);
      DEM_UNROLL
      for (int k = 0; k < 3; ++k) p_acc[k] += inc[k];
      store<3>(p.p_accum, 0, B, b, p_acc);
      load<12>(pts, p.bez_pts, 0, B, b);
      // add_way_point (Bezier_simple.cpp:12-27)
      if (bcount >= 4) {
        DEM_UNROLL
        for (int k = 0; k < 9; ++k) pts[k] = pts[k + 3];
        bt[0] = bt[1]; bt[1] = bt[2]; bt[2] = bt[3];
      }
      const int w = bcount < 3 ? bcount : 3;
      const T t_now = (T)tick_now * dt;
      DEM_UNROLL
      for (int k = 0; k < 4; ++k) {
        if (k == w) {
          pts[k * 3] = p_acc[0]; pts[k * 3 + 1] = p_acc[1]; pts[k * 3 + 2] = p_acc[2];
          bt[k] = t_now;
        }
      }
      bcount += 1;
      store<12>(p.bez_pts, 0, B, b, pts);

      const int window_start = t - (N < t ? N : t);
      const int start = window_start > tick_pre ? window_start : tick_pre;
      const int num = tick_now - start + 1;
      if (tick_now > window_start && bcount >= 4) {
        T t_int = bt[3] - bt[0];
        if (t_int == T(0)) t_int = T(1);
        const T u0 = ((T)start * dt - bt[0]) / t_int;
        const T du = dt / t_int;
        T node_prev[3], node_k[3];
        bezier_node(pts, u0, node_prev);
        for (int k = 0; k < N; ++k) {
          bezier_node(pts, u0 + du * (T)(k + 1), node_k);
          const int slot = start + k - t + N;
          if (k <= num - 2 && slot >= 0 && slot <= N - 2) {
            const int pj = (base_old + slot) % N;
            DEM_UNROLL
            for (int a = 0; a < 3; ++a)
              st(p.b_cam, (size_t)pj * 3 + a, B, b, -(node_k[a] - node_prev[a]));
            st(p.cam_act, (size_t)pj, B, b, T(1));
          }
          DEM_UNROLL
          for (int a = 0; a < 3; ++a) node_prev[a] = node_k[a];
        }
      }
    }

    if constexpr (GRP) {
      // the rest of the tick on the group, once lane 0 has ingested (and the
      // group is done with the previous tick's buffers)
      __syncwarp(grp.mask);
      if constexpr (ABL == ABL_MARG) {
      } else if (t >= N) {
        marg_group<T, S, M>(p, grp, base_old);
      }
      shift_group<T, S, M, L, LOT, ABL>(p, c, grp, i, base_old, (base_old + N - 1) % N);
      if constexpr (ABL == ABL_ASSEMBLY) {
        // no normal equations: the arrival cost's vector stands in for x (each
        // lane reads the element it wrote in marg_group)
        if (grp.ln < S) st(p.x, (size_t)i * S + grp.ln, B, b, ld(p.n_p, grp.ln, B, b));
      } else {
        sweep_group<T, S, M, CHOL, ABL>(p, grp, N, i, t, t % N);
      }
      continue;
    }

    // ---- marginalization (mhe_lanes._marginalize) -------------------------
    if constexpr (ABL == ABL_MARG) {
    } else if (lead && t >= N) {
      const int p0 = base_old;
      T A[SS], Qd[SS], AtQd[SS], Qc[9], PtQc[S * 3], PtQcP[SS];
      T bv[S], c0[3], Mp[SS], np_[S];
      load<SS>(A, p.A_dyn, (size_t)p0 * SS, B, b);
      load<SS>(Qd, p.Q_dyn, (size_t)p0 * SS, B, b);
      load<S>(bv, p.b_dyn, (size_t)p0 * S, B, b);
      load<9>(Qc, p.Q_cam, (size_t)p0 * 9, B, b);
      load<3>(c0, p.b_cam, (size_t)p0 * 3, B, b);
      load<SS>(Mp, p.M_p, 0, B, b);
      load<S>(np_, p.n_p, 0, B, b);
      const T act = ld(p.cam_act, (size_t)p0, B, b);
      matmul_tn<S, S, S>(A, Qd, AtQd);
      matmul_tn<3, S, 3>(c.Pc, Qc, PtQc);
      matmul<S, 3, S>(PtQc, c.Pc, PtQcP);

      T Sm[SS], C01[SS], D1[SS], l0[S], l1[S], tS[SS], tv[S], tv2[S], tv3[S];
      {
        // H^T R (s,m), then H^T R H (s,s) and H^T R y (s)
        T Rm[MM], HtR[S * M], yv[M];
        load<MM>(Rm, p.Q_meas, (size_t)p0 * MM, B, b);
        load<M>(yv, p.y_meas, (size_t)p0 * M, B, b);
        matmul_tn<M, S, M>(c.H, Rm, HtR);
        matmul<S, M, S>(HtR, c.H, tS);   // H^T R H
        matvec<S, M>(HtR, yv, tv2);      // H^T R y
      }
      matmul<S, S, S>(AtQd, A, Sm);      // A^T Qd A
      matvec<S, S>(AtQd, bv, tv);        // A^T Qd b
      matvec<S, 3>(PtQc, c0, tv3);       // P^T Qc c0
      T Qdb[S];
      matvec<S, S>(Qd, bv, Qdb);
      DEM_UNROLL
      for (int k = 0; k < SS; ++k) {
        const T app = act * PtQcP[k];
        Sm[k] = Mp[k] + Sm[k] + tS[k] + app;
        C01[k] = -(AtQd[k] + app);
        D1[k] = Qd[k] + app;
      }
      DEM_UNROLL
      for (int k = 0; k < S; ++k) {
        l0[k] = np_[k] - tv[k] - tv2[k] - act * tv3[k];
        l1[k] = Qdb[k] + act * tv3[k];
      }
      T Sinv[SS];
      gj_inv<S>(Sm, Sinv);
      matmul<S, S, S>(Sinv, C01, tS);
      matmul_tn<S, S, S>(C01, tS, Sm);
      DEM_UNROLL
      for (int k = 0; k < SS; ++k) Mp[k] = D1[k] - Sm[k];
      matvec<S, S>(Sinv, l0, tv);
      matvec_t<S, S>(C01, tv, tv2);
      DEM_UNROLL
      for (int k = 0; k < S; ++k) np_[k] = l1[k] - tv2[k];
      store<SS>(p.M_p, 0, B, b, Mp);
      store<S>(p.n_p, 0, B, b, np_);
    }

    // ---- shift + assembly of the two changed slots (mhe_lanes._tick_tail) --
    const int pN1 = base_old;                  // physical slot of logical N-1
    const int pN2 = (base_old + N - 1) % N;    // logical N-2 after the shift
    if (lead) {
      T Rp[9], accp[3], A_d[SS], b_d[S], Q_d[SS], Qcn[9], tmp9[9];
      if constexpr (ABL == ABL_BUILD) {   // the fresh dynamics and camera weight: zeros
        for (int k = 0; k < SS; ++k) { A_d[k] = T(0); Q_d[k] = T(0); }
        for (int k = 0; k < S; ++k) b_d[k] = T(0);
        for (int k = 0; k < 9; ++k) Qcn[k] = T(0);
      } else {
        load<9>(Rp, p.prev_R, 0, B, b);
        load<3>(accp, p.prev_acc, 0, B, b);
        build_dynamics<T, S, M>(c, Rp, accp, A_d, b_d, Q_d);
        if constexpr (LOT == 1) {
          T ctp[L];   // the previous tick's contact gates the foot noise
          load<L>(ctp, p.prev_ct, 0, B, b);
          add_foot_dynamics<T, S, M, L>(c, Rp, ctp, A_d, Q_d);
        }
        matmul<3, 3, 3>(Rp, c.Q_vo_p, tmp9);
        matmul_nt<3, 3, 3>(tmp9, Rp, Qcn);
      }

      store<SS>(p.A_dyn, (size_t)pN2 * SS, B, b, A_d);
      store<S>(p.b_dyn, (size_t)pN2 * S, B, b, b_d);
      store<SS>(p.Q_dyn, (size_t)pN2 * SS, B, b, Q_d);
      store<9>(p.Q_cam, (size_t)pN2 * 9, B, b, Qcn);
      fill<3>(p.b_cam, (size_t)pN2 * 3, B, b, T(0));
      st(p.cam_act, (size_t)pN2, B, b, T(0));

      // cache update for pN2: its measurement terms were cached when it was
      // the newest slot one tick earlier; add the fresh dynamics terms
      T AtQd_n[SS], tS[SS], tv[S], cur[SS], curv[S];
      matmul_tn<S, S, S>(A_d, Q_d, AtQd_n);
      matmul<S, S, S>(AtQd_n, A_d, tS);
      load<SS>(cur, p.Dslot, (size_t)pN2 * SS, B, b);
      DEM_UNROLL
      for (int k = 0; k < SS; ++k) { cur[k] += tS[k]; tS[k] = -AtQd_n[k]; }
      store<SS>(p.Dslot, (size_t)pN2 * SS, B, b, cur);
      store<SS>(p.Ub, (size_t)pN2 * SS, B, b, tS);
      matvec<S, S>(AtQd_n, b_d, tv);
      load<S>(curv, p.routb, (size_t)pN2 * S, B, b);
      DEM_UNROLL
      for (int k = 0; k < S; ++k) curv[k] += tv[k];
      store<S>(p.routb, (size_t)pN2 * S, B, b, curv);
    }
    if (lead) {
      T Rt[9], acc[3], om[3], pf[L * 3], Jf[L * 9], dqv[L * 3], ct[L];
      load<9>(Rt, p.R, (size_t)i * 9, B, b);
      load<3>(acc, p.accel, (size_t)i * 3, B, b);
      load<3>(om, p.omega, (size_t)i * 3, B, b);
      load<L * 3>(pf, p.pfoot, (size_t)i * L * 3, B, b);
      load<L * 9>(Jf, p.Jfoot, (size_t)i * L * 9, B, b);
      load<L * 3>(dqv, p.dq, (size_t)i * L * 3, B, b);
      load<L>(ct, p.contact, (size_t)i * L, B, b);
      T y_T[M], Q_T[MM];
      if constexpr (ABL == ABL_BUILD) {   // the fresh measurement: zeros
        for (int k = 0; k < M; ++k) y_T[k] = T(0);
        for (int k = 0; k < MM; ++k) Q_T[k] = T(0);
      } else if constexpr (LOT == 1) {
        build_measurement_pos<T, S, M, L>(c, Rt, pf, Jf, y_T, Q_T);
      } else {
        build_measurement<T, S, M, L>(c, Rt, om, pf, Jf, dqv, ct, y_T, Q_T);
      }

      store<M>(p.y_meas, (size_t)pN1 * M, B, b, y_T);
      store<MM>(p.Q_meas, (size_t)pN1 * MM, B, b, Q_T);
      fill<SS>(p.A_dyn, (size_t)pN1 * SS, B, b, T(0));
      fill<S>(p.b_dyn, (size_t)pN1 * S, B, b, T(0));
      fill<SS>(p.Q_dyn, (size_t)pN1 * SS, B, b, T(0));
      fill<3>(p.b_cam, (size_t)pN1 * 3, B, b, T(0));
      fill<9>(p.Q_cam, (size_t)pN1 * 9, B, b, T(0));
      st(p.cam_act, (size_t)pN1, B, b, T(0));

      // cache for the fresh slot pN1: measurement terms only
      T HtR[S * M], tS[SS], tv[S];
      matmul_tn<M, S, M>(c.H, Q_T, HtR);
      matmul<S, M, S>(HtR, c.H, tS);
      matvec<S, M>(HtR, y_T, tv);
      store<SS>(p.Dslot, (size_t)pN1 * SS, B, b, tS);
      fill<SS>(p.Ub, (size_t)pN1 * SS, B, b, T(0));
      store<S>(p.routb, (size_t)pN1 * S, B, b, tv);

      // previous-tick inputs for the next interval's dynamics
      T acc_s[3];
      matvec<3, 3>(Rt, acc, acc_s);
      DEM_UNROLL
      for (int k = 0; k < 3; ++k) acc_s[k] += c.gravity[k];
      store<9>(p.prev_R, 0, B, b, Rt);
      store<3>(p.prev_acc, 0, B, b, acc_s);
      store<L>(p.prev_ct, 0, B, b, ct);
    }
    if constexpr (CON) {
      // warm-start shift: the fresh slot (new logical N-1 = physical pN1)
      // reuses the previous newest iterate (old logical N-1 = physical pN2)
      if (lead) {
        T v[S];
        load<S>(v, q->z_adm, (size_t)pN2 * S, B, b);
        store<S>(q->z_adm, (size_t)pN1 * S, B, b, v);
        load<S>(v, q->y_adm, (size_t)pN2 * S, B, b);
        store<S>(q->y_adm, (size_t)pN1 * S, B, b, v);
      }
      if constexpr (ABL == ABL_ASSEMBLY) {
        // no normal equations and no ADMM: the arrival cost's vector stands
        // in for x, once lane 0 has written it
        __syncwarp(grp.mask);
        if (lead) q->iters[(size_t)i * B + b] = 0;
        if (grp.ln < S) st(p.x, (size_t)i * S + grp.ln, B, b, ld(p.n_p, grp.ln, B, b));
        __syncwarp(grp.mask);   // read before lane 0's next tick writes it
        continue;
      }
    }

    // ---- masked normal equations + streaming forward block-Thomas ---------
    const int n_states = (t + 1 < N) ? t + 1 : N;
    const int first = N - n_states;
    T Sinv[SS], yv[S], U_prev[SS], prev_QdPP[SS], prev_rin[S];
    T Lc[CHOL ? S * (S + 1) / 2 : 1], rd[CHOL ? S : 1];   // the Cholesky tail's factor
    T Mp[SS], np_[S];
    if (lead) {
      load<SS>(Mp, p.M_p, 0, B, b);
      load<S>(np_, p.n_p, 0, B, b);
    }
    if (lead)   // CON: lane 0 assembles the masked system for the group
    for (int j = 0; j < N; ++j) {
      const int pj = (base_new + j) % N;
      const bool valid = j >= first;
      const bool iv = valid && (j <= N - 2);
      T Qd[SS], bj[S], Qc[9], c0[3], PtQc[S * 3], PtQcP[SS];
      load<SS>(Qd, p.Q_dyn, (size_t)pj * SS, B, b);
      load<S>(bj, p.b_dyn, (size_t)pj * S, B, b);
      load<9>(Qc, p.Q_cam, (size_t)pj * 9, B, b);
      load<3>(c0, p.b_cam, (size_t)pj * 3, B, b);
      const T act = iv ? ld(p.cam_act, (size_t)pj, B, b) : T(0);
      matmul_tn<3, S, 3>(c.Pc, Qc, PtQc);
      DEM_UNROLL
      for (int k = 0; k < S * 3; ++k) PtQc[k] *= act;
      matmul<S, 3, S>(PtQc, c.Pc, PtQcP);
      if (!iv) {
        DEM_UNROLL
        for (int k = 0; k < SS; ++k) Qd[k] = T(0);
      }
      T Qd_b[S], PtQc_c[S];
      matvec<S, S>(Qd, bj, Qd_b);
      matvec<S, 3>(PtQc, c0, PtQc_c);

      T D_j[SS], r_j[S], U_j[SS];
      load<SS>(D_j, p.Dslot, (size_t)pj * SS, B, b);
      load<S>(r_j, p.routb, (size_t)pj * S, B, b);
      load<SS>(U_j, p.Ub, (size_t)pj * SS, B, b);
      DEM_UNROLL
      for (int k = 0; k < SS; ++k) D_j[k] += PtQcP[k];
      DEM_UNROLL
      for (int k = 0; k < S; ++k) r_j[k] += PtQc_c[k];
      if (j > 0) {
        DEM_UNROLL
        for (int k = 0; k < SS; ++k) D_j[k] += prev_QdPP[k];
        DEM_UNROLL
        for (int k = 0; k < S; ++k) r_j[k] -= prev_rin[k];
      }
      if (j == first) {
        DEM_UNROLL
        for (int k = 0; k < SS; ++k) D_j[k] += Mp[k];
        DEM_UNROLL
        for (int k = 0; k < S; ++k) r_j[k] -= np_[k];
      }
      DEM_UNROLL
      for (int k = 0; k < SS; ++k) prev_QdPP[k] = Qd[k] + PtQcP[k];
      DEM_UNROLL
      for (int k = 0; k < S; ++k) prev_rin[k] = Qd_b[k] + PtQc_c[k];
      if (!valid) {
        DEM_UNROLL
        for (int k = 0; k < SS; ++k) D_j[k] = T(0);
        DEM_UNROLL
        for (int k = 0; k < S; ++k) { D_j[k * S + k] = T(1); r_j[k] = T(0); }
      }
      const bool u_on = iv && (j + 1 >= first);
      DEM_UNROLL
      for (int k = 0; k < SS; ++k) U_j[k] = u_on ? (U_j[k] - PtQcP[k]) : T(0);

      if constexpr (CON) {
        // collect the masked system for the whole-window ADMM below
        store<SS>(q->Dw, (size_t)j * SS, B, b, D_j);
        store<S>(q->rw, (size_t)j * S, B, b, r_j);
        if (j < N - 1) store<SS>(q->Uw, (size_t)j * SS, B, b, U_j);
      } else if constexpr (CHOL) {
        chol_step<T, S>(j, D_j, r_j, U_prev, Lc, rd, yv);
      } else if (j == 0) {
        gj_inv<S>(D_j, Sinv);
        DEM_UNROLL
        for (int k = 0; k < S; ++k) yv[k] = r_j[k];
      } else {
        T W[SS], UtW[SS], t1[S], t2[S];
        matmul<S, S, S>(Sinv, U_prev, W);
        matmul_tn<S, S, S>(U_prev, W, UtW);
        DEM_UNROLL
        for (int k = 0; k < SS; ++k) D_j[k] -= UtW[k];
        matvec<S, S>(Sinv, yv, t1);
        matvec_t<S, S>(U_prev, t1, t2);
        DEM_UNROLL
        for (int k = 0; k < S; ++k) yv[k] = r_j[k] - t2[k];
        gj_inv<S>(D_j, Sinv);
      }
      if constexpr (!CON) {
        DEM_UNROLL
        for (int k = 0; k < SS; ++k) U_prev[k] = U_j[k];
      }
    }
    T xT[S];
    if constexpr (CON) {
      // whole-window box-ADMM by the group, warm-started from and written
      // back to the z/y ring (logical slot j at physical (base_new + j) % N),
      // once lane 0 has assembled the system and shifted the ring
      __syncwarp(grp.mask);
      const int its = admm_box_solve_group<T, S, USH>(grp, q->Dw, q->Uw, q->rw, q->z_adm,
                                                      q->y_adm, q->admm, lbi, ubi, base_new);
      if (lead) q->iters[(size_t)i * B + b] = its;
      if (grp.ln < S)   // x_{N-1}, each lane its element
        st(p.x, (size_t)i * S + grp.ln, B, b,
           grp.sm[BoxLayout<T, S, USH>::x(N) + (N - 1) * S + grp.ln]);
      __syncwarp(grp.mask);   // the ring written back before lane 0's next tick
      continue;
    } else if constexpr (CHOL) {
      T z[S];
      trsv_l<S>(Lc, rd, yv, z);
      trsv_lt<S>(Lc, rd, z, xT);
    } else {
      matvec<S, S>(Sinv, yv, xT);   // logical N-1 = newest state
    }
    store<S>(p.x, (size_t)i * S, B, b, xT);
  }

  if (!lead) return;   // CON, GRP: the schedule is lane 0's
  if constexpr (PI) {
    store<4>(p.bez_times_out, 0, B, b, bt);
    p.bez_count_out[b] = bcount;
  } else if (b == 0) {
    for (int k = 0; k < 4; ++k) p.bez_times_out[k] = bt[k];
    p.bez_count_out[0] = bcount;
  }
}

// The tick's operands from the C entry point's arrays: ptrs, the 34 pointers
// of MhePtrs in declaration order; consts (double), as mhe_launch lists them.
template <typename T>
MhePtrs<T> mhe_ptrs(void* const* ptrs) {
  MhePtrs<T> p;
  int q = 0;
  p.vo_active = (const int*)ptrs[q++];
  p.vo_tick_pre = (const int*)ptrs[q++];
  p.vo_tick_now = (const int*)ptrs[q++];
  p.bez_times_in = (const T*)ptrs[q++];
  p.bez_count_in = (const int*)ptrs[q++];
  p.R = (const T*)ptrs[q++];
  p.accel = (const T*)ptrs[q++];
  p.omega = (const T*)ptrs[q++];
  p.pfoot = (const T*)ptrs[q++];
  p.Jfoot = (const T*)ptrs[q++];
  p.dq = (const T*)ptrs[q++];
  p.contact = (const T*)ptrs[q++];
  p.vo_inc = (const T*)ptrs[q++];
  p.y_meas = (T*)ptrs[q++];
  p.Q_meas = (T*)ptrs[q++];
  p.A_dyn = (T*)ptrs[q++];
  p.b_dyn = (T*)ptrs[q++];
  p.Q_dyn = (T*)ptrs[q++];
  p.b_cam = (T*)ptrs[q++];
  p.Q_cam = (T*)ptrs[q++];
  p.cam_act = (T*)ptrs[q++];
  p.M_p = (T*)ptrs[q++];
  p.n_p = (T*)ptrs[q++];
  p.bez_pts = (T*)ptrs[q++];
  p.p_accum = (T*)ptrs[q++];
  p.prev_R = (T*)ptrs[q++];
  p.prev_acc = (T*)ptrs[q++];
  p.prev_ct = (T*)ptrs[q++];
  p.Dslot = (T*)ptrs[q++];
  p.Ub = (T*)ptrs[q++];
  p.routb = (T*)ptrs[q++];
  p.x = (T*)ptrs[q++];
  p.bez_times_out = (T*)ptrs[q++];
  p.bez_count_out = (int*)ptrs[q++];

  return p;
}

template <typename T, int S, int M, int LOT>
MheConstsFor<T, S, M, LOT> mhe_consts(const double* consts) {
  MheConstsFor<T, S, M, LOT> c;
  int k = 0;
  c.dt = (T)consts[k++];
  for (int i = 0; i < M * S; ++i) c.H[i] = (T)consts[k++];
  for (int i = 0; i < 3 * S; ++i) c.Pc[i] = (T)consts[k++];
  T* nine[8] = {c.Q_vo_p, c.C_p, c.C_accel, c.Q_accel_bias,
                c.C_enc_pos, c.C_enc_vel, c.C_gyro, c.Q_foot_swing};
  for (int a = 0; a < 8; ++a)
    for (int i = 0; i < 9; ++i) nine[a][i] = (T)consts[k++];
  for (int i = 0; i < 3; ++i) c.gravity[i] = (T)consts[k++];
  if constexpr (LOT == 1)
    for (int i = 0; i < 9; ++i) c.Q_foot_slide[i] = (T)consts[k++];
  return c;
}

// The kernels and their launch need nvcc; a host build of the tick body
// (tests/box_group_host/tick_harness.cpp) stops here.
#ifdef __CUDACC__

// The unconstrained ticks on either clock, with either tail: group_size<S>()
// threads per instance, a group beyond the fleet leaving whole.
template <typename T, int S, int M, int L, int LOT>
__global__ void mhe_kernel(MhePtrs<T> p, MheConstsFor<T, S, M, LOT> c, int N, int B,
                           int Tn, int t0) {
  constexpr int G = group_size<S>();
  const int b = blockIdx.x * (blockDim.x / G) + box_slot<G>();
  if (b >= B) return;
  mhe_body<T, S, M, L, LOT, false, false, false, ABL_NONE, true>(p, c, nullptr, N, B, Tn, t0, b);
}

template <typename T, int S, int M, int L, int LOT>
__global__ void mhe_box_kernel(MhePtrs<T> p, MheConstsFor<T, S, M, LOT> c, MheBox<T> q,
                               int N, int B, int Tn, int t0) {
  // group_size<S>() threads per instance; a group beyond the fleet leaves whole
  constexpr int G = group_size<S>();
  const int b = blockIdx.x * (blockDim.x / G) + box_slot<G>();
  if (b >= B) return;
  mhe_body<T, S, M, L, LOT, true, false>(p, c, &q, N, B, Tn, t0, b);
}

template <typename T, int S, int M, int L, int LOT>
__global__ void mhe_pi_kernel(MhePtrs<T> p, MheConstsFor<T, S, M, LOT> c, int N, int B,
                              int Tn, int t0) {
  constexpr int G = group_size<S>();
  const int b = blockIdx.x * (blockDim.x / G) + box_slot<G>();
  if (b >= B) return;
  mhe_body<T, S, M, L, LOT, false, true, false, ABL_NONE, true>(p, c, nullptr, N, B, Tn, t0, b);
}

template <typename T, int S, int M, int L, int LOT>
__global__ void mhe_pi_box_kernel(MhePtrs<T> p, MheConstsFor<T, S, M, LOT> c, MheBox<T> q,
                                  int N, int B, int Tn, int t0) {
  // group_size<S>() threads per instance; a group beyond the fleet leaves whole
  constexpr int G = group_size<S>();
  const int b = blockIdx.x * (blockDim.x / G) + box_slot<G>();
  if (b >= B) return;
  mhe_body<T, S, M, L, LOT, true, true>(p, c, &q, N, B, Tn, t0, b);
}

template <typename T, int S, int M, int L, int LOT>
__global__ void mhe_chol_kernel(MhePtrs<T> p, MheConstsFor<T, S, M, LOT> c, int N, int B,
                                int Tn, int t0) {
  constexpr int G = group_size<S>();
  const int b = blockIdx.x * (blockDim.x / G) + box_slot<G>();
  if (b >= B) return;
  mhe_body<T, S, M, L, LOT, false, false, true, ABL_NONE, true>(p, c, nullptr, N, B, Tn, t0,
                                                                b);
}

template <typename T, int S, int M, int L, int LOT>
__global__ void mhe_pi_chol_kernel(MhePtrs<T> p, MheConstsFor<T, S, M, LOT> c, int N, int B,
                                   int Tn, int t0) {
  constexpr int G = group_size<S>();
  const int b = blockIdx.x * (blockDim.x / G) + box_slot<G>();
  if (b >= B) return;
  mhe_body<T, S, M, L, LOT, false, true, true, ABL_NONE, true>(p, c, nullptr, N, B, Tn, t0,
                                                               b);
}

// The stage ablation: a tick with stage ABL skipped, on the group as the
// tick it ablates. The Gauss-Jordan tick on the shared clock ...
template <typename T, int S, int M, int L, int LOT, int ABL>
__global__ void mhe_abl_kernel(MhePtrs<T> p, MheConstsFor<T, S, M, LOT> c, int N, int B,
                               int Tn, int t0) {
  constexpr int G = group_size<S>();
  const int b = blockIdx.x * (blockDim.x / G) + box_slot<G>();
  if (b >= B) return;
  mhe_body<T, S, M, L, LOT, false, false, false, ABL, true>(p, c, nullptr, N, B, Tn, t0, b);
}

// ... on a clock per lane ...
template <typename T, int S, int M, int L, int LOT, int ABL>
__global__ void mhe_pi_abl_kernel(MhePtrs<T> p, MheConstsFor<T, S, M, LOT> c, int N, int B,
                                  int Tn, int t0) {
  constexpr int G = group_size<S>();
  const int b = blockIdx.x * (blockDim.x / G) + box_slot<G>();
  if (b >= B) return;
  mhe_body<T, S, M, L, LOT, false, true, false, ABL, true>(p, c, nullptr, N, B, Tn, t0, b);
}

// ... the Cholesky tick on either clock ...
template <typename T, int S, int M, int L, int LOT, bool PI, int ABL>
__global__ void mhe_chol_abl_kernel(MhePtrs<T> p, MheConstsFor<T, S, M, LOT> c, int N, int B,
                                    int Tn, int t0) {
  constexpr int G = group_size<S>();
  const int b = blockIdx.x * (blockDim.x / G) + box_slot<G>();
  if (b >= B) return;
  mhe_body<T, S, M, L, LOT, false, PI, true, ABL, true>(p, c, nullptr, N, B, Tn, t0, b);
}

// ... and the constrained tick on either clock (the skips in lane 0's prelude)
template <typename T, int S, int M, int L, int LOT, bool PI, int ABL>
__global__ void mhe_box_abl_kernel(MhePtrs<T> p, MheConstsFor<T, S, M, LOT> c, MheBox<T> q,
                                   int N, int B, int Tn, int t0) {
  constexpr int G = group_size<S>();
  const int b = blockIdx.x * (blockDim.x / G) + box_slot<G>();
  if (b >= B) return;
  mhe_body<T, S, M, L, LOT, true, PI, false, ABL>(p, c, &q, N, B, Tn, t0, b);
}

// ... and of the unconstrained group tick: block / group_size<S>()
// instances of TickLayout::stride scalars (mhe_replay_kernel.py's
// tick_geometry computes the same bytes)
template <typename T, int S, int M>
DEM_HHD size_t tick_shared_bytes(int block) {
  return (size_t)(block / group_size<S>()) * TickLayout<T, S, M>::stride() * sizeof(T);
}

// the constrained kernel of a clock, or with stage ABL skipped
template <typename T, int S, int M, int L, int LOT, bool PI, int ABL = ABL_NONE>
auto mhe_box_entry() {
  if constexpr (ABL != ABL_NONE) return &mhe_box_abl_kernel<T, S, M, L, LOT, PI, ABL>;
  else if constexpr (PI) return &mhe_pi_box_kernel<T, S, M, L, LOT>;
  else return &mhe_box_kernel<T, S, M, L, LOT>;
}

// the unconstrained kernel of a clock and a tail, or with stage ABL skipped
template <typename T, int S, int M, int L, int LOT, bool PI, bool CHOL, int ABL = ABL_NONE>
auto mhe_tick_entry() {
  if constexpr (ABL != ABL_NONE && CHOL) return &mhe_chol_abl_kernel<T, S, M, L, LOT, PI, ABL>;
  else if constexpr (ABL != ABL_NONE && PI) return &mhe_pi_abl_kernel<T, S, M, L, LOT, ABL>;
  else if constexpr (ABL != ABL_NONE) return &mhe_abl_kernel<T, S, M, L, LOT, ABL>;
  else if constexpr (CHOL && PI) return &mhe_pi_chol_kernel<T, S, M, L, LOT>;
  else if constexpr (CHOL) return &mhe_chol_kernel<T, S, M, L, LOT>;
  else if constexpr (PI) return &mhe_pi_kernel<T, S, M, L, LOT>;
  else return &mhe_kernel<T, S, M, L, LOT>;
}

// ... of the constrained kernel of this instantiation at N slots (csrc/mhe.cu's
// dem_mhe_geometry), out[6] = U in shared memory (1) or not (0)
template <typename T, int S, int M, int L, int LOT, bool PI>
int mhe_box_geometry(int N, int block, int* out) {
  const int err = group_geometry<group_size<S>()>(mhe_box_entry<T, S, M, L, LOT, PI>(),
                                                  box_shared_bytes<T, S>(N, block), block, out);
  if (!err) out[6] = box_u_shared<S>() ? 1 : 0;
  return err;
}

// The same figures of the unconstrained group tick with its tail (out[6] =
// 0).
template <typename T, int S, int M, int L, int LOT, bool PI, bool CHOL>
int mhe_tick_geometry(int block, int* out) {
  const int err = group_geometry<group_size<S>()>(mhe_tick_entry<T, S, M, L, LOT, PI, CHOL>(),
                                                  tick_shared_bytes<T, S, M>(block), block, out);
  if (!err) out[6] = 0;
  return err;
}

// One instantiation of the tick: S, M, L, LOT the model shape, CON selects the
// constrained kernel, PI the per-lane camera clock, CHOL the Cholesky tail
// (unconstrained only), ABL the stage ablation (any of them; constrained, not
// the solve stage). ptrs: the 34 pointers of
// MhePtrs in declaration order. consts (double): dt, H[m*s], Pc[3*s], then
// Q_vo_p, C_p, C_accel, Q_accel_bias, C_enc_pos, C_enc_vel, C_gyro,
// Q_foot_swing (9 each), gravity[3], Q_foot_slide[9] (read for LOT == 1).
// box_ptrs (CON; else unused): lb, ub, z_adm, y_adm, iters, then
// the scratch Dw, Uw, rw; ints/reals as admm_settings reads them. The
// constrained kernels take `block` threads per block, a multiple of
// group_size<S>(),
// and box_shared_bytes of dynamic shared memory, the unconstrained ones,
// ablated or not, likewise with tick_shared_bytes; the
// error of a launch the card refuses (too many threads, too much shared
// memory) is returned.
template <typename T, int S, int M, int L, int LOT, bool CON, bool PI, bool CHOL,
          int ABL = ABL_NONE>
int mhe_launch(void* const* ptrs, const double* consts, void* const* box_ptrs,
               const int* ints, const double* reals, int N, int B, int Tn,
               int t0, int block, void* stream) {
  const MhePtrs<T> p = mhe_ptrs<T>(ptrs);
  const MheConstsFor<T, S, M, LOT> c = mhe_consts<T, S, M, LOT>(consts);
  static_assert(!CHOL || !CON, "the Cholesky tail runs unconstrained");
  static_assert(!CON || ABL != ABL_SOLVE, "the constrained tick has no solve stage to ablate");
  constexpr int G = group_size<S>();
  if constexpr (!CON) {
    const auto kern = mhe_tick_entry<T, S, M, L, LOT, PI, CHOL, ABL>();
    size_t shmem = 0;
    const int err = box_launch_shape<G>(kern, tick_shared_bytes<T, S, M>(block), block, &shmem);
    if (err) return err;
    const int ipb = block / G;
    kern<<<(B + ipb - 1) / ipb, block, shmem, (cudaStream_t)stream>>>(p, c, N, B, Tn, t0);
  } else {
    MheBox<T> bx;
    int q = 0;
    bx.lb = (const T*)box_ptrs[q++];
    bx.ub = (const T*)box_ptrs[q++];
    bx.z_adm = (T*)box_ptrs[q++];
    bx.y_adm = (T*)box_ptrs[q++];
    bx.iters = (int*)box_ptrs[q++];
    bx.Dw = (T*)box_ptrs[q++];
    bx.Uw = (T*)box_ptrs[q++];
    bx.rw = (T*)box_ptrs[q++];
    bx.admm = admm_settings<T>(ints, reals);
    const auto kern = mhe_box_entry<T, S, M, L, LOT, PI, ABL>();
    size_t shmem = 0;
    const int err = box_launch_shape<G>(kern, box_shared_bytes<T, S>(N, block), block, &shmem);
    if (err) return err;
    const int ipb = block / G;
    kern<<<(B + ipb - 1) / ipb, block, shmem, (cudaStream_t)stream>>>(p, c, bx, N, B, Tn, t0);
  }
  return (int)cudaGetLastError();
}

#endif  // __CUDACC__

}  // namespace dem
