// The solve stage of the vision step in one launch: a frame's detections
// to its robot pose, as chalkydri_tpu_torch/pipeline.py::FrameSolver
// (forward_plain, through solver/robot_pose.py::solve_robot_pose)
// computes it in plain PyTorch.
//
// It replaces no TPU kernel: the JAX package's solver is plain jnp under
// jit, which XLA fuses. It was added because the plain chain is ~4,700
// tiny nodes of the replayed CUDA graph (the 20 undistortion steps, the
// 9x9 elimination, 4 subspace steps, 25 Jacobi rounds, 15 masked Newton
// steps of 8 candidates), each a launch of about 1.25 us on the card for
// a few hundred flops: the stage took 5.9 ms of a ~10 ms step.
//
// What bounds it: a frame is a few KB of state and about half a million
// operations, ~0.02 us by bytes or operations alone. The floor is the
// chain of dependent small steps (20 + 9 + 4 + 25 + 15 of them, each a
// short sequence of dependent multiply-adds and divisions; ~0.1 ms at
// [2, 16] on an H100), so the design keeps each chain on chip and cuts
// barriers, not bytes:
//   - one CTA a frame; every intermediate (rays, points, omega, its
//     inverse, the 9x5 basis, the candidates) stays in shared memory and
//     registers, nothing goes back to device memory between phases;
//   - phases split by __syncthreads: a thread a corner for the
//     undistortion, a thread a matrix entry for the linear system, the
//     9x18 elimination and the subspace products;
//   - one warp for the orthonormalizations and the Jacobi rounds (lanes
//     over rows or entries, __syncwarp between steps);
//   - a warp a candidate for nearest_so3 (lane 0) and the Newton steps
//     (lanes over the 6x9 and 6x6 products and the 6x7 elimination);
//   - the eliminations step from one buffer into another, one barrier a
//     step;
//   - one thread for the choice of candidate, the robot pose, the
//     std-devs and the gyro pivot.
//
// Numerics: the same work as the plain chain at the same precision and
// in the same order, so that on the card the result is the plain chain's
// bit for bit. Every rounding the plain chain makes is made here by
// __f*_rn / __d*_rn intrinsics, which nvcc never contracts; fma appears
// only where the plain chain's own kernel uses one. The orders are those
// of PyTorch's kernels on the card at the step's shape [2, 16] (torch
// 2.11, cuBLAS 12.8, read off a record of every op of the plain chain).
// They are the libraries' choices, not a contract: at B = 1 cuBLAS picks
// other kernels and the two differ in the last bits, and another torch or
// cuBLAS may do so at [2, 16] too (chip_smoke.py fails on that):
//   - a matrix product with more than one output column (cuBLAS gemm):
//     one fma chain over k from 0 (chain);
//   - a matrix-vector product (cuBLAS gemv): for a row-major matrix two
//     chains over the halves of k, added (gemv_rows); for a transposed
//     one, chains over runs of 4, added in order (gemv_cols);
//   - a sum over a contiguous last dim (ATen's reduce, block_x): lane t
//     of last_pow2(R) (at most 32) sums t, t + width, ..., lanes folded by
//     halving offsets (sum_lanes); a sum over a strided dim: one thread,
//     four accumulators over k mod 4, folded in order (sum_serial);
//   - a division by a Python number is a product with its reciprocal.
// Templated on float (the step) and double (held to the float64 oracle
// in the checks). Tags per frame at most MAX_TAGS; the threads of a CTA
// are a pure function of the tag count (ops/solve.py::solve_threads).

#include <cuda_runtime.h>
#include <stdint.h>

#include "ordered.cuh"

namespace {

constexpr int MAX_TAGS = 64;
constexpr int BLOCK = 5;        // the subspace basis (smallest_eigvecs)
constexpr int MAX_CAND = 2 * BLOCK;
constexpr int SWEEPS = 5;       // _jacobi_eigh_small

template <typename T> __device__ __forceinline__ T dot3(const T* a, const T* b) {
  return sum3(mul(a[0], b[0]), mul(a[1], b[1]), mul(a[2], b[2]));
}
template <typename T> __device__ __forceinline__ T norm3(const T* a) {
  return sqr(dot3(a, a));
}
template <typename T> __device__ __forceinline__ void cross(const T* a, const T* b, T* out) {
  out[0] = sub(mul(a[1], b[2]), mul(a[2], b[1]));
  out[1] = sub(mul(a[2], b[0]), mul(a[0], b[2]));
  out[2] = sub(mul(a[0], b[1]), mul(a[1], b[0]));
}
template <typename T> __device__ __forceinline__ T det3(const T* m) {
  T c[3];
  cross(m + 3, m + 6, c);
  return dot3(m, c);
}
template <typename T> __device__ __forceinline__ T dot9(const T* a, const T* b) {
  return sum_lanes<9, T>([&](int k) { return mul(a[k], b[k]); });
}
// amax / amin over n values; a NaN anywhere gives NaN.
template <typename T> __device__ T amax(const T* x, int n) {
  T m = x[0];
  for (int i = 1; i < n && m == m; ++i) m = (x[i] != x[i] || x[i] > m) ? x[i] : m;
  return m;
}
template <typename T> __device__ T amin(const T* x, int n) {
  T m = x[0];
  for (int i = 1; i < n && m == m; ++i) m = (x[i] != x[i] || x[i] < m) ? x[i] : m;
  return m;
}
// solver/sqpnp.py::_first_index of x == max (min): NaN matches nothing.
template <typename T> __device__ int first_equal(const T* x, int n, T m) {
  for (int i = 0; i < n; ++i)
    if (x[i] == m) return i;
  return 0;
}
template <typename T> __device__ int argmax_first(const T* x, int n) {
  return first_equal(x, n, amax(x, n));
}
template <typename T> __device__ int argmin_first(const T* x, int n) {
  return first_equal(x, n, amin(x, n));
}

// ---- the plain chain's routines, one frame or one candidate ----

// _analytic_eigh3's eigvec: a unit eigenvector of the symmetric 3x3 a for
// eigenvalue lam, the longest cross product of the rows of a - lam I.
template <typename T> __device__ void eigvec3(const T* a, T lam, T* out) {
  T m[9], cs[9], n2[3];
  for (int e = 0; e < 9; ++e) m[e] = sub(a[e], mul(lam, T(e % 4 == 0)));
  cross(m + 0, m + 3, cs + 0);
  cross(m + 3, m + 6, cs + 3);
  cross(m + 6, m + 0, cs + 6);
  for (int i = 0; i < 3; ++i) n2[i] = dot3(cs + 3 * i, cs + 3 * i);
  const T* v = cs + 3 * argmax_first(n2, 3);
  const T nv = norm3(v);
  const T d = clamp_min(nv, T(1e-30));
  for (int i = 0; i < 3; ++i) out[i] = nv > T(1e-30) ? dv(v[i], d) : T(i == 0);
}

// solver/sqpnp.py::_analytic_eigh3: the eigenvectors of the symmetric 3x3
// a as the columns of v, for the eigenvalues in descending order.
template <typename T> __device__ void eigh3(const T* a, T* v) {
  const T third = dv(T(1), T(3));
  const T q = mul(sum3(a[0], a[4], a[8]), third);
  T b[9];
  for (int e = 0; e < 9; ++e) b[e] = sub(a[e], mul(q, T(e % 4 == 0)));
  const T p2 = mul(sum_lanes<9, T>([&](int k) { return mul(b[k], b[k]); }), dv(T(1), T(6)));
  const T p = sqr(clamp_min(p2, T(0)));
  const T sp = clamp_min(p, T(1e-30));
  const T r = clamp(dv(det3(b), mul(mul(mul(T(2), sp), sp), sp)), T(-1), T(1));
  const T phi = mul(arccos(r), third);
  const T lam1 = add(q, mul(mul(T(2), p), cosine(phi)));
  const T lam3 = add(q, mul(mul(T(2), p), cosine(add(phi, T(2.0943951023931953)))));
  T v1[3], v3r[3], w3[3], fb[3], v3[3], v2[3], av[3];
  eigvec3(a, lam1, v1);
  eigvec3(a, lam3, v3r);
  const T d13 = dot3(v1, v3r);
  for (int i = 0; i < 3; ++i) w3[i] = sub(v3r[i], mul(d13, v1[i]));
  const T nw3 = norm3(w3);
  for (int i = 0; i < 3; ++i) av[i] = absval(v1[i]);
  const int kmin = argmin_first(av, 3);
  T ek[3] = {T(kmin == 0), T(kmin == 1), T(kmin == 2)};
  const T dk = dot3(v1, ek);
  for (int i = 0; i < 3; ++i) fb[i] = sub(ek[i], mul(dk, v1[i]));
  const T nfb = clamp_min(norm3(fb), T(1e-30));
  for (int i = 0; i < 3; ++i) fb[i] = dv(fb[i], nfb);
  const T dw = clamp_min(nw3, T(1e-30));
  for (int i = 0; i < 3; ++i) v3[i] = nw3 > T(1e-6) ? dv(w3[i], dw) : fb[i];
  cross(v3, v1, v2);
  for (int i = 0; i < 3; ++i) {
    v[3 * i + 0] = v1[i];
    v[3 * i + 1] = v2[i];
    v[3 * i + 2] = v3[i];
  }
}

// solver/sqpnp.py::nearest_so3 of one column-major 9-vector.
template <typename T> __device__ void nearest_so3(const T* rv, T* out) {
  T m[9], mtm[9], vs[9], a1[3], a2[3], u1[3], w2[3], pr[9], cn[3], fb2[3], u2[3], u3[3];
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) m[3 * i + j] = rv[3 * j + i];
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j)
      mtm[3 * i + j] = chain<T>(0, 3, [&](int k) { return m[3 * k + i]; },
                                [&](int k) { return m[3 * k + j]; });
  eigh3(mtm, vs);
  for (int i = 0; i < 3; ++i) {
    a1[i] = chain<T>(0, 3, [&](int k) { return m[3 * i + k]; }, [&](int k) { return vs[3 * k]; });
    a2[i] = chain<T>(0, 3, [&](int k) { return m[3 * i + k]; }, [&](int k) { return vs[3 * k + 1]; });
  }
  const T n1 = norm3(a1);
  const T scale = clamp_min(n1, T(1e-20));
  for (int i = 0; i < 3; ++i) u1[i] = n1 > T(1e-12) ? dv(a1[i], scale) : T(i == 0);
  const T d12 = dot3(u1, a2);
  for (int i = 0; i < 3; ++i) w2[i] = sub(a2[i], mul(d12, u1[i]));
  const T n2 = norm3(w2);
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) pr[3 * i + j] = sub(T(i == j), mul(u1[i], u1[j]));
  for (int j = 0; j < 3; ++j)  // column norms: a sum over a strided dim
    cn[j] = sqr(sum_serial<T>(3, [&](int i) { return mul(pr[3 * i + j], pr[3 * i + j]); }));
  const int jm = argmax_first(cn, 3);
  const T dmax = clamp_min(amax(cn, 3), T(1e-20));
  for (int i = 0; i < 3; ++i) fb2[i] = dv(pr[3 * i + jm], dmax);
  const T dn2 = clamp_min(n2, T(1e-20));
  const bool take = n2 > mul(scale, T(1e-5));
  for (int i = 0; i < 3; ++i) u2[i] = take ? dv(w2[i], dn2) : fb2[i];
  cross(u1, u2, u3);
  const T* us[3] = {u1, u2, u3};
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j)  // rot = u_s @ v_s^T; out = rot^T, row-major
      out[3 * j + i] = chain<T>(0, 3, [&](int k) { return us[k][i]; },
                                [&](int k) { return vs[3 * j + k]; });
}

// ---- shared memory ----

template <typename T>
struct Cand {
  T r[9], h[6], jac[54], rhs1[9], b[54], aug[2][42], tmp[9], delta[9], g[9];
  T energy, penalized, plaus, score, tall[3];
};

template <typename T>
struct Frame {
  T q_tt[9], qinv[9], q_rt[27], q_rr[81], tmp27[27], omega[81];
  T aug[2][9 * 18], winv[81];
  T x[45], y[45], ox[45];
  T a[25], ga[25], v[2][25], g[25];
  T basis[9 * BLOCK], prod[9];
  T cen[3], tcen[3], eps, cosg, sing;
  int npts, ntag, order[BLOCK];
};

template <typename T>
struct Params {
  // ids [B, T] int32, corners [B, T, 4, 2], valid [B, T] bool, margins
  // [B, T] (each contiguous within a frame, frames *_rs elements apart),
  // rot_table [L, 3, 3], t_table [L, 3], present [L] bool, cam [B, 9].
  const int32_t* ids;
  const T* corners;
  const uint8_t* valid;
  const T* margins;
  int ids_rs, corners_rs, valid_rs, margins_rs;
  const T* rot_table;
  const T* t_table;
  const uint8_t* present;
  int n_layout;
  const T* cam;
  const T* rc_rot;  // [B, 3, 3]
  const T* rc_t;    // [B, 3]
  const T* gyro;    // [B]
  int t;            // tag slots a frame
  T half;           // tag_size / 2
  T std_tag_size;   // robot_pose.py's TAG_SIZE (the std-dev scale)
  T sign_flip;
  T dm_min;
  int max_iter, undistort_iters, n_eig;
  T* rot_out;       // [B, 3, 3]
  T* pos_out;       // [B, 3]
  T* std_out;       // [B, 3]
  uint8_t* valid_out;
  int32_t* ntags_out;
};

template <typename T>
__device__ void undistort(const T* cam, T px, T py, int iters, T* ray, bool* conv) {
  const T fx = cam[0], fy = cam[1], cx = cam[2], cy = cam[3];
  const T k1 = cam[4], k2 = cam[5], p1 = cam[6], p2 = cam[7], k3 = cam[8];
  const T xd0 = dv(sub(px, cx), fx), xd1 = dv(sub(py, cy), fy);
  T x = xd0, y = xd1;
  for (int it = 0; it < iters; ++it) {
    const T r2 = add(mul(x, x), mul(y, y));
    const T radial = add(T(1), mul(r2, add(k1, mul(r2, add(k2, mul(r2, k3))))));
    const T dr = add(k1, mul(r2, add(mul(T(2), k2), mul(mul(T(3), k3), r2))));
    const T fxx = add(add(mul(x, radial), mul(mul(mul(p1, T(2)), x), y)),
                      mul(p2, add(r2, mul(mul(T(2), x), x))));
    const T fyy = add(add(mul(y, radial), mul(mul(mul(p2, T(2)), x), y)),
                      mul(p1, add(r2, mul(mul(T(2), y), y))));
    const T j00 = add(add(add(radial, mul(mul(mul(x, dr), T(2)), x)), mul(mul(T(2), p1), y)),
                      mul(mul(T(6), p2), x));
    const T j01 = add(add(mul(mul(mul(x, dr), T(2)), y), mul(mul(T(2), p1), x)),
                      mul(mul(T(2), p2), y));
    const T j10 = add(add(mul(mul(mul(y, dr), T(2)), x), mul(mul(T(2), p2), y)),
                      mul(mul(T(2), p1), x));
    const T j11 = add(add(add(radial, mul(mul(mul(y, dr), T(2)), y)), mul(mul(T(2), p2), x)),
                      mul(mul(T(6), p1), y));
    T det = sub(mul(j00, j11), mul(j01, j10));
    if (absval(det) < T(1e-12)) det = T(1);
    const T rx = sub(fxx, xd0), ry = sub(fyy, xd1);
    const T dx = dv(sub(mul(j11, rx), mul(j01, ry)), det);
    const T dy = dv(add(mul(-j10, rx), mul(j00, ry)), det);
    x = sub(x, dx);
    y = sub(y, dy);
  }
  const T r2 = add(mul(x, x), mul(y, y));
  const T radial = add(T(1), mul(r2, add(k1, mul(r2, add(k2, mul(r2, k3))))));
  const T xy2 = mul(mul(T(2), x), y);
  const T xdd = add(add(mul(x, radial), mul(p1, xy2)), mul(p2, add(r2, mul(mul(T(2), x), x))));
  const T ydd = add(add(mul(y, radial), mul(p2, xy2)), mul(p1, add(r2, mul(mul(T(2), y), y))));
  const T e0 = sub(xdd, xd0), e1 = sub(ydd, xd1);
  *conv = sqr(add(z(mul(e0, e0)), z(mul(e1, e1)))) < T(1e-6);
  ray[0] = x;
  ray[1] = y;
  ray[2] = T(1);
}

// Gauss-Jordan without pivoting (ops/linalg.py::_eliminate) on an n x w
// row-major matrix, by the threads [t, t + nt) a step apart: step k reads
// one buffer and writes the other, each thread dividing the pivot-row
// entries it needs itself, so a step takes one sync(). Returns the buffer
// that holds the result.
template <int n, int w, typename T, typename Sync>
__device__ T* eliminate(T* m0, T* m1, int t, int nt, Sync sync) {
  for (int k = 0; k < n; ++k) {
    const T* in = (k & 1) ? m1 : m0;
    T* out = (k & 1) ? m0 : m1;
    T piv = in[w * k + k];
    if (absval(piv) < T(1e-30)) piv = T(1e-30);
    for (int e = t; e < n * w; e += nt) {
      const int i = e / w, j = e % w;
      const T row = dv(in[w * k + j], piv);
      out[e] = i == k ? row : sub(in[e], mul(in[w * i + k], row));
    }
    sync();
  }
  return (n & 1) ? m1 : m0;
}

// The constraint tables of constraints_and_jacobian: constraint k on
// columns (p_k, q_k) of R, p = (0, 1, 2, 0, 0, 1), q = (0, 1, 2, 1, 2, 2).
__device__ __forceinline__ int col_p(int k) { return k < 3 ? k : (k == 5 ? 1 : 0); }
__device__ __forceinline__ int col_q(int k) { return k < 3 ? k : (k == 3 ? 1 : 2); }

// One masked SQP Newton step of one candidate by one warp
// (solver/sqpnp.py::newton_refine).
template <typename T>
__device__ void newton_step(Cand<T>& c, const T* omega, const T* winv, int lane, bool& done) {
  const T* r = c.r;
  for (int e = lane; e < 54; e += 32) {
    const int k = e / 9, m = e % 9, i = m / 3, j = m % 3;
    const int pk = col_p(k), qk = col_q(k);
    const T cq = chain<T>(0, 3, [&](int ii) { return T(ii == qk); }, [&](int ii) { return r[3 * ii + j]; });
    const T cp = chain<T>(0, 3, [&](int ii) { return T(ii == pk); }, [&](int ii) { return r[3 * ii + j]; });
    c.jac[e] = add(mul(T(i == pk), cq), mul(T(i == qk), cp));
  }
  if (lane < 9) {
    const int i = lane / 3, j = lane % 3;
    c.g[lane] = chain<T>(0, 3, [&](int k) { return r[3 * i + k]; }, [&](int k) { return r[3 * j + k]; });
  } else if (lane < 18) {
    const int i = lane - 9;
    c.rhs1[i] = -gemv_rows<T>(9, [&](int k) { return omega[9 * i + k]; }, [&](int k) { return r[k]; });
  }
  __syncwarp();
  for (int e = lane; e < 54; e += 32) {
    const int k = e / 9, j = e % 9;
    c.b[e] = chain<T>(0, 9, [&](int m) { return c.jac[9 * k + m]; }, [&](int m) { return winv[9 * m + j]; });
  }
  if (lane >= 22 && lane < 28) {
    const int k = lane - 22, pk = col_p(k), qk = col_q(k);
    T eg[3], e2[3];
    for (int j = 0; j < 3; ++j) {
      eg[j] = chain<T>(0, 3, [&](int ii) { return T(ii == pk); }, [&](int ii) { return c.g[3 * ii + j]; });
      e2[j] = T(j == qk);
    }
    c.h[k] = sub(sum3(mul(eg[0], e2[0]), mul(eg[1], e2[1]), mul(eg[2], e2[2])), T(k < 3));
  }
  __syncwarp();
  for (int e = lane; e < 36; e += 32) {
    const int k = e / 6, l = e % 6;
    c.aug[0][7 * k + l] = chain<T>(0, 9, [&](int m) { return c.b[9 * k + m]; }, [&](int m) { return c.jac[9 * l + m]; });
  }
  if (lane >= 4 && lane < 10) {
    const int k = lane - 4;
    c.aug[0][7 * k + 6] = add(gemv_rows<T>(9, [&](int m) { return c.b[9 * k + m]; },
                                           [&](int m) { return c.rhs1[m]; }), c.h[k]);
  }
  __syncwarp();
  eliminate<6, 7>(c.aug[0], c.aug[1], lane, 32, [] { __syncwarp(); });  // in aug[0]
  if (lane < 9) {
    c.tmp[lane] = sub(c.rhs1[lane], gemv_cols<T>(6, [&](int l) { return c.jac[9 * l + lane]; },
                                                 [&](int l) { return c.aug[0][7 * l + 6]; }));
  }
  __syncwarp();
  if (lane < 9)
    c.delta[lane] = gemv_rows<T>(9, [&](int m) { return winv[9 * lane + m]; }, [&](int m) { return c.tmp[m]; });
  __syncwarp();
  bool fin = true;
  for (int i = 0; i < 9; ++i) fin = fin && finite(c.delta[i]);
  const bool converged = dot9(c.delta, c.delta) < T(1e-16);
  const bool step_ok = fin && !done;
  if (lane < 9 && step_ok) c.r[lane] = add(c.r[lane], c.delta[lane]);
  done = done || !fin || (step_ok && converged);
  __syncwarp();
}

template <typename T>
__global__ void solve_frames_kernel(const Params<T> p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int fb = blockIdx.x, tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = nt >> 5;
  const int TT = p.t, N = 4 * TT, C = 2 * p.n_eig;
  Frame<T>& F = *reinterpret_cast<Frame<T>*>(smem);
  Cand<T>* cand = reinterpret_cast<Cand<T>*>(smem + sizeof(Frame<T>));
  T* p2d = reinterpret_cast<T*>(cand + C);  // [N][3] rays
  T* p3d = p2d + 3 * N;                      // [N][3] world points
  T* ctr = p3d + 3 * N;                      // [N][3] centered
  T* proj = ctr + 3 * N;                     // [N][9]
  T* pp = proj + 9 * N;                      // [N][9] p_i p_j
  T* ttag = pp + 9 * N;                      // [T][3] tag translations
  T* rtag = ttag + 3 * TT;                   // [T][9] tag rotations
  uint8_t* tagok = reinterpret_cast<uint8_t*>(rtag + 9 * TT);  // [T]
  uint8_t* conv = tagok + TT;                // [N]
  uint8_t* mask = conv + N;                  // [N]

  // 1. tags and rays: the id lookup, the undistortion (a thread a corner)
  for (int s = tid; s < TT; s += nt) {
    const int id = p.ids[(size_t)fb * p.ids_rs + s];
    const int ix = id < 0 ? 0 : (id > p.n_layout - 1 ? p.n_layout - 1 : id);
    bool known = p.present[ix] && id >= 0 && p.valid[(size_t)fb * p.valid_rs + s];
    if (p.dm_min > T(0)) known = known && p.margins[(size_t)fb * p.margins_rs + s] > p.dm_min;
    tagok[s] = known;
    for (int e = 0; e < 9; ++e) rtag[9 * s + e] = p.rot_table[9 * ix + e];
    for (int e = 0; e < 3; ++e) ttag[3 * s + e] = p.t_table[3 * ix + e];
  }
  for (int q = tid; q < N; q += nt) {
    const T* px = p.corners + (size_t)fb * p.corners_rs + q * 2;
    bool ok;
    undistort(p.cam + 9 * fb, px[0], px[1], p.undistort_iters, p2d + 3 * q, &ok);
    conv[q] = ok;
  }
  __syncthreads();
  for (int s = tid; s < TT; s += nt)
    tagok[s] = tagok[s] && conv[4 * s] && conv[4 * s + 1] && conv[4 * s + 2] && conv[4 * s + 3];
  if (tid == 0) {
    F.cosg = cosine(p.gyro[fb]);
    F.sing = sine(p.gyro[fb]);
  }
  __syncthreads();

  // 2. the tag corners in the world, the mask (solve_sqpnp's finite test)
  for (int q = tid; q < N; q += nt) {
    const int s = q >> 2, c = q & 3;
    const T h = p.half;
    const T off[3] = {T(0), (c == 1 || c == 2) ? h : -h, c >= 2 ? h : -h};
    T w[3];
    bool m = tagok[s];
    for (int i = 0; i < 3; ++i) {
      w[i] = add(chain<T>(0, 3, [&](int j) { return rtag[9 * s + 3 * i + j]; },
                          [&](int j) { return off[j]; }), ttag[3 * s + i]);
      m = m && finite(w[i]) && finite(p2d[3 * q + i]);
    }
    mask[q] = m;
    for (int i = 0; i < 3; ++i) {
      p3d[3 * q + i] = m ? w[i] : T(0);
      if (!m) p2d[3 * q + i] = T(i == 2);
    }
  }
  __syncthreads();

  // 3. counts and centroids (sums over strided dims: one thread each)
  if (tid < 3) {
    int n = 0;
    for (int q = 0; q < N; ++q) n += mask[q];
    const T s = sum_serial<T>(N, [&](int q) { return mul(p3d[3 * q + tid], T(mask[q])); });
    F.cen[tid] = dv(s, clamp_min(T(n), T(1)));
    if (tid == 0) F.npts = n;
  } else if (tid >= 32 && tid < 35) {
    const int i = tid - 32;
    int n = 0;
    for (int s = 0; s < TT; ++s) n += tagok[s];
    const T s = sum_serial<T>(TT, [&](int k) { return mul(ttag[3 * k + i], T(tagok[k])); });
    F.tcen[i] = dv(s, clamp_min(T(n), T(1)));
    if (i == 0) F.ntag = n;
  }
  __syncthreads();

  // 4. per point: centered, the ray's projector, p_i p_j
  for (int q = tid; q < N; q += nt) {
    const T mf = T(mask[q]);
    const T* v = p2d + 3 * q;
    T c[3];
    for (int i = 0; i < 3; ++i) c[i] = ctr[3 * q + i] = mul(sub(p3d[3 * q + i], F.cen[i]), mf);
    const T sq = dot3(v, v);
    const T inv = sq > T(0) ? mul(dv(T(1), clamp_min(sq, T(1e-30))), T(1)) : T(0);
    for (int a = 0; a < 3; ++a)
      for (int b = 0; b < 3; ++b) {
        proj[9 * q + 3 * a + b] = mul(sub(T(a == b), mul(mul(v[a], v[b]), inv)), mf);
        pp[9 * q + 3 * a + b] = mul(c[a], c[b]);
      }
  }
  __syncthreads();

  // 5. the linear system: Q_tt, Q_rt, Q_rr (a thread an entry)
  for (int e = tid; e < 117; e += nt) {
    if (e < 9) {
      F.q_tt[e] = sum_serial<T>(N, [&](int q) { return proj[9 * q + e]; });
    } else if (e < 36) {
      const int i = (e - 9) / 9, ab = (e - 9) % 9;
      F.q_rt[e - 9] = chain<T>(0, N, [&](int q) { return ctr[3 * q + i]; },
                               [&](int q) { return proj[9 * q + ab]; });
    } else {
      const int ij = (e - 36) / 9, ab = (e - 36) % 9;
      const int i = ij / 3, j = ij % 3, a = ab / 3, b = ab % 3;
      F.q_rr[9 * (3 * i + a) + 3 * j + b] = chain<T>(0, N, [&](int q) { return pp[9 * q + ij]; },
                                                     [&](int q) { return proj[9 * q + ab]; });
    }
  }
  __syncthreads();

  // 6. Q_tt^-1 by the adjugate (robust_inv3)
  if (tid == 0) {
    const T* m = F.q_tt;
    const T det = det3(m);
    const bool ok = absval(det) > T(1e-30);
    const T safe = ok ? det : T(1);
    const T cof[9] = {
        sub(mul(m[4], m[8]), mul(m[5], m[7])), sub(mul(m[2], m[7]), mul(m[1], m[8])),
        sub(mul(m[1], m[5]), mul(m[2], m[4])), sub(mul(m[5], m[6]), mul(m[3], m[8])),
        sub(mul(m[0], m[8]), mul(m[2], m[6])), sub(mul(m[2], m[3]), mul(m[0], m[5])),
        sub(mul(m[3], m[7]), mul(m[4], m[6])), sub(mul(m[1], m[6]), mul(m[0], m[7])),
        sub(mul(m[0], m[4]), mul(m[1], m[3]))};
    for (int e = 0; e < 9; ++e) F.qinv[e] = ok ? dv(cof[e], safe) : T(0);
  }
  __syncthreads();

  // 7. omega = Q_rr - (Q_rt Q_tt^-1) Q_rt^T
  for (int e = tid; e < 27; e += nt) {
    const int i = e / 3, j = e % 3;
    F.tmp27[e] = chain<T>(0, 3, [&](int k) { return F.q_rt[3 * i + k]; },
                          [&](int k) { return F.qinv[3 * k + j]; });
  }
  __syncthreads();
  for (int e = tid; e < 81; e += nt) {
    const int i = e / 9, j = e % 9;
    F.omega[e] = sub(F.q_rr[e], chain<T>(0, 3, [&](int k) { return F.tmp27[3 * i + k]; },
                                         [&](int k) { return F.q_rt[3 * j + k]; }));
  }
  __syncthreads();

  // 8. (omega + eps I)^-1 (regularized_omega_inv)
  if (tid == 0) {
    const T tr = sum_lanes<9, T>([&](int k) { return F.omega[10 * k]; });
    F.eps = mul(clamp_min(mul(tr, dv(T(1), T(9))), T(1e-12)), T(1e-4));
  }
  __syncthreads();
  for (int e = tid; e < 162; e += nt) {
    const int i = e / 18, j = e % 18;
    F.aug[0][e] = j < 9 ? add(F.omega[9 * i + j], mul(F.eps, T(i == j))) : T(i == j - 9);
  }
  __syncthreads();
  const T* inv = eliminate<9, 18>(F.aug[0], F.aug[1], tid, nt, [] { __syncthreads(); });
  for (int e = tid; e < 81; e += nt) F.winv[e] = inv[18 * (e / 9) + 9 + e % 9];
  for (int e = tid; e < 45; e += nt) F.x[e] = T(e / BLOCK == e % BLOCK);
  __syncthreads();

  // 9. the smallest eigenvectors: 4 steps of inverse subspace iteration
  for (int app = 0; app < 4; ++app) {
    for (int e = tid; e < 45; e += nt) {
      const int i = e / BLOCK, j = e % BLOCK;
      F.y[e] = chain<T>(0, 9, [&](int k) { return F.winv[9 * i + k]; },
                        [&](int k) { return F.x[BLOCK * k + j]; });
    }
    __syncthreads();
    if (warp == 0) {  // orthonormalize, column by column; lane i holds row i
      for (int j = 0; j < BLOCK; ++j) {
        T c = lane < 9 ? F.y[BLOCK * lane + j] : T(0);
        for (int q = 0; q < j; ++q) {
          if (lane < 9) F.prod[lane] = mul(F.x[BLOCK * lane + q], c);
          __syncwarp();
          const T d = sum_lanes<9, T>([&](int k) { return F.prod[k]; });
          __syncwarp();
          if (lane < 9) c = sub(c, mul(d, F.x[BLOCK * lane + q]));
        }
        if (lane < 9) F.prod[lane] = mul(c, c);
        __syncwarp();
        const T n = sqr(sum_lanes<9, T>([&](int k) { return F.prod[k]; }));
        if (lane < 9)
          F.x[BLOCK * lane + j] = n > T(1e-20) ? dv(c, clamp_min(n, T(1e-20))) : T(lane == j);
        __syncwarp();
      }
    }
    __syncthreads();
  }
  for (int e = tid; e < 45; e += nt) {
    const int i = e / BLOCK, j = e % BLOCK;
    F.ox[e] = chain<T>(0, 9, [&](int k) { return F.omega[9 * i + k]; },
                       [&](int k) { return F.x[BLOCK * k + j]; });
  }
  __syncthreads();
  for (int e = tid; e < 25; e += nt) {
    const int i = e / BLOCK, j = e % BLOCK;
    F.a[e] = chain<T>(0, 9, [&](int k) { return F.x[BLOCK * k + i]; },
                      [&](int k) { return F.ox[BLOCK * k + j]; });
    F.v[0][e] = T(i == j);
  }
  __syncthreads();

  // 10. Rayleigh-Ritz: parallel cyclic Jacobi on the 5x5 (round-robin
  // rounds of two disjoint rotations, angles from the pre-round matrix),
  // one warp
  if (warp == 0) {  // one warp, lanes over the 25 entries
    int cur = 0;
    for (int sweep = 0; sweep < SWEEPS; ++sweep) {
      for (int r = 0; r < BLOCK; ++r) {
        if (lane < 25) F.g[lane] = T(lane / BLOCK == lane % BLOCK);
        __syncwarp();
        if (lane < 2) {
          const int i = lane + 1;
          const int a0 = (r + i) % BLOCK, b0 = ((r - i) % BLOCK + BLOCK) % BLOCK;
          const int pi = a0 < b0 ? a0 : b0, qi = a0 < b0 ? b0 : a0;
          const T app = F.a[6 * pi], aqq = F.a[6 * qi], apq = F.a[BLOCK * pi + qi];
          const T th = mul(at2(mul(T(2), apq), sub(app, aqq)), T(0.5));
          const T c = cosine(th), s = sine(th);
          const T d = add(T(1), sub(c, T(1)));
          F.g[6 * pi] = d;
          F.g[6 * qi] = d;
          F.g[BLOCK * qi + pi] = s;
          F.g[BLOCK * pi + qi] = -s;
        }
        __syncwarp();
        if (lane < 25) {
          const int i = lane / BLOCK, j = lane % BLOCK;
          F.ga[lane] = chain<T>(0, BLOCK, [&](int k) { return F.g[BLOCK * k + i]; },
                                [&](int k) { return F.a[BLOCK * k + j]; });
        }
        __syncwarp();
        if (lane < 25) {
          const int i = lane / BLOCK, j = lane % BLOCK;
          F.a[lane] = chain<T>(0, BLOCK, [&](int k) { return F.ga[BLOCK * i + k]; },
                               [&](int k) { return F.g[BLOCK * k + j]; });
          F.v[cur ^ 1][lane] = chain<T>(0, BLOCK, [&](int k) { return F.v[cur][BLOCK * i + k]; },
                                        [&](int k) { return F.g[BLOCK * k + j]; });
        }
        cur ^= 1;
        __syncwarp();
      }
    }
  }
  const int cur = (SWEEPS * BLOCK) & 1;  // the buffer the last round wrote
  __syncthreads();
  if (tid == 0) {  // stable ascending argsort of the diagonal, NaN last
    int ord[BLOCK];
    for (int i = 0; i < BLOCK; ++i) {
      const T wi = F.a[6 * i];
      int j = i;
      while (j > 0) {
        const T wj = F.a[6 * ord[j - 1]];
        const bool before = (wi != wi) ? false : (wj != wj || wi < wj);
        if (!before) break;
        ord[j] = ord[j - 1];
        --j;
      }
      ord[j] = i;
    }
    for (int i = 0; i < BLOCK; ++i) F.order[i] = ord[i];
  }
  __syncthreads();
  const int K = p.n_eig;
  for (int e = tid; e < 9 * K; e += nt) {
    const int i = e / K, c = e % K;
    F.basis[e] = chain<T>(0, BLOCK, [&](int m) { return F.x[BLOCK * i + m]; },
                          [&](int m) { return F.v[cur][BLOCK * m + F.order[c]]; });
  }
  __syncthreads();

  // 11. the candidates, a warp each: each eigenvector x {-1, +1}, nearest
  // SO(3), the Newton steps, the gyro penalty, translation, cheirality and
  // the ground-plane plausibility
  for (int ci = warp; ci < C; ci += nwarps) {
    Cand<T>& c = cand[ci];
    if (lane == 0) {
      T gv[9];
      for (int i = 0; i < 9; ++i) {
        const T bv = F.basis[K * i + ci / 2];
        gv[i] = (ci & 1) ? bv : -bv;
      }
      nearest_so3(gv, c.r);
    }
    __syncwarp();
    bool done = false;
    for (int it = 0; it < p.max_iter; ++it) newton_step(c, F.omega, F.winv, lane, done);
    if (lane < 9)
      c.tmp[lane] = gemv_rows<T>(9, [&](int k) { return F.omega[9 * lane + k]; },
                                 [&](int k) { return c.r[k]; });
    __syncwarp();
    if (lane == 0) {
      const T* r = c.r;
      const T fwd[3] = {p.rc_rot[9 * fb], p.rc_rot[9 * fb + 3], p.rc_rot[9 * fb + 6]};
      c.energy = dot9(r, c.tmp);
      const T fx = add(add(mul(r[0], fwd[0]), mul(r[1], fwd[1])), mul(r[2], fwd[2]));
      const T fy = add(add(mul(r[3], fwd[0]), mul(r[4], fwd[1])), mul(r[5], fwd[2]));
      const T ang = clamp_min(sub(T(1), add(mul(fx, F.cosg), mul(fy, F.sing))), T(0));
      c.penalized = add(c.energy, mul(ang, p.sign_flip));
      T qr[3], tl[3];
      for (int i = 0; i < 3; ++i)
        qr[i] = gemv_rows<T>(9, [&](int m) { return F.q_rt[3 * m + i]; }, [&](int m) { return r[m]; });
      for (int i = 0; i < 3; ++i) {
        tl[i] = -gemv_rows<T>(3, [&](int k) { return F.qinv[3 * i + k]; }, [&](int k) { return qr[k]; });
        const T rc = chain<T>(0, 3, [&](int j) { return r[3 * j + i]; }, [&](int j) { return F.cen[j]; });
        c.tall[i] = sub(tl[i], rc);
      }
      bool front = true;
      for (int q = 0; q < N; ++q) {
        const T zc = add(chain<T>(0, 3, [&](int j) { return r[3 * j + 2]; },
                                  [&](int j) { return p3d[3 * q + j]; }), c.tall[2]);
        front = front && (zc > T(0) || !mask[q]);
      }
      c.score = front ? c.penalized : infinity(T(0));
      // |z| of the robot in the world: (R, t)^-1 o robot_to_cam
      const T* rct = p.rc_t + 3 * fb;
      const T tinv = -gemv_rows<T>(3, [&](int k) { return r[6 + k]; }, [&](int k) { return c.tall[k]; });
      const T tz = add(gemv_rows<T>(3, [&](int k) { return r[6 + k]; }, [&](int k) { return rct[k]; }), tinv);
      c.plaus = absval(tz);
    }
    __syncwarp();
  }
  __syncthreads();

  // 12. the candidate, the robot pose, std-devs and the gyro pivot
  if (tid == 0) {
    T score[MAX_CAND], plaus[MAX_CAND];
    for (int i = 0; i < C; ++i) score[i] = cand[i].score;
    const T lim = add(amin(score, C), mul(F.eps, T(3)));
    for (int i = 0; i < C; ++i) plaus[i] = score[i] <= lim ? cand[i].plaus : infinity(T(0));
    const int best = argmin_first(plaus, C);
    const Cand<T>& c = cand[best];
    const bool valid = finite(c.score) && F.npts >= 3;
    T R[9], t[3];
    for (int i = 0; i < 3; ++i) {
      t[i] = c.tall[i];
      for (int j = 0; j < 3; ++j) R[3 * i + j] = c.r[3 * j + i];
    }
    // std-devs (robot_pose.py::compute_std_devs)
    const T nt_f = T(F.ntag);
    const T rms = sqr(dv(clamp_min(c.energy, T(0)), clamp_min(mul(nt_f, T(4)), T(1))));
    const T inv_size = dv(T(1), p.std_tag_size);
    const T mult = add(T(1), mul(sqr(dot3(t, t)), inv_size));
    const T sqrt_n = sqr(clamp_min(nt_f, T(1)));
    T xy = clamp(mul(dv(mul(rms, mult), sqrt_n), T(5)), T(0.01), T(10));
    T th = clamp(mul(dv(mul(mul(rms, inv_size), mult), sqrt_n), T(2)), T(0.05),
                 T(3.141592653589793));
    if (rms > T(0.1)) xy = th = biggest(T(0));
    // the robot in the world: (R, t)^-1 o robot_to_cam
    const T* rcr = p.rc_rot + 9 * fb;
    const T* rct = p.rc_t + 3 * fb;
    T rot[9], pos[3];
    for (int i = 0; i < 3; ++i) {
      const T tinv = -chain<T>(0, 3, [&](int k) { return R[3 * k + i]; }, [&](int k) { return t[k]; });
      pos[i] = add(chain<T>(0, 3, [&](int k) { return R[3 * k + i]; }, [&](int k) { return rct[k]; }), tinv);
      for (int j = 0; j < 3; ++j)
        rot[3 * i + j] = chain<T>(0, 3, [&](int k) { return R[3 * k + i]; },
                                  [&](int k) { return rcr[3 * k + j]; });
    }
    // the yaw pivot toward the gyro about the tags' centroid
    const T pi_ = T(3.141592653589793), two_pi = T(6.283185307179586);
    const T yaw = at2(rot[3], rot[0]);
    const T a = add(sub(p.gyro[fb], yaw), pi_);
    T md = fmodulo(a, two_pi);
    if (md != T(0) && ((two_pi < T(0)) != (md < T(0)))) md = add(md, two_pi);
    const T dyaw = sub(md, pi_);
    const T deg = absval(mul(dyaw, T(57.29577951308232)));
    const T xs = clamp(mul(deg, dv(T(1), T(30))), T(0), T(1));
    const T applied = mul(dyaw, mul(mul(xs, xs), sub(T(3), mul(T(2), xs))));
    const T cz = cosine(applied), sz = sine(applied);
    const T rz[9] = {cz, -sz, T(0), sz, cz, T(0), T(0), T(0), T(1)};
    T d[3];
    for (int i = 0; i < 3; ++i) d[i] = sub(pos[i], F.tcen[i]);
    for (int i = 0; i < 3; ++i) {
      p.pos_out[3 * fb + i] = add(F.tcen[i], gemv_rows<T>(3, [&](int k) { return rz[3 * i + k]; },
                                                          [&](int k) { return d[k]; }));
      for (int j = 0; j < 3; ++j)
        p.rot_out[9 * fb + 3 * i + j] = chain<T>(0, 3, [&](int k) { return rz[3 * i + k]; },
                                                 [&](int k) { return rot[3 * k + j]; });
    }
    p.std_out[3 * fb + 0] = xy;
    p.std_out[3 * fb + 1] = xy;
    p.std_out[3 * fb + 2] = th;
    p.valid_out[fb] = valid;
    p.ntags_out[fb] = F.ntag;
  }
}

template <typename T>
size_t shared_bytes(int t, int n_eig) {
  return sizeof(Frame<T>) + sizeof(Cand<T>) * 2 * n_eig + sizeof(T) * (27 * 4 * t + 12 * t) +
         9 * t;
}

template <typename T>
int solve(void* const* ptrs, const int* ints, const double* reals, cudaStream_t stream) {
  Params<T> p;
  p.ids = (const int32_t*)ptrs[0];
  p.corners = (const T*)ptrs[1];
  p.valid = (const uint8_t*)ptrs[2];
  p.margins = (const T*)ptrs[3];
  p.rot_table = (const T*)ptrs[4];
  p.t_table = (const T*)ptrs[5];
  p.present = (const uint8_t*)ptrs[6];
  p.cam = (const T*)ptrs[7];
  p.rc_rot = (const T*)ptrs[8];
  p.rc_t = (const T*)ptrs[9];
  p.gyro = (const T*)ptrs[10];
  p.rot_out = (T*)ptrs[11];
  p.pos_out = (T*)ptrs[12];
  p.std_out = (T*)ptrs[13];
  p.valid_out = (uint8_t*)ptrs[14];
  p.ntags_out = (int32_t*)ptrs[15];
  const int B = ints[1], threads = ints[7];
  p.t = ints[2];
  p.n_layout = ints[3];
  p.max_iter = ints[4];
  p.undistort_iters = ints[5];
  p.n_eig = ints[6];
  p.ids_rs = ints[8];
  p.corners_rs = ints[9];
  p.valid_rs = ints[10];
  p.margins_rs = ints[11];
  p.half = (T)reals[0];
  p.std_tag_size = (T)reals[1];
  p.sign_flip = (T)reals[2];
  p.dm_min = (T)reals[3];
  const size_t bytes = shared_bytes<T>(p.t, p.n_eig);
  if (bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        solve_frames_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return (int)e;
  }
  solve_frames_kernel<T><<<B, threads, bytes, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

// ---- host entry ----
// ptrs: ids, corners, valid, margins, rot_table, t_table, present, cam,
// rc_rot, rc_t, gyro, rot_out, pos_out, std_out, valid_out, ntags_out.
// ints: dbl, B, t, n_layout, max_iter, undistort_iters, n_eig, threads,
// and the frame strides of ids, corners, valid and margins.
// reals: tag_size / 2, the std-dev tag size, sign_flip, dm_min.
extern "C" int chalkydri_solve(void* const* ptrs, const int* ints, const double* reals,
                               void* stream) {
  if (ints[2] < 1 || ints[2] > MAX_TAGS || ints[6] < 1 || ints[6] > BLOCK) return -1;
  return ints[0] ? solve<double>(ptrs, ints, reals, (cudaStream_t)stream)
                 : solve<float>(ptrs, ints, reals, (cudaStream_t)stream);
}
