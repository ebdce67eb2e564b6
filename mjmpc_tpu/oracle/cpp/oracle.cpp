// CPU rollout oracle — the native cross-check layer.
//
// Plays the role of the reference's first-party native component (the
// Cython batched rollout, /root/reference/mjmpc/envs/gym_env_wrapper_cy.pyx:
// a typed loop driving the simulator and collecting costs; build disabled
// upstream). Used to validate the JAX engine's rollout numerics from an
// independent, serial, double-precision implementation:
//   - AR(2) filtered-noise recurrence (control_utils.py:24-34 semantics)
//   - discounted cost-to-go (control_utils.py:37-46)
//   - per-particle pendulum / LQR rollout loops (gym_env_wrapper.py:125-153)
//   - full MPPI update (mppi.py:69-97) for end-to-end solve parity.
//
// Compiled on demand by cpp_oracle.py (g++ -O2 -shared); exposed via ctypes.

#include <cmath>
#include <cstdint>
#include <vector>

extern "C" {

// In-place AR(2) IIR filter along the horizon axis.
// eps: [n, h, da] row-major.
void ar_filter(double* eps, int64_t n, int64_t h, int64_t da,
               double b0, double b1, double b2) {
    if (h <= 2) return;
    for (int64_t i = 0; i < n; ++i) {
        double* p = eps + i * h * da;
        for (int64_t t = 2; t < h; ++t) {
            for (int64_t d = 0; d < da; ++d) {
                p[t * da + d] = b0 * p[t * da + d]
                              + b1 * p[(t - 1) * da + d]
                              + b2 * p[(t - 2) * da + d];
            }
        }
    }
}

// Discounted cost-to-go: out[i, t] = sum_{s>=t} gamma^(s-t) c[i, s],
// computed by the backward recurrence (exact at gamma = 0).
void cost_to_go(const double* costs, double* out, int64_t n, int64_t h,
                const double* gamma_seq) {
    double gamma = (h > 1) ? gamma_seq[1] / gamma_seq[0] : 0.0;
    for (int64_t i = 0; i < n; ++i) {
        const double* c = costs + i * h;
        double* o = out + i * h;
        double acc = 0.0;
        for (int64_t t = h - 1; t >= 0; --t) {
            acc = c[t] + gamma * acc;
            o[t] = acc;
        }
    }
}

// Serial per-particle pendulum rollout (mirrors envs/pendulum.py step).
// mean: [h], noise: [n, h]; costs_out: [n, h]. Every particle restarts
// from the same (th0, thdot0) — the reference's set_env_state-per-particle.
void pendulum_rollout(double g, double m, double l, double dt,
                      double max_speed, double max_torque,
                      double th0, double thdot0,
                      const double* mean, const double* noise,
                      int64_t n, int64_t h, double* costs_out) {
    const double pi = 3.14159265358979323846;
    for (int64_t i = 0; i < n; ++i) {
        double th = th0, thdot = thdot0;
        for (int64_t t = 0; t < h; ++t) {
            double u = mean[t] + noise[i * h + t];
            if (u > max_torque) u = max_torque;
            if (u < -max_torque) u = -max_torque;
            double ang = std::fmod(th + pi, 2.0 * pi);
            if (ang < 0) ang += 2.0 * pi;
            ang -= pi;
            costs_out[i * h + t] =
                ang * ang + 0.1 * thdot * thdot + 0.001 * u * u;
            thdot += (-3.0 * g / (2.0 * l) * std::sin(th + pi)
                      + 3.0 / (m * l * l) * u) * dt;
            th += thdot * dt;  // pre-clip velocity, like the env
            if (thdot > max_speed) thdot = max_speed;
            if (thdot < -max_speed) thdot = -max_speed;
        }
    }
}

// Serial LQR rollout: x' = A x + B u, cost = x^T Q x + u^T R u.
// A: [dx, dx], B: [dx, du], Q diag: [dx], R diag: [du],
// mean: [h, du], noise: [n, h, du], costs_out: [n, h].
void lqr_rollout(const double* A, const double* B, const double* Qd,
                 const double* Rd, const double* x0,
                 const double* mean, const double* noise,
                 int64_t n, int64_t h, int64_t dx, int64_t du,
                 double* costs_out) {
    std::vector<double> x(dx), xn(dx);
    for (int64_t i = 0; i < n; ++i) {
        for (int64_t k = 0; k < dx; ++k) x[k] = x0[k];
        for (int64_t t = 0; t < h; ++t) {
            const double* u = nullptr;
            std::vector<double> uv(du);
            for (int64_t d = 0; d < du; ++d)
                uv[d] = mean[t * du + d] + noise[(i * h + t) * du + d];
            u = uv.data();
            double c = 0.0;
            for (int64_t k = 0; k < dx; ++k) c += Qd[k] * x[k] * x[k];
            for (int64_t d = 0; d < du; ++d) c += Rd[d] * u[d] * u[d];
            costs_out[i * h + t] = c;
            for (int64_t k = 0; k < dx; ++k) {
                double s = 0.0;
                for (int64_t j = 0; j < dx; ++j) s += A[k * dx + j] * x[j];
                for (int64_t d = 0; d < du; ++d) s += B[k * du + d] * u[d];
                xn[k] = s;
            }
            x.swap(xn);
        }
    }
}

// Full MPPI mean update (mppi.py:69-97, alpha=1: no control cost):
// w = softmax(-ctg[:,0]/lam); new_mean = (1-ss)*mean + ss * sum_i w_i a_i.
void mppi_update(const double* mean, const double* actions,
                 const double* costs, int64_t n, int64_t h, int64_t da,
                 double gamma, double lam, double step_size,
                 double* new_mean) {
    std::vector<double> ctg0(n);
    for (int64_t i = 0; i < n; ++i) {
        const double* c = costs + i * h;
        double acc = 0.0;
        for (int64_t t = h - 1; t >= 0; --t) acc = c[t] + gamma * acc;
        ctg0[i] = acc;
    }
    double mx = ctg0[0];
    for (int64_t i = 1; i < n; ++i) mx = std::min(mx, ctg0[i]);
    double z = 0.0;
    std::vector<double> w(n);
    for (int64_t i = 0; i < n; ++i) {
        w[i] = std::exp(-(ctg0[i] - mx) / lam);
        z += w[i];
    }
    for (int64_t t = 0; t < h; ++t) {
        for (int64_t d = 0; d < da; ++d) {
            double s = 0.0;
            for (int64_t i = 0; i < n; ++i)
                s += w[i] / z * actions[(i * h + t) * da + d];
            new_mean[t * da + d] =
                (1.0 - step_size) * mean[t * da + d] + step_size * s;
        }
    }
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Serial double-precision kinematic-chain engine — the independent
// cross-check for engine/chain.py (VERDICT r1 item 7; quaternion
// ball/free joints added for the hand-suite models).
//
// The JAX engine derives Coriolis/gravity bias by AD of a tangent-space
// Lagrangian; here the SAME quantities come from a classic world-frame
// recursive Newton-Euler pass (qdd = 0; for multi-DOF joints the
// velocity-product term is w_parent x (joint velocity), which equals the
// usual w_i x s qd form) and the mass matrix from geometric-Jacobian
// composition — different algorithms, so agreement is evidence, not
// tautology. Mirrors mujoco_py's role for the reference's models
// (/root/reference/mjmpc/envs/gym_env_wrapper_cy.pyx:75-136).
//
// Joint types: 0 = hinge (1 q / 1 v), 1 = slide (1/1),
//              2 = ball (4 q unit quaternion wxyz / 3 v body angular),
//              3 = free (3 q parent-frame pos + 4 q quaternion /
//                        3 v parent-frame linear + 3 v body angular).
// Per-DOF arrays (armature/damping/stiffness/gear, qlow/qhigh) use the
// engine's [nv] / [nq] layouts.
// ---------------------------------------------------------------------------

namespace {

struct V3 { double x, y, z; };

inline V3 v3(const double* p) { return {p[0], p[1], p[2]}; }
inline V3 operator+(V3 a, V3 b) { return {a.x + b.x, a.y + b.y, a.z + b.z}; }
inline V3 operator-(V3 a, V3 b) { return {a.x - b.x, a.y - b.y, a.z - b.z}; }
inline V3 operator*(double s, V3 a) { return {s * a.x, s * a.y, s * a.z}; }
inline double dot(V3 a, V3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }
inline V3 cross(V3 a, V3 b) {
    return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z,
            a.x * b.y - a.y * b.x};
}

struct M3 { double m[9]; };

inline V3 mul(const M3& r, V3 v) {
    return {r.m[0] * v.x + r.m[1] * v.y + r.m[2] * v.z,
            r.m[3] * v.x + r.m[4] * v.y + r.m[5] * v.z,
            r.m[6] * v.x + r.m[7] * v.y + r.m[8] * v.z};
}

inline M3 mul(const M3& a, const M3& b) {
    M3 o{};
    for (int i = 0; i < 3; ++i)
        for (int j = 0; j < 3; ++j) {
            double s = 0;
            for (int k = 0; k < 3; ++k) s += a.m[i * 3 + k] * b.m[k * 3 + j];
            o.m[i * 3 + j] = s;
        }
    return o;
}

inline M3 eye3() { return {{1, 0, 0, 0, 1, 0, 0, 0, 1}}; }

inline V3 col(const M3& r, int k) {
    return {r.m[k], r.m[3 + k], r.m[6 + k]};
}

// Rodrigues rotation about a unit axis.
inline M3 axis_rot(V3 a, double ang) {
    double c = std::cos(ang), s = std::sin(ang), t = 1.0 - c;
    return {{t * a.x * a.x + c,       t * a.x * a.y - s * a.z,
             t * a.x * a.z + s * a.y,
             t * a.x * a.y + s * a.z, t * a.y * a.y + c,
             t * a.y * a.z - s * a.x,
             t * a.x * a.z - s * a.y, t * a.y * a.z + s * a.x,
             t * a.z * a.z + c}};
}

// Unit quaternion (w, x, y, z) -> rotation matrix (normalizes).
inline M3 quat_to_mat(const double* q) {
    double n = std::sqrt(q[0]*q[0] + q[1]*q[1] + q[2]*q[2] + q[3]*q[3]);
    double w = q[0]/n, x = q[1]/n, y = q[2]/n, z = q[3]/n;
    return {{1 - 2*(y*y + z*z), 2*(x*y - w*z), 2*(x*z + w*y),
             2*(x*y + w*z), 1 - 2*(x*x + z*z), 2*(y*z - w*x),
             2*(x*z - w*y), 2*(y*z + w*x), 1 - 2*(x*x + y*y)}};
}

inline void quat_mul(const double* a, const double* b, double* o) {
    o[0] = a[0]*b[0] - a[1]*b[1] - a[2]*b[2] - a[3]*b[3];
    o[1] = a[0]*b[1] + a[1]*b[0] + a[2]*b[3] - a[3]*b[2];
    o[2] = a[0]*b[2] - a[1]*b[3] + a[2]*b[0] + a[3]*b[1];
    o[3] = a[0]*b[3] + a[1]*b[2] - a[2]*b[1] + a[3]*b[0];
}

// axis-angle vector -> unit quaternion exp(w^/2)
inline void exp_quat(V3 w, double* o) {
    double t = std::sqrt(dot(w, w));
    double half = 0.5 * t;
    double sc = (t < 1e-9) ? 0.5 - t*t/48.0 : std::sin(half)/t;
    o[0] = std::cos(half); o[1] = sc*w.x; o[2] = sc*w.y; o[3] = sc*w.z;
}

// world inertia about COM: R I R^T
inline M3 world_inertia(const M3& r, const double* inertia) {
    M3 i{{inertia[0], inertia[1], inertia[2], inertia[3], inertia[4],
          inertia[5], inertia[6], inertia[7], inertia[8]}};
    M3 rt{{r.m[0], r.m[3], r.m[6], r.m[1], r.m[4], r.m[7],
           r.m[2], r.m[5], r.m[8]}};
    return mul(mul(r, i), rt);
}

constexpr int64_t NQ_OF[4] = {1, 1, 4, 7};
constexpr int64_t NV_OF[4] = {1, 1, 3, 6};

struct ChainModel {
    int64_t n;
    const int64_t* parent;
    const int64_t* jtype;
    const double* axis;        // [n,3] child-frame (hinge/slide)
    const double* body_pos;    // [n,3]
    const double* mass;        // [n]
    const double* com;         // [n,3]
    const double* inertia;     // [n,9]
    std::vector<int64_t> qoff, voff;
    int64_t nq = 0, nv = 0;

    void offsets() {
        qoff.resize(n); voff.resize(n);
        for (int64_t i = 0; i < n; ++i) {
            qoff[i] = nq; voff[i] = nv;
            nq += NQ_OF[jtype[i]]; nv += NV_OF[jtype[i]];
        }
    }
};

// forward kinematics: world rotations + frame origins
void fk(const ChainModel& mm, const double* q,
        std::vector<M3>& R, std::vector<V3>& P) {
    R.resize(mm.n); P.resize(mm.n);
    for (int64_t i = 0; i < mm.n; ++i) {
        int64_t pi = mm.parent[i];
        M3 rp = (pi < 0) ? eye3() : R[pi];
        V3 pp = (pi < 0) ? V3{0, 0, 0} : P[pi];
        V3 bp = v3(mm.body_pos + 3 * i);
        const double* qi = q + mm.qoff[i];
        switch (mm.jtype[i]) {
        case 0: {  // hinge
            P[i] = pp + mul(rp, bp);
            R[i] = mul(rp, axis_rot(v3(mm.axis + 3 * i), qi[0]));
            break;
        }
        case 1: {  // slide
            V3 aw = mul(rp, v3(mm.axis + 3 * i));
            P[i] = pp + mul(rp, bp) + qi[0] * aw;
            R[i] = rp;
            break;
        }
        case 2: {  // ball
            P[i] = pp + mul(rp, bp);
            R[i] = mul(rp, quat_to_mat(qi));
            break;
        }
        default: {  // free
            V3 t = {qi[0], qi[1], qi[2]};
            P[i] = pp + mul(rp, bp + t);
            R[i] = mul(rp, quat_to_mat(qi + 3));
            break;
        }
        }
    }
}

// per-velocity-DOF world axes + anchor origins + rotational flags
void dof_axes(const ChainModel& mm, const std::vector<M3>& R,
              const std::vector<V3>& P,
              std::vector<V3>& A, std::vector<V3>& O,
              std::vector<int>& rot) {
    A.resize(mm.nv); O.resize(mm.nv); rot.resize(mm.nv);
    for (int64_t i = 0; i < mm.n; ++i) {
        int64_t pi = mm.parent[i];
        M3 rp = (pi < 0) ? eye3() : R[pi];
        int64_t v = mm.voff[i];
        switch (mm.jtype[i]) {
        case 0:
            A[v] = mul(R[i], v3(mm.axis + 3 * i)); O[v] = P[i];
            rot[v] = 1; break;
        case 1:
            A[v] = mul(rp, v3(mm.axis + 3 * i)); O[v] = P[i];
            rot[v] = 0; break;
        case 2:
            for (int k = 0; k < 3; ++k) {
                A[v + k] = col(R[i], k); O[v + k] = P[i]; rot[v + k] = 1;
            }
            break;
        default:
            for (int k = 0; k < 3; ++k) {
                A[v + k] = col(rp, k); O[v + k] = P[i]; rot[v + k] = 0;
                A[v + 3 + k] = col(R[i], k); O[v + 3 + k] = P[i];
                rot[v + 3 + k] = 1;
            }
            break;
        }
    }
}

void mass_matrix_impl(ChainModel& mm, const double* q, double* m_out) {
    std::vector<M3> R; std::vector<V3> P;
    fk(mm, q, R, P);
    std::vector<V3> A, O; std::vector<int> rotf;
    dof_axes(mm, R, P, A, O, rotf);
    for (int64_t i = 0; i < mm.nv * mm.nv; ++i) m_out[i] = 0.0;
    std::vector<V3> jv(mm.nv), jw(mm.nv);
    std::vector<int64_t> dofs;
    for (int64_t i = 0; i < mm.n; ++i) {
        V3 ci = P[i] + mul(R[i], v3(mm.com + 3 * i));
        M3 iw = world_inertia(R[i], mm.inertia + 9 * i);
        dofs.clear();
        for (int64_t k = i; k >= 0; k = mm.parent[k])
            for (int64_t d = 0; d < NV_OF[mm.jtype[k]]; ++d)
                dofs.push_back(mm.voff[k] + d);
        for (int64_t d : dofs) {
            if (rotf[d]) { jv[d] = cross(A[d], ci - O[d]); jw[d] = A[d]; }
            else         { jv[d] = A[d]; jw[d] = {0, 0, 0}; }
        }
        for (int64_t a : dofs)
            for (int64_t b : dofs)
                m_out[a * mm.nv + b] += mm.mass[i] * dot(jv[a], jv[b])
                                      + dot(jw[a], mul(iw, jw[b]));
    }
}

void bias_impl(ChainModel& mm, const double* gravity,
               const double* q, const double* qd, double* bias_out) {
    std::vector<M3> R; std::vector<V3> P;
    fk(mm, q, R, P);
    V3 g = v3(gravity);
    std::vector<V3> w(mm.n), dw(mm.n), vo(mm.n), ao(mm.n),
        Fc(mm.n), Nc(mm.n), fa(mm.n), na(mm.n);
    for (int64_t i = 0; i < mm.n; ++i) {
        int64_t pi = mm.parent[i];
        M3 rp = (pi < 0) ? eye3() : R[pi];
        V3 wp = (pi < 0) ? V3{0, 0, 0} : w[pi];
        V3 dwp = (pi < 0) ? V3{0, 0, 0} : dw[pi];
        V3 vp = (pi < 0) ? V3{0, 0, 0} : vo[pi];
        V3 ap = (pi < 0) ? V3{0, 0, 0} : ao[pi];
        V3 pp = (pi < 0) ? V3{0, 0, 0} : P[pi];
        V3 r = P[i] - pp;
        const double* qdi = qd + mm.voff[i];
        // joint-space velocities in world frame
        V3 wj = {0, 0, 0};   // angular joint velocity
        V3 vj = {0, 0, 0};   // linear joint velocity (parent-frame axes)
        switch (mm.jtype[i]) {
        case 0: wj = qdi[0] * mul(R[i], v3(mm.axis + 3 * i)); break;
        case 1: vj = qdi[0] * mul(rp, v3(mm.axis + 3 * i)); break;
        case 2: wj = mul(R[i], V3{qdi[0], qdi[1], qdi[2]}); break;
        default:
            vj = mul(rp, V3{qdi[0], qdi[1], qdi[2]});
            wj = mul(R[i], V3{qdi[3], qdi[4], qdi[5]});
            break;
        }
        w[i] = wp + wj;
        // qdd = 0: the only angular-acceleration term is the transport
        // derivative w_i x wj, which equals wp x wj.
        dw[i] = dwp + cross(wp, wj);
        vo[i] = vp + cross(wp, r) + vj;
        ao[i] = ap + cross(dwp, r) + cross(wp, cross(wp, r))
              + 2.0 * cross(wp, vj);
        V3 rc = mul(R[i], v3(mm.com + 3 * i));
        V3 acc_c = ao[i] + cross(dw[i], rc) + cross(w[i], cross(w[i], rc));
        M3 iw = world_inertia(R[i], mm.inertia + 9 * i);
        Fc[i] = mm.mass[i] * (acc_c - g);
        Nc[i] = mul(iw, dw[i]) + cross(w[i], mul(iw, w[i]));
        fa[i] = {0, 0, 0}; na[i] = {0, 0, 0};
    }
    for (int64_t i = mm.n - 1; i >= 0; --i) {
        int64_t pi = mm.parent[i];
        M3 rp = (pi < 0) ? eye3() : R[pi];
        V3 rc = mul(R[i], v3(mm.com + 3 * i));
        V3 f = Fc[i] + fa[i];
        V3 nmom = Nc[i] + cross(rc, Fc[i]) + na[i];
        double* out = bias_out + mm.voff[i];
        switch (mm.jtype[i]) {
        case 0: out[0] = dot(mul(R[i], v3(mm.axis + 3 * i)), nmom); break;
        case 1: out[0] = dot(mul(rp, v3(mm.axis + 3 * i)), f); break;
        case 2:
            for (int k = 0; k < 3; ++k) out[k] = dot(col(R[i], k), nmom);
            break;
        default:
            for (int k = 0; k < 3; ++k) {
                out[k] = dot(col(rp, k), f);
                out[3 + k] = dot(col(R[i], k), nmom);
            }
            break;
        }
        if (pi >= 0) {
            fa[pi] = fa[pi] + f;
            na[pi] = na[pi] + nmom + cross(P[i] - P[pi], f);
        }
    }
}

}  // namespace

extern "C" {

void chain_mass_matrix(int64_t n, const int64_t* parent,
                       const int64_t* jtype, const double* axis,
                       const double* body_pos, const double* mass,
                       const double* com, const double* inertia,
                       const double* q, double* m_out) {
    ChainModel mm{n, parent, jtype, axis, body_pos, mass, com, inertia};
    mm.offsets();
    mass_matrix_impl(mm, q, m_out);
}

void chain_bias(int64_t n, const int64_t* parent, const int64_t* jtype,
                const double* axis, const double* body_pos,
                const double* mass, const double* com,
                const double* inertia, const double* gravity,
                const double* q, const double* qd, double* bias_out) {
    ChainModel mm{n, parent, jtype, axis, body_pos, mass, com, inertia};
    mm.offsets();
    bias_impl(mm, gravity, q, qd, bias_out);
}

void chain_site(int64_t n, const int64_t* parent, const int64_t* jtype,
                const double* axis, const double* body_pos,
                const double* q, int64_t site_body,
                const double* site_pos, double* out3) {
    ChainModel mm{n, parent, jtype, axis, body_pos, nullptr, nullptr,
                  nullptr};
    mm.offsets();
    std::vector<M3> R; std::vector<V3> P;
    fk(mm, q, R, P);
    V3 s = P[site_body] + mul(R[site_body], v3(site_pos));
    out3[0] = s.x; out3[1] = s.y; out3[2] = s.z;
}

// Semi-implicit Euler with implicit joint damping, scalar-joint limit
// projection, and quaternion exp-map retraction — the engine's step()
// semantics, serial f64. Stiffness applies to scalar joints only.
void chain_step(int64_t n, const int64_t* parent, const int64_t* jtype,
                const double* axis, const double* body_pos,
                const double* mass, const double* com,
                const double* inertia, const double* armature,
                const double* damping, const double* stiffness,
                const double* gear, const double* qlow,
                const double* qhigh, const double* gravity,
                double dt, int64_t n_substeps,
                const double* ctrl, double* q, double* qd) {
    ChainModel mm{n, parent, jtype, axis, body_pos, mass, com, inertia};
    mm.offsets();
    int64_t nv = mm.nv;
    std::vector<double> M(nv * nv), bias(nv), rhs(nv), acc(nv);
    for (int64_t s = 0; s < n_substeps; ++s) {
        mass_matrix_impl(mm, q, M.data());
        bias_impl(mm, gravity, q, qd, bias.data());
        for (int64_t i = 0; i < nv; ++i) {
            M[i * nv + i] += armature[i] + dt * damping[i];
            rhs[i] = gear[i] * ctrl[i] - bias[i] - damping[i] * qd[i];
        }
        for (int64_t b = 0; b < n; ++b)   // scalar-joint springs
            if (jtype[b] <= 1)
                rhs[mm.voff[b]] -= stiffness[mm.voff[b]] * q[mm.qoff[b]];
        // Cholesky solve (M is SPD)
        for (int64_t i = 0; i < nv; ++i)
            for (int64_t j = 0; j <= i; ++j) {
                double sum = M[i * nv + j];
                for (int64_t k = 0; k < j; ++k)
                    sum -= M[i * nv + k] * M[j * nv + k];
                M[i * nv + j] = (i == j) ? std::sqrt(sum)
                                         : sum / M[j * nv + j];
            }
        for (int64_t i = 0; i < nv; ++i) {
            double sum = rhs[i];
            for (int64_t k = 0; k < i; ++k) sum -= M[i * nv + k] * acc[k];
            acc[i] = sum / M[i * nv + i];
        }
        for (int64_t i = nv - 1; i >= 0; --i) {
            double sum = acc[i];
            for (int64_t k = i + 1; k < nv; ++k)
                sum -= M[k * nv + i] * acc[k];
            acc[i] = sum / M[i * nv + i];
        }
        for (int64_t i = 0; i < nv; ++i) qd[i] += dt * acc[i];
        // retraction
        for (int64_t b = 0; b < n; ++b) {
            double* qi = q + mm.qoff[b];
            double* qdi = qd + mm.voff[b];
            switch (jtype[b]) {
            case 0: case 1: {
                qi[0] += dt * qdi[0];
                int64_t qo = mm.qoff[b];
                if (qi[0] < qlow[qo]) { qi[0] = qlow[qo]; qdi[0] = 0.0; }
                if (qi[0] > qhigh[qo]) { qi[0] = qhigh[qo]; qdi[0] = 0.0; }
                break;
            }
            case 2: {
                double e[4], o[4];
                exp_quat({dt * qdi[0], dt * qdi[1], dt * qdi[2]}, e);
                quat_mul(qi, e, o);
                double nn = std::sqrt(o[0]*o[0]+o[1]*o[1]+o[2]*o[2]+o[3]*o[3]);
                for (int k = 0; k < 4; ++k) qi[k] = o[k] / nn;
                break;
            }
            default: {
                for (int k = 0; k < 3; ++k) qi[k] += dt * qdi[k];
                double e[4], o[4];
                exp_quat({dt * qdi[3], dt * qdi[4], dt * qdi[5]}, e);
                quat_mul(qi + 3, e, o);
                double nn = std::sqrt(o[0]*o[0]+o[1]*o[1]+o[2]*o[2]+o[3]*o[3]);
                for (int k = 0; k < 4; ++k) qi[3 + k] = o[k] / nn;
                break;
            }
            }
        }
    }
}

// Serial f64 open-loop rollout of a chain task: per particle, from
// (q0,qd0), H steps of u[t] = clip(mean[t] + noise[b,t], ulow, uhigh)
// with n_substeps engine substeps each, recording the site world
// position after every step into sites_out [N,H,3]. Task costs
// (reacher -l1-5l2 of reacher_env.py:29-39, peg depth shaping) are
// computed host-side from the sites, keeping this entry task-agnostic.
// Mirrors the reference's serial per-particle hot loop
// (gym_env_wrapper.py:123-153). Control dim == nv (scalar-joint arms).
void chain_site_rollout(int64_t n, const int64_t* parent,
                        const int64_t* jtype, const double* axis,
                        const double* body_pos, const double* mass,
                        const double* com, const double* inertia,
                        const double* armature, const double* damping,
                        const double* stiffness, const double* gear,
                        const double* qlow, const double* qhigh,
                        const double* gravity, double dt,
                        int64_t n_substeps, const double* q0,
                        const double* qd0, const double* mean,
                        const double* noise, int64_t N, int64_t H,
                        double ulow, double uhigh, int64_t site_body,
                        const double* site_pos, double* sites_out) {
    ChainModel mm{n, parent, jtype, axis, body_pos, mass, com, inertia};
    mm.offsets();
    int64_t nv = mm.nv, nq = mm.nq;
    std::vector<double> q(nq), qd(nv), u(nv);
    for (int64_t b = 0; b < N; ++b) {
        std::copy(q0, q0 + nq, q.begin());
        std::copy(qd0, qd0 + nv, qd.begin());
        for (int64_t t = 0; t < H; ++t) {
            for (int64_t k = 0; k < nv; ++k) {
                double v = mean[t * nv + k] + noise[(b * H + t) * nv + k];
                u[k] = std::min(std::max(v, ulow), uhigh);
            }
            chain_step(n, parent, jtype, axis, body_pos, mass, com,
                       inertia, armature, damping, stiffness, gear,
                       qlow, qhigh, gravity, dt, n_substeps, u.data(),
                       q.data(), qd.data());
            chain_site(n, parent, jtype, axis, body_pos, q.data(),
                       site_body, site_pos, sites_out + (b * H + t) * 3);
        }
    }
}

}  // extern "C"
