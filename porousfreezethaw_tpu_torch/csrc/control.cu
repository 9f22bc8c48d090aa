// The device-resident Merson controller: the step control of one attempt
// and the accepted-state update, on the control block of control.cuh.
//
// Replaces no Pallas kernel: these are the counterpart of the body of the
// JAX package's lax.while_loop controller, which XLA compiles
// (porousfreezethaw_tpu/solvers/merson.py:239-361, body_fun; the update
// select at :283-309).  With them an attempt is its five stage launches
// (the _dev entries of the stage kernels), pft_merson_control and
// pft_commit, all reading their scalars from device memory, so that a
// block of attempts is captured once in a CUDA graph and the host reads
// the control block back once per block (ops/cuda/control.py).
//
// pft_merson_control is one block.  It reduces the eps partials of the
// stage-5 tail with the NaN-propagating max, in their width (float32 for
// the freezing kernels, float64 or float32 for the DEM's leaf maxima,
// models/dem/attempt.py), then one thread runs the
// per-attempt logic of the host loop (solvers/merson.py merson_solve) in
// float64, every operation an _rn intrinsic, so that nvcc contracts none
// of them and each rounds as Python's float does: the local mode's |h/3|,
// the growth factor 0.8 (delta/eps)^0.2 (2 for eps = 0 or NaN, 0 for inf),
// accept_growth_min on eps < delta, the NaN backoff and its abort, the
// trimming of the last step and the continuation h, the per-call
// max_steps, the status, the trace write at the clipped index; then the
// scalars of the next attempt: the float32 ones of the stage kernels, the
// float64 coefficients h/3, h/6, h/8, h and the float64 stage times t,
// t + h/3, t + h/2, t + h of the plain PyTorch stages.  The
// power is correctly rounded (pow_02 below), as the host's
// solvers/merson.py pow_02 is: neither the C library's pow, which
// Python's ** calls, nor CUDA's is.
//
// pft_commit reads the accept flag and returns at once when it is 0, so a
// rejected attempt costs one empty launch.  Otherwise it copies (u, p) of
// y_spec into the state (DeltaAttempt, the stage path; the DEM's float64
// or float32 leaves, copied as 4-byte words), adds the
// increment dy into the (hi, lo) planes by TwoSum (DeltaAttemptComp), or
// flips the slot index cur (FusedAttempt).
//
// What bounds them on Hopper: pft_merson_control moves a few hundred
// bytes (the partials and the block) and does some hundred float64
// operations; its time is the launch.  The copy and TwoSum commits are
// bound by their bytes: 4 planes (copy) or 10 (TwoSum) of the grid, or
// twice the DEM state, each thread moving 16 bytes at a time where the
// planes allow it.
#include <cuda_runtime.h>
#include <math.h>

#include <type_traits>

#include "control.cuh"
#include "freezing.cuh"

namespace pft {

constexpr int NAN_ABORT = -4;     // solvers/merson.py NAN_ABORT
constexpr int CONTROL_THREADS = 256;
constexpr int COMMIT_COPY = 0, COMMIT_TWOSUM = 1, COMMIT_FLIP = 2;
constexpr int COMMIT_THREADS = 256;

// ---------------------------------------------------------------------------
// q ** 0.2, correctly rounded
// ---------------------------------------------------------------------------

struct DD { double hi, lo; };     // hi + lo, |lo| <= ulp(hi)/2

__device__ __forceinline__ DD dd_mul(DD a, DD b) {
    const double p = __dmul_rn(a.hi, b.hi);
    double e = __fma_rn(a.hi, b.hi, -p);
    e = __fma_rn(a.hi, b.lo, e);
    e = __fma_rn(a.lo, b.hi, e);
    e = __fma_rn(a.lo, b.lo, e);
    const double hi = __dadd_rn(p, e);
    return DD{hi, __dsub_rn(e, __dsub_rn(hi, p))};
}

// Whether the exact q ** 0.2, whose fifth power is th + tl, lies beyond the
// midpoint of y and its neighbour z, on the side of z.  The midpoint is
// (y, (z - y)/2) exactly; its fifth power in double-double is good to
// about 2^-100 relative.
__device__ __forceinline__ bool beyond_mid(double th, double tl, double y,
                                           double z) {
    const DD m{y, __dmul_rn(__dsub_rn(z, y), 0.5)};
    const DD m2 = dd_mul(m, m), m4 = dd_mul(m2, m2), m5 = dd_mul(m4, m);
    const double d = __dadd_rn(__dsub_rn(th, m5.hi), __dsub_rn(tl, m5.lo));
    return z > y ? d > 0.0 : !(d > 0.0);
}

// q ** 0.2 correctly rounded, for q >= 0 (solvers/merson.py pow_02, which
// compares in exact integers).  0.2 in binary is 1/5 + 2^-54/5, so the
// fifth power of the exact result is q exp(log(q) 2^-54), which
// q + q log(q) 2^-54 gives to about 2^-100 relative.  CUDA's pow is within
// a few ulps; each step moves it to a neighbour while the exact value lies
// beyond the midpoint.
__device__ double pow_02(double q) {
    double y = pow(q, 0.2);
    if (!(y > 0.0 && y < INFINITY)) return y;
    const double th = q;
    const double tl = __dmul_rn(__dmul_rn(q, log(q)), 0x1p-54);
    for (int i = 0; i < 8; ++i) {
        // the neighbours of the positive y (nextafter toward inf and 0)
        const long long bits = __double_as_longlong(y);
        const double up = __longlong_as_double(bits + 1);
        const double dn = __longlong_as_double(bits - 1);
        if (beyond_mid(th, tl, y, up))
            y = up;
        else if (beyond_mid(th, tl, y, dn))
            y = dn;
        else
            break;
    }
    return y;
}

// ---------------------------------------------------------------------------
// the step control
// ---------------------------------------------------------------------------

__device__ __forceinline__ double top_of(const Control& c, double t) {
    return t < c.t_switch ? c.top1 : c.top2;
}

// The scalars of the next attempt from c.t and c.h
// (ops/cuda/control.py next_scalars_plain).
__device__ void next_scalars(Control& c) {
    const double t = c.t, h = c.h;
    c.hs[0] = __ddiv_rn(h, 3.0);
    c.hs[1] = __ddiv_rn(h, 6.0);
    c.hs[2] = __ddiv_rn(h, 8.0);
    c.hs[3] = h;
    const double t3 = __dadd_rn(t, c.hs[0]);
    const double t2 = __dadd_rn(t, __ddiv_rn(h, 2.0));
    const double t1 = __dadd_rn(t, h);
    c.ts64[0] = t;
    c.ts64[1] = t3;
    c.ts64[2] = t2;
    c.ts64[3] = t1;
    c.ts[0] = __double2float_rn(t);
    c.ts[1] = c.ts[2] = __double2float_rn(t3);
    c.ts[3] = __double2float_rn(t2);
    c.ts[4] = __double2float_rn(t1);
    c.h32 = __double2float_rn(h);
    const double D = top_of(c, t);
    c.D1 = __double2float_rn(D);
    c.dD[0] = 0.0f;
    c.dD[1] = c.dD[2] = __double2float_rn(__dsub_rn(top_of(c, t3), D));
    c.dD[3] = __double2float_rn(__dsub_rn(top_of(c, t2), D));
    c.dD[4] = __double2float_rn(__dsub_rn(top_of(c, t1), D));
}

// One attempt's step control on its error estimate eps_in (the partials'
// max, exact in float64): the loop body of merson_solve after the stages,
// line for line (ops/cuda/control.py control_plain).
__device__ void control_step(Control& c, double eps_in) {
    const double t = c.t, h = c.h;
    const double h3 = __ddiv_rn(h, 3.0);
    c.steps_total += 1;
    double eps = eps_in;
    if (c.local_mode) eps = __dmul_rn(eps, fabs(h3));
    // eps == 0 and a NaN eps take 2; eps == inf gives 0
    double fac = eps > 0.0 ? __dmul_rn(0.8, pow_02(__ddiv_rn(c.delta, eps)))
                           : 2.0;
    const bool nan_occurred = c.handle_nan && !isfinite(eps);
    const bool accept = eps < c.delta || fabs(h) < c.h_min;
    if (c.growth_min > 1.0 && eps < c.delta && c.growth_min > fac)
        fac = c.growth_min;
    const double new_h = __dmul_rn(fac, h);
    const bool upd = accept && !nan_occurred;
    const double t_new = upd ? __dadd_rn(t, h) : t;
    const long long steps_new = upd ? c.steps + 1 : c.steps;
    // the NaN backoff and its abort
    const double left = __dsub_rn(c.tf, t);
    const bool too_small = left != 0.0 && fabs(__ddiv_rn(h, left)) < 1e-11;
    const bool nan_abort = nan_occurred && too_small;
    // the last step: trimmed to tf, the untrimmed estimate kept
    const bool next_finish = fabs(__dsub_rn(c.tf, t_new)) <= fabs(new_h);
    const bool done = (upd && c.finished) || nan_abort;
    if (nan_abort) c.status = NAN_ABORT;
    const double h_next = nan_occurred ? __ddiv_rn(h, 10.0)
                          : upd && next_finish ? __dsub_rn(c.tf, t_new)
                          : new_h;
    if (upd && next_finish && !done) c.h_cont = new_h;
    c.finished = nan_occurred ? 0 : upd ? (int)next_finish : 0;
    if (c.n_trace > 0 && upd) {
        long long idx = steps_new - c.start_steps - 1;
        idx = idx < 0 ? 0 : idx > c.n_trace - 1 ? c.n_trace - 1 : idx;
        c.t_tr[idx] = t_new;
        c.h_tr[idx] = h;
    }
    c.t = t_new;
    c.h = h_next;
    c.steps = steps_new;
    c.done = done;
    c.accept = upd;
    c.halt = done || c.steps_total - c.start_total >= c.max_steps;
    next_scalars(c);
}

__device__ __forceinline__ double nan_max(double a, double b) {
    return (a > b || a != a) ? a : b;
}

// The NaN-propagating max of the n partials at eps, in their width T, for
// thread 0 (the other threads' results are partial).
template <typename T>
__device__ T eps_max(const void* eps_v, long long n) {
    __shared__ T warp_max[CONTROL_THREADS / 32];
    const T* eps = static_cast<const T*>(eps_v);
    T m = -INFINITY;
    for (long long i = threadIdx.x; i < n; i += CONTROL_THREADS)
        m = nan_max(m, eps[i]);
    for (int off = 16; off > 0; off >>= 1)
        m = nan_max(m, __shfl_down_sync(0xffffffffu, m, off));
    if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = m;
    __syncthreads();
    if (threadIdx.x == 0)
        for (int i = 1; i < CONTROL_THREADS / 32; ++i)
            m = nan_max(m, warp_max[i]);
    return m;
}

__global__ void __launch_bounds__(CONTROL_THREADS)
merson_control_kernel(Control* c) {
    // a halted loop (the idle attempts at the end of a captured block)
    // commits nothing
    if (c->halt) {
        if (threadIdx.x == 0) c->accept = 0;
        return;
    }
    // every thread reads the same flag, so the branch is uniform
    const double m = c->eps_f64 ? eps_max<double>(c->eps, c->eps_n)
                                : (double)eps_max<float>(c->eps, c->eps_n);
    if (threadIdx.x == 0) control_step(*c, m);
}

// ---------------------------------------------------------------------------
// the commit
// ---------------------------------------------------------------------------

// hi + dy into (hi, lo) by Knuth's TwoSum, as models/freezing/delta.py
// two_sum rounds it
__device__ __forceinline__ void two_sum_into(float& hi, float& lo, float dy) {
    const float t1 = __fadd_rn(dy, lo);
    const float s = __fadd_rn(hi, t1);
    const float bb = __fsub_rn(s, hi);
    const float err = __fadd_rn(__fsub_rn(hi, __fsub_rn(s, bb)),
                                __fsub_rn(t1, bb));
    hi = s;
    lo = err;
}

template <int MODE, int VEC>
__global__ void __launch_bounds__(COMMIT_THREADS)
commit_kernel(const Control* c, float* hi, float* lo, const float* src,
              int* cur, long long n) {
    if (!c->accept) return;
    if (MODE == COMMIT_FLIP) {
        if (blockIdx.x == 0 && threadIdx.x == 0) *cur ^= 1;
        return;
    }
    using V = typename std::conditional<VEC == 4, float4, float>::type;
    const long long nv = n / VEC;
    const long long stride = (long long)gridDim.x * COMMIT_THREADS;
    for (long long i = (long long)blockIdx.x * COMMIT_THREADS + threadIdx.x;
         i < nv; i += stride) {
        const V s = reinterpret_cast<const V*>(src)[i];
        if (MODE == COMMIT_COPY) {
            reinterpret_cast<V*>(hi)[i] = s;
            continue;
        }
        V h = reinterpret_cast<V*>(hi)[i], l = reinterpret_cast<V*>(lo)[i];
        float* hp = reinterpret_cast<float*>(&h);
        float* lp = reinterpret_cast<float*>(&l);
        const float* sp = reinterpret_cast<const float*>(&s);
#pragma unroll
        for (int k = 0; k < VEC; ++k) two_sum_into(hp[k], lp[k], sp[k]);
        reinterpret_cast<V*>(hi)[i] = h;
        reinterpret_cast<V*>(lo)[i] = l;
    }
}

template <int MODE, int VEC>
static int launch_commit(const Control* c, float* hi, float* lo,
                         const float* src, int* cur, long long n,
                         cudaStream_t s) {
    long long blocks = MODE == COMMIT_FLIP
        ? 1 : (n / VEC + COMMIT_THREADS - 1) / COMMIT_THREADS;
    blocks = blocks < 1 ? 1 : blocks > 2048 ? 2048 : blocks;
    commit_kernel<MODE, VEC><<<(unsigned)blocks, COMMIT_THREADS, 0, s>>>(
        c, hi, lo, src, cur, n);
    return (int)cudaGetLastError();
}

__global__ void pow_02_kernel(const double* q, double* out, long long n) {
    const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i < n) out[i] = pow_02(q[i]);
}

}  // namespace pft

using namespace pft;

extern "C" {

// sizeof(Control), which the host's mirror of the layout must equal
int pft_control_size(void) { return (int)sizeof(Control); }

// The step control of one attempt on the control block ctl (device
// memory), on stream.  Returns cudaGetLastError() after the launch.
int pft_merson_control(void* ctl, void* stream) {
    if (!ctl) return 1001;
    merson_control_kernel<<<1, CONTROL_THREADS, 0,
                            static_cast<cudaStream_t>(stream)>>>(
        static_cast<Control*>(ctl));
    return (int)cudaGetLastError();
}

// The commit of one attempt when ctl's accept flag is set: mode 0 copies n
// elements of elem_bytes (4 or 8) of src into hi, as 4-byte words; mode 1
// adds n floats of src into (hi, lo) by TwoSum; mode 2 flips *cur.  Every
// pointer is device memory.  Returns cudaGetLastError() after the launch;
// 1000 + n for bad arguments.
int pft_commit(const void* ctl, int mode, void* hi_v, void* lo_v,
               const void* src_v, int* cur, long long n, int elem_bytes,
               void* stream) {
    const Control* c = static_cast<const Control*>(ctl);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    float* hi = static_cast<float*>(hi_v);
    float* lo = static_cast<float*>(lo_v);
    const float* src = static_cast<const float*>(src_v);
    if (!c) return 1001;
    if (elem_bytes != 4 && !(elem_bytes == 8 && mode == COMMIT_COPY))
        return 1004;
    // a copy moves bits: a float64 element is two 4-byte words
    n *= elem_bytes / 4;
    if (mode == COMMIT_FLIP)
        return cur ? launch_commit<COMMIT_FLIP, 1>(c, hi, lo, src, cur, n, s)
                   : 1002;
    if (mode != COMMIT_COPY && mode != COMMIT_TWOSUM) return 1003;
    if (!hi || !src || (mode == COMMIT_TWOSUM && !lo) || n < 1) return 1002;
    const uintptr_t addr = reinterpret_cast<uintptr_t>(hi)
                           | reinterpret_cast<uintptr_t>(lo)
                           | reinterpret_cast<uintptr_t>(src);
    const bool wide = n % 4 == 0 && addr % 16 == 0;
    if (mode == COMMIT_COPY)
        return wide ? launch_commit<COMMIT_COPY, 4>(c, hi, lo, src, cur, n, s)
                    : launch_commit<COMMIT_COPY, 1>(c, hi, lo, src, cur, n, s);
    return wide ? launch_commit<COMMIT_TWOSUM, 4>(c, hi, lo, src, cur, n, s)
                : launch_commit<COMMIT_TWOSUM, 1>(c, hi, lo, src, cur, n, s);
}

// out[i] = pow_02(q[i]) for i < n: the control kernel's power on given
// values, to compare it with the host's.
int pft_pow_02(const double* q, double* out, long long n, void* stream) {
    if (!q || !out || n < 1) return 1002;
    pow_02_kernel<<<(unsigned)((n + 255) / 256), 256, 0,
                    static_cast<cudaStream_t>(stream)>>>(q, out, n);
    return (int)cudaGetLastError();
}

}  // extern "C"
