// The control block of the device-resident Merson controller: the state of
// merson_solve's loop (solvers/merson.py), its per-call constants and the
// scalars of the next attempt's stages, in device memory.  One
// layout for the host (ops/cuda/control.py mirrors it field by field and
// checks its size against pft_control_size()) and every kernel:
//
//   control.cu       pft_merson_control: the step control of one attempt
//                    (reads the eps partials, writes the state, the accept
//                    flag, the trace and the next attempt's scalars);
//                    pft_commit: the accepted-state update, read from the
//                    accept flag on the device;
//   fused_stage.cu, fused_attempt.cu, delta_g.cu
//                    the _dev entries of the stage kernels, which read
//                    (t_s, h) or (h, D1, dDi) of their stage from here
//                    (the float64 stage entry: ts64 and hs) and return at
//                    once once the loop has halted;
//   ops/cuda/control.py RHSAttempt
//                    the plain PyTorch stages of the DEM and of the
//                    freezing f64 and noise paths, which read the float64
//                    coefficients hs and stage times ts64 through 0-d
//                    views of the block.
#pragma once

#include <stdint.h>

namespace pft {

struct Control {
    // the controller's state, in float64 as the host loop keeps it
    double t, h, h_cont;
    // per-call constants: the end time, the step control, and the
    // Dirichlet top (top1 before t_switch, top2 from it) in float64
    double tf, delta, h_min, growth_min;
    double top1, top2, t_switch;
    // the float64 stage coefficients of the next attempt, h/3, h/6, h/8
    // and h, each rounded as the host loop's Python floats round them
    double hs[4];
    // the float64 stage times of the next attempt, t, t + h/3, t + h/2 and
    // t + h, formed as the host loop's Python floats are formed
    double ts64[4];
    long long steps, steps_total;
    long long start_steps, start_total, max_steps;
    // device memory: the eps partials of the stage-5 tail (float32, or
    // float64 where eps_f64 is set), the (t, h) trace of accepted steps
    // (n_trace entries each, or null)
    const void* eps;
    double* t_tr;
    double* h_tr;
    long long eps_n;
    int n_trace;
    int finished, done;
    int halt;          // the loop's condition is false: done, or max_steps
                       // attempts in this call
    int status, accept;
    int handle_nan, local_mode;
    int eps_f64;       // the eps partials are float64 (a DEM state's width)
    // the float32 scalars of the next attempt, formed from t and h as the
    // host loop forms them: the stage times t, t + h/3, t + h/3, t + h/2,
    // t + h; h; the Dirichlet value D(t) and D(t_s) - D(t) of stages 2-5
    // (dD[0] = 0), differences taken in float64
    float ts[5];
    float h32;
    float D1;
    float dD[5];
};

// The stage a _dev entry computes (0-4) and its coefficients c_a in the
// field's width T: in float32 the c_a from which it forms h*c_a as the host
// forms them for the by-value entries; in float64 the c_a of the sums of
// merson_stages (stage.cuh stage_scalars).
template <class T>
struct DevStageT {
    const Control* ctl;
    T coef[3];
    int stage;
};
using DevStage = DevStageT<float>;

// The DevStage of a _dev entry's launch: its nk coefficients coefs (host
// memory), 0 past them.
template <class T>
inline DevStageT<T> dev_stage(const void* ctl, int stage, int nk,
                              const T* coefs) {
    return DevStageT<T>{static_cast<const Control*>(ctl),
                        {nk > 0 ? coefs[0] : T(0), nk > 1 ? coefs[1] : T(0),
                         nk > 2 ? coefs[2] : T(0)}, stage};
}

}  // namespace pft
