"""C source templates for embedded code generation.

The port's own copy of ``osqp_tpu/codegen/ctemplates.py``: the same text,
with only the generator's name in the emitted comments changed.  The emitted
artifact is a self-contained ADMM solver in plain C with a statically
allocated workspace (no malloc), dense (a baked Cholesky factor) or sparse
(CSR operands and a Jacobi-PCG KKT solve), plus a CPython-C-API extension
wrapper.

Generated module surface (parity with the reference wrapper):

    solve() -> (x, y, status_val, iter, run_time)
    update_data_vec(q=None, l=None, u=None) -> int
    update_data_mat(P_x=None, P_i=None, A_x=None, A_i=None) -> int   [mode 2]

Tokens of the form @NAME@ are substituted by the driver.
"""

SOLVER_C = r'''
/* Embedded OSQP-class dense ADMM solver - generated by osqp_tpu_torch.codegen.
 * Statically allocated workspace; no heap, no I/O (profiling via
 * clock_gettime when OSQP_TPU_PROFILING is set).
 *
 * Algorithm: ADMM on  min 1/2 x'Px + q'x  s.t. l <= Ax <= u  with the
 * normal-equations KKT reduction M = P + sigma I + A' diag(rho) A
 * (Cholesky factor baked at generation time; refactorized in-place after
 * matrix updates when EMBEDDED_MODE == 2).
 */

#include <math.h>
#include <string.h>
#if @PROFILING@
#include <time.h>
#endif
#if @PRINTING@
#include <stdio.h>
#endif

#include "@PREFIX@workspace.h"

#define EMB_N @N@
#define EMB_M @M@
#define EMBEDDED_MODE @MODE@
#define EMB_PRINTING @PRINTING@
#define EMB_PROFILING @PROFILING@
#define EMB_INTERRUPT @INTERRUPT@
#define EMB_DERIVATIVES @DERIVATIVES@

#if @INTERRUPT@
/* cooperative interruption: another thread / a signal handler sets the flag
 * via @PREFIX@osqp_request_interrupt(); the solve loop polls it at every
 * termination check and returns EMB_SIGINT (reference: OSQP_ENABLE_INTERRUPT
 * define, /root/reference/src/osqp/interface.py:476). */
static volatile int @PREFIX@interrupt_flag = 0;
void @PREFIX@osqp_request_interrupt(void) { @PREFIX@interrupt_flag = 1; }
#define EMB_SIGINT 10
#endif

typedef @FLOAT@ emb_float;
typedef int emb_int;

/* ------------------------------------------------------------------ */
/* status codes (match osqp_tpu.constants.SolverStatus)               */
#define EMB_SOLVED 1
#define EMB_SOLVED_INACCURATE 2
#define EMB_PRIMAL_INFEASIBLE 3
#define EMB_DUAL_INFEASIBLE 5
#define EMB_MAX_ITER_REACHED 7
#define EMB_UNSOLVED 11

#define EMB_INFTY ((emb_float)1e30)
#define EMB_MIN_SCALING ((emb_float)1e-4)

static emb_float emb_inf_norm(const emb_float* v, int k) {
    emb_float r = (emb_float)0;
    for (int i = 0; i < k; ++i) { emb_float a = fabs((double)v[i]); if (a > r) r = a; }
    return r;
}

/* y <- A x   (A is EMB_M x EMB_N row-major) */
static void emb_Ax(const emb_float* A, const emb_float* x, emb_float* y) {
    for (int i = 0; i < EMB_M; ++i) {
        emb_float s = 0;
        const emb_float* row = A + (size_t)i * EMB_N;
        for (int j = 0; j < EMB_N; ++j) s += row[j] * x[j];
        y[i] = s;
    }
}

/* y <- A' v */
static void emb_Aty(const emb_float* A, const emb_float* v, emb_float* y) {
    for (int j = 0; j < EMB_N; ++j) y[j] = 0;
    for (int i = 0; i < EMB_M; ++i) {
        const emb_float* row = A + (size_t)i * EMB_N;
        emb_float vi = v[i];
        for (int j = 0; j < EMB_N; ++j) y[j] += row[j] * vi;
    }
}

/* y <- P x  (P is EMB_N x EMB_N row-major symmetric) */
static void emb_Px(const emb_float* P, const emb_float* x, emb_float* y) {
    for (int i = 0; i < EMB_N; ++i) {
        emb_float s = 0;
        const emb_float* row = P + (size_t)i * EMB_N;
        for (int j = 0; j < EMB_N; ++j) s += row[j] * x[j];
        y[i] = s;
    }
}

/* solve L L' s = b in place (L lower, row-major) */
static void emb_chol_solve(const emb_float* L, emb_float* b) {
    for (int i = 0; i < EMB_N; ++i) {
        emb_float s = b[i];
        const emb_float* row = L + (size_t)i * EMB_N;
        for (int j = 0; j < i; ++j) s -= row[j] * b[j];
        b[i] = s / row[i];
    }
    for (int i = EMB_N - 1; i >= 0; --i) {
        emb_float s = b[i];
        for (int j = i + 1; j < EMB_N; ++j) s -= L[(size_t)j * EMB_N + i] * b[j];
        b[i] = s / L[(size_t)i * EMB_N + i];
    }
}

/* in-place dense Cholesky of M into L; returns 0 on success */
static int emb_cholesky(const emb_float* M, emb_float* L) {
    for (int i = 0; i < EMB_N * EMB_N; ++i) L[i] = 0;
    for (int i = 0; i < EMB_N; ++i) {
        for (int j = 0; j <= i; ++j) {
            emb_float s = M[(size_t)i * EMB_N + j];
            for (int k = 0; k < j; ++k)
                s -= L[(size_t)i * EMB_N + k] * L[(size_t)j * EMB_N + k];
            if (i == j) {
                if (s <= (emb_float)0) return 1;
                L[(size_t)i * EMB_N + j] = (emb_float)sqrt((double)s);
            } else {
                L[(size_t)i * EMB_N + j] = s / L[(size_t)j * EMB_N + j];
            }
        }
    }
    return 0;
}

/* rebuild M = P + sigma I + A' diag(rho) A and refactorize */
static int emb_refactor(void) {
    static emb_float Mbuf[EMB_N * EMB_N];
    for (int i = 0; i < EMB_N; ++i)
        for (int j = 0; j < EMB_N; ++j)
            Mbuf[(size_t)i * EMB_N + j] = @PREFIX@P[(size_t)i * EMB_N + j]
                + ((i == j) ? @PREFIX@settings.sigma : (emb_float)0);
    for (int k = 0; k < EMB_M; ++k) {
        const emb_float* row = @PREFIX@A + (size_t)k * EMB_N;
        emb_float rk = @PREFIX@rho_vec[k];
        for (int i = 0; i < EMB_N; ++i) {
            emb_float rki = rk * row[i];
            for (int j = 0; j < EMB_N; ++j)
                Mbuf[(size_t)i * EMB_N + j] += rki * row[j];
        }
    }
    return emb_cholesky(Mbuf, @PREFIX@L);
}

/* Adaptive rho (goes beyond the reference's embedded mode, which fixes rho):
 * the dense in-place refactorization makes rho adaptation feasible with a
 * static workspace. */
static void emb_adapt_rho(void) {
    @PREFIX@Workspace* w = &@PREFIX@work;
    static emb_float Axv[EMB_M > 0 ? EMB_M : 1];
    static emb_float Pxv[EMB_N];
    static emb_float Atyv[EMB_N];
    emb_Ax(@PREFIX@A, w->x, Axv);
    emb_Px(@PREFIX@P, w->x, Pxv);
    emb_Aty(@PREFIX@A, w->y, Atyv);
    emb_float num_p = 0, den_p = 0;
    for (int i = 0; i < EMB_M; ++i) {
        emb_float r = fabs((double)(Axv[i] - w->z[i]));
        if (r > num_p) num_p = r;
        emb_float a = fabs((double)Axv[i]); if (a > den_p) den_p = a;
        emb_float b = fabs((double)w->z[i]); if (b > den_p) den_p = b;
    }
    emb_float pri = num_p / (den_p + (emb_float)1e-10);
    emb_float num_d = 0, den_d = 0;
    for (int j = 0; j < EMB_N; ++j) {
        emb_float r = fabs((double)(Pxv[j] + @PREFIX@q[j] + Atyv[j]));
        if (r > num_d) num_d = r;
        emb_float a = fabs((double)Atyv[j]); if (a > den_d) den_d = a;
        emb_float b = fabs((double)Pxv[j]); if (b > den_d) den_d = b;
        emb_float cq = fabs((double)@PREFIX@q[j]); if (cq > den_d) den_d = cq;
    }
    emb_float dua = num_d / (den_d + (emb_float)1e-10);
    emb_float new_rho = @PREFIX@settings.rho *
        (emb_float)sqrt((double)(pri / (dua + (emb_float)1e-10)));
    if (new_rho < (emb_float)1e-6) new_rho = (emb_float)1e-6;
    if (new_rho > (emb_float)1e6) new_rho = (emb_float)1e6;
    emb_float tol = (emb_float)5.0;
    if (new_rho > tol * @PREFIX@settings.rho || new_rho < @PREFIX@settings.rho / tol) {
        @PREFIX@settings.rho = new_rho;
        for (int i = 0; i < EMB_M; ++i) {
            signed char t = @PREFIX@constr_type[i];
            emb_float r = (t == 1) ? (emb_float)1e3 * new_rho
                        : (t == -1) ? (emb_float)1e-6 : new_rho;
            @PREFIX@rho_vec[i] = r;
            @PREFIX@rho_inv_vec[i] = (emb_float)1.0 / r;
        }
        emb_refactor();
    }
}

static void emb_residuals(emb_float* pri_out, emb_float* dua_out,
                          emb_float* eps_pri_out, emb_float* eps_dua_out) {
    static emb_float Axv[EMB_M > 0 ? EMB_M : 1];
    static emb_float Pxv[EMB_N];
    static emb_float Atyv[EMB_N];
    static emb_float tmpm[EMB_M > 0 ? EMB_M : 1];
    static emb_float tmpn[EMB_N];
    @PREFIX@Workspace* w = &@PREFIX@work;

    emb_Ax(@PREFIX@A, w->x, Axv);
    emb_Px(@PREFIX@P, w->x, Pxv);
    emb_Aty(@PREFIX@A, w->y, Atyv);

    /* unscaled primal residual */
    for (int i = 0; i < EMB_M; ++i) tmpm[i] = @PREFIX@Einv[i] * (Axv[i] - w->z[i]);
    emb_float pri = emb_inf_norm(tmpm, EMB_M);

    /* unscaled dual residual */
    for (int j = 0; j < EMB_N; ++j)
        tmpn[j] = @PREFIX@cinv * @PREFIX@Dinv[j] * (Pxv[j] + @PREFIX@q[j] + Atyv[j]);
    emb_float dua = emb_inf_norm(tmpn, EMB_N);

    /* tolerances */
    for (int i = 0; i < EMB_M; ++i) tmpm[i] = @PREFIX@Einv[i] * Axv[i];
    emb_float sp = emb_inf_norm(tmpm, EMB_M);
    for (int i = 0; i < EMB_M; ++i) tmpm[i] = @PREFIX@Einv[i] * w->z[i];
    emb_float sz = emb_inf_norm(tmpm, EMB_M);
    emb_float rel_p = sp > sz ? sp : sz;

    for (int j = 0; j < EMB_N; ++j) tmpn[j] = @PREFIX@Dinv[j] * Atyv[j];
    emb_float s1 = emb_inf_norm(tmpn, EMB_N);
    for (int j = 0; j < EMB_N; ++j) tmpn[j] = @PREFIX@Dinv[j] * Pxv[j];
    emb_float s2 = emb_inf_norm(tmpn, EMB_N);
    for (int j = 0; j < EMB_N; ++j) tmpn[j] = @PREFIX@Dinv[j] * @PREFIX@q[j];
    emb_float s3 = emb_inf_norm(tmpn, EMB_N);
    emb_float rel_d = @PREFIX@cinv * (s1 > s2 ? (s1 > s3 ? s1 : s3) : (s2 > s3 ? s2 : s3));

    *pri_out = pri;
    *dua_out = dua;
    *eps_pri_out = @PREFIX@settings.eps_abs + @PREFIX@settings.eps_rel * rel_p;
    *eps_dua_out = @PREFIX@settings.eps_abs + @PREFIX@settings.eps_rel * rel_d;
}

static int emb_is_primal_infeasible(void) {
    @PREFIX@Workspace* w = &@PREFIX@work;
    static emb_float tmpm[EMB_M > 0 ? EMB_M : 1];
    static emb_float tmpn[EMB_N];
    if (EMB_M == 0) return 0;
    for (int i = 0; i < EMB_M; ++i) tmpm[i] = @PREFIX@E[i] * w->delta_y[i];
    emb_float norm_dy = emb_inf_norm(tmpm, EMB_M);
    emb_float eps = @PREFIX@settings.eps_prim_inf;
    if (norm_dy <= eps) return 0;
    emb_float lhs = 0;
    for (int i = 0; i < EMB_M; ++i) {
        emb_float dy = w->delta_y[i];
        lhs += @PREFIX@u[i] * (dy > 0 ? dy : 0) + @PREFIX@l[i] * (dy < 0 ? dy : 0);
    }
    if (lhs >= -eps * norm_dy) return 0;
    emb_Aty(@PREFIX@A, w->delta_y, tmpn);
    for (int j = 0; j < EMB_N; ++j) tmpn[j] *= @PREFIX@Dinv[j];
    return emb_inf_norm(tmpn, EMB_N) < eps * norm_dy;
}

static int emb_is_dual_infeasible(void) {
    @PREFIX@Workspace* w = &@PREFIX@work;
    static emb_float tmpm[EMB_M > 0 ? EMB_M : 1];
    static emb_float tmpn[EMB_N];
    for (int j = 0; j < EMB_N; ++j) tmpn[j] = @PREFIX@D[j] * w->delta_x[j];
    emb_float norm_dx = emb_inf_norm(tmpn, EMB_N);
    emb_float eps = @PREFIX@settings.eps_dual_inf;
    emb_float c = @PREFIX@c_scale;
    if (norm_dx <= eps) return 0;
    emb_float qdx = 0;
    for (int j = 0; j < EMB_N; ++j) qdx += @PREFIX@q[j] * w->delta_x[j];
    if (qdx >= -c * eps * norm_dx) return 0;
    emb_Px(@PREFIX@P, w->delta_x, tmpn);
    for (int j = 0; j < EMB_N; ++j) tmpn[j] *= @PREFIX@Dinv[j];
    if (emb_inf_norm(tmpn, EMB_N) >= c * eps * norm_dx) return 0;
    emb_Ax(@PREFIX@A, w->delta_x, tmpm);
    for (int i = 0; i < EMB_M; ++i) {
        emb_float adx = @PREFIX@Einv[i] * tmpm[i];
        if (@PREFIX@u[i] < EMB_INFTY * EMB_MIN_SCALING && adx > eps * norm_dx) return 0;
        if (@PREFIX@l[i] > -EMB_INFTY * EMB_MIN_SCALING && adx < -eps * norm_dx) return 0;
    }
    return 1;
}

static void emb_admm_iteration(void) {
    @PREFIX@Workspace* w = &@PREFIX@work;
    static emb_float rhs[EMB_N];
    static emb_float b2[EMB_M > 0 ? EMB_M : 1];
    static emb_float Axt[EMB_M > 0 ? EMB_M : 1];
    emb_float alpha = @PREFIX@settings.alpha;
    emb_float sigma = @PREFIX@settings.sigma;

    for (int i = 0; i < EMB_M; ++i)
        b2[i] = w->z[i] - @PREFIX@rho_inv_vec[i] * w->y[i];
    for (int j = 0; j < EMB_N; ++j) rhs[j] = sigma * w->x[j] - @PREFIX@q[j];
    for (int i = 0; i < EMB_M; ++i) {
        const emb_float* row = @PREFIX@A + (size_t)i * EMB_N;
        emb_float rb = @PREFIX@rho_vec[i] * b2[i];
        for (int j = 0; j < EMB_N; ++j) rhs[j] += row[j] * rb;
    }
    emb_chol_solve(@PREFIX@L, rhs); /* rhs now holds x_tilde */
    emb_Ax(@PREFIX@A, rhs, Axt);

    for (int j = 0; j < EMB_N; ++j) {
        emb_float x_new = alpha * rhs[j] + (1 - alpha) * w->x[j];
        w->delta_x[j] = x_new - w->x[j];
        w->x[j] = x_new;
    }
    for (int i = 0; i < EMB_M; ++i) {
        emb_float nu = @PREFIX@rho_vec[i] * (Axt[i] - b2[i]);
        emb_float z_tilde = w->z[i] + @PREFIX@rho_inv_vec[i] * (nu - w->y[i]);
        emb_float z_relax = alpha * z_tilde + (1 - alpha) * w->z[i];
        emb_float z_new = z_relax + @PREFIX@rho_inv_vec[i] * w->y[i];
        if (z_new < @PREFIX@l[i]) z_new = @PREFIX@l[i];
        if (z_new > @PREFIX@u[i]) z_new = @PREFIX@u[i];
        emb_float dy = @PREFIX@rho_vec[i] * (z_relax - z_new);
        w->z[i] = z_new;
        w->delta_y[i] = dy;
        w->y[i] += dy;
    }
}

int @PREFIX@osqp_solve(void) {
    @PREFIX@Workspace* w = &@PREFIX@work;
#if @PROFILING@
    struct timespec t0, t1;
    clock_gettime(CLOCK_MONOTONIC, &t0);
#endif
    int ct = @PREFIX@settings.check_termination;
    int status = EMB_UNSOLVED;
    int it = 0;
#if @INTERRUPT@
    @PREFIX@interrupt_flag = 0;
#endif

    if (!@PREFIX@settings.warm_starting) {
        memset(w->x, 0, sizeof(emb_float) * EMB_N);
        if (EMB_M) {
            memset(w->z, 0, sizeof(emb_float) * EMB_M);
            memset(w->y, 0, sizeof(emb_float) * EMB_M);
        }
    }
#if @PRINTING@
    printf("iter    pri_res      dua_res      rho\n");
#endif

    for (it = 1; it <= @PREFIX@settings.max_iter; ++it) {
        emb_admm_iteration();
        if (ct > 0 && (it % ct == 0)) {
            emb_float pri, dua, eps_pri, eps_dua;
            emb_residuals(&pri, &dua, &eps_pri, &eps_dua);
            w->pri_res = pri; w->dua_res = dua;
#if @PRINTING@
            printf("%4d  %11.4e  %11.4e  %9.2e\n", it, (double)pri,
                   (double)dua, (double)@PREFIX@settings.rho);
#endif
            int pri_ok = (EMB_M == 0) || (pri < eps_pri);
            int dua_ok = dua < eps_dua;
            if (pri_ok && dua_ok) { status = EMB_SOLVED; break; }
            if (!pri_ok && emb_is_primal_infeasible()) { status = EMB_PRIMAL_INFEASIBLE; break; }
            if (!dua_ok && emb_is_dual_infeasible()) { status = EMB_DUAL_INFEASIBLE; break; }
#if @INTERRUPT@
            if (@PREFIX@interrupt_flag) { status = EMB_SIGINT; break; }
#endif
            if (@PREFIX@settings.adaptive_rho &&
                @PREFIX@settings.adaptive_rho_interval > 0 &&
                (it % @PREFIX@settings.adaptive_rho_interval == 0))
                emb_adapt_rho();
        }
    }
    if (status == EMB_UNSOLVED) {
        it = @PREFIX@settings.max_iter;
        emb_float pri, dua, eps_pri, eps_dua;
        emb_residuals(&pri, &dua, &eps_pri, &eps_dua);
        w->pri_res = pri; w->dua_res = dua;
        int pri_ok = (EMB_M == 0) || (pri < eps_pri);
        int dua_ok = dua < eps_dua;
        if (pri_ok && dua_ok) status = EMB_SOLVED;
        else {
            emb_float f = (emb_float)10;
            if (((EMB_M == 0) || pri < f * eps_pri) && dua < f * eps_dua)
                status = EMB_SOLVED_INACCURATE;
            else
                status = EMB_MAX_ITER_REACHED;
        }
    }

#if @PRINTING@
    printf("status: %d  iterations: %d\n", status, it);
#endif

    /* store unscaled solution */
    for (int j = 0; j < EMB_N; ++j)
        @PREFIX@sol_x[j] = @PREFIX@D[j] * w->x[j];
    for (int i = 0; i < EMB_M; ++i)
        @PREFIX@sol_y[i] = @PREFIX@cinv * @PREFIX@E[i] * w->y[i];

    w->status_val = status;
    w->iter = it;
#if @PROFILING@
    clock_gettime(CLOCK_MONOTONIC, &t1);
    w->run_time = (emb_float)((t1.tv_sec - t0.tv_sec) + 1e-9 * (t1.tv_nsec - t0.tv_nsec));
#else
    w->run_time = (emb_float)0;
#endif
    return 0;
}

int @PREFIX@osqp_update_data_vec(const emb_float* q_new, const emb_float* l_new,
                                 const emb_float* u_new) {
    if (q_new) {
        for (int j = 0; j < EMB_N; ++j)
            @PREFIX@q[j] = @PREFIX@c_scale * @PREFIX@D[j] * q_new[j];
    }
    if (l_new) {
        for (int i = 0; i < EMB_M; ++i) {
            emb_float v = l_new[i] < -EMB_INFTY ? -EMB_INFTY : l_new[i];
            @PREFIX@l[i] = @PREFIX@E[i] * v;
        }
    }
    if (u_new) {
        for (int i = 0; i < EMB_M; ++i) {
            emb_float v = u_new[i] > EMB_INFTY ? EMB_INFTY : u_new[i];
            @PREFIX@u[i] = @PREFIX@E[i] * v;
        }
    }
    for (int i = 0; i < EMB_M; ++i)
        if (@PREFIX@l[i] > @PREFIX@u[i]) return 1;
    @PREFIX@work.status_val = EMB_UNSOLVED;
    return 0;
}

#if EMBEDDED_MODE == 2
int @PREFIX@osqp_update_data_mat(const emb_float* P_x, const int* P_i, int P_n,
                                 const emb_float* A_x, const int* A_i, int A_n) {
    if (P_x) {
        for (int k = 0; k < (P_i ? P_n : @PREFIX@P_nnz); ++k) {
            int idx = P_i ? P_i[k] : k;
            if (idx < 0 || idx >= @PREFIX@P_nnz) return 1;
            int r = @PREFIX@P_pat_row[idx];
            int cc = @PREFIX@P_pat_col[idx];
            emb_float v = @PREFIX@c_scale * @PREFIX@D[r] * @PREFIX@D[cc] * P_x[k];
            @PREFIX@P[(size_t)r * EMB_N + cc] = v;
            @PREFIX@P[(size_t)cc * EMB_N + r] = v;
        }
    }
    if (A_x) {
        for (int k = 0; k < (A_i ? A_n : @PREFIX@A_nnz); ++k) {
            int idx = A_i ? A_i[k] : k;
            if (idx < 0 || idx >= @PREFIX@A_nnz) return 1;
            int r = @PREFIX@A_pat_row[idx];
            int cc = @PREFIX@A_pat_col[idx];
            @PREFIX@A[(size_t)r * EMB_N + cc] =
                @PREFIX@E[r] * @PREFIX@D[cc] * A_x[k];
        }
    }
    @PREFIX@work.status_val = EMB_UNSOLVED;
    return emb_refactor();
}
#endif
'''

WORKSPACE_H = r'''
/* Generated by osqp_tpu_torch.codegen - statically allocated workspace. */
#ifndef @PREFIX_UPPER@WORKSPACE_H
#define @PREFIX_UPPER@WORKSPACE_H

typedef @FLOAT@ emb_float_t;

typedef struct {
    emb_float_t eps_abs, eps_rel, eps_prim_inf, eps_dual_inf;
    emb_float_t alpha, sigma, rho;
    int max_iter, check_termination, warm_starting;
    int adaptive_rho, adaptive_rho_interval;
} @PREFIX@Settings;

typedef struct {
    emb_float_t x[@N@];
    emb_float_t z[@M_OR_1@];
    emb_float_t y[@M_OR_1@];
    emb_float_t delta_x[@N@];
    emb_float_t delta_y[@M_OR_1@];
@EXTRA_WORK@    emb_float_t pri_res, dua_res, run_time;
    int status_val, iter;
} @PREFIX@Workspace;

extern @PREFIX@Settings @PREFIX@settings;
extern @PREFIX@Workspace @PREFIX@work;
@MATRIX_DECLS@
extern emb_float_t @PREFIX@q[@N@];
extern emb_float_t @PREFIX@l[@M_OR_1@];
extern emb_float_t @PREFIX@u[@M_OR_1@];
extern emb_float_t @PREFIX@rho_vec[@M_OR_1@];
extern emb_float_t @PREFIX@rho_inv_vec[@M_OR_1@];
extern emb_float_t @PREFIX@D[@N@];
extern emb_float_t @PREFIX@Dinv[@N@];
extern emb_float_t @PREFIX@E[@M_OR_1@];
extern emb_float_t @PREFIX@Einv[@M_OR_1@];
extern emb_float_t @PREFIX@c_scale;
extern emb_float_t @PREFIX@cinv;
extern emb_float_t @PREFIX@sol_x[@N@];
extern emb_float_t @PREFIX@sol_y[@M_OR_1@];
extern signed char @PREFIX@constr_type[@M_OR_1@];
@PATTERN_DECLS@

int @PREFIX@osqp_solve(void);
int @PREFIX@osqp_update_data_vec(const emb_float_t* q_new, const emb_float_t* l_new,
                                 const emb_float_t* u_new);
#if @INTERRUPT@
void @PREFIX@osqp_request_interrupt(void);
#endif
#if @MODE@ == 2
int @PREFIX@osqp_update_data_mat(const emb_float_t* P_x, const int* P_i, int P_n,
                                 const emb_float_t* A_x, const int* A_i, int A_n);
#endif

#endif
'''

MODULE_C = r'''
/* CPython extension wrapper for the generated embedded solver. */
#define PY_SSIZE_T_CLEAN
#include <Python.h>
#define NPY_NO_DEPRECATED_API NPY_1_7_API_VERSION
#include <numpy/arrayobject.h>

#include "@PREFIX@workspace.h"

#define EMB_NPY_FLOAT @NPY_FLOAT@

static PyObject* emb_solve(PyObject* self, PyObject* args) {
    int status = @PREFIX@osqp_solve();
    if (status != 0) {
        PyErr_SetString(PyExc_RuntimeError, "Solve failed");
        return NULL;
    }
    npy_intp n = @N@;
    npy_intp m = @M@;
    PyObject* x = PyArray_SimpleNew(1, &n, EMB_NPY_FLOAT);
    PyObject* y = PyArray_SimpleNew(1, &m, EMB_NPY_FLOAT);
    if (!x || !y) return NULL;
    memcpy(PyArray_DATA((PyArrayObject*)x), @PREFIX@sol_x, sizeof(emb_float_t) * @N@);
    if (m) memcpy(PyArray_DATA((PyArrayObject*)y), @PREFIX@sol_y, sizeof(emb_float_t) * @M@);
    return Py_BuildValue('(NNiid)', x, y, @PREFIX@work.status_val,
                         @PREFIX@work.iter, (double)@PREFIX@work.run_time);
}

static int emb_vec_from_obj(PyObject* obj, emb_float_t* out, int len) {
    if (obj == Py_None) return 0;
    PyArrayObject* arr = (PyArrayObject*)PyArray_FROM_OTF(obj, EMB_NPY_FLOAT, NPY_ARRAY_IN_ARRAY);
    if (!arr) return -1;
    if (PyArray_SIZE(arr) != len) {
        Py_DECREF(arr);
        PyErr_SetString(PyExc_ValueError, "bad vector length");
        return -1;
    }
    memcpy(out, PyArray_DATA(arr), sizeof(emb_float_t) * len);
    Py_DECREF(arr);
    return 1;
}

static PyObject* emb_update_data_vec(PyObject* self, PyObject* args, PyObject* kwargs) {
    static char* kwlist[] = {"q", "l", "u", NULL};
    PyObject *qo = Py_None, *lo = Py_None, *uo = Py_None;
    if (!PyArg_ParseTupleAndKeywords(args, kwargs, "|OOO", kwlist, &qo, &lo, &uo))
        return NULL;
    static emb_float_t qb[@N@], lb[@M_OR_1@], ub[@M_OR_1@];
    int hq = emb_vec_from_obj(qo, qb, @N@);
    int hl = emb_vec_from_obj(lo, lb, @M@);
    int hu = emb_vec_from_obj(uo, ub, @M@);
    if (hq < 0 || hl < 0 || hu < 0) return NULL;
    int rc = @PREFIX@osqp_update_data_vec(hq ? qb : NULL, hl ? lb : NULL, hu ? ub : NULL);
    if (rc != 0) {
        PyErr_SetString(PyExc_ValueError, "Lower bound must be lower than or equal to upper bound");
        return NULL;
    }
    return PyLong_FromLong(rc);
}

#if @MODE@ == 2
static PyObject* emb_update_data_mat(PyObject* self, PyObject* args, PyObject* kwargs) {
    static char* kwlist[] = {"P_x", "P_i", "A_x", "A_i", NULL};
    PyObject *pxo = Py_None, *pio = Py_None, *axo = Py_None, *aio = Py_None;
    if (!PyArg_ParseTupleAndKeywords(args, kwargs, "|OOOO", kwlist, &pxo, &pio, &axo, &aio))
        return NULL;

    PyArrayObject *px = NULL, *pi = NULL, *ax = NULL, *ai = NULL;
    if (pxo != Py_None) px = (PyArrayObject*)PyArray_FROM_OTF(pxo, EMB_NPY_FLOAT, NPY_ARRAY_IN_ARRAY);
    if (pio != Py_None) pi = (PyArrayObject*)PyArray_FROM_OTF(pio, NPY_INT32, NPY_ARRAY_IN_ARRAY);
    if (axo != Py_None) ax = (PyArrayObject*)PyArray_FROM_OTF(axo, EMB_NPY_FLOAT, NPY_ARRAY_IN_ARRAY);
    if (aio != Py_None) ai = (PyArrayObject*)PyArray_FROM_OTF(aio, NPY_INT32, NPY_ARRAY_IN_ARRAY);

    int rc = @PREFIX@osqp_update_data_mat(
        px ? (emb_float_t*)PyArray_DATA(px) : NULL,
        pi ? (int*)PyArray_DATA(pi) : NULL,
        px ? (int)PyArray_SIZE(px) : (pi ? (int)PyArray_SIZE(pi) : 0),
        ax ? (emb_float_t*)PyArray_DATA(ax) : NULL,
        ai ? (int*)PyArray_DATA(ai) : NULL,
        ax ? (int)PyArray_SIZE(ax) : (ai ? (int)PyArray_SIZE(ai) : 0));
    Py_XDECREF(px); Py_XDECREF(pi); Py_XDECREF(ax); Py_XDECREF(ai);
    if (rc != 0) {
        PyErr_SetString(PyExc_ValueError, "matrix update failed");
        return NULL;
    }
    return PyLong_FromLong(rc);
}
#endif

static PyMethodDef EmbMethods[] = {
    {"solve", emb_solve, METH_NOARGS, "Solve the embedded QP."},
    {"update_data_vec", (PyCFunction)emb_update_data_vec, METH_VARARGS | METH_KEYWORDS,
     "Update q/l/u."},
#if @MODE@ == 2
    {"update_data_mat", (PyCFunction)emb_update_data_mat, METH_VARARGS | METH_KEYWORDS,
     "Update P/A values."},
#endif
    {NULL, NULL, 0, NULL}};

static struct PyModuleDef embmodule = {
    PyModuleDef_HEAD_INIT, "@EXT_NAME@", "Embedded osqp_tpu solver", -1, EmbMethods};

PyMODINIT_FUNC PyInit_@EXT_NAME@(void) {
    import_array();
    return PyModule_Create(&embmodule);
}
'''

SETUP_PY = r'''
"""Build script for the generated embedded extension (generated by
osqp_tpu_torch.codegen)."""

import numpy
from setuptools import Extension, setup

setup(
    name='@EXT_NAME@',
    ext_modules=[
        Extension(
            '@EXT_NAME@',
            sources=['@PREFIX@workspace.c', '@PREFIX@emosqp_solver.c', '@EXT_NAME@_module.c'],
            include_dirs=['.', numpy.get_include()],
            extra_compile_args=['-O3'],
        )
    ],
)
'''

CMAKELISTS = r'''
# Generated by osqp_tpu_torch.codegen - standalone embedded solver library.
cmake_minimum_required(VERSION 3.16)
project(@EXT_NAME@_embedded C)
add_library(@PREFIX@emosqp STATIC @PREFIX@workspace.c @PREFIX@emosqp_solver.c)
target_include_directories(@PREFIX@emosqp PUBLIC ${CMAKE_CURRENT_SOURCE_DIR})
target_link_libraries(@PREFIX@emosqp m)
'''

SOLVER_SPARSE_C = r'''
/* Embedded OSQP-class SPARSE ADMM solver - generated by osqp_tpu_torch.codegen.
 * O(nnz) statically-allocated workspace (CSR P/A/A' + vectors; no dense
 * matrices, no factorization): the KKT system
 *     (P + sigma I + A' diag(rho) A) x_tilde = rhs
 * is solved per iteration by Jacobi-preconditioned conjugate gradients,
 * warm-started from the previous x_tilde - the embedded analogue of the
 * reference's solver_type='indirect' path (reference
 * src/osqp/interface.py:254-260), with the sparse data shipped into the
 * emitted project like the reference's codegen_src sparse core
 * (reference src/osqp/interface.py:480-488).
 */

#include <math.h>
#include <string.h>
#if @PROFILING@
#include <time.h>
#endif
#if @PRINTING@
#include <stdio.h>
#endif

#include "@PREFIX@workspace.h"

#define EMB_N @N@
#define EMB_M @M@
#define EMBEDDED_MODE @MODE@

#if @INTERRUPT@
static volatile int @PREFIX@interrupt_flag = 0;
void @PREFIX@osqp_request_interrupt(void) { @PREFIX@interrupt_flag = 1; }
#define EMB_SIGINT 10
#endif

typedef @FLOAT@ emb_float;

#define EMB_SOLVED 1
#define EMB_SOLVED_INACCURATE 2
#define EMB_PRIMAL_INFEASIBLE 3
#define EMB_DUAL_INFEASIBLE 5
#define EMB_MAX_ITER_REACHED 7
#define EMB_UNSOLVED 11

#define EMB_INFTY ((emb_float)1e30)
#define EMB_MIN_SCALING ((emb_float)1e-4)
#define EMB_CG_TOL ((emb_float)@CG_TOL@)
#define EMB_CG_MAX_ITER @CG_MAX_ITER@

static emb_float emb_inf_norm(const emb_float* v, int k) {
    emb_float r = (emb_float)0;
    for (int i = 0; i < k; ++i) { emb_float a = fabs((double)v[i]); if (a > r) r = a; }
    return r;
}

/* y <- S x for a CSR matrix (indptr/indices/data), S is rows x anything */
static void emb_csr_mv(const int* indptr, const int* indices,
                       const emb_float* data, int rows,
                       const emb_float* x, emb_float* y) {
    for (int i = 0; i < rows; ++i) {
        emb_float s = 0;
        for (int k = indptr[i]; k < indptr[i + 1]; ++k) s += data[k] * x[indices[k]];
        y[i] = s;
    }
}

#define emb_Px(x, y) emb_csr_mv(@PREFIX@P_indptr, @PREFIX@P_indices, @PREFIX@P_data, EMB_N, (x), (y))
#define emb_Ax(x, y) emb_csr_mv(@PREFIX@A_indptr, @PREFIX@A_indices, @PREFIX@A_data, EMB_M, (x), (y))
#define emb_Aty(v, y) emb_csr_mv(@PREFIX@At_indptr, @PREFIX@At_indices, @PREFIX@At_data, EMB_N, (v), (y))

/* diag(M) = diag(P) + sigma + sum_i rho_i A[i, j]^2  (Jacobi precond) */
static void emb_build_diagM(void) {
    for (int j = 0; j < EMB_N; ++j)
        @PREFIX@diag_M[j] = @PREFIX@settings.sigma;
    for (int i = 0; i < EMB_N; ++i)
        for (int k = @PREFIX@P_indptr[i]; k < @PREFIX@P_indptr[i + 1]; ++k)
            if (@PREFIX@P_indices[k] == i) @PREFIX@diag_M[i] += @PREFIX@P_data[k];
    for (int i = 0; i < EMB_M; ++i) {
        emb_float r = @PREFIX@rho_vec[i];
        for (int k = @PREFIX@A_indptr[i]; k < @PREFIX@A_indptr[i + 1]; ++k) {
            emb_float a = @PREFIX@A_data[k];
            @PREFIX@diag_M[@PREFIX@A_indices[k]] += r * a * a;
        }
    }
}

/* y <- M x = P x + sigma x + A' (rho .* (A x)) */
static void emb_Mx(const emb_float* x, emb_float* y) {
    static emb_float tm[EMB_M > 0 ? EMB_M : 1];
    static emb_float tn[EMB_N];
    emb_Px(x, y);
    for (int j = 0; j < EMB_N; ++j) y[j] += @PREFIX@settings.sigma * x[j];
    if (EMB_M) {
        emb_Ax(x, tm);
        for (int i = 0; i < EMB_M; ++i) tm[i] *= @PREFIX@rho_vec[i];
        emb_Aty(tm, tn);
        for (int j = 0; j < EMB_N; ++j) y[j] += tn[j];
    }
}

/* Jacobi-PCG: solve M xt = rhs, warm-started from xt's current value */
static void emb_cg_solve(const emb_float* rhs, emb_float* xt) {
    static emb_float r[EMB_N], p[EMB_N], zv[EMB_N], Mp[EMB_N];
    emb_float bnorm2 = 0;
    for (int j = 0; j < EMB_N; ++j) bnorm2 += rhs[j] * rhs[j];
    emb_float tol2 = EMB_CG_TOL * EMB_CG_TOL * bnorm2;
    if (tol2 <= (emb_float)0) tol2 = (emb_float)1e-38;

    emb_Mx(xt, r);
    emb_float rnorm2 = 0;
    for (int j = 0; j < EMB_N; ++j) { r[j] = rhs[j] - r[j]; rnorm2 += r[j] * r[j]; }
    emb_float rz = 0;
    for (int j = 0; j < EMB_N; ++j) { zv[j] = r[j] / @PREFIX@diag_M[j]; p[j] = zv[j]; rz += r[j] * zv[j]; }

    /* float32-only stagnation guard: CG residual norms are not monotone,
     * so give it a patience window — if no meaningful improvement for 16
     * iterations the f32 floor has been hit and more iterations only burn
     * cycles.  Compiled OUT of double builds, where a >16-iteration
     * plateau mid-descent is legitimate and must not truncate the solve. */
#if @CG_STAGNATION@
    emb_float best = rnorm2;
    int since_best = 0;
#endif
    for (int k = 0; k < EMB_CG_MAX_ITER && rnorm2 > tol2; ++k) {
#if @CG_STAGNATION@
        if (rnorm2 < best * (emb_float)0.999) { best = rnorm2; since_best = 0; }
        else if (++since_best >= 16) break;
#endif
        emb_Mx(p, Mp);
        emb_float denom = 0;
        for (int j = 0; j < EMB_N; ++j) denom += p[j] * Mp[j];
        if (denom == (emb_float)0) break;
        emb_float a = rz / denom;
        rnorm2 = 0;
        for (int j = 0; j < EMB_N; ++j) {
            xt[j] += a * p[j];
            r[j] -= a * Mp[j];
            rnorm2 += r[j] * r[j];
        }
        emb_float rzn = 0;
        for (int j = 0; j < EMB_N; ++j) { zv[j] = r[j] / @PREFIX@diag_M[j]; rzn += r[j] * zv[j]; }
        emb_float beta = (rz != (emb_float)0) ? rzn / rz : (emb_float)0;
        rz = rzn;
        for (int j = 0; j < EMB_N; ++j) p[j] = zv[j] + beta * p[j];
    }
}

/* Adaptive rho: the indirect path needs only a diag_M rebuild, no
 * refactorization - rho adaptation is essentially free here. */
static void emb_adapt_rho(void) {
    @PREFIX@Workspace* w = &@PREFIX@work;
    static emb_float Axv[EMB_M > 0 ? EMB_M : 1];
    static emb_float Pxv[EMB_N];
    static emb_float Atyv[EMB_N];
    emb_Ax(w->x, Axv);
    emb_Px(w->x, Pxv);
    emb_Aty(w->y, Atyv);
    emb_float num_p = 0, den_p = 0;
    for (int i = 0; i < EMB_M; ++i) {
        emb_float r = fabs((double)(Axv[i] - w->z[i]));
        if (r > num_p) num_p = r;
        emb_float a = fabs((double)Axv[i]); if (a > den_p) den_p = a;
        emb_float b = fabs((double)w->z[i]); if (b > den_p) den_p = b;
    }
    emb_float pri = num_p / (den_p + (emb_float)1e-10);
    emb_float num_d = 0, den_d = 0;
    for (int j = 0; j < EMB_N; ++j) {
        emb_float r = fabs((double)(Pxv[j] + @PREFIX@q[j] + Atyv[j]));
        if (r > num_d) num_d = r;
        emb_float a = fabs((double)Atyv[j]); if (a > den_d) den_d = a;
        emb_float b = fabs((double)Pxv[j]); if (b > den_d) den_d = b;
        emb_float cq = fabs((double)@PREFIX@q[j]); if (cq > den_d) den_d = cq;
    }
    emb_float dua = num_d / (den_d + (emb_float)1e-10);
    emb_float new_rho = @PREFIX@settings.rho *
        (emb_float)sqrt((double)(pri / (dua + (emb_float)1e-10)));
    if (new_rho < (emb_float)1e-6) new_rho = (emb_float)1e-6;
    if (new_rho > (emb_float)1e6) new_rho = (emb_float)1e6;
    emb_float tol = (emb_float)5.0;
    if (new_rho > tol * @PREFIX@settings.rho || new_rho < @PREFIX@settings.rho / tol) {
        @PREFIX@settings.rho = new_rho;
        for (int i = 0; i < EMB_M; ++i) {
            signed char t = @PREFIX@constr_type[i];
            emb_float r = (t == 1) ? (emb_float)1e3 * new_rho
                        : (t == -1) ? (emb_float)1e-6 : new_rho;
            @PREFIX@rho_vec[i] = r;
            @PREFIX@rho_inv_vec[i] = (emb_float)1.0 / r;
        }
        emb_build_diagM();
    }
}

static void emb_residuals(emb_float* pri_out, emb_float* dua_out,
                          emb_float* eps_pri_out, emb_float* eps_dua_out) {
    static emb_float Axv[EMB_M > 0 ? EMB_M : 1];
    static emb_float Pxv[EMB_N];
    static emb_float Atyv[EMB_N];
    static emb_float tmpm[EMB_M > 0 ? EMB_M : 1];
    static emb_float tmpn[EMB_N];
    @PREFIX@Workspace* w = &@PREFIX@work;

    emb_Ax(w->x, Axv);
    emb_Px(w->x, Pxv);
    emb_Aty(w->y, Atyv);

    for (int i = 0; i < EMB_M; ++i) tmpm[i] = @PREFIX@Einv[i] * (Axv[i] - w->z[i]);
    emb_float pri = emb_inf_norm(tmpm, EMB_M);

    for (int j = 0; j < EMB_N; ++j)
        tmpn[j] = @PREFIX@cinv * @PREFIX@Dinv[j] * (Pxv[j] + @PREFIX@q[j] + Atyv[j]);
    emb_float dua = emb_inf_norm(tmpn, EMB_N);

    for (int i = 0; i < EMB_M; ++i) tmpm[i] = @PREFIX@Einv[i] * Axv[i];
    emb_float sp = emb_inf_norm(tmpm, EMB_M);
    for (int i = 0; i < EMB_M; ++i) tmpm[i] = @PREFIX@Einv[i] * w->z[i];
    emb_float sz = emb_inf_norm(tmpm, EMB_M);
    emb_float rel_p = sp > sz ? sp : sz;

    for (int j = 0; j < EMB_N; ++j) tmpn[j] = @PREFIX@Dinv[j] * Atyv[j];
    emb_float s1 = emb_inf_norm(tmpn, EMB_N);
    for (int j = 0; j < EMB_N; ++j) tmpn[j] = @PREFIX@Dinv[j] * Pxv[j];
    emb_float s2 = emb_inf_norm(tmpn, EMB_N);
    for (int j = 0; j < EMB_N; ++j) tmpn[j] = @PREFIX@Dinv[j] * @PREFIX@q[j];
    emb_float s3 = emb_inf_norm(tmpn, EMB_N);
    emb_float rel_d = @PREFIX@cinv * (s1 > s2 ? (s1 > s3 ? s1 : s3) : (s2 > s3 ? s2 : s3));

    *pri_out = pri;
    *dua_out = dua;
    *eps_pri_out = @PREFIX@settings.eps_abs + @PREFIX@settings.eps_rel * rel_p;
    *eps_dua_out = @PREFIX@settings.eps_abs + @PREFIX@settings.eps_rel * rel_d;
}

static int emb_is_primal_infeasible(void) {
    @PREFIX@Workspace* w = &@PREFIX@work;
    static emb_float tmpm[EMB_M > 0 ? EMB_M : 1];
    static emb_float tmpn[EMB_N];
    if (EMB_M == 0) return 0;
    for (int i = 0; i < EMB_M; ++i) tmpm[i] = @PREFIX@E[i] * w->delta_y[i];
    emb_float norm_dy = emb_inf_norm(tmpm, EMB_M);
    emb_float eps = @PREFIX@settings.eps_prim_inf;
    if (norm_dy <= eps) return 0;
    emb_float lhs = 0;
    for (int i = 0; i < EMB_M; ++i) {
        emb_float dy = w->delta_y[i];
        lhs += @PREFIX@u[i] * (dy > 0 ? dy : 0) + @PREFIX@l[i] * (dy < 0 ? dy : 0);
    }
    if (lhs >= -eps * norm_dy) return 0;
    emb_Aty(w->delta_y, tmpn);
    for (int j = 0; j < EMB_N; ++j) tmpn[j] *= @PREFIX@Dinv[j];
    return emb_inf_norm(tmpn, EMB_N) < eps * norm_dy;
}

static int emb_is_dual_infeasible(void) {
    @PREFIX@Workspace* w = &@PREFIX@work;
    static emb_float tmpm[EMB_M > 0 ? EMB_M : 1];
    static emb_float tmpn[EMB_N];
    for (int j = 0; j < EMB_N; ++j) tmpn[j] = @PREFIX@D[j] * w->delta_x[j];
    emb_float norm_dx = emb_inf_norm(tmpn, EMB_N);
    emb_float eps = @PREFIX@settings.eps_dual_inf;
    emb_float c = @PREFIX@c_scale;
    if (norm_dx <= eps) return 0;
    emb_float qdx = 0;
    for (int j = 0; j < EMB_N; ++j) qdx += @PREFIX@q[j] * w->delta_x[j];
    if (qdx >= -c * eps * norm_dx) return 0;
    emb_Px(w->delta_x, tmpn);
    for (int j = 0; j < EMB_N; ++j) tmpn[j] *= @PREFIX@Dinv[j];
    if (emb_inf_norm(tmpn, EMB_N) >= c * eps * norm_dx) return 0;
    emb_Ax(w->delta_x, tmpm);
    for (int i = 0; i < EMB_M; ++i) {
        emb_float adx = @PREFIX@Einv[i] * tmpm[i];
        if (@PREFIX@u[i] < EMB_INFTY * EMB_MIN_SCALING && adx > eps * norm_dx) return 0;
        if (@PREFIX@l[i] > -EMB_INFTY * EMB_MIN_SCALING && adx < -eps * norm_dx) return 0;
    }
    return 1;
}

static void emb_admm_iteration(void) {
    @PREFIX@Workspace* w = &@PREFIX@work;
    static emb_float rhs[EMB_N];
    static emb_float b2[EMB_M > 0 ? EMB_M : 1];
    static emb_float rb[EMB_M > 0 ? EMB_M : 1];
    static emb_float tn[EMB_N];
    static emb_float Axt[EMB_M > 0 ? EMB_M : 1];
    emb_float alpha = @PREFIX@settings.alpha;
    emb_float sigma = @PREFIX@settings.sigma;

    for (int i = 0; i < EMB_M; ++i) {
        b2[i] = w->z[i] - @PREFIX@rho_inv_vec[i] * w->y[i];
        rb[i] = @PREFIX@rho_vec[i] * b2[i];
    }
    for (int j = 0; j < EMB_N; ++j) rhs[j] = sigma * w->x[j] - @PREFIX@q[j];
    if (EMB_M) {
        emb_Aty(rb, tn);
        for (int j = 0; j < EMB_N; ++j) rhs[j] += tn[j];
    }
    emb_cg_solve(rhs, w->xt);  /* warm-started PCG: xt holds x_tilde */
    emb_Ax(w->xt, Axt);

    for (int j = 0; j < EMB_N; ++j) {
        emb_float x_new = alpha * w->xt[j] + (1 - alpha) * w->x[j];
        w->delta_x[j] = x_new - w->x[j];
        w->x[j] = x_new;
    }
    for (int i = 0; i < EMB_M; ++i) {
        emb_float nu = @PREFIX@rho_vec[i] * (Axt[i] - b2[i]);
        emb_float z_tilde = w->z[i] + @PREFIX@rho_inv_vec[i] * (nu - w->y[i]);
        emb_float z_relax = alpha * z_tilde + (1 - alpha) * w->z[i];
        emb_float z_new = z_relax + @PREFIX@rho_inv_vec[i] * w->y[i];
        if (z_new < @PREFIX@l[i]) z_new = @PREFIX@l[i];
        if (z_new > @PREFIX@u[i]) z_new = @PREFIX@u[i];
        emb_float dy = @PREFIX@rho_vec[i] * (z_relax - z_new);
        w->z[i] = z_new;
        w->delta_y[i] = dy;
        w->y[i] += dy;
    }
}

int @PREFIX@osqp_solve(void) {
    @PREFIX@Workspace* w = &@PREFIX@work;
#if @PROFILING@
    struct timespec t0, t1;
    clock_gettime(CLOCK_MONOTONIC, &t0);
#endif
    int ct = @PREFIX@settings.check_termination;
    int status = EMB_UNSOLVED;
    int it = 0;
#if @INTERRUPT@
    @PREFIX@interrupt_flag = 0;
#endif

    if (!@PREFIX@settings.warm_starting) {
        memset(w->x, 0, sizeof(emb_float) * EMB_N);
        memset(w->xt, 0, sizeof(emb_float) * EMB_N);
        if (EMB_M) {
            memset(w->z, 0, sizeof(emb_float) * EMB_M);
            memset(w->y, 0, sizeof(emb_float) * EMB_M);
        }
    }
#if @PRINTING@
    printf("iter    pri_res      dua_res      rho\n");
#endif

    for (it = 1; it <= @PREFIX@settings.max_iter; ++it) {
        emb_admm_iteration();
        if (ct > 0 && (it % ct == 0)) {
            emb_float pri, dua, eps_pri, eps_dua;
            emb_residuals(&pri, &dua, &eps_pri, &eps_dua);
            w->pri_res = pri; w->dua_res = dua;
#if @PRINTING@
            printf("%4d  %11.4e  %11.4e  %9.2e\n", it, (double)pri,
                   (double)dua, (double)@PREFIX@settings.rho);
#endif
            int pri_ok = (EMB_M == 0) || (pri < eps_pri);
            int dua_ok = dua < eps_dua;
            if (pri_ok && dua_ok) { status = EMB_SOLVED; break; }
            if (!pri_ok && emb_is_primal_infeasible()) { status = EMB_PRIMAL_INFEASIBLE; break; }
            if (!dua_ok && emb_is_dual_infeasible()) { status = EMB_DUAL_INFEASIBLE; break; }
#if @INTERRUPT@
            if (@PREFIX@interrupt_flag) { status = EMB_SIGINT; break; }
#endif
            if (@PREFIX@settings.adaptive_rho &&
                @PREFIX@settings.adaptive_rho_interval > 0 &&
                (it % @PREFIX@settings.adaptive_rho_interval == 0))
                emb_adapt_rho();
        }
    }
    if (status == EMB_UNSOLVED) {
        it = @PREFIX@settings.max_iter;
        emb_float pri, dua, eps_pri, eps_dua;
        emb_residuals(&pri, &dua, &eps_pri, &eps_dua);
        w->pri_res = pri; w->dua_res = dua;
        int pri_ok = (EMB_M == 0) || (pri < eps_pri);
        int dua_ok = dua < eps_dua;
        if (pri_ok && dua_ok) status = EMB_SOLVED;
        else {
            emb_float f = (emb_float)10;
            if (((EMB_M == 0) || pri < f * eps_pri) && dua < f * eps_dua)
                status = EMB_SOLVED_INACCURATE;
            else
                status = EMB_MAX_ITER_REACHED;
        }
    }

#if @PRINTING@
    printf("status: %d  iterations: %d\n", status, it);
#endif

    for (int j = 0; j < EMB_N; ++j)
        @PREFIX@sol_x[j] = @PREFIX@D[j] * w->x[j];
    for (int i = 0; i < EMB_M; ++i)
        @PREFIX@sol_y[i] = @PREFIX@cinv * @PREFIX@E[i] * w->y[i];

    w->status_val = status;
    w->iter = it;
#if @PROFILING@
    clock_gettime(CLOCK_MONOTONIC, &t1);
    w->run_time = (emb_float)((t1.tv_sec - t0.tv_sec) + 1e-9 * (t1.tv_nsec - t0.tv_nsec));
#else
    w->run_time = (emb_float)0;
#endif
    return 0;
}

int @PREFIX@osqp_update_data_vec(const emb_float* q_new, const emb_float* l_new,
                                 const emb_float* u_new) {
    if (q_new) {
        for (int j = 0; j < EMB_N; ++j)
            @PREFIX@q[j] = @PREFIX@c_scale * @PREFIX@D[j] * q_new[j];
    }
    if (l_new) {
        for (int i = 0; i < EMB_M; ++i) {
            emb_float v = l_new[i] < -EMB_INFTY ? -EMB_INFTY : l_new[i];
            @PREFIX@l[i] = @PREFIX@E[i] * v;
        }
    }
    if (u_new) {
        for (int i = 0; i < EMB_M; ++i) {
            emb_float v = u_new[i] > EMB_INFTY ? EMB_INFTY : u_new[i];
            @PREFIX@u[i] = @PREFIX@E[i] * v;
        }
    }
    for (int i = 0; i < EMB_M; ++i)
        if (@PREFIX@l[i] > @PREFIX@u[i]) return 1;
    @PREFIX@work.status_val = EMB_UNSOLVED;
    return 0;
}

#if EMBEDDED_MODE == 2
/* value updates in the reference's CSC-data order: baked index maps point
 * each user data slot at its CSR position(s) (P gets both triangles). */
int @PREFIX@osqp_update_data_mat(const emb_float* P_x, const int* P_i, int P_n,
                                 const emb_float* A_x, const int* A_i, int A_n) {
    if (P_x) {
        for (int k = 0; k < (P_i ? P_n : @PREFIX@P_nnz); ++k) {
            int idx = P_i ? P_i[k] : k;
            if (idx < 0 || idx >= @PREFIX@P_nnz) return 1;
            int r = @PREFIX@P_pat_row[idx];
            int cc = @PREFIX@P_pat_col[idx];
            emb_float v = @PREFIX@c_scale * @PREFIX@D[r] * @PREFIX@D[cc] * P_x[k];
            @PREFIX@P_data[@PREFIX@P_map1[idx]] = v;
            if (@PREFIX@P_map2[idx] >= 0) @PREFIX@P_data[@PREFIX@P_map2[idx]] = v;
        }
    }
    if (A_x) {
        for (int k = 0; k < (A_i ? A_n : @PREFIX@A_nnz); ++k) {
            int idx = A_i ? A_i[k] : k;
            if (idx < 0 || idx >= @PREFIX@A_nnz) return 1;
            int r = @PREFIX@A_pat_row[idx];
            int cc = @PREFIX@A_pat_col[idx];
            emb_float v = @PREFIX@E[r] * @PREFIX@D[cc] * A_x[k];
            @PREFIX@A_data[@PREFIX@A_map[idx]] = v;
            @PREFIX@At_data[@PREFIX@At_map[idx]] = v;
        }
    }
    @PREFIX@work.status_val = EMB_UNSOLVED;
    emb_build_diagM();
    return 0;
}
#endif
'''
