// Serial (single-thread) float64 particle-filter engine: the port's own
// copy of the JAX package's serial reference engine.
//
// The same algorithms as the port's filters (bioreactor dynamics,
// Gaussian-sum pdf, the systematic resampling walk) in portable scalar
// code, float64 throughout, behind a C ABI bound with ctypes
// (gpu_se_tpu_torch/native/serial.py). It is the float64 oracle that the
// card's float32 predict and update are held against where no JAX is
// installed.

#include <cmath>
#include <cstdint>
#include <algorithm>

extern "C" {

// Low-N bioreactor state delta, dt premultiplied (the port's
// models/bioreactor.homeostatic_des).
void homeostatic_des(const double* x, const double* u, double dt, double* out) {
    double Cg = std::max(x[0], 0.0);
    double Cx = std::max(x[1], 0.0);
    double Cfa = std::max(x[2], 0.0);
    double Ce = std::max(x[3], 0.0);
    double Ch = x[4];

    double Fg_in = u[0], Fm_in = u[1];
    double Cg_in = 5000.0 / 180.0;
    double F_out = Fg_in + Fm_in;

    double rH = 280.0 / 180.0 - Cg;
    double rFA_max = 0.25 / 116.0 * Cx * 24.6;
    double rFA = rFA_max * (Cg / (1e-2 + Cg));

    double r1_max = (0.4 - 0.25) / 180.0 * Cx * 24.6;
    double r1_req = r1_max - (r1_max / 2000.0 / (0.28 / 180.0) * rH + 0.01 * Ch);
    double r1 = std::min(r1_max, std::max(0.0, r1_req)) * (Cg / (1e-2 + Cg));

    double rE_max = 0.025 / 46.0 * Cx * 24.6;
    double rE = std::min(rE_max, std::max(0.0, r1_req - r1_max));

    double r2_max = (0.1 - 0.025) / 180.0 * Cx * 24.6;
    double r2 = std::min(r2_max, std::max(0.0, r1_req - r1_max - rE));

    double rG = -rFA * (116.0 / 180.0) - r1 - rE * (46.0 / 180.0) - r2;

    out[0] = (Fg_in * Cg_in - F_out * Cg + rG) * dt;
    out[1] = 0.0;
    out[2] = (-F_out * Cfa + rFA) * dt;
    out[3] = (-F_out * Ce + rE) * dt;
    out[4] = rH * dt;
}

// Per-particle predict: x_i += f(x_i, u, dt) + noise_i.
void pf_predict(double* particles, int64_t n, int64_t nx,
                const double* u, double dt, const double* noise) {
    double delta[8];
    for (int64_t i = 0; i < n; ++i) {
        double* xi = particles + i * nx;
        homeostatic_des(xi, u, dt, delta);
        for (int64_t j = 0; j < nx; ++j) xi[j] += delta[j] + noise[i * nx + j];
    }
}

// Gaussian-sum pdf of residuals (z - g(x_i, u)) for the 2-output
// measurement model g = (Cg*180, Cfa*116); weights_io *= pdf.
// means: (nd, ny); inv_cov: (nd, ny, ny); log_const: (nd); mix_w: (nd).
void pf_update(const double* particles, double* weights_io,
               int64_t n, int64_t nx,
               const double* z, int64_t ny, int64_t nd,
               const double* means, const double* inv_cov,
               const double* norm_const, const double* mix_w) {
    for (int64_t i = 0; i < n; ++i) {
        const double* xi = particles + i * nx;
        double y0 = xi[0] * 180.0;
        double y1 = xi[2] * 116.0;
        double e[2] = {z[0] - y0, z[1] - y1};
        double p = 0.0;
        for (int64_t d = 0; d < nd; ++d) {
            double quad = 0.0;
            for (int64_t a = 0; a < ny; ++a) {
                double ea = e[a] - means[d * ny + a];
                for (int64_t b = 0; b < ny; ++b) {
                    double eb = e[b] - means[d * ny + b];
                    quad += ea * inv_cov[(d * ny + a) * ny + b] * eb;
                }
            }
            p += mix_w[d] * norm_const[d] * std::exp(-0.5 * quad);
        }
        weights_io[i] *= p;
    }
}

// Systematic resampling: the sequential cumsum walk.
void systematic_resample_indices(const double* weights, int64_t n,
                                 double r, int64_t* idx_out) {
    double total = 0.0;
    for (int64_t i = 0; i < n; ++i) total += weights[i];
    double cum = 0.0;
    int64_t k = 0;
    double ck = weights[0] / total;
    for (int64_t i = 0; i < n; ++i) {
        double u = (static_cast<double>(i) + r) / static_cast<double>(n);
        while (ck < u && k < n - 1) {
            ++k;
            cum = ck;
            ck += weights[k] / total;
        }
        idx_out[i] = k;
    }
    (void)cum;
}

// Gather particles by ancestor index into out (n, nx).
void gather(const double* particles, const int64_t* idx, int64_t n,
            int64_t nx, double* out) {
    for (int64_t i = 0; i < n; ++i) {
        const double* src = particles + idx[i] * nx;
        for (int64_t j = 0; j < nx; ++j) out[i * nx + j] = src[j];
    }
}

}  // extern "C"
