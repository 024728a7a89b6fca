"""LaTeX dump of the noise mixtures' tuning matrices.

Counterpart of the reference's ``results/print_latex/state_meas_noise.py``.
The mixtures are built on the CPU, whatever the host, so the script
runs wherever sympy is; sympy is imported by :func:`main`.
"""
import numpy as np

from gpu_se_tpu_torch import sim


def _np(t):
    return t.detach().numpy()


def main():
    import sympy

    state_pdf, measurement_pdf = sim.get_noise(device="cpu")
    sympy.print_latex(sympy.Matrix(np.diag(_np(state_pdf.covariances[0]))).T)
    sympy.print_latex(sympy.Matrix(_np(measurement_pdf.means[0])).T)
    sympy.print_latex(sympy.Matrix(_np(measurement_pdf.means[1])).T)
    sympy.print_latex(sympy.Matrix(np.diag(_np(measurement_pdf.covariances[0]))).T)
    sympy.print_latex(sympy.Matrix(np.diag(_np(measurement_pdf.covariances[1]))).T)
    sympy.print_latex(sympy.Matrix(_np(measurement_pdf.weights)).T)


if __name__ == "__main__":
    main()
