"""LaTeX dump of the MPC's tuning matrices.

Counterpart of the reference's ``results/print_latex/controller_params.py``.
Q and R are the harness's host constants, so nothing is built on a
device; sympy is imported by :func:`main`.
"""
import numpy as np

from gpu_se_tpu_torch.sim import harness


def main():
    import sympy

    sympy.print_latex(sympy.Matrix(np.diag(harness.MPC_Q).T))
    sympy.print_latex(sympy.Matrix(np.diag(harness.MPC_R).T))


if __name__ == "__main__":
    main()
