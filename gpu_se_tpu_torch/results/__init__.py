"""The experiments layer: the thesis's figures and campaigns on the port.

Counterpart of the reference's top-level ``results/`` package, module
for module (``pf_openloop/pf_run_seq.py`` here is ``results/pf_openloop/
pf_run_seq.py`` there), plus ``pacf_series`` and ``campaign`` in place of
the reference's ``scripts/pacf_series.py`` and ``scripts/campaign_*.py``.

Every experiment with a ``gpu`` flag runs on the card for ``gpu=True``
(and raises where there is none) and on the CPU for ``gpu=False``; the
closed-loop and MPC experiments take ``device=``, the card unless the
caller asks for the CPU. Expensive results are memoized in the port's
jar (``utils.PickleJar``, ``picklejar_torch/``). Neither matplotlib nor
sympy is imported until a ``plot()``, ``save_fig`` or a ``print_latex``
``main()`` needs it, so every module imports on a host without them.
"""
