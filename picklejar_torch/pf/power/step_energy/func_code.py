@RunSequences.vectorize
@PickleJar.pickle(path="pf/power")
@PowerMeasurement.measure
def step_energy(N, t_run, gpu):
    """Runs fused PF steps for ``t_run`` seconds; returns the count."""
    return paced_steps("pf", N, t_run, gpu)
