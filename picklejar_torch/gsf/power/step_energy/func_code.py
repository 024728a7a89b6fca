@RunSequences.vectorize
@PickleJar.pickle(path="gsf/power")
@PowerMeasurement.measure
def step_energy(N, t_run, gpu):
    """Runs fused GSF steps for ``t_run`` seconds; returns the count."""
    return paced_steps("gsf", N, t_run, gpu)
