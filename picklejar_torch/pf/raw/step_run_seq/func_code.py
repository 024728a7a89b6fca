@RunSequences.vectorize
@PickleJar.pickle(path="pf/raw")
def step_run_seq(N, runs, gpu):
    return run_seq("pf", "step", N, runs, gpu)
