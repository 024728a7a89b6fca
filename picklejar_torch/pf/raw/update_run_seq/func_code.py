@RunSequences.vectorize
@PickleJar.pickle(path="pf/raw")
def update_run_seq(N, runs, gpu):
    return run_seq("pf", "update", N, runs, gpu)
