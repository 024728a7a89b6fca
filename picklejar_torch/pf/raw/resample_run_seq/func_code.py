@RunSequences.vectorize
@PickleJar.pickle(path="pf/raw")
def resample_run_seq(N, runs, gpu):
    return run_seq("pf", "resample", N, runs, gpu)
