@RunSequences.vectorize
@PickleJar.pickle(path="gsf/raw")
def resample_run_seq(N, runs, gpu):
    return run_seq("gsf", "resample", N, runs, gpu)
