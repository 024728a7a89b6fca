@RunSequences.vectorize
@PickleJar.pickle(path="gsf/raw")
def update_run_seq(N, runs, gpu):
    return run_seq("gsf", "update", N, runs, gpu)
