@RunSequences.vectorize
@PickleJar.pickle(path="pf/raw")
def predict_run_seq(N, runs, gpu):
    return run_seq("pf", "predict", N, runs, gpu)
