@RunSequences.vectorize
@PickleJar.pickle(path="gsf/raw")
def predict_run_seq(N, runs, gpu):
    return run_seq("gsf", "predict", N, runs, gpu)
