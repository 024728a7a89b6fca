@RunSequences.vectorize
@PickleJar.pickle(path="gsf/noop")
def noop_run_seq(N, runs, gpu):
    """Timer-overhead control: time an empty region."""
    del N, gpu
    out = np.empty(runs)
    for i in range(runs):
        t0 = time.perf_counter()
        out[i] = time.perf_counter() - t0
    return out
