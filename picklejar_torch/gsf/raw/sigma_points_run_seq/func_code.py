@RunSequences.vectorize
@PickleJar.pickle(path="gsf/raw")
def sigma_points_run_seq(N, runs, gpu):
    """Sigma-point generation alone (:data:`sigma_points_op`)."""
    state, _ = build("gsf", N, gpu)
    try:
        return time_op(sigma_points_op, state, runs)
    finally:
        release(sigma_points_op)
