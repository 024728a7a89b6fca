@RunSequences.vectorize
@PickleJar.pickle(path="gsf/raw")
def sigma_points_run_seq(N, runs, gpu):
    """Sigma-point generation alone (batched Cholesky and spread)."""
    state, _ = build("gsf", N, gpu)

    # chain through the state (the first sigma point is the mean) so that
    # each call takes the last one's output
    def sp(s):
        return dataclasses.replace(s, means=gs_ukf.get_sigma_points(s)[:, 0, :])

    return time_op(sp, state, runs)
