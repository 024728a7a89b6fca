@PickleJar.pickle(path="pf/breakdown")
def breakdown_run_seqs(n, runs, gpu):
    """:func:`breakdown_pf`, memoized for the breakdown figure."""
    return breakdown_pf(n, runs, gpu)
