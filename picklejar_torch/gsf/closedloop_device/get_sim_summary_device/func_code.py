@PickleJar.pickle(path="gsf/closedloop_device")
def get_sim_summary_device(N_particles, dt_control, dt_predict,
                           monte_carlo=0, end_time=50, device="cuda"):
    """Device twin of :func:`get_sim_summary`: the loop of
    ``sim.loop.make_scan_loop`` with the GSUKF."""
    return sim_summary_device(N_particles, dt_control, dt_predict,
                              monte_carlo, end_time, False, device)
