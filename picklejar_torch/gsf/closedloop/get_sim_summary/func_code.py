@PickleJar.pickle(path="gsf/closedloop")
def get_sim_summary(N_particles, dt_control, dt_predict, monte_carlo=0,
                    end_time=50, device="cuda"):
    """Run one closed-loop simulation with the GSUKF; summarize its
    quality and runtime."""
    return sim_summary(N_particles, dt_control, dt_predict, monte_carlo,
                       end_time, False, device)
