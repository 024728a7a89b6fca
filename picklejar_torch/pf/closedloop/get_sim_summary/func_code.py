@PickleJar.pickle(path="pf/closedloop")
def get_sim_summary(N_particles, dt_control, dt_predict, monte_carlo=0,
                    end_time=50, device="cuda"):
    """Run one closed-loop simulation with the PF; summarize its quality
    and runtime."""
    return sim_summary(N_particles, dt_control, dt_predict, monte_carlo,
                       end_time, True, device)
