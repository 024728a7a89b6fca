@PickleJar.pickle(path="bioreactor/mpc_run_seq")
def mpc_run_seq(n_runs=1000, dt_control=0.1, device="cuda"):
    """Wall-clock seconds of ``n_runs`` warm-started closed-loop MPC
    solves, the host's latency of ``K.step``; a solve that raises falls
    back to ``u = [0.06, 0.2]`` and is timed all the same."""
    end_time = 50
    ts = np.linspace(0, end_time, int(end_time * 10))
    dt = ts[1]
    bioreactor, lin_model, K, _ = sim.get_parts(dt_control=dt_control,
                                                device=device)

    us = [np.array([0.06, 0.2])]
    xs = [bioreactor.X.copy()]
    ys = [bioreactor.outputs(us[-1])]

    times = []
    while len(times) < n_runs:
        for t in ts[1:]:
            u_temp = us[-1].copy()
            t0 = time.perf_counter()
            try:
                u = K.step(
                    lin_model.xn2d(xs[-1]),
                    lin_model.un2d(us[-1]),
                    lin_model.yn2d(ys[-1]),
                )
            except ValueError:
                u = np.array([0.06, 0.2]) - lin_model.u_bar
            times.append(time.perf_counter() - t0)
            u_temp[lin_model.inputs] = lin_model.ud2n(u)
            us.append(u_temp.copy())
            bioreactor.step(dt, us[-1])
            ys.append(bioreactor.outputs(us[-1]))
            xs.append(bioreactor.X.copy())
            if len(times) >= n_runs:
                break
    return np.array(times)
