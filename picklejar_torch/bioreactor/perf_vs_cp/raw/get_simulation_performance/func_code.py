@PickleJar.pickle(path="bioreactor/perf_vs_cp/raw")
def get_simulation_performance(dt_control, monte_carlo, device="cuda"):
    """ITSE of one noisy closed-loop run at the given control period; the
    noise generators are seeded ``7 monte_carlo + 1`` and ``+ 2``."""
    device_label(device)
    end_time = 50
    ts = np.linspace(0, end_time, end_time * 20)
    dt = ts[1]
    assert dt <= dt_control

    bioreactor, lin_model, K, _ = sim.get_parts(dt_control=dt_control,
                                                device=device)
    state_pdf, measurement_pdf = sim.get_noise(device=device)
    state_pdf.generator.manual_seed(monte_carlo * 7 + 1)
    measurement_pdf.generator.manual_seed(monte_carlo * 7 + 2)

    us = [np.array([0.06, 0.2])]
    xs = [bioreactor.X.copy()]
    ys = [bioreactor.outputs(us[-1])]
    ys_meas = [bioreactor.outputs(us[-1])]

    t_next = 0.0
    for t in ts[1:]:
        if t > t_next:
            u_temp = us[-1].copy()
            try:
                u = K.step(
                    lin_model.xn2d(xs[-1]),
                    lin_model.un2d(us[-1]),
                    lin_model.yn2d(ys_meas[-1]),
                )
            except ValueError:
                u = np.array([0.06, 0.2]) - lin_model.u_bar
            u_temp[lin_model.inputs] = lin_model.ud2n(u)
            us.append(u_temp.copy())
            t_next += dt_control
        else:
            us.append(us[-1])
        bioreactor.step(dt, us[-1])
        bioreactor.X = bioreactor.X + host_array(state_pdf.draw()).squeeze()
        outputs = bioreactor.outputs(us[-1])
        ys.append(outputs.copy())
        outputs = outputs.copy()
        outputs[lin_model.outputs] += host_array(measurement_pdf.draw()).squeeze()
        ys_meas.append(outputs)
        xs.append(bioreactor.X.copy())

    ys = np.array(ys)
    return sim.performance(ys[:, lin_model.outputs], lin_model.yd2n(K.ysp), ts)
