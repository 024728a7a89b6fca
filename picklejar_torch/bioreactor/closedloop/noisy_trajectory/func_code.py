@PickleJar.pickle(path="bioreactor/closedloop")
def noisy_trajectory(end_time=50, dt_control=1, seed=0, device="cuda"):
    """:func:`simulate`'s result as host arrays: ``ts``, ``ys``,
    ``ys_meas``, ``us``, ``biass``, the ``itse`` and the ``device``
    label."""
    label = device_label(device)
    ts, ys, ys_meas, lin_model, K, us, dt_control, biass, end_time = \
        simulate(end_time, dt_control, seed, device)
    return {"device": label, "ts": ts, "ys": ys, "ys_meas": ys_meas,
            "us": us, "biass": biass,
            "itse": float(sim.performance(ys[:, lin_model.outputs],
                                          lin_model.yd2n(K.ysp), ts)),
            "dt_control": dt_control, "end_time": end_time}
