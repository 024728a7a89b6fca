@PickleJar.pickle(path="bioreactor/closedloop")
def trajectory(end_time=50, dt_control=1, device="cuda"):
    """:func:`simulate`'s result as host arrays: ``ts``, ``ys``, ``us``,
    ``biass``, the set point in natural units ``ysp``, the model's
    ``inputs`` and ``outputs``, the ``itse`` and the ``device`` label."""
    label = device_label(device)
    ts, ys, lin_model, K, us, dt_control, biass, end_time = simulate(
        end_time, dt_control, device)
    return {"device": label, "ts": ts, "ys": ys, "us": us, "biass": biass,
            "ysp": lin_model.yd2n(K.ysp),
            "inputs": list(lin_model.inputs),
            "outputs": list(lin_model.outputs),
            "itse": float(sim.performance(ys[:, lin_model.outputs],
                                          lin_model.yd2n(K.ysp), ts)),
            "dt_control": dt_control, "end_time": end_time}
