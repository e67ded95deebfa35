"""mapping.k4_launches_per_step: K4 (mapping's windowed 5-NN) launches
counted on the card over the window, per step (a sweep of every lane):
two a mapping GN refresh that ran."""


def read(r):
    return r.launches["k4"] / r.window.steps if r.window.steps else None
