"""odometry.k3_launches_per_step: K3 (odometry's correspondence search)
launches counted on the card over the window, per step (a sweep of every
lane): two a GN refresh that ran."""


def read(r):
    return r.launches["k3"] / r.window.steps if r.window.steps else None
