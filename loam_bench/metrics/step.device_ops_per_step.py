"""step.device_ops_per_step: device operations (kernels, copies,
memsets) in the profiled slice, per step (a sweep of every lane)."""


def read(r):
    p = r.profile
    return p["device_ops"] / p["steps"] if p and p["steps"] else None
