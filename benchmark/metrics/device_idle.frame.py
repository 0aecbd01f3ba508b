"""device_idle.frame: 1 - the union of the device's kernel, memcpy and memset
intervals over the traced window's wall time, in the frame cells."""


def read(run):
    t = run.trace
    if t is None or t.window_s <= 0 or not t.device:
        return None
    return 1.0 - t.busy_s / t.window_s
